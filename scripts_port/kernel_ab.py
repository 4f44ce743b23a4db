#!/usr/bin/env python3
"""Time K2 (the marcher), K2 with noise, K1's forward and backward, K4 on
both routes, K3 forward and backward, K9 forward and backward, a served
view's kernels, the clean train step and the watermark step for one tree of
the repository, on one NVIDIA GPU: the way to put two commits side by side
on one card.

    python3 scripts_port/kernel_ab.py <tree> [--out FILE]

``<tree>`` is the root of a checkout (this repository, or another commit
unpacked with ``git archive``): its ``nerf_signature_tpu_torch`` is built and
imported, and the inputs are made by this repository's ``chip_smoke.py``
helpers from their seeds: K2 and K1 on the serving chunk of view 0 (4096
rays at the ball's centre, budget 256, the prefilter on), K2 with noise on
the train step's 4096 random rays (budget 128), and view 0 at 800x800
rendered in 157 chunks under torch.profiler (device time by kernel).  K4's
forward (bf16 and fp32) on the serving chunk, its full backward at the
train step's samples and its feature-only backward at the watermark step's
(chip_smoke.py's shapes and cotangents).  K3's forward on the field's
output at the serving chunk, the train step's samples and the watermark
step's, and its backward at the last two (the loss's cotangents of
weights_sum and image, as chip_smoke.py draws them).  K1's backward at the
train step's samples (16 x 2, and 16 x 4) and into the message's one-level
table at the watermark step's (chip_smoke.py's cotangents); where the
tree's K1 backward groups the adds of coarse levels by row
(``ops/hashenc.py:COMBINE_MAX_RES``), also with that resolution limit at 0
(never), 128, 256, 1024 and 2^20 (always).  K9 forward and backward at the
recipe's 32-bit message tables.  Each kernel: per call (CUDA events around
one call, median) and on the device (torch.profiler, the durations of its
device work).  Then the end-to-end rates: Trainer.train
for 512 steps on the radius-0.7 ball (train rays/s) and
WatermarkTrainer.train for 1000 steps of the README stage-2 recipe on that
backbone (watermark rays/s), each followed by 16 profiled steps (wall and
device busy ms a step, idle share).  Prints one JSON line (also to
``--out``).  Run each tree in its own process, in turns (parent, change,
change, parent), all in one call to the card.

Where the tree's ``composite.cu`` has the serial chain of 32 shuffles (the
cumulative sum of tau in slot order), each K3 row also has a ``K3_scan``
twin: that source built alone with the chain swapped for a warp scan of 5
steps, the same loads, stores and stop but other roundings (so it is
timed, never used).  The gap between the two is what the chain costs.
"""

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the body of composite.cu's serial chain, and a warp scan in its place
CHAIN = re.compile(r"(__device__ __forceinline__ float serial_cumsum\(float& carry, float tau, "
                   r"int lane\) \{\n).*?\n\}\n", re.S)
SCAN = """  float v = tau;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = __fadd_rn(y, v);
  }
  v = __fadd_rn(carry, v);
  carry = __shfl_sync(FULL, v, 31);
  return v;
}
"""


def scan_variant(tree):
    """The tree's composite.cu with the serial chain swapped for a warp scan,
    built alone (the flags of the package's build) into its _build
    directory and loaded: (forward, backward) C entry points; None if the
    source has no such chain."""
    from nerf_signature_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "composite.cu")) as f:
        src, n = CHAIN.subn(lambda mt: mt.group(1) + SCAN, f.read())
    if n == 0:
        return None
    out = os.path.join(tree, "nerf_signature_tpu_torch", "_build", "k3_scan")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "composite_scan.cu"), os.path.join(out, "libk3_scan.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = ([_cuda._nvcc()] + _cuda._ARCH + _cuda._COMMON + _cuda.SOURCES["composite.cu"] +
           ["-I", _cuda.CSRC, "-shared", cu, "-o", so])
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the scan variant:\n{r.stdout}")
    lib = ctypes.CDLL(so)
    fns = []
    for sym in ("ngp_composite", "ngp_composite_bwd"):
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = _cuda._SIGNATURES[sym], ctypes.c_int
        fns.append(fn)
    return fns


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA GPU visible; this script runs on the card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import nerf_signature_tpu_torch as pkg

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != tree:
        raise RuntimeError(f"imported {pkg.__file__}, not the package of {tree}")
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import composite as t_comp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    gpu = cs.phase_device()
    dev = torch.device("cuda")
    _cuda.library()
    out = {"tree": tree, "gpu": gpu}

    def timed(name, run, reps=30):
        out[name] = {"ms": cs.median_ms(run, reps), "device_ms": cs.device_ms(run, reps)}

    scan = scan_variant(tree)

    def k3(tag, fpx, cfg, mk, f, ds, gen, backward=True):
        """K3 forward (and backward) on the field's output at these samples,
        and the scan variant, if any, on the same inputs."""
        N_, S_ = mk["mask"].shape
        with torch.no_grad():
            sig, _, rgb = t_ngp.field_heads(fpx, cfg, f, ds)
        sig = (sig.reshape(N_, S_) * m.rc.density_scale).contiguous()
        rgb = rgb.reshape(N_, S_, 3).contiguous()
        args = (sig, rgb, mk["deltas"], mk["ts"])
        timed("K3_" + tag, lambda: t_comp.composite_rays(*args, mask=mk["mask"]))
        ptrs = [t.data_ptr() for t in args[:4]] + [mk["mask"].data_ptr(), 1e-4, N_, S_]
        stream = lambda: torch.cuda.current_stream().cuda_stream
        if scan:
            outs = [torch.empty((N_,), device=dev), torch.empty((N_,), device=dev),
                    torch.empty((N_, 3), device=dev), torch.empty((N_, S_), device=dev)]
            timed("K3_scan_" + tag, lambda: scan[0](*ptrs, *(o.data_ptr() for o in outs),
                                                    stream()))
        if backward:
            g_img = torch.randn((N_, 3), generator=gen, device=dev) * 1e-4
            g_ws = -(g_img * torch.rand((N_, 3), generator=gen, device=dev)).sum(-1)
            timed("K3_bwd_" + tag, lambda: t_comp.composite_rays_bwd(
                *args, mk["mask"], 1e-4, g_ws=g_ws, g_image=g_img))
            if scan:
                gsig, grgb = torch.empty_like(sig), torch.empty_like(rgb)
                timed("K3_scan_bwd_" + tag, lambda: scan[1](
                    *ptrs, g_ws.data_ptr(), None, g_img.data_ptr(), None, gsig.data_ptr(),
                    grgb.data_ptr(), stream()))

    m = cs.make_model(dev)
    grid, aabb = m.occ.occupancy, default_aabb(m.rc)
    ro, rd, _ = cs.serve_chunk(dev)
    kw = cs.march_kwargs(m, True)
    plan = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                              budget=kw["budget"], prefilter=True)
    coarse = t_march.coarse_grid(grid, plan)
    timed("K2", lambda: t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw))
    march = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
    fp = t_ngp.field_params(m.params, m.cfg)
    x01 = ((march["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    res, S = m.cfg.resolutions, m.cfg.log2_hashmap_size
    timed("K1", lambda: t_hash.hash_encode(x01, fp["hash_table"], res, S,
                                           table_g=fp["hash_table_g"]), 20)
    del march, x01

    ro_t, rd_t = cs.train_rays(dev)
    noise = torch.rand((cs.TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev)
    kw_t = dict(kw, budget=cs.TRAIN_BUDGET, prefilter=None, noise=noise)
    plan_t = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                                budget=cs.TRAIN_BUDGET)
    coarse_t = t_march.coarse_grid(grid, plan_t)
    timed("K2_noise", lambda: t_march.march_rays_aabb(ro_t, rd_t, aabb, grid, coarse=coarse_t,
                                                      **kw_t))

    # K4 on both routes: forward on the serving chunk
    cfg32 = dataclasses.replace(m.cfg, compute_dtype=torch.float32)
    fp32 = t_ngp.field_params(m.params, cfg32)
    march = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
    x01 = ((march["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    dirs = march["dirs"].reshape(-1, 3).contiguous()
    with torch.no_grad():
        feat = t_hash.hash_encode(x01, fp["hash_table"], res, S, table_g=fp["hash_table_g"])
    timed("K4", lambda: t_ngp.field_heads(fp, m.cfg, feat, dirs), 20)
    timed("K4_f32", lambda: t_ngp.field_heads(fp32, cfg32, feat, dirs), 10)
    k3("serve", fp, m.cfg, march, feat, dirs, None, backward=False)
    del x01, dirs, feat, march

    def backward_inputs(fpx, cfg, tag, ro_, rd_, aabb_, grid_, gen, **march_kw):
        """Encoded samples and cotangents zero on padded samples, as in
        chip_smoke.py's train-kernels and watermark-kernels phases; K3 at
        these samples (``tag``) on the way."""
        mk = t_march.march_rays_aabb(ro_, rd_, aabb_, grid_, **march_kw)
        live = mk["mask"].reshape(-1).float()
        xs = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        ds = mk["dirs"].reshape(-1, 3).contiguous()
        with torch.no_grad():
            f = t_hash.hash_encode(xs, fpx["hash_table"], res, S, table_g=fpx["hash_table_g"])
        k3(tag, fpx, cfg, mk, f, ds, gen)
        gs = torch.randn((xs.shape[0],), generator=gen, device=dev) * 1e-4 * live
        gr = torch.randn((xs.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
        return f, ds, gs, gr, xs, live

    def k1_bwd(tag, xs, live, n_rows, res_, log2, F, gen):
        """K1's backward on chip_smoke.py's cotangents (zero on the dead
        samples), and with the grouping's resolution limit swept."""
        g_feat = torch.randn((xs.shape[0], len(res_) * F), generator=gen, device=dev) * 1e-4
        g_feat *= live[:, None]
        run = lambda: t_hash._hash_encode_bwd_kernel(xs, g_feat, n_rows, res_, log2,
                                                     torch.bfloat16, False, None)
        timed("K1_bwd_" + tag, run, 20)
        if hasattr(t_hash, "COMBINE_MAX_RES"):
            keep = t_hash.COMBINE_MAX_RES
            for limit in (0, 128, 256, 1024, 1 << 20):
                t_hash.COMBINE_MAX_RES = limit
                timed(f"K1_bwd_{tag}_combine_{limit}", run, 20)
            t_hash.COMBINE_MAX_RES = keep

    # K4's full backward and K1's backward at the train step's samples
    gen = torch.Generator(device=dev).manual_seed(7)
    f, ds, gs, gr, xs, live = backward_inputs(fp, m.cfg, "clean", ro_t, rd_t, aabb, grid, gen,
                                              coarse=coarse_t, **kw_t)
    for name, fpx, cfg in (("K4_bwd", fp, m.cfg), ("K4_bwd_f32", fp32, cfg32)):
        w = t_ngp._kernel_widths(fpx, cfg)
        timed(name, lambda: t_ngp.field_heads_bwd(cfg, w, f, ds, fpx["mlp_flat"], gs, gr,
                                                  fpx.get("mlp_mma")), 10)
    k1_bwd("clean", xs, live, fp["hash_table"].shape[0], res, S, 2, gen)
    del f, ds, gs, gr, xs, live
    # K1's backward at 16 x 4 (rows of 4 features), the train step's samples
    m4 = cs.make_model(dev, levels=16, features=4)
    mk = t_march.march_rays_aabb(ro_t, rd_t, aabb, m4.occ.occupancy, coarse=coarse_t, **kw_t)
    xs = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    k1_bwd("16x4", xs, mk["mask"].reshape(-1).float(), m4.params["hash_table"].shape[0],
           m4.cfg.resolutions, S, 4, gen)
    del m4, mk, xs
    # K4's feature-only backward at the watermark step's samples
    mw = cs.make_wm_model(dev)
    x = cs.wm_step_inputs(dev)
    fpw = t_ngp.field_params(mw.backbone, mw.cfg)
    cfgw32 = dataclasses.replace(mw.cfg, compute_dtype=torch.float32)
    fpw32 = t_ngp.field_params(mw.backbone, cfgw32)
    gen = torch.Generator(device=dev).manual_seed(17)
    f, ds, gs, gr, xs, live = backward_inputs(
        fpw, mw.cfg, "wm", torch.cat([x["ro_b"].reshape(-1, 3), x["ct_o"]]),
        torch.cat([x["rd_b"].reshape(-1, 3), x["ct_d"]]), default_aabb(mw.rc),
        mw.occ.occupancy, gen, min_near=0.2, bound=1.0, max_steps=1024, budget=256)
    for name, fpx, cfg in (("K4_bwd_feat", fpw, mw.cfg), ("K4_bwd_feat_f32", fpw32, cfgw32)):
        w = t_ngp._kernel_widths(fpx, cfg)
        timed(name, lambda: t_ngp.field_heads_bwd_feat(cfg, w, f, ds, fpx["mlp_flat"], gs, gr,
                                                       fpx.get("mlp_mma")), 10)
    # K1's backward into the message's one-level table; K9 both ways
    from nerf_signature_tpu_torch.models import message as t_msg
    from nerf_signature_tpu_torch.models import watermark as t_wm

    tables, bits = mw.trainable["msg_tables"], x["bits"]
    D, _, T, F = tables.shape
    res_m, _, _ = t_wm.msg_encode_placement(mw.wcfg)
    k1_bwd("wm", xs, live, T, res_m, mw.wcfg.msg_log2_hashmap_size, F, gen)
    timed("K9", lambda: t_msg._msg_table_kernel(tables, bits, torch.bfloat16))
    g_eff = torch.randn((T, F), generator=gen, device=dev)
    timed("K9_bwd", lambda: t_msg._msg_table_bwd_kernel(g_eff, bits, D))
    del f, ds, gs, gr, xs, live, mw, x, fpw, fpw32, fp32, tables, g_eff

    rays = cs.view_rays(cs.orbit_poses(cs.N_VIEWS, cs.ORBIT_RADIUS)[:1])
    render = lambda: m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True)
    render()
    out["view"] = cs.view_profile(render)
    del m, fp

    # the end-to-end rates: the clean train step and the watermark step
    r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS)
    steps = r["trainer"].global_step
    out["train"] = dict(cs.profile_steps(r["trainer"], r["loader"]), steps=steps,
                        seconds=r["seconds"], psnr1=r["psnr1"],
                        rays_per_s=steps * cs.TRAIN_RAYS / r["seconds"])
    with tempfile.TemporaryDirectory() as workdir:
        w = cs.wm_train(dev, r["trainer"].model, workdir)
        tr = w["trainer"]
        prof = cs.profile_steps(tr, w["loader"], tag="wm profile",
                                step=lambda d: tr.train_step_data(d, tr.random_message()))
        out["wm"] = dict(prof, steps=w["steps"], seconds=w["seconds"],
                         rays_per_s=w["steps"] * cs.WM_STEP_RAYS / w["seconds"])
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
