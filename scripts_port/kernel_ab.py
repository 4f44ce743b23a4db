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
device busy ms a step, idle share).  Then the device loops: Trainer.train_device
(512 steps at --steps_per_dispatch 64 on the radius-0.7 ball), K5's pack,
unpack and unpack backward at the clean and watermark steps' shapes on that
model's grid (chip_smoke.py's K5 phase: bit-exact against the plain
versions, then per call and device ms with the L2 flushed), and
WatermarkTrainer.train_device (1000 steps of the recipe on that backbone),
each loop with its rays/s and one more dispatch profiled (wall and busy ms a
step, K5 pack's device ms a step).  ``--sections`` picks among ``kernels``
(everything before the rates), ``steps`` (the per-step rates), ``loops``,
``k4`` (K4's fp32 SIMT kernels alone, below), ``k10``, ``bg``, ``k7k5``,
``k5host`` and ``k6`` (below); the first three by default.
Prints one JSON line (also to ``--out``).  Run each tree in its own
process, in turns (parent, change, change, parent), all in one call to the
card.

``k4``: K4's fp32 forward on the serving chunk, its fp32 full backward at
the train step's samples and its fp32 feature-only backward at the
watermark step's, at 16 x 2, 8 x 2 (encoding width 16), 16 x 4 (64) and
12 x 2 (24, run at 32), through ``chip_smoke.py``'s ``k4_forward``,
``k4_bwd`` and ``k4_bwd_feat`` (each against its plain version; per call
and device ms, the fp32 ``torch.matmul`` chain's, the bound), with a hash
of every output (sigma, geo, rgb, the logit, the density-only query's
sigma and geo; the full backward's g_feat and g_weights; g_feat).  The
full backward's g_weights are also saved beside ``--out`` (``.gw.pt``).

``bg``: the background colour (``models/ngp.py:ngp_background``) of a
random bg model at the defaults (4 levels x F = 2 x 2^15 rows, bg_net 24
-> 64 -> 3, seeded), in bf16 and fp32: its forward at the train step's
4096 rays and at the serving chunk (no gradient), and its forward and
backward together at the train step's rays (the gradients of bg_table and
both bg_net matrices; its device ms by kernel too); each per call (CUDA
events, median), on the device (torch.profiler) and the device work a call
launches (kernels, memsets, copies: counted in a trace); with a hash of the
outputs.  Then the bg loop
(Trainer.train_device, 512 steps at K = 64 with --bg_radius 8 on
chip_smoke.py's sky views; one more dispatch profiled: busy ms a step and
the idle share) and one 800x800 view served on that model (the wall clock
of a render, median of 3, and its device busy ms under torch.profiler).

``k7k5``: K7's one-corner forward (``ops/hashenc.py:_hash_encode_1c_kernel``)
at the train step's 524,288 samples (``chip_smoke.py``'s noisy march of
4096 random rays at budget 128 on the procedural ball) at 16 x 2 (pitch
32) and 16 x 4, with K1's forward and backward (controls: the same level
arguments) and K7's backward at strides 1 and 2 on the same samples
(``chip_smoke.py``'s ``k7_bwd_row``: against its plain version, device ms
warm and cold split by name into the kernel and the zeroing of the
table's gradient, each with its bound); then the K7 loop trained
(``k7_trained``: Trainer.train_device, 512 steps at K = 64 with
--stochastic_hash_grad; one more dispatch profiled, K7's backward kernel's
ms a step), K7's backward at strides 1 and 2 on that model at the clean
step's shape and at the loop's own (the inputs one more eager step hands
it: K5's compacted slots, K4's cotangent), and K5 at the clean and
watermark steps' shapes on its trained grid (no digests: the trained model
differs from run to run); then K5 at those shapes on the ball
(``chip_smoke.py``'s ``k5_march`` and ``auto_mc``, through ``k5_case``:
bit-exact against the plain versions): the unpack, its backward and the
pack.  Each row: ms a call (CUDA events,
median), device ms cold (L2 flushed) and warm (torch.profiler), host µs a
call (ms less the warm device ms), and ms a call in a stream of 200
back-to-back calls (``loop_ms``: CUDA events around them all, the larger
of host and device time a call); the yardsticks, labelled "the gather
alone (choice excluded)" (``index_select`` of rows chosen beforehand) and
"the gather alone (keep mask excluded)" (through a ``src`` built
beforehand); the digests of every deterministic output (the backwards add
by atomics and carry none).  K7's rows also time the host path alone: the
wrapper on an empty batch (nothing launched) and the C entry at M = 0 in
the tree's own argument form (13 scalars and arrays, or the prepared level
block), each a perf_counter over ``HOST_CALLS`` calls.  It ends with
``k5host``, which also runs alone: K5 unpack's host path at both shapes,
five readings each (median and all) of the wrapper on an empty slot map,
of its outputs' two ways of allocation (two tensors, or one buffer and two
views), and of the unpack and its backward in streams of back-to-back
calls.

``k6``: K6, the occupancy-grid update (``ops/grid.py``), on the trained
grid of the clean loop (Trainer.train_device, 512 steps at K = 64 on the
radius-0.7 ball, as ``chip_smoke.py``'s device-loop phase trains it): first
one more dispatch of that loop profiled (wall and busy ms a step, the idle
share, the device ms a step of the kernels named ``k6_``); then one full and
one partial update through ``update_extra_state`` on seeded draws, each from
the same saved grid: ms a call (CUDA events, median), device ms warm and
cold, the device ms a call split into its queries, the query's setup and
K6's own work, and by kernel with full names (``chip_smoke.py:k6_split``),
the bound of its own bytes and of the whole update's, and the digests of
the grid's five tensors after one update (the trained grid itself differs
from run to run: K1's backward adds by atomics); then the same update on
``chip_smoke.py``'s
seeded procedural model, its grid made by two full updates on seeded draws
(no training, so every tree makes it bit for bit): ms, device ms and the
digests, which ``--compare`` holds equal across the trees.

``k10``: K10 on the samples of an eager CopyRNeRF watermark step (the
README recipe with ``--copyrnerf`` on a random full-width backbone, 2
steps), through ``chip_smoke.py``'s ``k10_row`` (against its plain
version; per call and cold device ms, the bound) and ``k10_in_step`` (its
device ms inside one more eager step under torch.profiler), with a hash of
its output; then on synthetic inputs at a third, two thirds and all of the
recipe's 1,511,424 samples: its device ms from torch.profiler cold (the L2
flushed) and warm, from CUDA events over back-to-back calls, and a fill_
of as many bytes (cold), the card's write rate there.  Then

    python3 scripts_port/kernel_ab.py --compare A.json B.json ...

prints, for each kernel row, every file's device ms, ms and host µs a call
and whether all the files' outputs are bit-equal, and, where ``.gw.pt`` files lie beside them,
the worst relative L2 of each full backward's g_weights against the first
file's.

Where the tree's ``composite.cu`` has the serial chain of 32 shuffles (the
cumulative sum of tau in slot order), each K3 row also has a ``K3_scan``
twin: that source built alone with the chain swapped for a warp scan of 5
steps, the same loads, stores and stop but other roundings (so it is
timed, never used).  The gap between the two is what the chain costs.
"""

import argparse
import ctypes
import dataclasses
import hashlib
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


def loops(out, dev, cs):
    """The device loops at --steps_per_dispatch DL_K, and K5 on the clean
    loop's trained grid, into ``out``."""
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train.trainer_wtmk import wm_device_loop

    K = cs.DL_K
    r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS, steps_per_dispatch=K)
    tr = r["trainer"]
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, cs.RES,
                        cs.RES, dev)
    out["clean_loop"] = dict(
        cs.profile_dispatch(lambda: t_dl.device_train_loop(tr, data, K), K, "device loop profile",
                            tr.model.rc.compact_frac > 0),
        steps=tr.global_step, seconds=r["seconds"], psnr1=r["psnr1"],
        rays_per_s=tr.global_step * cs.TRAIN_RAYS / r["seconds"],
        k5_launches={k: v for k, v in r["launches"].items() if k.startswith("K5")})
    del data
    out["k5"] = cs.k5_phase(dev, tr.model)
    with tempfile.TemporaryDirectory() as workdir:
        w = cs.wm_train(dev, tr.model, workdir, tag="wm device loop", steps_per_dispatch=K)
        wt, loader = w["trainer"], w["loader"]
        ro_b, rd_b = wt._device_rays(next(iter(loader))["watermark"])
        wdata = t_dl.preload(loader.poses, loader.train_images, loader.intrinsics, loader.H,
                             loader.W, dev)
        out["wm_loop"] = dict(
            cs.profile_dispatch(lambda: wm_device_loop(wt, wdata, ro_b, rd_b, K), K,
                                "wm device loop profile", wt.model.rc.compact_frac > 0),
            steps=w["steps"], seconds=w["seconds"],
            rays_per_s=w["steps"] * w["step_rays"] / w["seconds"],
            k5_launches={k: v for k, v in w["launches"].items() if k.startswith("K5")})


# the table geometries of the k4 section: (levels, features)
K4_GEOMETRIES = {"16x2": (16, 2), "8x2": (8, 2), "16x4": (16, 4), "12x2": (12, 2)}


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def k4_simt(out, dev, cs, gw_out):
    """K4's fp32 SIMT forward, full backward and feature-only backward at
    K4_GEOMETRIES, their rows and the hashes of their outputs, into ``out``;
    the full backward's g_weights by geometry into ``gw_out``."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    for geo, (L, F) in K4_GEOMETRIES.items():
        m = cs.make_model(dev, levels=L, features=F)
        cfg = dataclasses.replace(m.cfg, compute_dtype=torch.float32)
        fp = t_ngp.field_params(m.params, cfg)
        pitch = t_ngp.feature_pitch(cfg)
        ro, rd, _ = cs.serve_chunk(dev)
        mk = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), m.occ.occupancy,
                                     **cs.march_kwargs(m, None))
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
                                  table_g=fp["hash_table_g"], pitch=pitch)
        row, _ = cs.k4_forward(fp, cfg, feat, dirs)
        s, g, r, raw = t_ngp.field_heads(fp, cfg, feat, dirs, want_geo=True, want_raw=True)
        sd, gd, _ = t_ngp.field_heads(fp, cfg, feat, None, want_geo=True)
        row.update(samples=feat.shape[0], sha={k: digest(v) for k, v in (
            ("sigma", s), ("geo", g), ("rgb", r), ("raw", raw), ("density_sigma", sd),
            ("density_geo", gd))})
        out[f"K4_f32_{geo}"] = row
        del mk, x01, dirs, feat, s, g, r, raw, sd, gd
        # the full backward at the train step's samples (chip_smoke.py's
        # train-kernels phase: 4096 random rays, budget 128, its noise)
        ro_t, rd_t = cs.train_rays(dev)
        noise = torch.rand((cs.TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(7),
                           device=dev)
        grid = m.occ.occupancy
        plan = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                                  budget=cs.TRAIN_BUDGET)
        mk = t_march.march_rays_aabb(ro_t, rd_t, default_aabb(m.rc), grid,
                                     coarse=t_march.coarse_grid(grid, plan),
                                     **dict(cs.march_kwargs(m, None), budget=cs.TRAIN_BUDGET,
                                            noise=noise))
        live = mk["mask"].reshape(-1).float()
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        with torch.no_grad():
            feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions,
                                      cfg.log2_hashmap_size, table_g=fp["hash_table_g"],
                                      pitch=pitch)
        gen = torch.Generator(device=dev).manual_seed(5)
        g_sigma = torch.randn((x01.shape[0],), generator=gen, device=dev) * 1e-4 * live
        g_rgb = torch.randn((x01.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
        row = cs.k4_bwd(fp, cfg, feat, dirs, g_sigma, g_rgb)
        w = t_ngp._kernel_widths(fp, cfg)
        gf, gw = t_ngp.field_heads_bwd(cfg, w, feat, dirs, fp["mlp_flat"], g_sigma, g_rgb)
        row.update(samples=feat.shape[0], live_samples=int(live.sum()),
                   sha={"g_feat": digest(gf), "g_weights": digest(gw)})
        out[f"K4_bwd_f32_{geo}"] = row
        gw_out[geo] = gw.cpu()
        del m, mk, live, x01, dirs, feat, g_sigma, g_rgb, gf, gw
        mw = cs.make_wm_model(dev, levels=L, features=F)
        x = cs.wm_step_inputs(dev)
        fpw = t_ngp.field_params(mw.backbone, cfg)
        mk = t_march.march_rays_aabb(
            torch.cat([x["ro_b"].reshape(-1, 3), x["ct_o"]]),
            torch.cat([x["rd_b"].reshape(-1, 3), x["ct_d"]]), default_aabb(mw.rc),
            mw.occ.occupancy, min_near=0.2, bound=1.0, max_steps=1024, budget=256)
        live = mk["mask"].reshape(-1).float()
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        with torch.no_grad():
            feat = t_hash.hash_encode(x01, fpw["hash_table"], cfg.resolutions,
                                      cfg.log2_hashmap_size, table_g=fpw["hash_table_g"],
                                      pitch=pitch)
        gen = torch.Generator(device=dev).manual_seed(17)
        g_sigma = torch.randn((x01.shape[0],), generator=gen, device=dev) * 1e-4 * live
        g_rgb = torch.randn((x01.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
        row = cs.k4_bwd_feat(fpw, cfg, feat, dirs, g_sigma, g_rgb)
        w = t_ngp._kernel_widths(fpw, cfg)
        gf = t_ngp.field_heads_bwd_feat(cfg, w, feat, dirs, fpw["mlp_flat"], g_sigma, g_rgb)
        row.update(samples=feat.shape[0], sha={"g_feat": digest(gf)})
        out[f"K4_bwd_feat_f32_{geo}"] = row
        del mw, x, fpw, mk, live, x01, dirs, feat, g_sigma, g_rgb, gf


def k10(out, dev, cs):
    """K10 on an eager CopyRNeRF step's own samples (a random full-width
    backbone, the README recipe with --copyrnerf, 2 steps first): its row
    (cold device ms), its device ms inside one more eager step, the hash of
    its output, into ``out``."""
    from nerf_signature_tpu_torch.ops import copyrnerf as t_k10

    with tempfile.TemporaryDirectory() as workdir:
        w = cs.wm_train(dev, cs.make_model(dev), workdir, iters=2, extra=["--copyrnerf"],
                        tag="k10 ab", required=("K10_copyrnerf_input",),
                        k4_names=("K4_field_raw",))
        tr, loader = w["trainer"], w["loader"]
        rec = cs.record_field_inputs(tr, next(iter(loader)))
        row = cs.k10_row(rec["k10"])
        row["in_step"] = cs.k10_in_step(tr, next(iter(loader)))
        row["sha"] = {"out": digest(t_k10.copyrnerf_input(*rec["k10"]))}
        out["K10"] = row
        del w, tr, loader, rec
    g = torch.Generator(device=dev).manual_seed(3)
    sweep = {}
    for M in K10_SAMPLES:
        x = torch.rand((M, 3), generator=g, device=dev) * 2 - 1
        d = torch.nn.functional.normalize(torch.randn((M, 3), generator=g, device=dev), dim=-1)
        rgb = torch.rand((M, 3), generator=g, device=dev)
        raw = torch.randn((M,), generator=g, device=dev)
        msg = torch.randint(0, 2, (32,), generator=g, device=dev, dtype=torch.int32)
        run = lambda: t_k10.copyrnerf_input(x, d, rgb, raw, msg, 1.0)
        buf = torch.empty((M, 88 + 32), device=dev)
        sweep[M] = {"cold_ms": cs.device_ms(run, 10, cold=True), "warm_ms": cs.device_ms(run, 10),
                    "events_ms": cs.events_ms(run, 10),
                    "fill_cold_ms": cs.device_ms(lambda: buf.fill_(1.0), 10, cold=True),
                    "bound_ms": cs.bound_of(M * 520 + 128, M * 180, cs.PEAK_FP32)[0]}
        print(f"[K10 sweep] {M} samples: {sweep[M]}", flush=True)
        del x, d, rgb, raw, msg, buf
    out["K10"]["by_samples"] = sweep


def bg(out, dev, cs):
    """The background colour's rows (forward at the train and serving
    shapes, forward + backward at the train shape, bf16 and fp32), the bg
    loop and a served bg view, into ``out``."""
    import time

    from nerf_signature_tpu_torch.models import ngp as t_ngp

    ro_t, rd_t = cs.train_rays(dev)
    ro_s, rd_s, _ = cs.serve_chunk(dev)
    for dname, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg = t_ngp.NGPConfig(bg_radius=cs.BG_RADIUS, compute_dtype=dtype)
        params = t_ngp.init_ngp_params(torch.Generator().manual_seed(0), cfg, dev)
        params["bg_table"].mul_(1e4)  # U(+-1): features that move the colour
        leaves = [params["bg_table"]] + list(params["bg_net"])
        for p in leaves:
            p.requires_grad_(True)
        bp = t_ngp.bg_params(params, cfg)
        for shape, (ro, rd) in (("train", (ro_t, rd_t)), ("serve", (ro_s, rd_s))):
            def fwd():
                with torch.no_grad():
                    return t_ngp.ngp_background(bp, cfg, ro, rd)

            row = {"ms": cs.median_ms(fwd, 30), "device_ms": cs.device_ms(fwd, 30),
                   "launched": cs.device_work(fwd), "sha": {"rgb": digest(fwd())}}
            out[f"bg_fwd_{shape}_{dname}"] = row
            print(f"[bg ab] fwd {shape} {dname}: {row}", flush=True)
        g = torch.rand((ro_t.shape[0], 3), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev)

        def fwd_bwd():
            return torch.autograd.grad(t_ngp.ngp_background(bp, cfg, ro_t, rd_t), leaves, g)

        grads = fwd_bwd()
        by_name, _ = cs.traced(lambda: [fwd_bwd() for _ in range(10)], "bg by kernel")
        row = {"ms": cs.median_ms(fwd_bwd, 30), "device_ms": cs.device_ms(fwd_bwd, 30),
               "launched": cs.device_work(fwd_bwd),
               "device_ms_by_kernel": None if by_name is None else {
                   name: us / 10 / 1e3 for name, us in by_name.items()},
               "sha": {f"g{i}": digest(t) for i, t in enumerate(grads)}}
        out[f"bg_fwd_bwd_train_{dname}"] = row
        print(f"[bg ab] fwd+bwd train {dname}: {row}", flush=True)
        del params, leaves, bp, grads
    r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS, steps_per_dispatch=cs.DL_K,
                      bg_radius=cs.BG_RADIUS, views=cs.SkyBallViews)
    tr, m = r["trainer"], r["trainer"].model
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, cs.RES,
                        cs.RES, dev)
    out["bg_loop"] = dict(
        cs.profile_dispatch(lambda: t_dl.device_train_loop(tr, data, cs.DL_K), cs.DL_K,
                            "bg loop profile", m.rc.compact_frac > 0),
        steps=tr.global_step, seconds=r["seconds"], psnr1=r["psnr1"],
        rays_per_s=tr.global_step * cs.TRAIN_RAYS / r["seconds"])
    del data
    held = r["held"]

    def render():
        return m.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"]

    render()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = cs.view_profile(render)
    out["bg_view"] = {"wall_ms": sorted(walls)[1], "walls_ms": walls,
                      "busy_ms": None if prof is None else prof["device_ms"],
                      "profiled_wall_ms": None if prof is None else prof["wall_ms"]}
    print(f"[bg ab] loop {out['bg_loop']}; served view {out['bg_view']}", flush=True)


# the table geometries of the k7k5 section's K7 rows: (levels, features)
K7K5_GEOMETRIES = {"16x2": (16, 2), "16x4": (16, 4)}
# calls a row of host-only timings averages over
HOST_CALLS = 5000


def host_us(fn, n=HOST_CALLS):
    """The host's µs a call of ``fn`` (a perf_counter over ``n`` calls, the
    device's queue drained before and after)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def loop_ms(fn, n=200):
    """ms a call in a stream of ``n`` back-to-back calls (CUDA events around
    them all): the larger of the host's time a call and the device's, with
    none of the wake-up after a synchronize that a lone call's events see."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def entry_us(t_hash, _cuda, res, log2, F, pitch):
    """K7's one-corner forward's C entry alone at M = 0 (it returns before
    any launch), called with the tree's own argument form: the 13 scalars
    and level arrays (their pointers made once, outside the timing) or the
    prepared level block.  µs a call: ctypes' conversion and the entry's
    checks."""
    fn = getattr(_cuda.library(), "ngp_hash_encode_1c")
    stream = _cuda.current_stream_handle()
    if hasattr(t_hash, "level_args"):
        block = t_hash.level_args(res, log2)
        return len(_cuda._SIGNATURES["ngp_hash_encode_1c"]), host_us(
            lambda: fn(0, 0, 1, F, 0, pitch, 0, block.ptr, stream))
    a = t_hash._level_args(len(res), res, log2, False, None)
    ptrs = (a[0].ctypes.data_as(_cuda._FP), a[1].ctypes.data_as(_cuda._UP),
            a[2].ctypes.data_as(_cuda._UP))
    return len(_cuda._SIGNATURES["ngp_hash_encode_1c"]), host_us(
        lambda: fn(0, 0, 1, F, 0, pitch, 0, len(res), *ptrs, log2, stream))


def k7k5(out, dev, cs):
    """K7's one-corner forward at the train step's samples and geometries
    K7K5_GEOMETRIES, K1's forward and backward and K7's backward there too
    (controls: the same level arguments, their kernels unchanged), the host
    path alone (the wrapper and the C entry at M = 0), and K5 at the clean
    and watermark steps' shapes (its pack and unpack backward: controls),
    into ``out``."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import compact as t_compact
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    def split(fn, reps=30):
        t = cs.call_split(fn, reps)
        return dict(t, device_ms=t["device_ms_cold"], loop_ms=loop_ms(fn))

    for geo, (L, F) in K7K5_GEOMETRIES.items():
        m = cs.make_model(dev, levels=L, features=F)
        cfg = m.cfg
        fp = t_ngp.field_params(m.params, cfg)
        pitch = t_ngp.feature_pitch(cfg)
        ro_t, rd_t = cs.train_rays(dev)
        noise = torch.rand((cs.TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(7),
                           device=dev)
        grid = m.occ.occupancy
        plan = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                                  budget=cs.TRAIN_BUDGET)
        mk = t_march.march_rays_aabb(ro_t, rd_t, default_aabb(m.rc), grid,
                                     coarse=t_march.coarse_grid(grid, plan),
                                     **dict(cs.march_kwargs(m, None), budget=cs.TRAIN_BUDGET,
                                            noise=noise))
        live = mk["mask"].reshape(-1).float()
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        M = x01.shape[0]
        table, tg = fp["hash_table"].detach(), fp["hash_table_g"]
        res, log2, n_rows = cfg.resolutions, cfg.log2_hashmap_size, table.shape[0]
        chosen, _ = t_hash.stochastic_choice(x01, res, log2)
        flat = chosen.reshape(-1)
        fwd = lambda: t_hash._hash_encode_1c_kernel(x01, tg, n_rows, res, log2, False, None,
                                                    pitch)
        gather = split(lambda: tg.index_select(0, flat))
        bms, bby = cs.bound_of(M * 12 + M * L * F * 4 + int(torch.unique(flat).numel()) * F * 2,
                               0, cs.PEAK_FP32)
        x0 = torch.zeros((0, 3), device=dev)
        n_args, c_us = entry_us(t_hash, _cuda, res, log2, F, pitch)
        out[f"K7_fwd_1c_{geo}"] = dict(
            split(fwd), samples=M, live_samples=int(live.sum()), pitch=pitch, bound_ms=bms,
            bound_by=bby, library_what="the gather alone (choice excluded)",
            library_ms=gather["ms"], library_device_ms=gather["device_ms"],
            library_device_ms_warm=gather["device_ms_warm"], library_host_us=gather["host_us"],
            library_loop_ms=gather["loop_ms"],
            wrapper_m0_us=host_us(lambda: t_hash._hash_encode_1c_kernel(
                x0, tg, n_rows, res, log2, False, None, pitch)),
            c_entry_m0_us=c_us, c_entry_args=n_args, sha={"out": digest(fwd())})
        k1 = lambda: t_hash._hash_encode_kernel(x01, tg, n_rows, res, log2, False, None, pitch)
        out[f"K1_fwd_{geo}"] = dict(split(k1), sha={"out": digest(k1())})
        g_feat = torch.zeros((M, pitch), device=dev)
        g_feat[:, :L * F] = torch.randn((M, L * F), generator=torch.Generator(
            device=dev).manual_seed(13), device=dev) * 1e-4 * live[:, None]
        # the backwards add by atomics: timed, not hashed
        out[f"K1_bwd_{geo}"] = split(lambda: t_hash._hash_encode_bwd_kernel(
            x01, g_feat, n_rows, res, log2, torch.bfloat16, False, None, F), 20)
        names = [f"K7_fwd_1c_{geo}", f"K1_fwd_{geo}", f"K1_bwd_{geo}"]
        for stride in (1, 2):
            names.append(f"K7_bwd_{geo}" + ("" if stride == 1 else f"_s{stride}"))
            out[names[-1]] = k7_bwd(cs, x01, g_feat, n_rows, res, log2, F, stride,
                                    f"k7k5 {geo}")
        for name in names:
            print(f"[k7k5] {name}: {out[name]}", flush=True)
        del m, fp, mk, live, x01, table, tg, chosen, flat, g_feat
    k7_trained(out, dev, cs)
    m = cs.make_model(dev)
    for tag, n_rays, budget in (("clean", cs.TRAIN_RAYS, cs.TRAIN_BUDGET),
                                ("wm", cs.WM_STEP_RAYS, 256)):
        mask, xyzs, rd, n_occ = cs.k5_march(m, n_rays, budget, seed=41)
        M = mask.numel()
        Mc, frac = cs.auto_mc(n_occ, n_rays, budget)
        rows = cs.k5_case(dev, mask, xyzs, rd, Mc, f"{n_rays} x {budget}", digest=digest)
        comp = t_compact.compact(mask, xyzs, rd, Mc)
        g = torch.Generator(device=dev).manual_seed(1)
        sig_c = torch.randn((Mc,), generator=g, device=dev)
        rgb_c = torch.rand((Mc, 3), generator=g, device=dev)
        g_sig, g_rgb = torch.randn((M,), device=dev), torch.randn((M, 3), device=dev)
        src = torch.clamp(torch.cumsum(mask.reshape(-1).to(torch.int64), 0) - 1, 0, Mc - 1)
        for name, fn, lib in (
                ("K5_compact_pack", lambda: t_compact.compact(mask, xyzs, rd, Mc), None),
                ("K5_compact_unpack", lambda: t_compact._unpack_kernel(sig_c, rgb_c, comp.slot_of),
                 lambda: (sig_c[src], rgb_c[src])),
                ("K5_compact_unpack_bwd",
                 lambda: t_compact.unpack_bwd(g_sig, g_rgb, comp.sample_of), None)):
            rows[name]["loop_ms"] = loop_ms(fn)
            if lib is not None:
                rows[name]["library_loop_ms"] = loop_ms(lib)
            out[f"{name}_{tag}"] = dict(rows[name], compact_frac=frac)
            print(f"[k7k5] {name}_{tag}: {out[f'{name}_{tag}']}", flush=True)
        del mask, xyzs, rd, comp, sig_c, rgb_c, g_sig, g_rgb, src


def k7_bwd(cs, x01, g_feat, n_rows, res, log2, F, stride, tag):
    """K7's backward at one input and stride: ``chip_smoke.py``'s
    ``k7_bwd_row`` (checked against its plain version; device ms warm and
    cold, each split into the kernel and the zeroing of the table's
    gradient; the bounds) and ms a call in a stream of calls."""
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    row = cs.k7_bwd_row(x01, g_feat, n_rows, res, log2, F, stride, tag)
    row["loop_ms"] = loop_ms(lambda: t_hash._hash_encode_stoch_bwd_kernel(
        x01, g_feat, n_rows, res, log2, False, None, F, stride))
    return row


def k7_trained(out, dev, cs):
    """The K7 loop (Trainer.train_device, 512 steps at K = 64 with
    --stochastic_hash_grad, as ``chip_smoke.py``'s phase 11 trains it), one
    more dispatch profiled (busy ms a step, K7's backward kernel's ms a
    step); K7's backward at strides 1 and 2 on that model at the clean
    step's shape (``k7_clean_inputs``) and on the inputs the loop hands it
    (``k7_loop_inputs``: K5's compacted slots, K4's cotangent); then K5 at
    the clean and watermark steps' shapes on its trained grid (the unpack
    backward; the pack and the unpack as controls), into ``out``.  The
    trained model differs from run to run (atomics): each row lists its
    shape, and no digest is kept."""
    from nerf_signature_tpu_torch.ops import compact as t_compact
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    K = cs.DL_K
    r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS, steps_per_dispatch=K, stochastic=True)
    tr = r["trainer"]
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, cs.RES,
                        cs.RES, dev)
    prof = cs.profile_dispatch(lambda: t_dl.device_train_loop(tr, data, K), K,
                               "k7 loop profile", tr.model.rc.compact_frac > 0,
                               match=(cs.K7_BWD_TRACE,))
    out["k7_loop"] = dict(prof, steps=tr.global_step, seconds=r["seconds"], psnr1=r["psnr1"],
                          rays_per_s=tr.global_step * cs.TRAIN_RAYS / r["seconds"],
                          k7_launches={k: v for k, v in r["launches"].items()
                                       if k.startswith("K7")})
    print(f"[k7k5] k7_loop: {out['k7_loop']}", flush=True)
    cfg = tr.model.cfg
    res, log2, F = cfg.resolutions, cfg.log2_hashmap_size, cfg.n_features
    n_rows = tr.model.params["hash_table"].shape[0]
    x01, _, g_feat = cs.k7_clean_inputs(dev, tr.model)
    xl, gl, _ = cs.k7_loop_inputs(tr, data)
    for stride in (1, 2):
        for shape, (xs, gs) in (("trained", (x01, g_feat)), ("loop", (xl, gl))):
            name = f"K7_bwd_{shape}_s{stride}"
            out[name] = k7_bwd(cs, xs, gs, n_rows, res, log2, F, stride, f"k7k5 {shape}")
            print(f"[k7k5] {name}: {out[name]}", flush=True)
    del x01, g_feat, xl, gl, data
    for tag, n_rays, budget in (("clean", cs.TRAIN_RAYS, cs.TRAIN_BUDGET),
                                ("wm", cs.WM_STEP_RAYS, 256)):
        mask, xyzs, rd, n_occ = cs.k5_march(tr.model, n_rays, budget, seed=41)
        M = mask.numel()
        Mc, frac = cs.auto_mc(n_occ, n_rays, budget)
        rows = cs.k5_case(dev, mask, xyzs, rd, Mc, f"trained {n_rays} x {budget}")
        comp = t_compact.compact(mask, xyzs, rd, Mc)
        g_sig, g_rgb = torch.randn((M,), device=dev), torch.randn((M, 3), device=dev)
        rows["K5_compact_unpack_bwd"]["loop_ms"] = loop_ms(
            lambda: t_compact.unpack_bwd(g_sig, g_rgb, comp.sample_of))
        for name, row in rows.items():
            out[f"{name}_trained_{tag}"] = dict(row, compact_frac=frac)
            print(f"[k7k5] {name}_trained_{tag}: {out[f'{name}_trained_{tag}']}", flush=True)
        del mask, xyzs, rd, comp, g_sig, g_rgb
    del r, tr


def k5_host(out, dev, cs, reps=5):
    """K5 unpack's host path at the clean and watermark steps' shapes (the
    procedural ball of ``k7k5``), into ``out``: the wrapper on an empty slot
    map (checks, allocation and the C entry, which launches nothing) and its
    two ways to allocate the outputs (two tensors; one buffer and two views
    of it), each ``host_us``; the unpack and, unchanged, its backward in
    streams of back-to-back calls (``loop_ms``); each the median of
    ``reps`` readings, all listed."""
    import statistics

    from nerf_signature_tpu_torch.ops import compact as t_compact

    m = cs.make_model(dev)
    for tag, n_rays, budget in (("clean", cs.TRAIN_RAYS, cs.TRAIN_BUDGET),
                                ("wm", cs.WM_STEP_RAYS, 256)):
        mask, xyzs, rd, n_occ = cs.k5_march(m, n_rays, budget, seed=41)
        M = mask.numel()
        Mc, _ = cs.auto_mc(n_occ, n_rays, budget)
        comp = t_compact.compact(mask, xyzs, rd, Mc)
        sig_c, rgb_c = torch.rand((Mc,), device=dev), torch.rand((Mc, 3), device=dev)
        g_sig, g_rgb = torch.rand((M,), device=dev), torch.rand((M, 3), device=dev)
        empty_map = comp.slot_of[:0]

        def views(n=M):
            buf = sig_c.new_empty((4 * n,))
            return buf.as_strided((n,), (1,)), buf.as_strided((n, 3), (3, 1), n)

        runs = {"wrapper_m0_us": (host_us, lambda: t_compact._unpack_kernel(sig_c, rgb_c,
                                                                             empty_map)),
                "two_allocations_us": (host_us, lambda: (sig_c.new_empty((M,)),
                                                         sig_c.new_empty((M, 3)))),
                "one_allocation_two_views_us": (host_us, views),
                "unpack_loop_ms": (loop_ms, lambda: t_compact._unpack_kernel(sig_c, rgb_c,
                                                                              comp.slot_of)),
                "unpack_bwd_loop_ms": (loop_ms, lambda: t_compact.unpack_bwd(g_sig, g_rgb,
                                                                             comp.sample_of))}
        row = {}
        for name, (timer, fn) in runs.items():
            got = [timer(fn) for _ in range(reps)]
            row[name], row[name + "_all"] = statistics.median(got), got
        out[f"K5_unpack_host_{tag}"] = row
        print(f"[k5 host] {tag}: {row}", flush=True)
        del mask, xyzs, rd, comp, sig_c, rgb_c, g_sig, g_rgb, empty_map


def k6(out, dev, cs):
    """The clean loop's profiled dispatch and K6's full and partial updates
    on that loop's trained grid, into ``out``."""
    from nerf_signature_tpu_torch.ops import grid as t_grid
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    K = cs.DL_K
    r = cs.train_case(dev, cs.TRAIN_BALL, cs.TRAIN_ITERS, steps_per_dispatch=K)
    tr, m = r["trainer"], r["trainer"].model
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, cs.RES,
                        cs.RES, dev)
    out["clean_loop"] = dict(
        cs.profile_dispatch(lambda: t_dl.device_train_loop(tr, data, K), K, "device loop profile",
                            m.rc.compact_frac > 0, match=("k6_",)),
        steps=tr.global_step, seconds=r["seconds"], psnr1=r["psnr1"],
        rays_per_s=tr.global_step * cs.TRAIN_RAYS / r["seconds"],
        k6_launches={k: v for k, v in r["launches"].items() if k.startswith("K6")})
    del data
    saved = [t.clone() for t in m.occ]

    def restore():
        for a, b in zip(m.occ, saved):
            a.copy_(b)

    C, H = m.occ.density.shape[0], m.rc.grid_size
    for kind, full in (("full", True), ("partial", False)):
        draws = t_grid.draw_grid_randomness(torch.Generator(device=dev).manual_seed(21), C, H,
                                            full, dev)
        run = lambda: m.update_extra_state(full=full, draws=draws)  # noqa: E731
        restore()
        run()
        row = {"sha": {name: digest(t) for name, t in zip(m.occ._fields, m.occ)},
               "occupied": float(m.occ.occupancy.float().mean())}
        restore()
        row.update(ms=cs.median_ms(run, 10), device_ms=cs.device_ms(run, 5),
                   device_ms_cold=cs.device_ms(run, 5, cold=True),
                   split=cs.k6_split(m, full, draws),
                   **dict(zip(("bound_ms", "bound_by"),
                              cs.bound_of(cs.k6_own_bytes(m, draws), 0, cs.PEAK_FP32))),
                   bound_whole_ms=cs.bound_of(cs.k6_bytes(m, full), 0, cs.PEAK_FP32)[0])
        restore()
        out[f"K6_{kind}"] = row
        print(f"[k6 ab] {kind}: {row}", flush=True)
    # the same on a grid every tree makes bit for bit (the loop's training is
    # not: K1's backward adds by atomics): chip_smoke.py's seeded procedural
    # model, its grid from two full updates on seeded draws
    mb = cs.make_model(dev)
    for seed in (31, 32):
        mb.update_extra_state(full=True, draws=t_grid.draw_grid_randomness(
            torch.Generator(device=dev).manual_seed(seed), C, H, True, dev))
    start = [t.clone() for t in mb.occ]
    for kind, full in (("full", True), ("partial", False)):
        draws = t_grid.draw_grid_randomness(torch.Generator(device=dev).manual_seed(33), C, H,
                                            full, dev)
        run = lambda: mb.update_extra_state(full=full, draws=draws)  # noqa: E731
        for a, b in zip(mb.occ, start):
            a.copy_(b)
        run()
        row = {"sha": {name: digest(t) for name, t in zip(mb.occ._fields, mb.occ)},
               "occupied": float(mb.occ.occupancy.float().mean()),
               "ms": cs.median_ms(run, 10), "device_ms": cs.device_ms(run, 5)}
        out[f"K6_{kind}_seeded"] = row
        print(f"[k6 ab] {kind} on the seeded grid: {row}", flush=True)


# K10's synthetic sample counts: a third, two thirds and all of the recipe's
# CopyRNeRF step (1,511,424 samples, chip_smoke.py's phase 12)
K10_SAMPLES = (503_808, 1_007_616, 1_511_424)


def compare(paths):
    """Each kernel row of the k4 section in every file: device ms, and
    whether the files' outputs are bit-equal."""
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.loads(f.read().strip().splitlines()[-1]))
    rows = {}
    for name, row in runs[0].items():
        if not (isinstance(row, dict) and ("sha" in row or "host_us" in row
                                           or "kernel_ms" in row)):
            continue
        rows[name] = {"device_ms": [r[name]["device_ms"] for r in runs],
                      "ms": [r[name]["ms"] for r in runs],
                      **{k: [r[name].get(k) for r in runs]
                         for k in ("device_ms_cold", "kernel_ms", "kernel_ms_cold",
                                   "zeroing_ms", "zeroing_ms_cold") if k in row},
                      "host_us": [r[name].get("host_us") for r in runs],
                      "loop_ms": [r[name].get("loop_ms") for r in runs],
                      "library_loop_ms": [r[name].get("library_loop_ms") for r in runs],
                      "library_device_ms": [r[name].get("library_device_ms") for r in runs],
                      "in_step_device_ms": [r[name].get("in_step", {}).get("device_ms")
                                            for r in runs],
                      "bound_ms": row.get("bound_ms"),
                      **{k: row[k] for k in ("kernel_bound_ms", "kernel_live_bound_ms",
                                             "zeroing_bound_ms") if k in row}}
        if "sha" in row:
            sha = row["sha"]
            keys = sha.keys() if isinstance(sha, dict) else range(len(sha))
            rows[name].update(bit_equal=all(r[name]["sha"] == sha for r in runs),
                              bit_equal_by_output={k: all(r[name]["sha"][k] == sha[k]
                                                          for r in runs) for k in keys})
    gws = [torch.load(p + ".gw.pt") for p in paths if os.path.exists(p + ".gw.pt")]
    if len(gws) > 1:
        for geo, ref in gws[0].items():
            rows[f"K4_bwd_f32_{geo}"]["g_weights_rel_l2_vs_first"] = max(
                float((g[geo] - ref).norm() / ref.norm()) for g in gws[1:])
    return {"files": paths, "gpu": [r.get("gpu") for r in runs], "rows": rows}


def main():
    if sys.argv[1:2] == ["--compare"]:
        print(json.dumps(compare(sys.argv[2:])))
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--out")
    ap.add_argument("--sections", default="kernels,steps,loops")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
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

    if "kernels" in sections:
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
    if "steps" in sections:
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
        del r, w, tr
    if "loops" in sections:
        loops(out, dev, cs)
    if "k4" in sections:
        gws = {}
        k4_simt(out, dev, cs, gws)
        if args.out:
            torch.save(gws, args.out + ".gw.pt")
    if "k10" in sections:
        k10(out, dev, cs)
    if "bg" in sections:
        bg(out, dev, cs)
    if "k7k5" in sections:
        k7k5(out, dev, cs)
    if "k7k5" in sections or "k5host" in sections:
        k5_host(out, dev, cs)
    if "k6" in sections:
        k6(out, dev, cs)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
