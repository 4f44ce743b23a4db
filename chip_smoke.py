#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc).  Phases, each failing loudly:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the four kernels (csrc/*.cu, sm_90a);
  3. kernels — K1-K4 at the serving path's shapes: each kernel against its
               plain version on the same inputs (stated limits), median
               times over several launches (CUDA events), the plain
               version's time, the least time the card could take (bound),
               and for K4 a bf16 torch.matmul chain as a yardstick;
  4. serve   — a full-width model (README Blender recipe: -O --bound 1.0
               --scale 0.8 --dt_gamma 0, NGPConfig defaults, grid 128^3,
               max_steps 1024, budget 256) with random weights from a seed
               and a procedural ball grid, written as a checkpoint in the
               JAX format, loaded by the serving Trainer, which renders 4
               views at 800x800 (157 chunks of 4096 rays each); launch
               counts; view 0 again through the plain versions; the
               occupancy rebuild of a grid-less checkpoint through K1 + K4.

The last lines are one JSON object with every kernel's numbers, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX: the port is ``nerf_signature_tpu_torch``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM bytes/s and bf16 / fp32 flop/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12

# Blender synthetic intrinsics and the README recipe's scale
BLENDER_ANGLE_X = 0.6911112070083618
RES = 800
ORBIT_RADIUS = 4.0 * 0.8
N_VIEWS = 4
CHUNK = 4096


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps, warmup=2):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_of(n_bytes, n_ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and ops / peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def orbit_poses(n, radius, seed=0):
    from nerf_signature_tpu_torch.data.rays import rand_poses

    return rand_poses(np.random.default_rng(seed), n, radius=radius)


def view_rays(poses):
    from nerf_signature_tpu_torch.data.rays import get_rays

    fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    return get_rays(poses, (fl, fl, RES / 2, RES / 2), RES, RES, -1)


def ball_grid(C, H, radius=0.4, bound=1.0):
    """Procedural occupancy: cells whose centre lies within ``radius`` of the
    origin, per cascade (a converged-scene-like march population)."""
    occ = torch.zeros((C, H, H, H), dtype=torch.bool)
    c = (torch.arange(H, dtype=torch.float64) + 0.5) / H * 2 - 1
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    for cas in range(C):
        s = min(2**cas, bound)
        occ[cas] = (x**2 + y**2 + z**2) * s * s < radius**2
    return occ


def ball_rgba(rays_o, rays_d, radius=0.4):
    """The repo's analytic textured ball (RGBA)."""
    b = np.sum(rays_o * rays_d, -1)
    c = np.sum(rays_o * rays_o, -1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    p = rays_o + t[..., None] * rays_d
    rgba = np.zeros((*rays_o.shape[:-1], 4), np.float32)
    rgba[..., 0] = np.where(hit, 0.6 + 0.4 * np.sin(8 * p[..., 0]), 0)
    rgba[..., 1] = np.where(hit, 0.5 + 0.5 * np.cos(7 * p[..., 1]), 0)
    rgba[..., 2] = np.where(hit, 0.3, 0)
    rgba[..., 3] = hit.astype(np.float32)
    return np.clip(rgba, 0, 1)


def psnr(a, b):
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return -10 * math.log10(max(mse, 1e-20))


# ---------------------------------------------------------------- phase 1
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gpu_line = smi.splitlines()[0].strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvidia-smi: {gpu_line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return gpu_line


# ---------------------------------------------------------------- phase 2
def phase_build():
    from nerf_signature_tpu_torch.ops import _cuda

    t0 = time.time()
    _cuda.library()
    info = _cuda.build_info
    log(f"[build] {info['path']} in {time.time() - t0:.1f} s "
        f"(nvcc {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log("[build]   " + line.strip())


# ---------------------------------------------------------------- phase 3
def make_model(dev, *, bound=1.0, dense=False, seed=0):
    """The full-width model of the README recipe, random weights from a seed;
    the hash table is drawn at U(+-1) instead of U(+-1e-4) so the field
    varies in space (densities from ~0 to opaque)."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig

    cfg = NGPConfig(bound=bound, compute_dtype=torch.bfloat16, dense_coarse=dense)
    m = NGPModel(cfg, min_near=0.2, density_thresh=10.0, dt_gamma=0.0,
                 max_steps=1024, grid_size=128, seed=seed, infer_budget=256,
                 device=dev)
    m.params["hash_table"].mul_(1e4)
    m.occ = m.occ._replace(occupancy=ball_grid(m.cascade, 128, bound=bound).to(dev))
    return m


def march_kwargs(m, prefilter):
    rc = m.rc
    return dict(min_near=rc.min_near, bound=rc.bound, dt_gamma=rc.dt_gamma,
                max_steps=rc.max_steps, budget=m.infer_budget, prefilter=prefilter)


def phase_kernels(dev):
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import composite as t_comp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    results = {}
    m = make_model(dev)
    cfg = m.cfg
    poses = orbit_poses(N_VIEWS, ORBIT_RADIUS)
    rays = view_rays(poses[:1])
    # the chunk of view 0 with the most occupied samples (the ball's centre)
    mid = (RES // 2) * RES
    lo = (mid // CHUNK) * CHUNK
    ro = torch.from_numpy(rays["rays_o"][0, lo:lo + CHUNK]).to(dev).contiguous()
    rd = torch.from_numpy(rays["rays_d"][0, lo:lo + CHUNK]).to(dev).contiguous()

    # ---- K2 marcher: C = 1 (this recipe) and C = 2, prefilter on and off
    k2 = None
    for bound, gamma in ((1.0, 0.0), (2.0, 1 / 128)):
        mb = m if bound == 1.0 else make_model(dev, bound=2.0)
        if bound == 1.0:
            ro_b, rd_b = ro, rd
        else:
            rb = view_rays(orbit_poses(1, 4.5, seed=1))
            ro_b = torch.from_numpy(rb["rays_o"][0, lo:lo + CHUNK]).to(dev).contiguous()
            rd_b = torch.from_numpy(rb["rays_d"][0, lo:lo + CHUNK]).to(dev).contiguous()
        grid = mb.occ.occupancy
        for pf in (True, False):
            kw = march_kwargs(mb, pf)
            kw["dt_gamma"] = gamma
            plan = t_march.march_plan(grid.shape[0], 128, bound=bound, dt_gamma=gamma,
                                      max_steps=1024, budget=256, prefilter=pf)
            coarse = t_march.coarse_grid(grid, plan)
            aabb = default_aabb(mb.rc)
            k = t_march.march_rays_aabb(ro_b, rd_b, aabb, grid, coarse=coarse, **kw)
            p = t_march.march_rays_aabb(ro_b, rd_b, aabb, grid, coarse=coarse,
                                        plain=True, **kw)
            torch.cuda.synchronize()
            if not torch.equal(k["mask"], p["mask"]):
                raise AssertionError(f"K2 mask differs (C={grid.shape[0]}, prefilter={pf})")
            err = max(float((k[n].float() - p[n].float()).abs().max())
                      for n in ("xyzs", "ts", "deltas", "nears", "fars", "n_occupied",
                                "n_occupied_raw", "n_groups_occ"))
            if err != 0.0:
                raise AssertionError(f"K2 outputs differ by {err} (C={grid.shape[0]}, "
                                     f"prefilter={pf}); limit 0 (same roundings)")
            n_samp = int(k["mask"].sum())
            log(f"[K2] C={grid.shape[0]} prefilter={pf} dt_gamma={gamma:g}: mask equal, "
                f"max abs err {err} (limit 0), {n_samp} samples "
                f"({n_samp / CHUNK:.1f}/ray), groups/ray "
                f"{float(k['n_groups_occ'].float().mean()):.1f}")
            if bound == 1.0 and pf == plan.prefilter and pf:
                ms = median_ms(lambda: t_march.march_rays_aabb(
                    ro_b, rd_b, aabb, grid, coarse=coarse, **kw), 30)
                pms = median_ms(lambda: t_march.march_rays_aabb(
                    ro_b, rd_b, aabb, grid, coarse=coarse, plain=True, **kw), 5, 1)
                N, S = k["mask"].shape
                n_bytes = (N * 24 + N * S * (12 + 4 + 4 + 1) + N * 20
                           + grid.numel() + coarse.numel())
                bms, bby = bound_of(n_bytes, 0, PEAK_FP32)
                k2 = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                          bound_by=bby, library_ms=None, march=k)
    results["K2_march"] = k2

    # ---- K1 hash encoder on the march's samples of that chunk
    fp = t_ngp.field_params(m.params, cfg)
    xyzs = k2["march"]["xyzs"].reshape(-1, 3)
    dirs = k2["march"]["dirs"].reshape(-1, 3)
    x01 = (xyzs + 1.0) / 2.0
    M = x01.shape[0]
    res = cfg.resolutions
    S_log2 = cfg.log2_hashmap_size
    feat = t_hash.hash_encode(x01, fp["hash_table"], res, S_log2, table_g=fp["hash_table_g"])
    feat_p = t_hash.hash_encode_plain(x01, fp["hash_table"], res, S_log2,
                                      table_g=fp["hash_table_g"])
    err1 = float((feat - feat_p).abs().max())
    # dense coarse levels and the fp32 gather, same positions
    md = make_model(dev, dense=True)
    sides = md.cfg.dense_sides
    tg = md.params["hash_table"].to(torch.bfloat16)
    e_dense = float((t_hash.hash_encode(x01, md.params["hash_table"], res, S_log2,
                                        dense_sides=sides, table_g=tg)
                     - t_hash.hash_encode_plain(x01, md.params["hash_table"], res, S_log2,
                                                dense_sides=sides, table_g=tg)).abs().max())
    e_f32 = float((t_hash.hash_encode(x01, fp["hash_table"], res, S_log2)
                   - t_hash.hash_encode_plain(x01, fp["hash_table"], res, S_log2)).abs().max())
    del md, tg
    for name, e in (("hashed bf16", err1), (f"dense ({sum(1 for s in sides if s)} levels) "
                                            "bf16", e_dense), ("hashed fp32", e_f32)):
        log(f"[K1] {name}: max abs err {e:.3g} (limit 1e-6)")
        if not e <= 1e-6:
            raise AssertionError(f"K1 {name} differs from its plain version by {e}")
    ms1 = median_ms(lambda: t_hash.hash_encode(x01, fp["hash_table"], res, S_log2,
                                               table_g=fp["hash_table_g"]), 20)
    pms1 = median_ms(lambda: t_hash.hash_encode_plain(x01, fp["hash_table"], res, S_log2,
                                                      table_g=fp["hash_table_g"]), 3, 1)
    rows = touched_rows(x01, res, S_log2)
    L = len(res)
    bms1, bby1 = bound_of(M * 12 + M * L * 2 * 4 + rows * 4, M * L * 57, PEAK_FP32)
    log(f"[K1] M={M} L={L}: {rows} distinct table rows touched ({rows * 4 / 1e6:.1f} MB bf16)")
    results["K1_hash_encode"] = dict(max_abs_err=max(err1, e_dense, e_f32), ms=ms1,
                                     plain_ms=pms1, bound_ms=bms1, bound_by=bby1,
                                     library_ms=None)

    # ---- K4 field heads at bf16 on those features
    sk, _, rk = t_ngp.field_heads(fp, cfg, feat, dirs)
    sp, _, rp = t_ngp.field_heads_plain(fp, cfg, feat, dirs)
    e_rgb = float((rk - rp).abs().max())
    e_sig = float(((sk - sp).abs() / sp.abs().clamp_min(1e-6)).max())
    log(f"[K4] bf16: rgb max abs err {e_rgb:.3g} (limit 1e-2), sigma max rel err "
        f"{e_sig:.3g} (limit 2e-2); sigma range {float(sp.min()):.3g}..{float(sp.max()):.3g}")
    if not (e_rgb <= 1e-2 and e_sig <= 2e-2):
        raise AssertionError("K4 differs from its plain version beyond its limits")
    ms4 = median_ms(lambda: t_ngp.field_heads(fp, cfg, feat, dirs), 20)
    pms4 = median_ms(lambda: t_ngp.field_heads_plain(fp, cfg, feat, dirs), 5, 1)
    lib4 = library_mlp_ms(fp, cfg, feat, dirs)
    n_w = sum(w.numel() for w in fp["sigma_net"] + fp["color_net"])
    bms4, bby4 = bound_of(M * (32 * 4 + 12 + 4 + 12), M * 2 * n_w, PEAK_BF16)
    results["K4_field"] = dict(max_abs_err=e_rgb, ms=ms4, plain_ms=pms4, bound_ms=bms4,
                               bound_by=bby4, library_ms=lib4)

    # ---- K3 compositor on the field's output
    N, S = k2["march"]["mask"].shape
    mk = k2["march"]
    sig = (sp.reshape(N, S) * m.rc.density_scale).contiguous()
    rgb = rp.reshape(N, S, 3).contiguous()
    ck = t_comp.composite_rays(sig, rgb, mk["deltas"], mk["ts"], mask=mk["mask"])
    cp = t_comp.composite_rays_plain(sig, rgb, mk["deltas"], mk["ts"], mask=mk["mask"])
    e3 = max(float((ck[n] - cp[n]).abs().max()) for n in ck)
    tau = torch.where(mk["mask"], sig * mk["deltas"], 0.0)
    t_in = torch.exp(-(torch.cumsum(tau, -1) - tau))
    n_live = int((t_in >= 1e-4).sum()) + int((t_in < 1e-4).any(-1).sum())
    log(f"[K3] max abs err {e3:.3g} (limit 1e-5); {n_live} of {N * S} slots read "
        f"before T < 1e-4")
    if not e3 <= 1e-5:
        raise AssertionError(f"K3 differs from its plain version by {e3}")
    ms3 = median_ms(lambda: t_comp.composite_rays(sig, rgb, mk["deltas"], mk["ts"],
                                                  mask=mk["mask"]), 30)
    pms3 = median_ms(lambda: t_comp.composite_rays_plain(sig, rgb, mk["deltas"], mk["ts"],
                                                         mask=mk["mask"]), 10, 1)
    bms3, bby3 = bound_of(n_live * 25 + N * S * 4 + N * 20, n_live * 12, PEAK_FP32)
    results["K3_composite"] = dict(max_abs_err=e3, ms=ms3, plain_ms=pms3, bound_ms=bms3,
                                   bound_by=bby3, library_ms=None)
    del k2["march"]
    for name, r in results.items():
        log(f"[{name.split('_')[0]}] ms {r['ms']:.4f} | plain {r['plain_ms']:.4f} | "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) | library {r['library_ms']}")
    return results


def touched_rows(x01, res, log2_size):
    """Distinct table rows the 8-corner gathers of these positions read."""
    from nerf_signature_tpu_torch.ops.hashenc import _hash3

    L = len(res)
    seen = torch.zeros(L << log2_size, dtype=torch.bool, device=x01.device)
    x = x01.clamp(0, 1)
    for lv, r in enumerate(res):
        s = x * torch.tensor(r, dtype=torch.float32, device=x.device)
        cell = torch.floor(s).to(torch.int64)
        for c in range(8):
            di, dj, dk = (c >> 2) & 1, (c >> 1) & 1, c & 1
            idx = _hash3(cell[:, 0] + di, cell[:, 1] + dj, cell[:, 2] + dk, log2_size)
            seen[idx + (lv << log2_size)] = True
    return int(seen.sum())


def library_mlp_ms(fp, cfg, feat, dirs):
    """The same two MLPs as a chain of bf16 torch.matmul calls (a yardstick,
    never called by the port); inputs prepared outside the timed region."""
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    bf = torch.bfloat16
    ws = [w.to(bf) for w in fp["sigma_net"]]
    wc = [w.to(bf) for w in fp["color_net"]]
    xs = feat.to(bf)
    xc = torch.cat([sh_encode(dirs, 4), feat[:, :15]], -1).to(bf)

    def run():
        h = torch.relu(xs @ ws[0]) @ ws[1]
        c = torch.relu(torch.relu(xc @ wc[0]) @ wc[1]) @ wc[2]
        return h, c

    return median_ms(run, 20)


# ---------------------------------------------------------------- phase 4
def phase_serve(dev, workdir):
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb
    from nerf_signature_tpu_torch.train.metrics import PSNRMeter
    from nerf_signature_tpu_torch.train.trainer import Trainer

    opt = type("Opt", (), {"max_ray_batch": CHUNK})()
    ws = os.path.join(workdir, "ws")
    # the checkpoint: full-width params + the ball grid, in the JAX format
    writer = Trainer("ngp", opt, make_model(dev), workspace=ws, use_checkpoint="scratch",
                     mute=True)
    ckpt = writer.save_checkpoint(full=True)
    best = writer.save_checkpoint(best=True)
    occ_frac = float(writer.model.occ.occupancy.float().mean())
    del writer
    log(f"[serve] checkpoint {os.path.getsize(ckpt) / 1e6:.1f} MB, grid {occ_frac:.2%} occupied")

    poses = orbit_poses(N_VIEWS, ORBIT_RADIUS)
    rays = view_rays(poses)
    loader = []
    for v in range(N_VIEWS):
        gt = ball_rgba(rays["rays_o"][v], rays["rays_d"][v]).reshape(1, RES, RES, 4)
        loader.append({"H": RES, "W": RES, "rays_o": rays["rays_o"][v:v + 1],
                       "rays_d": rays["rays_d"][v:v + 1], "images": gt})

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig

    def fresh_model():
        return NGPModel(NGPConfig(bound=1.0), min_near=0.2, density_thresh=10.0,
                        dt_gamma=0.0, max_steps=1024, grid_size=128, seed=1,
                        infer_budget=256, device=dev)

    # ---- the main path: load through the serving Trainer, render 4 views
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    trainer = Trainer("ngp", opt, fresh_model(), workspace=ws, use_checkpoint="latest",
                      metrics=[PSNRMeter()], mute=True)
    trainer.evaluate_one_epoch(loader)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] evaluate_one_epoch: {N_VIEWS} views {RES}x{RES} in {seconds:.2f} s "
        f"(checkpoint load included) = {N_VIEWS * RES * RES / seconds:.0f} rays/s; "
        f"PSNR vs the analytic ball {trainer.metrics[0].measure():.2f} dB (random weights); "
        f"peak memory {peak:.2f} GiB")
    log(f"[serve] launches during the main path: {launches}")
    per_view = math.ceil(RES * RES / CHUNK)
    for name, n in launches.items():
        if n != N_VIEWS * per_view:
            raise AssertionError(f"{name}: {n} launches, expected {N_VIEWS} x {per_view}")

    # ---- view 0 through the kernels and through the plain versions
    m = trainer.model
    params_backup, m.params = m.params, trainer.eval_params()
    try:
        t0 = time.time()
        img_k = m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True)["image"]
        torch.cuda.synchronize()
        t_kernel = time.time() - t0
        t0 = time.time()
        img_p = m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True, plain=True)["image"]
        torch.cuda.synchronize()
        t_plain = time.time() - t0
        ro = torch.from_numpy(rays["rays_o"][0, :CHUNK]).to(dev)
        rd = torch.from_numpy(rays["rays_d"][0, :CHUNK]).to(dev)
        kw = march_kwargs(m, None)
        mk = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), m.occ.occupancy, **kw)
        mp = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), m.occ.occupancy,
                                     plain=True, **kw)
    finally:
        m.params = params_backup
    if not torch.equal(mk["mask"], mp["mask"]):
        raise AssertionError("first chunk: kernel and plain masks differ")
    if not (bool(torch.isfinite(img_k).all()) and img_k.shape == (RES * RES, 3)):
        raise AssertionError("kernel render is not finite or has the wrong shape")
    db = psnr(img_k, img_p)
    # bound: the kernel path and the plain path round each MLP layer to bf16
    # after fp32 sums taken in another order; a one-step bf16 flip (0.4%) in
    # a few samples moves a pixel by < 3e-3, i.e. PSNR well above 45 dB
    log(f"[serve] view 0: kernel path {t_kernel:.2f} s, plain path {t_plain:.2f} s; "
        f"first-chunk mask equal; image PSNR kernel vs plain {db:.2f} dB (limit 45)")
    if not db >= 45.0:
        raise AssertionError(f"kernel vs plain render PSNR {db:.2f} dB < 45")
    del trainer, m

    # ---- a grid-less (best) checkpoint: rebuild the grid through K1 + K4
    _cuda.reset_launch_counts()
    t0 = time.time()
    rebuilt = Trainer("ngp", opt, fresh_model(), workspace=os.path.join(workdir, "ws2"),
                      use_checkpoint=best, mute=True)
    torch.cuda.synchronize()
    frac = float(rebuilt.model.occ.occupancy.float().mean())
    n = _cuda.launch_counts()
    log(f"[serve] grid rebuild (2 full passes over 128^3 cells) {time.time() - t0:.2f} s: "
        f"{frac:.2%} occupied; launches {n}")
    if not (0.0 < frac < 1.0 and n["K1_hash_encode"] > 0 and n["K4_field"] > 0):
        raise AssertionError("grid rebuild did not run through K1 + K4")
    return launches


SOURCES = {
    "K1_hash_encode": ("nerf_signature_tpu_torch/csrc/hashenc.cu",
                       "nerf_signature_tpu/ops/hashenc.py:250"),
    "K2_march": ("nerf_signature_tpu_torch/csrc/marcher.cu",
                 "nerf_signature_tpu/ops/marching.py:310"),
    "K3_composite": ("nerf_signature_tpu_torch/csrc/composite.cu",
                     "nerf_signature_tpu/ops/composite.py:25"),
    "K4_field": ("nerf_signature_tpu_torch/csrc/field.cu",
                 "nerf_signature_tpu/models/mlp.py:30"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    import nerf_signature_tpu_torch  # noqa: F401  (fails outside the repo)

    gpu_line = phase_device()
    dev = torch.device("cuda")
    phase_build()
    kernels = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_serve(dev, workdir)
    rows = []
    for name in ("K1_hash_encode", "K2_march", "K3_composite", "K4_field"):
        r = kernels[name]
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
