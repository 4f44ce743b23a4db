#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc).  Phases, each failing loudly:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the kernels (csrc/*.cu, sm_90a), one process a
               source, all started together;
  3. kernels — K1-K4 at the serving path's shapes: each kernel against its
               plain version on the same inputs (stated limits; K2 bit for
               bit with C = 1 and 2, dt_gamma 0 and 1/128, the prefilter on,
               off and on with a group budget that truncates; K3 forward and
               backward also on edge cases: S of 1, 31, 32, 40 and 256,
               stops inside the first chunk and at slots 31 and 32, the
               mask on, absent and all off, T_thresh 0 and 1e-4, N = 0),
               median times over several launches (CUDA events; K1, K2 and
               K3 also their device time, torch.profiler), the plain
               version's time, the least time the card could take (bound),
               and for K4 a bf16 torch.matmul chain as a yardstick; P1 (the
               Pallas probe's gather) at the probe's shapes, bit-exact,
               with torch.take as its yardstick, and the device time
               (torch.profiler) of the kernel, table[idx] and torch.take;
  4. train-kernels — at the train step's shapes (4096 random rays of a
               view, budget 128, the uncompacted M = 524,288 samples): K2
               with perturbation noise bit-exact against its plain version;
               the K1, K3 and K4 backward kernels against their plain
               backwards (stated limits) with median times, plain times,
               bounds and library yardsticks (K4's full backward in bf16 on
               the tensor cores and in fp32 on the SIMT units, K3's
               backward, each with bit-equal repeats and its device time),
               K3's forward at this shape too; then one whole train step
               (loss and per-leaf gradients) through the kernels against
               one through the plain versions, in bf16 and in fp32; then at
               the watermark step's shapes (32 key blocks of 12x12 and 4096
               content rays, budget 256): K9 forward (bit-exact) and
               backward (exact), K1's backward into the message's
               effective table (one level, its bound and index_add_), the
               feature-only K4 backward in bf16 (the tensor-core kernel) and
               fp32 (the SIMT one), K3 forward and backward (as above, N =
               8,704, S = 256), and one whole
               watermark step (loss and per-leaf gradients) through the
               kernels against the plain versions, in bf16 and in fp32; each
               whole step must run K4 on its dtype's route alone;
  5. geometry — the other table geometries at 2^19 rows a level: 8 x 2
               (K4 at encoding width 16), 8 x 4 (K1 with 4 features a row),
               16 x 4 (K4 at width 64, K1 with 4 features at 16 levels), 32 x 2
               (K4 at width 64, K1 at 32 levels), 12 x 2 (width 24: K4 at 32,
               the features zero-padded by K1), 24 x 1 (K1 with 1 feature a
               row, width 24) and 8 x 8 (K1 with 8 features a row, width 64):
               K1 forward (bit-exact; the padded columns exactly 0) and
               backward (its atomics modelled), K4 forward, full and
               feature-only backward on both routes, each against its plain
               version; a whole clean and a whole watermark step through the
               kernels against the plain versions (bf16, fp32); but for
               32 x 2, Trainer.train for 128 steps on the radius-0.7 ball
               (launches; at 8 x 4, 16 x 4 and 12 x 2 the held-out PSNR must
               rise 6 dB), then 64 watermark steps on that backbone; 16 x 8
               (width 128) must be refused before a model is built;
  6. serve   — a full-width model (README Blender recipe: -O --bound 1.0
               --scale 0.8 --dt_gamma 0, NGPConfig defaults, grid 128^3,
               max_steps 1024, budget 256) with random weights from a seed
               and a procedural ball grid, written as a checkpoint in the
               JAX format, loaded by the serving Trainer, which renders 4
               views at 800x800 (157 chunks of 4096 rays each); launch
               counts; view 0 under torch.profiler (device time by
               kernel) and again through the plain versions; the
               occupancy rebuild of a grid-less checkpoint through K1 + K4;
  7. train   — a fresh full-width model (standard init) trained by the
               port's Trainer.train (the CLI's train defaults: 4096 rays,
               budget 128 auto-adapted, grid updates every 16 steps,
               auto compaction and group budget, lr 1e-2, EMA 0.95) for 512
               steps on 32 analytic views of 800x800 of a ball of radius
               0.7, made here; loss per epoch,
               train rays/s, step time, peak memory and every kernel's
               launches; it fails unless the loss falls and a held-out
               view's PSNR rises at least 6 dB over the untrained model's;
               then torch.profiler over 16 more steps (device time by
               kernel, the device's idle share); then 384 steps on the
               radius-0.4 ball, which fail unless the march budget, the
               compaction and the group budget each moved;
  8. wm      — the watermark stage at the README stage-2 recipe (-O
               --message_dim 32 --num_rows 32 --num_cols 32 --downscale 2
               --lambda_w 0.005 --lambda_i 1.0 --loss_w bce --iters 1000) on
               the backbone phase 7 trained, frozen, built by the CLI's own
               setup from a Blender-style scene file (32 orbit views, 800x800
               halved, no images) and key blocks picked on the key render:
               resolve_auto_compaction, WatermarkTrainer.train (watermark
               rays/s, step time, peak memory, launches), test_bitacc over
               200 messages with no distortion and 200 with noise (bit
               accuracy, log10 p, seconds a message), test_image on 2 views,
               a profile of 16 more steps; it fails unless lossw halves, bit
               accuracy >= 0.95 with no distortion and the test image PSNR
               >= 30 dB.

The last lines are one JSON object with every kernel's numbers, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX: the port is ``nerf_signature_tpu_torch``.
"""

import dataclasses
import gc
import json
import math
import os
import re
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
# the train step (CLI defaults): rays a step, the initial march budget, and
# the train phase's length
TRAIN_RAYS = 4096
TRAIN_BUDGET = 128
TRAIN_VIEWS = 32
TRAIN_ITERS = 512
# the train phase's ball; on the serving ball (radius 0.4) the auto group
# budget sinks to its floor of 16 groups and training stalls there (PERF.md,
# the group budget finding), so the quality check trains on a larger ball
TRAIN_BALL = 0.7
# the adaptations' case: the serving ball moves the march budget, the
# compaction and the group budget (the group budget only after the grid's
# 16th update, at step 240)
ADAPT_BALL = 0.4
ADAPT_ITERS = 384
# the table geometries (levels, features a row) the card takes besides
# 16 x 2, and the length of their Trainer.train runs
GEOMETRIES = {"8x2": (8, 2), "8x4": (8, 4), "16x4": (16, 4), "32x2": (32, 2), "12x2": (12, 2),
              "24x1": (24, 1), "8x8": (8, 8)}
# the geometries that also train and run the watermark stage (32 x 2, K4 at
# width 64 as 16 x 4 is: its kernels and whole steps only)
GEO_TRAINED = ("8x2", "8x4", "16x4", "12x2", "24x1", "8x8")
# the geometries whose held-out PSNR must rise 6 dB in GEO_ITERS steps
GEO_QUALITY = ("8x4", "16x4", "12x2")
GEO_ITERS = 128
# the watermark stage's length on each geometry's trained backbone (two
# epochs of the recipe's 32 views)
GEO_WM_ITERS = 64
# the watermark stage, README stage-2 recipe: -O --message_dim 32 --num_rows 32
# --num_cols 32 --downscale 2 --lambda_w 0.005 --lambda_i 1.0 --loss_w bce
# --iters 1000 on the backbone the train phase trained; a step renders
# 4096 content rays and 32 key blocks of 12x12 (8,704 rays) at budget 256
WM_BITS = 32
WM_RES = RES // 2
WM_BLOCK = WM_RES // 32
WM_ITERS = 1000
WM_TRIALS = 200
WM_STEP_RAYS = TRAIN_RAYS + WM_BITS * WM_BLOCK**2
WM_RECIPE = ["-O", "--wtmk_tcnn", "--message_dim", "32", "--lambda_w", "0.005",
             "--lambda_i", "1.0", "--loss_w", "bce", "--iters", str(WM_ITERS),
             "--num_rows", "32", "--num_cols", "32", "--downscale", "2",
             "--bound", "1.0", "--scale", "0.8", "--dt_gamma", "0"]


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


def device_events(prof):
    """{name: microseconds} of the device work (kernels, copies, memsets)
    in a torch.profiler trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    by_name = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    return by_name


# torch.profiler now and then returns a trace without its device events
# (once twice in a row); a traced measurement is retried this many times
TRACE_TRIES = 4
# device_ms calls that fell back to CUDA events (every try came back empty)
EVENT_FALLBACKS = []


def traced(work, what):
    """Run ``work()`` under torch.profiler and return (its device events by
    name, its result), retrying while a trace comes back without device
    events; the events are None when every try did."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = work()
            torch.cuda.synchronize()
        by_name = device_events(prof)
        if by_name:
            return by_name, out
        log(f"[trace] {what}: torch.profiler's trace holds no device events "
            f"(try {attempt} of {TRACE_TRIES})")
        time.sleep(0.5)
    return None, out


def events_ms(fn, reps):
    """Device time of one call of ``fn`` from CUDA events around ``reps``
    calls queued behind a spin kernel that outlasts their dispatch, so the
    host's launch gaps do not show (unless ``fn`` waits for the device)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 6)
    b.record()
    b.synchronize()
    cycles_per_ms = 10 ** 6 / a.elapsed_time(b)
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: the durations of the device work
    that ``reps`` calls launch, summed from a torch.profiler trace, over
    ``reps`` (the host's dispatch and the gaps between launches left out,
    which CUDA events around a call count).  Where every trace comes back
    empty, ``events_ms`` measures it instead (counted in EVENT_FALLBACKS)."""
    fn()
    by_name, _ = traced(lambda: [fn() for _ in range(reps)], "device_ms")
    if by_name:
        return sum(by_name.values()) / reps / 1e3
    ms = events_ms(fn, reps)
    EVENT_FALLBACKS.append(ms)
    log(f"[trace] device_ms from CUDA events instead: {ms:.4f} ms a call")
    return ms


# the forward kernels a served view runs, by a substring of their names
VIEW_KERNELS = {"K1": "hash_encode_fwd", "K2": "march_fwd", "K3": "composite_fwd",
                "K4": "field_mma_fwd"}


def view_profile(render):
    """One served view under torch.profiler: the device ms of K1-K4's
    forward kernels, their sum, all device work, and the render's wall clock
    (profiler on); None where every trace came back empty."""
    def work():
        t0 = time.time()
        render()
        torch.cuda.synchronize()
        return time.time() - t0

    by_name, wall = traced(work, "served view")
    if by_name is None:
        return None
    out = {k: sum(us for n, us in by_name.items() if pat in n) / 1e3
           for k, pat in VIEW_KERNELS.items()}
    out.update(kernels_ms=sum(out.values()), device_ms=sum(by_name.values()) / 1e3,
               wall_ms=wall * 1e3)
    return out


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
    # the tensor-core kernels must not spill (ptxas -v, every instantiation)
    spills = {}
    for sec in info["log"].split("== ")[1:]:
        name = sec.split()[0]
        if name in TENSOR_CORE_SOURCES:
            spills[name] = [int(n) for n in re.findall(r"(\d+) bytes spill stores", sec)]
    log(f"[build] spill stores of the tensor-core kernels (bytes, per instantiation): {spills}")
    if sorted(spills) != sorted(TENSOR_CORE_SOURCES) or not all(spills.values()) or any(
            any(v) for v in spills.values()):
        raise AssertionError(f"the tensor-core kernels spill or were not reported: {spills}")
    return info["seconds"]


# ---------------------------------------------------------------- phase 3
def make_model(dev, *, bound=1.0, dense=False, seed=0, dtype=torch.bfloat16, levels=16,
               features=2):
    """The full-width model of the README recipe (or another table geometry:
    ``levels`` x ``features``, 2^19 rows a level), random weights from a
    seed; the hash table is drawn at U(+-1) instead of U(+-1e-4) so the
    field varies in space (densities from ~0 to opaque)."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig

    cfg = NGPConfig(bound=bound, compute_dtype=dtype, dense_coarse=dense, n_levels=levels,
                    n_features=features)
    m = NGPModel(cfg, min_near=0.2, density_thresh=10.0, dt_gamma=0.0,
                 max_steps=1024, grid_size=128, seed=seed, infer_budget=256,
                 device=dev)
    m.params["hash_table"].mul_(1e4)
    m.occ = m.occ._replace(occupancy=ball_grid(m.cascade, 128, bound=bound).to(dev))
    return m


def serve_chunk(dev):
    """The serving path's chunk of view 0 with the most occupied samples
    (the ball's centre): its rays and first ray's index."""
    rays = view_rays(orbit_poses(N_VIEWS, ORBIT_RADIUS)[:1])
    lo = ((RES // 2) * RES // CHUNK) * CHUNK
    ro = torch.from_numpy(rays["rays_o"][0, lo:lo + CHUNK]).to(dev).contiguous()
    rd = torch.from_numpy(rays["rays_d"][0, lo:lo + CHUNK]).to(dev).contiguous()
    return ro, rd, lo


def march_kwargs(m, prefilter):
    rc = m.rc
    return dict(min_near=rc.min_near, bound=rc.bound, dt_gamma=rc.dt_gamma,
                max_steps=rc.max_steps, budget=m.infer_budget, prefilter=prefilter)


def phase_kernels(dev):
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    results = {}
    m = make_model(dev)
    cfg = m.cfg
    ro, rd, lo = serve_chunk(dev)

    # ---- K2 marcher: C = 1 (this recipe) and C = 2, dt_gamma 0 and 1/128,
    # prefilter on and off, and on with a group budget that truncates
    k2 = None
    rb = view_rays(orbit_poses(1, 4.5, seed=1))
    cases = {1.0: (m, ro, rd), 2.0: (
        make_model(dev, bound=2.0),
        torch.from_numpy(rb["rays_o"][0, lo:lo + CHUNK]).to(dev).contiguous(),
        torch.from_numpy(rb["rays_d"][0, lo:lo + CHUNK]).to(dev).contiguous())}
    for bound, gamma in ((1.0, 0.0), (2.0, 1 / 128), (1.0, 1 / 128), (2.0, 0.0)):
        mb, ro_b, rd_b = cases[bound]
        grid = mb.occ.occupancy
        for pf, gb in ((True, None), (False, None), (True, 16)):
            kw = march_kwargs(mb, pf)
            kw.update(dt_gamma=gamma, group_budget=gb)
            plan = t_march.march_plan(grid.shape[0], 128, bound=bound, dt_gamma=gamma,
                                      max_steps=1024, budget=256, prefilter=pf,
                                      group_budget=gb)
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
            log(f"[K2] C={grid.shape[0]} prefilter={pf} group budget {plan.group_budget} "
                f"dt_gamma={gamma:g}: mask equal, "
                f"max abs err {err} (limit 0), {n_samp} samples "
                f"({n_samp / CHUNK:.1f}/ray), groups/ray "
                f"{float(k['n_groups_occ'].float().mean()):.1f}")
            if (bound, gamma, gb) == (1.0, 0.0, None) and pf:  # the serving path's march
                run = lambda: t_march.march_rays_aabb(ro_b, rd_b, aabb, grid, coarse=coarse, **kw)
                ms, dms = median_ms(run, 30), device_ms(run, 30)
                pms = median_ms(lambda: t_march.march_rays_aabb(
                    ro_b, rd_b, aabb, grid, coarse=coarse, plain=True, **kw), 5, 1)
                N, S = k["mask"].shape
                n_bytes = (N * 24 + N * S * (12 + 4 + 4 + 1) + N * 20
                           + grid.numel() + coarse.numel())
                bms, bby = bound_of(n_bytes, 0, PEAK_FP32)
                k2 = dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                          bound_by=bby, library_ms=None, march=k)
    results["K2_march"] = k2
    del cases

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
        log(f"[K1] {name}: max abs err {e:.3g} (limit 0: the same roundings)")
        if e != 0.0:
            raise AssertionError(f"K1 {name} differs from its plain version by {e}")
    results["K1_hash_encode"] = dict(k1_timing(x01, fp, res, S_log2),
                                     max_abs_err=max(err1, e_dense, e_f32))

    # ---- K4 field heads on those features: bf16 on the tensor cores (the
    # serving path), fp32 on the SIMT units (the fp32 route)
    results["K4_field"], (sp, rp) = k4_forward(fp, cfg, feat, dirs)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    fp32 = t_ngp.field_params(m.params, cfg32)
    results["K4_field_f32"], _ = k4_forward(fp32, cfg32, feat, dirs)

    # ---- K3 compositor on the field's output, then its edge cases
    N, S = k2["march"]["mask"].shape
    mk = k2["march"]
    sig = (sp.reshape(N, S) * m.rc.density_scale).contiguous()
    rgb = rp.reshape(N, S, 3).contiguous()
    results["K3_composite"], _ = k3_rows("serve", sig, rgb, mk["deltas"], mk["ts"], mk["mask"])
    k3_edges(dev)
    del k2["march"]
    results["P1_gather"] = p1_gather(dev)
    for name, r in results.items():
        log(f"[{name.split('_')[0]}] ms {r['ms']:.4f} | plain {r['plain_ms']:.4f} | "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) | library {r['library_ms']}")
    return results


def p1_gather(dev):
    """P1 at the Pallas probe's shapes: a [2^19] fp32 table gathered at
    524,288 int32 indices, bit-exact with table[idx]; torch.take is the
    yardstick."""
    from nerf_signature_tpu_torch.ops import gather as t_gather

    g = torch.Generator(device=dev).manual_seed(21)
    T, N = 1 << 19, 524_288
    table = torch.rand(T, generator=g, device=dev)
    idx = torch.randint(0, T, (N,), generator=g, device=dev, dtype=torch.int32)
    out = t_gather.table_gather(table, idx)
    ref = t_gather.table_gather_plain(table, idx)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"[P1] table {T} fp32, {N} indices: max abs err {err} (limit 0)")
    if not torch.equal(out, ref):
        raise AssertionError("P1 differs from table[idx]")
    idx64 = idx.long()
    runs = (lambda: t_gather.table_gather(table, idx),
            lambda: t_gather.table_gather_plain(table, idx), lambda: torch.take(table, idx64))
    # per call with CUDA events around it (host dispatch included), then the
    # device's own time; the table is in L2 after the first call either way
    ms, pms, lib = (median_ms(fn, 50) for fn in runs)
    dms, pdms, ldms = (device_ms(fn, 50) for fn in runs)
    bms, bby = bound_of(N * 4 + N * 4 + T * 4, 0, PEAK_FP32)
    log(f"[P1] per call {ms:.4f} ms, device {dms:.4f} ms; table[idx] {pms:.4f} / {pdms:.4f} ms; "
        f"torch.take {lib:.4f} / {ldms:.4f} ms; bound {bms:.4f} ms ({bby})")
    return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, plain_device_ms=pdms,
                bound_ms=bms, bound_by=bby, library_ms=lib, library_device_ms=ldms)


def k1_timing(x01, fp, res, log2_size, pitch=None):
    """K1's forward row at these positions (the gather in bf16; output rows
    of ``pitch`` floats, the main path's at a padded width): per call (CUDA
    events) and on the device (torch.profiler), its plain version, and the
    bound."""
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    run = lambda: t_hash.hash_encode(x01, fp["hash_table"], res, log2_size,
                                     table_g=fp["hash_table_g"], pitch=pitch)
    ms, dms = median_ms(run, 20), device_ms(run, 20)
    pms = median_ms(lambda: t_hash.hash_encode_plain(x01, fp["hash_table"], res, log2_size,
                                                     table_g=fp["hash_table_g"]), 3, 1)
    rows = touched_rows(x01, res, log2_size)
    M, L, F = x01.shape[0], len(res), fp["hash_table"].shape[1]
    # positions read, features written (L*F of them a sample: the padded
    # columns are not the function's), each touched bf16 row read once; per
    # (sample, level) 25 flops of weights and 8 corners x F multiply-adds
    bms, bby = bound_of(M * 12 + M * L * F * 4 + rows * F * 2, M * L * (25 + 16 * F), PEAK_FP32)
    log(f"[K1] M={M} L={L} F={F} pitch {pitch or L * F}: {rows} distinct table rows touched "
        f"({rows * F * 2 / 1e6:.1f} MB bf16); per call {ms:.4f} ms, device {dms:.4f} ms")
    return dict(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=None)


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


def k4_forward(fp, cfg, feat, dirs):
    """K4's forward in cfg's dtype (bf16: the tensor-core kernel; fp32: the
    SIMT one) against its plain version, with and without directions (the
    density-only query of grid updates and meshing); its row's numbers and
    the plain (sigma, rgb)."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    bf16 = cfg.compute_dtype == torch.bfloat16
    tag = "K4" if bf16 else "K4 f32"
    fw = feat[:, :cfg.enc_dim]  # the plain versions read the encoding width
    sk, gk, rk = t_ngp.field_heads(fp, cfg, feat, dirs, want_geo=True)
    sd, gd, _ = t_ngp.field_heads(fp, cfg, feat, None, want_geo=True)
    sp, gp, rp = t_ngp.field_heads_plain(fp, cfg, fw, dirs)
    e_rgb = float((rk - rp).abs().max())
    e_sig = float(((sk - sp).abs() / sp.abs().clamp_min(1e-6)).max())
    # geo: |k - p| <= atol + rtol |p|, reported as the worst ratio to that
    lim_sig, lim_rgb, g_rtol, g_atol = (2e-2, 1e-2, 2e-2, 1e-2) if bf16 else (1e-5,) * 4
    e_geo = float(((gk - gp).abs() / (g_atol + g_rtol * gp.abs())).max())
    steps = {n: float((a != b).float().mean()) for n, a, b in
             (("sigma", sk, sp), ("geo", gk, gp), ("rgb", rk, rp))}
    same = torch.equal(sd, sk) and torch.equal(gd, gk)
    log(f"[{tag}] rgb max abs err {e_rgb:.3g} (limit {lim_rgb:g}), sigma max rel err {e_sig:.3g} "
        f"(limit {lim_sig:g}), geo worst share of its limit {e_geo:.3g} (limit 1); sigma range "
        f"{float(sp.min()):.3g}..{float(sp.max()):.3g}; share of outputs not equal to the "
        f"plain version's {steps}; density-only query equal to the colour query's: {same}")
    if not (e_rgb <= lim_rgb and e_sig <= lim_sig and e_geo <= 1.0 and same):
        raise AssertionError(f"{tag} differs from its plain version beyond its limits")
    ms = median_ms(lambda: t_ngp.field_heads(fp, cfg, feat, dirs), 20)
    pms = median_ms(lambda: t_ngp.field_heads_plain(fp, cfg, fw, dirs), 5, 1)
    lib = library_mlp_ms(fp, fw, dirs, cfg.compute_dtype)
    M = feat.shape[0]
    n_w = sum(w.numel() for w in fp["sigma_net"] + fp["color_net"])
    bms, bby = bound_of(M * (cfg.enc_dim * 4 + 12 + 4 + 12), M * 2 * n_w,
                        PEAK_BF16 if bf16 else PEAK_FP32)
    return dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                library_ms=lib, share_not_equal=steps), (sp, rp)


def library_mlp_ms(fp, feat, dirs, dtype=torch.bfloat16):
    """The same two MLPs as a chain of torch.matmul calls in ``dtype`` (a
    yardstick, never called by the port); inputs prepared outside the timed
    region."""
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    ws = [w.to(dtype) for w in fp["sigma_net"]]
    wc = [w.to(dtype) for w in fp["color_net"]]
    xs = feat.to(dtype)
    xc = torch.cat([sh_encode(dirs, 4), feat[:, :15]], -1).to(dtype)

    def run():
        h = torch.relu(xs @ ws[0]) @ ws[1]
        c = torch.relu(torch.relu(xc @ wc[0]) @ wc[1]) @ wc[2]
        return h, c

    return median_ms(run, 20)


# ---------------------------------------------------------------- phase 4
def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def k3_needs(sig, deltas, mask, T_thresh=1e-4):
    """What K3 must read of these inputs: the slots before each ray's stop
    (the first whose entering T is below T_thresh), whose mask bytes it
    needs, and the live ones among them, whose sigma, delta, t and three
    colours (24 B) it needs.  Masked slots, and every slot from the stop on,
    need nothing but their zero outputs."""
    with torch.no_grad():
        live = torch.ones_like(sig, dtype=torch.bool) if mask is None else mask
        tau = torch.where(live, sig * deltas, 0.0)
        t_in = torch.exp(-(torch.cumsum(tau, -1) - tau))
        before = torch.cumsum((t_in < T_thresh).int(), -1) == 0
        return int(before.sum()), int((before & live).sum())


def k3_rows(tag, sig, rgb, deltas, ts, mask, g_ws=None, g_img=None):
    """K3 forward (and, given the cotangents, backward) on one shape's
    inputs, against the plain version: the forward within 1e-5 max abs
    error, the backward within 1e-5 relative L2 with bit-equal repeats.
    Per call (CUDA events) and on the device (torch.profiler), the plain
    version's time and the bound (from ``k3_needs``).  Returns the rows."""
    from nerf_signature_tpu_torch.ops import composite as t_comp

    N, S = sig.shape
    fwd = lambda: t_comp.composite_rays(sig, rgb, deltas, ts, mask=mask)
    plain = lambda: t_comp.composite_rays_plain(sig, rgb, deltas, ts, mask=mask)
    ck, cp = fwd(), plain()
    e3 = max(float((ck[n] - cp[n]).abs().max()) for n in ck)
    n_before, n_live = k3_needs(sig, deltas, mask)
    log(f"[K3 {tag}] N={N} S={S}: max abs err {e3:.3g} (limit 1e-5); of {N * S} slots "
        f"{n_before} lie before their ray's stop (T < 1e-4), {n_live} of them live")
    if not e3 <= 1e-5:
        raise AssertionError(f"K3 ({tag}) differs from its plain version by {e3}")
    read = n_live * 24 + (0 if mask is None else n_before)
    bms, bby = bound_of(read + N * S * 4 + N * 20, n_live * 12, PEAK_FP32)
    needs = dict(slots=N * S, before_stop=n_before, live=n_live)
    row_f = dict(max_abs_err=e3, ms=median_ms(fwd, 30), device_ms=device_ms(fwd, 30),
                 plain_ms=median_ms(plain, 10, 1), bound_ms=bms, bound_by=bby, library_ms=None,
                 needs=needs)
    log(f"[K3 {tag}] {row_f['ms']:.4f} ms a call, device {row_f['device_ms']:.4f} ms, plain "
        f"{row_f['plain_ms']:.4f} ms, bound {bms:.4f} ms ({bby})")
    if g_img is None:
        return row_f, None
    bwd = lambda: t_comp.composite_rays_bwd(sig, rgb, deltas, ts, mask, 1e-4, g_ws=g_ws,
                                            g_image=g_img)
    (gs_k, gr_k), (gs_2, gr_2) = bwd(), bwd()
    same = torch.equal(gs_k, gs_2) and torch.equal(gr_k, gr_2)
    s_p, r_p = sig.clone().requires_grad_(True), rgb.clone().requires_grad_(True)
    out = t_comp.composite_rays_plain(s_p, r_p, deltas, ts, mask)
    plain_b = lambda: torch.autograd.grad([out["weights_sum"], out["image"]], [s_p, r_p],
                                          [g_ws, g_img], retain_graph=True)
    gs_p, gr_p = plain_b()
    e = max(rel_l2(gs_k, gs_p), rel_l2(gr_k, gr_p))
    a = max(float((gs_k - gs_p).abs().max()), float((gr_k - gr_p).abs().max()))
    log(f"[K3 bwd {tag}] rel L2 {e:.3g} (limit 1e-5), max abs err {a:.3g}; repeats equal bit "
        f"for bit: {same}")
    if not (e <= 1e-5 and same):
        raise AssertionError(f"K3 backward ({tag}) differs from its plain version (rel L2 {e}) "
                             f"or from itself")
    bms, bby = bound_of(read + N * 16 + N * S * 16, n_live * 40, PEAK_FP32)
    row_b = dict(max_abs_err=a, rel_l2=e, ms=median_ms(bwd, 30), device_ms=device_ms(bwd, 30),
                 plain_ms=median_ms(plain_b, 10, 1), bound_ms=bms, bound_by=bby,
                 library_ms=None, needs=needs)
    log(f"[K3 bwd {tag}] {row_b['ms']:.4f} ms a call, device {row_b['device_ms']:.4f} ms, "
        f"plain {row_b['plain_ms']:.4f} ms, bound {bms:.4f} ms ({bby})")
    return row_f, row_b


def k3_edges(dev):
    """K3 forward and backward against the plain versions where the warp
    walk has its edges: S of 1, 31, 32, 40 and 256 (not a multiple of the
    32-slot chunk, or one chunk), stops inside the first chunk and at slots
    31 and 32, the mask on, absent and all off, T_thresh 0 and 1e-4, 515
    rays (not a multiple of a block's 4), and N = 0.  Forward within 1e-5
    max abs error, backward within 1e-5 relative L2 (all-masked: exactly
    zero), bit-equal repeats."""
    from nerf_signature_tpu_torch.kernel_cases import k3_edge_inputs
    from nerf_signature_tpu_torch.ops import composite as t_comp

    gen = torch.Generator(device=dev).manual_seed(9)
    worst_f = worst_b = 0.0
    n_cases = 0
    for S in (1, 31, 32, 40, 256):
        for mask_kind in ("on", "off", "all_masked"):
            for thr in (0.0, 1e-4):
                sig, rgb, dt, ts, mask = (None if v is None else torch.from_numpy(v).to(dev)
                                          for v in k3_edge_inputs(515, S, mask_kind))
                k = t_comp.composite_rays(sig, rgb, dt, ts, mask=mask, T_thresh=thr)
                p = t_comp.composite_rays_plain(sig, rgb, dt, ts, mask=mask, T_thresh=thr)
                ef = max(float((k[n] - p[n]).abs().max()) for n in k)
                cts = [torch.randn(shape, generator=gen, device=dev)
                       for shape in ((515,), (515,), (515, 3), (515, S))]
                once = t_comp.composite_rays_bwd(sig, rgb, dt, ts, mask, thr, *cts)
                again = t_comp.composite_rays_bwd(sig, rgb, dt, ts, mask, thr, *cts)
                s_p, r_p = sig.clone().requires_grad_(True), rgb.clone().requires_grad_(True)
                out = t_comp.composite_rays_plain(s_p, r_p, dt, ts, mask=mask, T_thresh=thr)
                gs_p, gr_p = torch.autograd.grad(
                    [out[n] for n in ("weights_sum", "depth", "image", "weights")], [s_p, r_p],
                    cts)
                if mask_kind == "all_masked":
                    eb = 0.0 if not (once[0].any() or once[1].any()) else math.inf
                else:
                    eb = max(rel_l2(once[0], gs_p), rel_l2(once[1], gr_p))
                same = torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])
                stops = True
                if thr > 0 and S > 32 and mask_kind != "all_masked":
                    w = k["weights"]
                    stops = not (w[0, 1:].any() or w[1, 31:].any() or w[2, 32:].any())
                if not (ef <= 1e-5 and eb <= 1e-5 and same and stops):
                    raise AssertionError(
                        f"K3 edge case S={S} mask={mask_kind} T_thresh={thr}: forward max abs "
                        f"err {ef}, backward rel L2 {eb}, repeats equal {same}, stops {stops}")
                worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
                n_cases += 1
    empty = t_comp.composite_rays(*(torch.zeros((0, 64) + e, device=dev)
                                    for e in ((), (3,), (), ())))
    if empty["weights"].shape != (0, 64) or empty["image"].shape != (0, 3):
        raise AssertionError("K3 at N = 0: wrong output shapes")
    log(f"[K3 edges] {n_cases} cases and N = 0: forward worst max abs err {worst_f:.3g} "
        f"(limit 1e-5), backward worst rel L2 {worst_b:.3g} (limit 1e-5), repeats equal")


def train_rays(dev, seed=3):
    """TRAIN_RAYS random pixels of an orbit view (the train sampler's draw)."""
    from nerf_signature_tpu_torch.data.rays import get_rays

    fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    r = get_rays(orbit_poses(1, ORBIT_RADIUS, seed=seed), (fl, fl, RES / 2, RES / 2), RES,
                 RES, TRAIN_RAYS, rng=np.random.default_rng(seed))
    return (torch.from_numpy(r["rays_o"][0]).to(dev).contiguous(),
            torch.from_numpy(r["rays_d"][0]).to(dev).contiguous())


def phase_train_kernels(dev):
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    results = {}
    m = make_model(dev)
    cfg = m.cfg
    ro, rd = train_rays(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
    grid = m.occ.occupancy
    aabb = default_aabb(m.rc)

    # ---- K2 with perturbation noise, the auto prefilter (on here) and off
    for pf in (None, False):
        kw = dict(min_near=m.rc.min_near, bound=1.0, dt_gamma=0.0, max_steps=1024,
                  budget=TRAIN_BUDGET, prefilter=pf, noise=noise)
        plan = t_march.march_plan(grid.shape[0], 128, bound=1.0, max_steps=1024,
                                  budget=TRAIN_BUDGET, prefilter=pf)
        coarse = t_march.coarse_grid(grid, plan)
        k = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
        p = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, plain=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k["mask"], p["mask"]):
            raise AssertionError(f"K2 with noise: mask differs (prefilter={plan.prefilter})")
        err = max(float((k[n].float() - p[n].float()).abs().max())
                  for n in ("xyzs", "ts", "deltas", "nears", "fars", "n_occupied",
                            "n_occupied_raw", "n_groups_occ"))
        log(f"[K2 noise] prefilter={plan.prefilter}: mask equal, max abs err {err} (limit 0), "
            f"{int(k['mask'].sum())} samples")
        if err != 0.0:
            raise AssertionError(f"K2 with noise differs from its plain version by {err}")
        if pf is None:
            march = k
            run = lambda: t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
            ms, dms = median_ms(run, 30), device_ms(run, 30)
            pms = median_ms(lambda: t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse,
                                                            plain=True, **kw), 5, 1)
            N, S = k["mask"].shape
            bms, bby = bound_of(N * 28 + N * S * 21 + N * 20 + grid.numel() + coarse.numel(),
                                0, PEAK_FP32)
            results["K2_march"] = dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                                       bound_ms=bms, bound_by=bby, library_ms=None)

    N, S = march["mask"].shape
    M = N * S
    live = march["mask"].reshape(-1).float()
    fp = t_ngp.field_params(m.params, cfg)
    res, S_log2 = cfg.resolutions, cfg.log2_hashmap_size
    rows = fp["hash_table"].shape[0]
    x01 = ((march["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    dirs = march["dirs"].reshape(-1, 3).contiguous()
    log(f"[train-kernels] N={N} S={S} M={M} samples, {int(live.sum())} live")

    # ---- K1 backward: cotangents zero on padded samples, like a train step
    results["K1_hash_encode_bwd"] = k1_bwd(x01, live, rows, res, S_log2, cfg.n_features, gen)

    # ---- K4's full backward on the encoded samples: bf16 on the tensor
    # cores (the clean step's route), fp32 on the SIMT units
    with torch.no_grad():
        feat = t_hash.hash_encode(x01, fp["hash_table"], res, S_log2, table_g=fp["hash_table_g"])
        sig, _, rgb = t_ngp.field_heads(fp, cfg, feat, dirs)
    g_sigma = torch.randn((M,), generator=gen, device=dev) * 1e-4 * live
    g_rgb = torch.randn((M, 3), generator=gen, device=dev) * 1e-4 * live[:, None]
    results["K4_field_bwd"] = k4_bwd(fp, cfg, feat, dirs, g_sigma, g_rgb)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    results["K4_field_bwd_f32"] = k4_bwd(t_ngp.field_params(m.params, cfg32), cfg32, feat, dirs,
                                         g_sigma, g_rgb)

    # ---- K3 forward and backward on the field's output, the loss's cotangents
    sig2 = (sig.reshape(N, S) * m.rc.density_scale).contiguous()
    rgb2 = rgb.reshape(N, S, 3).contiguous()
    bg = torch.rand((N, 3), generator=gen, device=dev)
    g_img = torch.randn((N, 3), generator=gen, device=dev) * 1e-4
    g_ws = -(g_img * bg).sum(-1)
    results["K3_composite_clean"], results["K3_composite_bwd"] = k3_rows(
        "clean step", sig2, rgb2, march["deltas"], march["ts"], march["mask"], g_ws, g_img)

    # ---- one whole train step through the kernels and through the plain
    # versions, in bf16 and fp32
    fp32_counts = {"train step": clean_steps(dev, ro, rd, bg, noise)["float32"]}
    wm_kernels(dev, results, fp32_counts)
    results["K4_field_bwd_feat_f32"]["fp32_step_launches"] = fp32_counts
    for name, r in results.items():
        log(f"[{name}] ms {r['ms']:.4f} | plain {r['plain_ms']:.4f} | "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) | library {r['library_ms']}")
    return results


def clean_steps(dev, ro, rd, bg, noise, levels=16, features=2):
    """One whole train step through the kernels against one through the
    plain versions, in bf16 and in fp32, at a table geometry (``levels`` x
    ``features``).  K2 is bit-exact and K3/K1 differ by fp32 sum order, so
    what is left is K4's bf16 roundings of sums taken in another order than
    cuBLAS's.  The limits are a few times the readings on an H100 (loss
    7.0e-8 relative; per-leaf rel L2 2.6e-4 in bf16, 8.1e-7 in fp32).  Fails
    unless K4 ran on the dtype's route alone; returns each dtype's launches."""
    from nerf_signature_tpu_torch.ops import _cuda

    counts = {}
    for dtype, lim_rel in ((torch.bfloat16, 2e-3), (torch.float32, 1e-5)):
        lim_loss = 1e-6
        mt = make_model(dev, dtype=dtype, levels=levels, features=features)
        _cuda.reset_launch_counts()
        (lk, gk_), (lp, gp_) = (train_step_grads(mt, ro, rd, bg, noise, plain)
                                for plain in (False, True))
        n = _cuda.launch_counts()
        k4_route(n, dtype, ("K4_field", "K4_field_bwd"), "train step")
        counts[str(dtype)[6:]] = n
        el = abs(float(lk) - float(lp)) / abs(float(lp))
        worst = max(rel_l2(a, b) for a, b in zip(gk_, gp_))
        log(f"[train step] {levels} x {features}, {str(dtype)[6:]}: loss {float(lk):.6g} vs "
            f"plain {float(lp):.6g} (rel {el:.3g}, limit {lim_loss:g}); per-leaf grads worst "
            f"rel L2 {worst:.3g} (limit {lim_rel:g})")
        if not (el <= lim_loss and worst <= lim_rel):
            raise AssertionError(f"train step through the kernels differs from the plain "
                                 f"one ({levels} x {features}, {str(dtype)})")
        del mt
    return counts


def wm_steps(dev, x, levels=16, features=2):
    """One whole watermark step through the kernels against one through the
    plain versions, in bf16 and in fp32, at a table geometry.  A conv bias
    before a batch norm has a zero gradient in exact arithmetic (noise of
    ~1e-9 either way) and is left out of the per-leaf comparison.  The
    limits are a few times the readings on an H100 (loss equal; worst leaf
    8.4e-4 in bf16, the message tables', and 2.0e-5 in fp32).  Fails unless
    K4 ran on the dtype's route alone; returns each dtype's launches."""
    from nerf_signature_tpu_torch.ops import _cuda

    counts = {}
    for dtype, lim_rel in ((torch.bfloat16, 5e-3), (torch.float32, 1e-4)):
        lim_loss = 1e-6
        mt = make_wm_model(dev, dtype=dtype, levels=levels, features=features)
        _cuda.reset_launch_counts()
        (lk, gk_), (lp, gp_) = (wm_step_grads(mt, x, plain) for plain in (False, True))
        n = _cuda.launch_counts()
        k4_route(n, dtype, ("K4_field", "K4_field_bwd_feat"), "wm step")
        counts[str(dtype)[6:]] = n
        el = abs(float(lk) - float(lp)) / abs(float(lp))
        scale = max(float(g.norm()) for g in gp_)
        kept = [(a, b) for a, b in zip(gk_, gp_) if float(b.norm()) > 1e-5 * scale]
        worst = max(rel_l2(a, b) for a, b in kept)
        log(f"[wm step] {levels} x {features}, {str(dtype)[6:]}: loss {float(lk):.6g} vs plain "
            f"{float(lp):.6g} (rel {el:.3g}, limit {lim_loss:g}); {len(kept)} of {len(gp_)} "
            f"trainable leaves' grads, worst rel L2 {worst:.3g} (limit {lim_rel:g}); message "
            f"tables {rel_l2(gk_[0], gp_[0]):.3g}")
        if not (el <= lim_loss and worst <= lim_rel):
            raise AssertionError(f"watermark step through the kernels differs from the plain "
                                 f"one ({levels} x {features}, {str(dtype)})")
        del mt, gk_, gp_
    return counts


def k1_bwd(x01, live, n_rows, res, log2_size, F, gen, pitch=None):
    """K1's backward (bf16 gather) against its plain version on random
    cotangents of the live samples (zero on padded ones, as in a train
    step; at ``pitch`` > L*F the padded columns zero, as K4's g_feat has
    them); its row, with its device time and index_add_ of the same corner
    contributions as the yardstick, and (``atomics_modelled``, kept out of
    the ``kernels`` line) the atomics its design issues on these inputs as
    ``kernel_cases.k1_bwd_atomics`` models them in plain PyTorch: a count
    of the algorithm, not a measurement of the kernel."""
    from nerf_signature_tpu_torch.kernel_cases import k1_bwd_atomics
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    M, L = x01.shape[0], len(res)
    dev = x01.device
    pitch = pitch or L * F
    g_feat = torch.zeros((M, pitch), device=dev)
    g_feat[:, :L * F] = torch.randn((M, L * F), generator=gen, device=dev) * 1e-4 * live[:, None]
    g_w = g_feat[:, :L * F].contiguous()
    run = lambda: t_hash._hash_encode_bwd_kernel(x01, g_feat, n_rows, res, log2_size,
                                                 torch.bfloat16, False, None, F)
    gk = run()
    gp = t_hash.hash_encode_bwd_plain(x01, g_w, n_rows, res, log2_size, torch.bfloat16)
    e1, a1 = rel_l2(gk, gp), float((gk - gp).abs().max())
    log(f"[K1 bwd] F={F} L={L} pitch {pitch}: rel L2 {e1:.3g} (limit 1e-5), max abs err "
        f"{a1:.3g}")
    if not e1 <= 1e-5:
        raise AssertionError(f"K1 backward (F={F}) differs from its plain version: rel L2 {e1}")
    del gk, gp
    ms, dms = median_ms(run, 20), device_ms(run, 20)
    pms = median_ms(lambda: t_hash.hash_encode_bwd_plain(
        x01, g_w, n_rows, res, log2_size, torch.bfloat16), 3, 1)
    atomics = k1_bwd_atomics(x01, g_w, F, res, log2_size, torch.bfloat16)
    idx, val = [], []
    g3 = g_w.reshape(M, L, F).permute(1, 0, 2)
    for ci, cw in t_hash._corners(x01, res, log2_size, False, None, torch.float32):
        ct = (cw[..., None] * g3).to(torch.bfloat16).float()
        for f in range(F):
            idx.append((ci * F + f).reshape(-1))
            val.append(ct[..., f].reshape(-1))
    idx, val = torch.cat(idx), torch.cat(val)
    n_adds = int((val != 0).sum())
    buf = torch.zeros(n_rows * F, device=dev)
    lib = median_ms(lambda: buf.index_add_(0, idx, val), 10)
    del idx, val, buf
    # bound: the cotangent read and the grad table written whole; x read only
    # for samples with a nonzero cotangent; one add for each nonzero value
    n_hot = int((g_w != 0).any(-1).sum())
    bms, bby = bound_of(M * L * F * 4 + n_hot * 12 + n_rows * F * 4, n_adds, PEAK_FP32)
    log(f"[K1 bwd] F={F} L={L}: {n_hot} of {M} samples hot; per call {ms:.4f} ms, device "
        f"{dms:.4f} ms, bound {bms:.4f} ms ({bby}); atomics {atomics} (modelled, not "
        f"measured); index_add_ {lib:.4f} ms")
    return dict(max_abs_err=a1, rel_l2=e1, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                bound_by=bby, library_ms=lib, atomics_modelled=atomics)


def k4_bwd(fp, cfg, feat, dirs, g_sigma, g_rgb):
    """K4's full backward in cfg's dtype (bf16: the tensor-core kernel; fp32:
    the SIMT one) against autograd through the plain version, with a
    bit-equal repeat; its row, with the device time of the kernel and of
    the library chain's autograd."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    bf16 = cfg.compute_dtype == torch.bfloat16
    tag = "K4 bwd" if bf16 else "K4 bwd f32"
    widths = t_ngp._kernel_widths(fp, cfg)
    flat, mma = fp["mlp_flat"], fp.get("mlp_mma")
    run = lambda: t_ngp.field_heads_bwd(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma)
    gf_k, gw_k = run()
    nets = [w.clone().requires_grad_(True) for w in fp["sigma_net"] + fp["color_net"]]
    pp = dict(fp, sigma_net=nets[:2], color_net=nets[2:])
    f_p = feat.clone().requires_grad_(True)
    s_p, _, r_p = t_ngp.field_heads_plain(pp, cfg, f_p[:, :cfg.enc_dim], dirs)
    plain_bwd = lambda: torch.autograd.grad([s_p, r_p], [f_p] + nets, [g_sigma, g_rgb],
                                            retain_graph=True)
    gp4 = plain_bwd()
    gw_p = torch.cat([g.reshape(-1) for g in gp4[1:]])
    # at a padded width (IN > W) Ws0's rows W..IN-1 face zero features: their
    # gradient is 0, and field_params' cat drops it on the way to the params
    W, IN, hid = cfg.enc_dim, widths[0], widths[1]
    if bool(gw_k[W * hid:IN * hid].any()):
        raise AssertionError(f"{tag}: Ws0's padded rows have a nonzero gradient")
    gw_w = torch.cat([gw_k[:W * hid], gw_k[IN * hid:]])
    e4 = max(rel_l2(gf_k, gp4[0]), max(rel_l2(a, b.reshape(-1)) for a, b in zip(
        torch.split(gw_w, [w.numel() for w in nets]), gp4[1:])))
    a4 = max(float((gf_k - gp4[0]).abs().max()), float((gw_w - gw_p).abs().max()))
    lim = 1e-2 if bf16 else 1e-5
    log(f"[{tag}] worst rel L2 over g_feat and the 5 weight leaves {e4:.3g} (limit {lim:g}), "
        f"max abs err {a4:.3g}")
    if not e4 <= lim:
        raise AssertionError(f"{tag} differs from its plain version: rel L2 {e4}")
    gf_again, gw_again = run()
    if not (torch.equal(gw_again, gw_k) and torch.equal(gf_again, gf_k)):
        raise AssertionError(f"{tag}: a repeat is not bit-equal (weight gradient or g_feat)")
    del gf_again, gw_again, gp4
    ms = median_ms(run, 10)
    dms = device_ms(run)
    pms = median_ms(plain_bwd, 5, 1)
    del plain_bwd, f_p, s_p, r_p
    lib_run = library_mlp_bwd(fp, feat[:, :cfg.enc_dim], dirs, g_sigma, g_rgb,
                              dtype=cfg.compute_dtype)
    lib, ldms = median_ms(lib_run, 10), device_ms(lib_run, 10)
    # bound: every sample's cotangents read and g_feat written; feat and dirs
    # read, and the forward and both products done (6 flops a weight), only
    # for samples with a nonzero cotangent; the weights read, g_weights written
    M = feat.shape[0]
    n_w = sum(w.numel() for w in nets)
    n_hot = int(((g_sigma != 0) | (g_rgb != 0).any(-1)).sum())
    bms, bby = bound_of(M * (4 + 12 + cfg.enc_dim * 4) + n_hot * (cfg.enc_dim * 4 + 12)
                        + n_w * 8, n_hot * 6 * n_w, PEAK_BF16 if bf16 else PEAK_FP32)
    log(f"[{tag}] {n_hot} of {M} samples carry a nonzero cotangent; per call {ms:.4f} ms, "
        f"device {dms:.4f} ms; library chain {lib:.4f} / {ldms:.4f} ms; bound {bms:.4f} ms "
        f"({bby}); bit-equal repeat")
    return dict(max_abs_err=a4, rel_l2=e4, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                bound_by=bby, library_ms=lib, library_device_ms=ldms)


def train_step_grads(m, ro, rd, bg, noise, plain):
    """The train step's loss (trainer.py's MSE over a random background) and
    its per-leaf gradients, through the kernels or the plain versions."""
    from nerf_signature_tpu_torch.models.ngp import field_params, ngp_field
    from nerf_signature_tpu_torch.render.renderer import render_rays_occ
    from nerf_signature_tpu_torch.train.trainer import param_leaves

    leaves = param_leaves(m.params)
    for p in leaves:
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(11)
    images = torch.rand((ro.shape[0], 4), generator=g).to(ro.device)
    gt = images[:, :3] * images[:, 3:] + bg * (1.0 - images[:, 3:])
    fp = field_params(m.params, m.cfg)
    out = render_rays_occ(lambda x, d: ngp_field(fp, m.cfg, x, d, plain=plain),
                          m.occ.occupancy, ro, rd, m.rc, budget=TRAIN_BUDGET, bg_color=bg,
                          noise=noise, plain=plain)
    loss = torch.mean(torch.mean((out["image"] - gt) ** 2, dim=-1))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def library_mlp_bwd(fp, feat, dirs, g_sigma, g_rgb, weights_grad=True, dtype=torch.bfloat16):
    """A call of autograd's backward of the torch.matmul chain of
    library_mlp_ms in ``dtype`` (a yardstick, never called by the port);
    with ``weights_grad`` False the inputs' gradients only (frozen
    weights)."""
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    bf = dtype
    ws = [w.to(bf).requires_grad_(weights_grad) for w in fp["sigma_net"]]
    wc = [w.to(bf).requires_grad_(weights_grad) for w in fp["color_net"]]
    xs = feat.to(bf).requires_grad_(True)
    xc = torch.cat([sh_encode(dirs, 4), feat[:, :15]], -1).to(bf).requires_grad_(True)
    h = torch.relu(xs @ ws[0]) @ ws[1]
    c = torch.relu(torch.relu(xc @ wc[0]) @ wc[1]) @ wc[2]
    gh = torch.cat([g_sigma[:, None], torch.zeros_like(h[:, 1:], dtype=torch.float32)],
                   -1).to(bf)
    gc = g_rgb.to(bf)
    wrt = [xs, xc] + (ws + wc if weights_grad else [])
    return lambda: torch.autograd.grad([h, c], wrt, [gh, gc], retain_graph=True)


def make_wm_model(dev, dtype=torch.bfloat16, seed=0, levels=16, features=2):
    """The recipe's watermarked model with random weights from a seed: the
    full-width backbone of make_model on the ball grid, 32-bit message
    tables at U(+-0.1) (so the message moves the field), a fresh decoder."""
    from nerf_signature_tpu_torch.api import WatermarkModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.models.watermark import WatermarkConfig

    wcfg = WatermarkConfig(ngp=NGPConfig(bound=1.0, compute_dtype=dtype, n_levels=levels,
                                         n_features=features), message_dim=WM_BITS)
    m = WatermarkModel(wcfg, min_near=0.2, density_thresh=10.0, dt_gamma=0.0,
                       max_steps=1024, grid_size=128, seed=seed, infer_budget=256, device=dev)
    m.backbone["hash_table"].mul_(1e4)
    m.trainable["msg_tables"].mul_(1e3)
    m.occ = m.occ._replace(occupancy=ball_grid(m.cascade, 128).to(dev))
    return m


def wm_step_inputs(dev, seed=4):
    """A watermark step's rays at the recipe's shapes: 32 key blocks of
    12x12 tiling the middle of one 400x400 view (on the ball), 4096 random
    pixels of another view with random pseudo-GT, a random message."""
    from nerf_signature_tpu_torch.data.rays import get_rays

    fl = WM_RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    intr = (fl, fl, WM_RES / 2, WM_RES / 2)
    poses = orbit_poses(2, ORBIT_RADIUS, seed=seed)
    key = get_rays(poses[:1], intr, WM_RES, WM_RES, -1)
    ro = key["rays_o"][0].reshape(WM_RES, WM_RES, 3)
    rd = key["rays_d"][0].reshape(WM_RES, WM_RES, 3)
    r0, c0, B = WM_RES // 2 - 2 * WM_BLOCK, WM_RES // 2 - 4 * WM_BLOCK, WM_BLOCK
    corners = [(r0 + (i // 8) * B, c0 + (i % 8) * B) for i in range(WM_BITS)]
    ro_b = np.stack([ro[r:r + B, c:c + B] for r, c in corners])
    rd_b = np.stack([rd[r:r + B, c:c + B] for r, c in corners])
    rng = np.random.default_rng(seed)
    ct = get_rays(poses[1:], intr, WM_RES, WM_RES, TRAIN_RAYS, rng=rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return dict(ro_b=t(ro_b), rd_b=t(rd_b), ct_o=t(ct["rays_o"][0]), ct_d=t(ct["rays_d"][0]),
                ct_gt=t(rng.uniform(size=(TRAIN_RAYS, 3))),
                bits=torch.from_numpy(rng.integers(0, 2, WM_BITS).astype(np.int32)).to(dev))


def wm_step_grads(m, x, plain):
    """The watermark step's loss (trainer_wtmk._wm_step_loss at the recipe's
    lambdas, one render at budget 256) and the trainable leaves' gradients,
    through the kernels or the plain versions."""
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm

    leaves = t_twm.trainable_leaves(m.trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = t_twm._wm_step_loss(
        m.backbone, m.trainable, m.occ.occupancy, x["ro_b"], x["rd_b"], x["ct_o"], x["ct_d"],
        x["ct_gt"], x["bits"], None, 0.005, 1.0, m.wcfg, m.rc, 256, 256, "none",
        t_twm.make_loss_w("bce"), plain=plain)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def k4_bwd_feat(fp, cfg, feat, dirs, g_sigma, g_rgb):
    """The feature-only K4 backward in cfg's dtype (bf16: the tensor-core
    kernel; fp32: the SIMT one) against autograd through the plain version
    and against the full backward's g_feat, on the same route (the same
    products, so equal bit for bit); its row."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    bf16 = cfg.compute_dtype == torch.bfloat16
    tag = "K4 bwd feat" if bf16 else "K4 bwd feat f32"
    widths = t_ngp._kernel_widths(fp, cfg)
    flat, mma = fp["mlp_flat"], fp.get("mlp_mma")
    gf_k = t_ngp.field_heads_bwd_feat(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma)
    gf_full = t_ngp.field_heads_bwd(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma)[0]
    f_p = feat.clone().requires_grad_(True)
    s_p, _, r_p = t_ngp.field_heads_plain(fp, cfg, f_p[:, :cfg.enc_dim], dirs)
    plain_bwd = lambda: torch.autograd.grad([s_p, r_p], [f_p], [g_sigma, g_rgb],
                                            retain_graph=True)
    (gf_p,) = plain_bwd()
    lim = 1e-2 if bf16 else 1e-5
    e4, e_full = rel_l2(gf_k, gf_p), rel_l2(gf_k, gf_full)
    a4 = float((gf_k - gf_p).abs().max())
    equal_full = torch.equal(gf_k, gf_full)
    log(f"[{tag}] rel L2 vs plain {e4:.3g} (limit {lim:g}), max abs err {a4:.3g}; vs the full "
        f"backward's g_feat rel L2 {e_full:.3g} (limit 0), equal bit for bit: {equal_full}")
    if not (e4 <= lim and equal_full):
        raise AssertionError(f"{tag} differs from its plain version or from the full "
                             "backward's g_feat")
    del gf_full, gf_p
    ms = median_ms(lambda: t_ngp.field_heads_bwd_feat(cfg, widths, feat, dirs, flat, g_sigma,
                                                      g_rgb, mma), 10)
    full_ms = median_ms(lambda: t_ngp.field_heads_bwd(cfg, widths, feat, dirs, flat, g_sigma,
                                                      g_rgb, mma), 5)
    log(f"[{tag}] {ms:.4f} ms; the full backward (with the weight gradient) on the same "
        f"inputs {full_ms:.4f} ms")
    pms = median_ms(plain_bwd, 5, 1)
    lib = median_ms(library_mlp_bwd(fp, feat[:, :cfg.enc_dim], dirs, g_sigma, g_rgb,
                                    weights_grad=False, dtype=cfg.compute_dtype), 10)
    # bound: cotangents read and g_feat written for every sample; feat and
    # dirs read, the forward and the transposed products done (4 flops a
    # weight) only for samples with a nonzero cotangent; no weight gradient
    M = feat.shape[0]
    n_hot = int(((g_sigma != 0) | (g_rgb != 0).any(-1)).sum())
    bms, bby = bound_of(M * (4 + 12 + cfg.enc_dim * 4) + n_hot * (cfg.enc_dim * 4 + 12)
                        + flat.numel() * 4, n_hot * 4 * flat.numel(),
                        PEAK_BF16 if bf16 else PEAK_FP32)
    log(f"[{tag}] {n_hot} of {M} samples carry a nonzero cotangent")
    return dict(max_abs_err=a4, rel_l2=e4, rel_l2_vs_full_bwd=e_full, ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=bby, library_ms=lib, full_bwd_ms=full_ms)


def k4_route(counts, dtype, names, what):
    """Fail unless K4's kernels in ``names`` ran on the route of ``dtype``
    alone: bf16 the tensor-core kernel, fp32 the SIMT one (``name_f32``).
    Returns the SIMT kernels' counts."""
    for name in names:
        tc, simt = counts[name], counts[name + "_f32"]
        ok = (tc > 0 and simt == 0) if dtype == torch.bfloat16 else (tc == 0 and simt > 0)
        if not ok:
            raise AssertionError(f"{what} in {dtype}: {name} launched {tc} times on the tensor "
                                 f"cores and {simt} times on the SIMT route")
    return {name + "_f32": counts[name + "_f32"] for name in names}


def wm_kernels(dev, results, fp32_counts):
    """K9 forward and backward, K1's backward into the message table, K3
    forward and backward, the feature-only K4 backward and one whole
    watermark step, kernels against plain versions, at the recipe's shapes;
    the fp32 step's SIMT launches go to ``fp32_counts``."""
    from nerf_signature_tpu_torch.models import message as t_msg
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.models import watermark as t_wm
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    m = make_wm_model(dev)
    x = wm_step_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(17)

    # ---- K9 forward: bit-exact (same adds in bit order, same bf16 rounding)
    tables, bits = m.trainable["msg_tables"], x["bits"]
    D, _, T, F = tables.shape
    for gd in (torch.bfloat16, torch.float32):
        k_eff, k_g = t_msg._msg_table_kernel(tables, bits, gd)
        p_eff, p_g = t_msg.msg_table_plain(tables, bits, gd)
        torch.cuda.synchronize()
        if not (torch.equal(k_eff, p_eff) and torch.equal(k_g, p_g)):
            raise AssertionError(f"K9 differs from its plain version ({gd})")
    e9 = float((k_eff - p_eff).abs().max())
    log(f"[K9] D={D} T={T} F={F}: eff and the bf16/fp32 copies equal to the plain version "
        f"(max abs err {e9}, limit 0)")
    rows = torch.arange(D, device=dev) * 2 + bits.long()
    flat = tables.reshape(2 * D, T * F)
    run9 = lambda: t_msg._msg_table_kernel(tables, bits, torch.bfloat16)
    ms9, dms9 = median_ms(run9, 30), device_ms(run9, 30)
    pms9 = median_ms(lambda: t_msg.msg_table_plain(tables, bits, torch.bfloat16), 10)
    lib9 = median_ms(lambda: flat.index_select(0, rows).sum(0), 30)
    bms9, bby9 = bound_of(D * T * F * 4 + D * 4 + T * F * (4 + 2), D * T * F, PEAK_FP32)
    log(f"[K9] per call {ms9:.4f} ms, device {dms9:.4f} ms, bound {bms9:.4f} ms ({bby9})")
    results["K9_msg_table"] = dict(max_abs_err=e9, ms=ms9, device_ms=dms9, plain_ms=pms9,
                                   bound_ms=bms9, bound_by=bby9, library_ms=lib9)

    # ---- K9 backward: exact (g_eff into the selected tables, zeros elsewhere)
    g_eff = torch.randn((T, F), generator=gen, device=dev)
    gk = t_msg._msg_table_bwd_kernel(g_eff, bits, D)
    gp = t_msg.msg_table_bwd_plain(g_eff, bits, D)
    torch.cuda.synchronize()
    if not torch.equal(gk, gp):
        raise AssertionError("K9 backward differs from its plain version")
    log(f"[K9 bwd] g_tables [{D}, 2, {T}, {F}] equal to the plain version (limit 0)")
    run9b = lambda: t_msg._msg_table_bwd_kernel(g_eff, bits, D)
    ms9b, dms9b = median_ms(run9b, 30), device_ms(run9b, 30)
    pms9b = median_ms(lambda: t_msg.msg_table_bwd_plain(g_eff, bits, D), 10)
    # the yardstick: one torch.where of the bits' one-hot (made outside the
    # timing, as K9's rows are) over g_eff, the same [D, 2, T, F] tensor
    sel = (torch.arange(2, device=dev)[None, :] == bits.long()[:, None]).view(D, 2, 1, 1)
    run9l = lambda: torch.where(sel, g_eff, 0.0)
    if not torch.equal(run9l(), gp):
        raise AssertionError("K9 backward's library call differs from the plain version")
    lib9b, ldms9b = median_ms(run9l, 30), device_ms(run9l, 30)
    bms9b, bby9b = bound_of(2 * D * T * F * 4 + T * F * 4 + D * 4, 0, PEAK_FP32)
    log(f"[K9 bwd] per call {ms9b:.4f} ms, device {dms9b:.4f} ms, bound {bms9b:.4f} ms "
        f"({bby9b}); torch.where {lib9b:.4f} / {ldms9b:.4f} ms")
    results["K9_msg_table_bwd"] = dict(max_abs_err=0.0, ms=ms9b, device_ms=dms9b,
                                       plain_ms=pms9b, bound_ms=bms9b, bound_by=bby9b,
                                       library_ms=lib9b, library_device_ms=ldms9b)
    del gk, gp, sel

    # ---- K4 backward, features only, on the step's uncompacted samples
    ro = torch.cat([x["ro_b"].reshape(-1, 3), x["ct_o"]])
    rd = torch.cat([x["rd_b"].reshape(-1, 3), x["ct_d"]])
    march = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), m.occ.occupancy,
                                    min_near=0.2, bound=1.0, max_steps=1024, budget=256)
    N, S = march["mask"].shape
    M = N * S
    live = march["mask"].reshape(-1).float()
    cfg = m.cfg
    fp = t_ngp.field_params(m.backbone, cfg)
    x01 = ((march["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    dirs = march["dirs"].reshape(-1, 3).contiguous()
    with torch.no_grad():
        feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
                                  table_g=fp["hash_table_g"])
        sig, _, rgb = t_ngp.field_heads(fp, cfg, feat, dirs)

    # ---- K1 backward into the message's effective table: one level, the
    # table's T rows of F features, the step's uncompacted samples
    res_m, _, _ = t_wm.msg_encode_placement(m.wcfg)
    log(f"[K1 bwd wm] L={len(res_m)} (resolution {res_m[0]:g}), {T} rows of F={F}, M={M}")
    results["K1_hash_encode_bwd_wm"] = k1_bwd(x01, live, T, res_m, m.wcfg.msg_log2_hashmap_size,
                                              F, gen)
    del x01

    # ---- K3 forward and backward on the field's output at this step's shapes
    sig = (sig.reshape(N, S) * m.rc.density_scale).contiguous()
    rgb = rgb.reshape(N, S, 3).contiguous()
    g_img = torch.randn((N, 3), generator=gen, device=dev) * 1e-4
    g_ws = -(g_img * torch.rand((N, 3), generator=gen, device=dev)).sum(-1)
    results["K3_composite_wm"], results["K3_composite_bwd_wm"] = k3_rows(
        "watermark step", sig, rgb, march["deltas"], march["ts"], march["mask"], g_ws, g_img)
    del march, sig, rgb, g_img, g_ws
    g_sigma = torch.randn((M,), generator=gen, device=dev) * 1e-4 * live
    g_rgb = torch.randn((M, 3), generator=gen, device=dev) * 1e-4 * live[:, None]
    log(f"[K4 bwd feat] N={N} S={S} M={M}")
    results["K4_field_bwd_feat"] = k4_bwd_feat(fp, cfg, feat, dirs, g_sigma, g_rgb)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    results["K4_field_bwd_feat_f32"] = k4_bwd_feat(t_ngp.field_params(m.backbone, cfg32), cfg32,
                                                   feat, dirs, g_sigma, g_rgb)
    del feat, dirs, g_sigma, g_rgb, live

    # ---- one whole watermark step through the kernels and through the plain
    # versions, in bf16 and fp32
    fp32_counts["wm step"] = wm_steps(dev, x)["float32"]


# ---------------------------------------------------------------- phase 5
def phase_geometry(dev):
    """The other table geometries at full table size (2^19 rows a level):
    8 x 2 (K4 at encoding width 16), 8 x 4 (K1 with 4 features a row),
    16 x 4 (K4 at width 64, K1 with 4 features at 16 levels), 32 x 2 (K4
    at width 64, K1 at its 32-level limit), 12 x 2 (width 24, K4 at 32 on
    features K1 writes zero-padded), 24 x 1 (K1 with 1 feature a row, width
    24) and 8 x 8 (K1 with 8 features a row, width 64).
    For each: K1's forward (bit-exact) and K4's forward on the serving
    chunk's samples, K1's and K4's full backward at the train step's shapes,
    K4's feature-only backward at the watermark step's, each kernel against
    its plain version on both of K4's routes; one whole clean step and one
    whole watermark step through the kernels against the plain versions (bf16
    and fp32, the existing limits).  For each of GEO_TRAINED: Trainer.train
    for GEO_ITERS steps on the radius-0.7 ball, the quality limit checked at
    GEO_QUALITY, then the watermark stage on the backbone that run trained:
    the README stage-2 recipe for GEO_WM_ITERS steps through the CLI's setup
    (``wm_train``).  And the refusal of 16 x 8 (width 128) before a model is
    built.  Returns each kernel's row at each geometry (keyed (kernel,
    geometry); K1's forward is timed only where VARIANTS has a row for it),
    each trained geometry's launches (under "train" its Trainer.train run's,
    under "wm" its WatermarkTrainer.train run's) and its training numbers."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    try:
        NGPModel(t_ngp.NGPConfig(n_levels=16, n_features=8), device=dev)
    except NotImplementedError as e:
        if "ROADMAP queue 3" not in str(e):
            raise
        log(f"[geometry] 16 x 8 refused up front: {str(e)[:120]}...")
    else:
        raise AssertionError("16 x 8 (encoding width 128) was not refused on the card")

    rows, launches, stats = {}, {}, {}
    for geo, (L, F) in GEOMETRIES.items():
        gen = torch.Generator(device=dev).manual_seed(23)
        m = make_model(dev, levels=L, features=F)
        cfg, S_log2 = m.cfg, m.cfg.log2_hashmap_size
        fp = t_ngp.field_params(m.params, cfg)
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        fp32 = t_ngp.field_params(m.params, cfg32)
        aabb, grid = default_aabb(m.rc), m.occ.occupancy
        # K4's built input width: the rows K1 writes and K4 reads (the
        # columns past L*F zero)
        pitch = t_ngp.feature_pitch(cfg)
        # serving shapes: K1 bit-exact, then K4 on both routes
        ro, rd, _ = serve_chunk(dev)
        mk = t_march.march_rays_aabb(ro, rd, aabb, grid, **march_kwargs(m, None))
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        del mk
        feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions, S_log2,
                                  table_g=fp["hash_table_g"], pitch=pitch)
        same = torch.equal(feat[:, :L * F], t_hash.hash_encode_plain(
            x01, fp["hash_table"], cfg.resolutions, S_log2, table_g=fp["hash_table_g"]))
        pad_zero = not bool(feat[:, L * F:].any())
        log(f"[geometry] {geo}: K1 forward at M={x01.shape[0]}, L={L}, F={F}, pitch {pitch} "
            f"equal to its plain version bit for bit: {same} (limit: equal); the "
            f"{pitch - L * F} padded columns exactly 0: {pad_zero}")
        if not (same and pad_zero):
            raise AssertionError(f"K1 ({geo}) differs from its plain version")
        krows = {"K4_field": k4_forward(fp, cfg, feat, dirs)[0],
               "K4_field_f32": k4_forward(fp32, cfg32, feat, dirs)[0]}
        if ("K1_hash_encode", geo, None) in VARIANTS.values():
            krows["K1_hash_encode"] = dict(k1_timing(x01, fp, cfg.resolutions, S_log2, pitch),
                                           max_abs_err=0.0)
        del feat, x01, dirs
        # train step shapes: K1's and K4's full backward
        ro, rd = train_rays(dev)
        noise = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
        mk = t_march.march_rays_aabb(ro, rd, aabb, grid, noise=noise, **dict(
            march_kwargs(m, None), budget=TRAIN_BUDGET))
        live = mk["mask"].reshape(-1).float()
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        del mk
        krows["K1_hash_encode_bwd"] = k1_bwd(x01, live, fp["hash_table"].shape[0],
                                             cfg.resolutions, S_log2, F, gen, pitch)
        with torch.no_grad():
            feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions, S_log2,
                                      table_g=fp["hash_table_g"], pitch=pitch)
        g_sigma = torch.randn((x01.shape[0],), generator=gen, device=dev) * 1e-4 * live
        g_rgb = torch.randn((x01.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
        krows["K4_field_bwd"] = k4_bwd(fp, cfg, feat, dirs, g_sigma, g_rgb)
        krows["K4_field_bwd_f32"] = k4_bwd(fp32, cfg32, feat, dirs, g_sigma, g_rgb)
        del feat, x01, dirs, g_sigma, g_rgb, live
        bg = torch.rand((TRAIN_RAYS, 3), generator=gen, device=dev)
        clean_steps(dev, ro, rd, bg, noise, L, F)
        # watermark step shapes: K4's feature-only backward, then the whole step
        mw = make_wm_model(dev, levels=L, features=F)
        x = wm_step_inputs(dev)
        fpw = t_ngp.field_params(mw.backbone, cfg)
        fpw32 = t_ngp.field_params(mw.backbone, cfg32)
        mk = t_march.march_rays_aabb(
            torch.cat([x["ro_b"].reshape(-1, 3), x["ct_o"]]),
            torch.cat([x["rd_b"].reshape(-1, 3), x["ct_d"]]), default_aabb(mw.rc),
            mw.occ.occupancy, min_near=0.2, bound=1.0, max_steps=1024, budget=256)
        live = mk["mask"].reshape(-1).float()
        x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
        dirs = mk["dirs"].reshape(-1, 3).contiguous()
        del mk
        with torch.no_grad():
            feat = t_hash.hash_encode(x01, fpw["hash_table"], cfg.resolutions, S_log2,
                                      table_g=fpw["hash_table_g"], pitch=pitch)
        g_sigma = torch.randn((x01.shape[0],), generator=gen, device=dev) * 1e-4 * live
        g_rgb = torch.randn((x01.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
        krows["K4_field_bwd_feat"] = k4_bwd_feat(fpw, cfg, feat, dirs, g_sigma, g_rgb)
        krows["K4_field_bwd_feat_f32"] = k4_bwd_feat(fpw32, cfg32, feat, dirs, g_sigma, g_rgb)
        del feat, x01, dirs, g_sigma, g_rgb, live, mw, fpw, fpw32, m, fp, fp32
        wm_steps(dev, x, L, F)
        rows.update({(k, geo): r for k, r in krows.items()})
        if geo not in GEO_TRAINED:
            gc.collect()
            continue
        # the main path: Trainer.train with this geometry
        r = train_case(dev, TRAIN_BALL, GEO_ITERS, levels=L, features=F)
        stats[geo] = {k: r[k] for k in ("seconds", "psnr0", "psnr1")}
        log(f"[geometry] {geo}: Trainer.train {r['trainer'].global_step} steps in "
            f"{r['seconds']:.2f} s, held-out PSNR {r['psnr0']:.2f} -> {r['psnr1']:.2f} dB "
            f"(limit at {' and '.join(GEO_QUALITY)}: +6 dB); launches {r['launches']}")
        for name in CLEAN_TRAIN:
            if r["launches"][name] == 0:
                raise AssertionError(f"{name} was not launched by Trainer.train at {geo}")
        k4_route(r["launches"], torch.bfloat16, ("K4_field", "K4_field_bwd"),
                 f"Trainer.train at {geo}")
        if geo in GEO_QUALITY and not r["psnr1"] >= r["psnr0"] + 6.0:
            raise AssertionError(f"{geo}: held-out PSNR {r['psnr1']:.2f} dB < untrained "
                                 f"{r['psnr0']:.2f} + 6 dB")
        # the main path: the watermark stage on this geometry's trained backbone
        with tempfile.TemporaryDirectory() as workdir:
            w = wm_train(dev, r["trainer"].model, workdir, GEO_WM_ITERS,
                         ["--n_levels", str(L), "--n_features", str(F)], f"geometry wm {geo}")
        launches[geo] = {"train": r["launches"], "wm": w["launches"]}
        stats[geo].update(wm_steps=w["steps"], wm_seconds=w["seconds"])
        del r, w
        gc.collect()  # the trainers hold cycles: free their models before the next phase
    return rows, launches, stats


# ---------------------------------------------------------------- phase 6
def phase_serve(dev, workdir):
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb
    from nerf_signature_tpu_torch.train.metrics import PSNRMeter
    from nerf_signature_tpu_torch.train.trainer import Trainer

    opt = type("Opt", (), {"max_ray_batch": CHUNK, "lr": 1e-2, "iters": 30000})()
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
        want = N_VIEWS * per_view if name in FORWARD else 0  # serving runs no backward
        if n != want:
            raise AssertionError(f"{name}: {n} launches while serving, expected {want}")

    # ---- view 0 through the kernels and through the plain versions
    m = trainer.model
    params_backup, m.params = m.params, trainer.eval_params()
    try:
        t0 = time.time()
        img_k = m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True)["image"]
        torch.cuda.synchronize()
        t_kernel = time.time() - t0
        view = view_profile(lambda: m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True))
        if view is None:
            log("[serve] view 0 under torch.profiler: not measured (no trace held device events)")
        else:
            log(f"[serve] view 0 under torch.profiler: device ms by kernel "
                f"{ {k: round(view[k], 3) for k in VIEW_KERNELS} }, K1-K4 "
                f"{view['kernels_ms']:.2f} ms, all device work {view['device_ms']:.2f} ms, "
                f"wall {view['wall_ms']:.1f} ms")
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
    if not (0.0 < frac < 1.0 and n["K1_hash_encode"] > 0):
        raise AssertionError("grid rebuild did not run through K1")
    k4_route(n, torch.bfloat16, ("K4_field",), "grid rebuild")
    return launches, view


# ---------------------------------------------------------------- phase 7
class BallViews:
    """The train loader: TRAIN_VIEWS orbit views of the analytic ball of
    ``radius`` at RES x RES; each step draws TRAIN_RAYS random pixels of one
    view (shuffled per epoch) and colours them analytically (no images are
    stored)."""

    def __init__(self, radius, seed=5):
        self.radius = radius
        self.poses = orbit_poses(TRAIN_VIEWS, ORBIT_RADIUS, seed=seed)
        fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
        self.intrinsics = np.array([fl, fl, RES / 2, RES / 2])
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return TRAIN_VIEWS

    def __iter__(self):
        from nerf_signature_tpu_torch.data.rays import get_rays

        for v in self.rng.permutation(TRAIN_VIEWS):
            r = get_rays(self.poses[v:v + 1], self.intrinsics, RES, RES, TRAIN_RAYS,
                         rng=self.rng)
            yield {"H": RES, "W": RES, "rays_o": r["rays_o"], "rays_d": r["rays_d"],
                   "images": ball_rgba(r["rays_o"], r["rays_d"], radius=self.radius)}


def held_out_psnr(m, params, rays, gt):
    backup, m.params = m.params, params
    try:
        img = m.render(rays["rays_o"][0], rays["rays_d"][0], staged=True)["image"]
    finally:
        m.params = backup
    if not (bool(torch.isfinite(img).all()) and img.shape == gt.shape):
        raise AssertionError("held-out render is not finite or has the wrong shape")
    return psnr(img, gt)


def watch_adaptations(trainer):
    """Count the moves of the march budget, the compaction and the group
    budget: their values are compared before every train step.  Returns the
    counts and the compare function (call it once more after training)."""
    m = trainer.model
    moves = {"budget": 0, "compaction": 0, "group budget": 0}
    last = [(m.train_budget, m.rc.compact_frac, m.rc.group_budget)]

    def note():
        now = (m.train_budget, m.rc.compact_frac, m.rc.group_budget)
        for k, a, b in zip(moves, last[0], now):
            moves[k] += a != b
        last[0] = now

    step = trainer.train_step_data

    def watched(data):
        note()
        return step(data)

    trainer.train_step_data = watched
    return moves, note


def train_case(dev, radius, iters, group_budget=-1, levels=16, features=2):
    """A fresh full-width model (standard init; ``levels`` x ``features``
    table geometry) trained by the port's Trainer.train with the CLI's train
    defaults on BallViews(radius).
    Returns the trainer, its loader, the loop's wall seconds, the kernels'
    launches, peak memory, the held-out view's PSNR before and after, and the
    adaptations' moves."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.trainer import Trainer

    opt = SimpleNamespace(lr=1e-2, iters=iters, num_rays=TRAIN_RAYS, max_steps=1024,
                          update_extra_interval=16, compact_frac=-1, group_budget=group_budget,
                          max_ray_batch=CHUNK, patch_size=1, color_space="srgb")
    model = NGPModel(NGPConfig(bound=1.0, n_levels=levels, n_features=features),
                     min_near=0.2, density_thresh=10.0, dt_gamma=0.0, max_steps=1024,
                     grid_size=128, seed=2, train_budget=TRAIN_BUDGET, infer_budget=256,
                     device=dev)
    loader = BallViews(radius)
    held = view_rays(orbit_poses(1, ORBIT_RADIUS, seed=9))
    rgba = ball_rgba(held["rays_o"][0], held["rays_d"][0], radius=radius)
    gt = torch.from_numpy(rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])).to(dev)
    # no workspace: no per-epoch checkpoint (params, EMA and Adam's moments,
    # ~270 MB each) inside the timed loop; the CPU tests cover the ring buffer
    trainer = Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch")
    moves, note = watch_adaptations(trainer)
    psnr0 = held_out_psnr(model, trainer.eval_params(), held, gt)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    trainer.train(loader, None, max_epochs=math.ceil(iters / TRAIN_VIEWS))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    note()
    psnr1 = held_out_psnr(model, trainer.eval_params(), held, gt)
    return dict(trainer=trainer, loader=loader, seconds=seconds, launches=launches,
                peak=peak, psnr0=psnr0, psnr1=psnr1, moves=moves)


def adaptation_state(model):
    occ = float(model.occ.occupancy.float().mean())
    return (f"final budget {model.train_budget}, compaction {model.rc.compact_frac}, "
            f"group budget {model.rc.group_budget}, grid {occ:.2%} occupied after "
            f"{int(model.occ.iter_density)} updates")


def phase_train(dev):
    r = train_case(dev, TRAIN_BALL, TRAIN_ITERS)
    trainer, seconds, launches = r["trainer"], r["seconds"], r["launches"]
    steps = trainer.global_step
    psnr0, psnr1 = r["psnr0"], r["psnr1"]
    losses = trainer.stats["loss"]
    log(f"[train] {steps} steps of {TRAIN_RAYS} rays in {seconds:.2f} s (grid updates and "
        f"mark_untrained_grid included): {steps * TRAIN_RAYS / seconds:.0f} "
        f"train rays/s, {seconds / steps * 1e3:.2f} ms a step; peak memory "
        f"{r['peak']:.2f} GiB")
    log(f"[train] epoch losses {[round(v, 6) for v in losses]}")
    log(f"[train] {adaptation_state(trainer.model)}; moves {r['moves']}")
    log(f"[train] held-out view PSNR vs the analytic ball: untrained {psnr0:.2f} dB, "
        f"trained {psnr1:.2f} dB (limit: +6 dB)")
    log(f"[train] launches during Trainer.train: {launches}")
    profile_steps(trainer, r["loader"])
    if steps != TRAIN_ITERS:
        raise AssertionError(f"Trainer.train ran {steps} steps, expected {TRAIN_ITERS}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not psnr1 >= psnr0 + 6.0:
        raise AssertionError(f"held-out PSNR {psnr1:.2f} dB < untrained {psnr0:.2f} + 6 dB")
    for name in SOURCES:
        if name in CLEAN_TRAIN and launches[name] == 0:
            raise AssertionError(f"{name} was not launched by Trainer.train")
    k4_route(launches, torch.bfloat16, ("K4_field", "K4_field_bwd"), "Trainer.train")
    trained = trainer.model  # the wm phase's frozen backbone
    del r, trainer

    # ---- the adaptations' case: each of the three must move at least once
    a = train_case(dev, ADAPT_BALL, ADAPT_ITERS)
    log(f"[train adapt] ball of radius {ADAPT_BALL}, {a['trainer'].global_step} steps in "
        f"{a['seconds']:.2f} s: moves {a['moves']}; {adaptation_state(a['trainer'].model)}; "
        f"held-out PSNR {a['psnr0']:.2f} -> {a['psnr1']:.2f} dB")
    for name, n in a["moves"].items():
        if n == 0:
            raise AssertionError(f"the {name} adaptation never moved in {ADAPT_ITERS} steps")
    return dict(launches=launches, seconds=seconds, steps=steps,
                rays_per_s=steps * TRAIN_RAYS / seconds, psnr0=psnr0, psnr1=psnr1,
                model=trained)


def profile_steps(trainer, loader, n=16, tag="profile", step=None):
    """torch.profiler over n more train steps (after the timed run): the
    device's busy time by kernel, from the trace's device events (kernels,
    copies, memsets; one stream, so they do not overlap), and its idle share
    of the wall clock.  ``step(data)`` defaults to ``trainer.train_step_data``.
    Returns the wall and busy ms a step and the idle share."""
    from itertools import islice

    step = step or trainer.train_step_data
    batches = list(islice(iter(loader), n))

    def work():
        t0 = time.time()
        for data in batches:
            step(data)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e6

    by_name, wall_us = traced(work, tag)
    if by_name is None:
        log(f"[{tag}] {n} train steps: device busy time not measured (no trace held "
            f"device events)")
        return {"wall_ms": wall_us / n / 1e3, "busy_ms": None, "idle_share": None}
    busy_us = sum(by_name.values())
    log(f"[{tag}] {n} train steps: wall {wall_us / n / 1e3:.3f} ms a step, device busy "
        f"{busy_us / n / 1e3:.3f} ms a step (idle share {1 - busy_us / wall_us:.1%}), "
        f"{len(by_name)} distinct device functions")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        log(f"[{tag}]   {us / n / 1e3:8.4f} ms a step ({us / busy_us:6.1%})  {name[:90]}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "idle_share": 1 - busy_us / wall_us}


# ---------------------------------------------------------------- phase 8
def orbit_poses_rh(n, radius, seed):
    """Right-handed orbit poses (scipy's slerp of the test poses needs
    det > 0), in the ngp convention."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(np.pi / 3, 2 * np.pi / 3, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    c = np.stack([radius * np.sin(th) * np.sin(ph), radius * np.cos(th),
                  radius * np.sin(th) * np.cos(ph)], -1).astype(np.float32)
    fwd = -c / np.linalg.norm(c, axis=-1, keepdims=True)
    right = np.cross(np.tile([0.0, -1.0, 0.0], (n, 1)), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = np.stack([right, np.cross(fwd, right), fwd], -1)
    poses[:, :3, 3] = c
    return poses


def write_scene(root, scale=0.8):
    """A Blender-style scene of the analytic ball: transforms_{train,test}.json
    with h = w = 800 (400 at --downscale 2), the Blender camera angle, 32
    train and 2 test orbit poses.  No images: the watermark stage renders
    its ground truth with the frozen backbone."""
    os.makedirs(root, exist_ok=True)
    for split, n, seed in (("train", TRAIN_VIEWS, 31), ("test", 2, 32)):
        frames = []
        for i, p in enumerate(orbit_poses_rh(n, ORBIT_RADIUS, seed)):
            m = np.eye(4, dtype=np.float32)  # inverse of nerf_matrix_to_ngp
            m[0] = [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] / scale]
            m[1] = [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] / scale]
            m[2] = [p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] / scale]
            frames.append({"file_path": f"r_{i}", "transform_matrix": m.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": BLENDER_ANGLE_X, "h": RES, "w": RES, "frames": frames},
                      f)
    return root


def pick_key_blocks(model, ws, seed):
    """The key pose (a random orbit pose, as the provider draws it) and the
    32 key blocks of its render with the largest pixel variance, saved where
    the CLI loads them (the JPEG-ratio picker needs PIL, which this machine
    may lack)."""
    from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses

    pose = rand_poses(np.random.default_rng(seed), 1, radius=ORBIT_RADIUS)
    fl = WM_RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    r = get_rays(pose, (fl, fl, WM_RES / 2, WM_RES / 2), WM_RES, WM_RES, -1)
    img = model.render(r["rays_o"][0], r["rays_d"][0], None, staged=True)["image"]
    img = img.float().cpu().numpy().reshape(WM_RES, WM_RES, 3)
    B = WM_BLOCK
    blocks = img[:32 * B, :32 * B].reshape(32, B, 32, B, 3).transpose(0, 2, 1, 3, 4)
    var = blocks.reshape(32 * 32, -1).var(-1)
    sel = np.argsort(-var)[:WM_BITS]
    rows, cols = sel // 32, sel % 32
    coords = np.stack([rows * B, cols * B, (rows + 1) * B, (cols + 1) * B], 1).astype(np.int64)
    np.save(os.path.join(ws, "key_poses.npy"), pose)
    np.save(os.path.join(ws, "key_blocks.npy"), coords)
    return float(var[sel].min())


def wm_train(dev, backbone_model, workdir, iters=WM_ITERS, extra=(), tag="wm"):
    """The watermark stage's main path as its CLI drives it, on
    ``backbone_model`` saved as the clean checkpoint: main_nerf_wtmk's parser
    and setup (the README stage-2 recipe for ``iters`` steps, plus ``extra``
    flags), the key blocks, resolve_auto_compaction, then
    WatermarkTrainer.train with the launch counts set to 0 just before it,
    its epochs timed (no checkpoint I/O).  Returns the model, trainer,
    loader factory, the run's launches, steps, seconds and peak memory."""
    from nerf_signature_tpu_torch import main_nerf_wtmk
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.checkpoint import save_checkpoint

    clean = os.path.join(workdir, "clean", "ngp_ep0016.ckpt")
    save_checkpoint(clean, {"params": backbone_model.params, "occ": backbone_model.occ,
                            "epoch": 16, "global_step": TRAIN_ITERS})
    scene = write_scene(os.path.join(workdir, "scene"))
    ws = os.path.join(workdir, "ws_wm")
    # only the final checkpoint: per-epoch saves of params, tables and Adam's
    # moments (~0.9 GB each) would sit inside the timed loop
    opt = main_nerf_wtmk.parse([scene, "--workspace", ws, "--ckpt", clean,
                                "--save_interval", "1000"] + WM_RECIPE
                               + ["--iters", str(iters), *extra])
    t0 = time.time()
    model, trainer, make_loader = main_nerf_wtmk.setup(opt)
    os.makedirs(ws, exist_ok=True)
    var_min = pick_key_blocks(model, ws, opt.seed)
    loader = make_loader("train", 1, 100)
    set_up = time.time() - t0
    trainer.resolve_auto_compaction(loader)
    log(f"[{tag}] set-up {set_up:.2f} s (checkpoint load, key render, {len(loader)} pseudo-GT "
        f"views of {loader.H}x{loader.W}); key blocks {loader.images_block.shape}, least "
        f"block variance {var_min:.4g}; resolved compaction {model.rc.compact_frac}, group "
        f"budget {model.rc.group_budget}")

    epoch_s = []
    run_epoch = trainer.train_one_epoch

    def timed_epoch(ldr):
        t = time.time()
        out = run_epoch(ldr)  # ends in a host sync (the epoch's mean loss)
        epoch_s.append(time.time() - t)
        return out

    trainer.train_one_epoch = timed_epoch
    max_epochs = math.ceil(iters / len(loader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    trainer.train(loader, None, None, max_epochs)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.train_one_epoch = run_epoch
    steps, seconds = trainer.global_step, sum(epoch_s)
    log(f"[{tag}] {steps} steps of {WM_STEP_RAYS} rays in {seconds:.2f} s: "
        f"{steps * WM_STEP_RAYS / seconds:.0f} watermark rays/s, {seconds / steps * 1e3:.2f} ms "
        f"a step; peak memory {peak:.2f} GiB")
    log(f"[{tag}] epoch lossw {[round(v, 5) for v in trainer.stats['lossw']]}")
    log(f"[{tag}] launches during WatermarkTrainer.train: {launches}")
    if steps != iters:
        raise AssertionError(f"WatermarkTrainer.train ran {steps} steps, expected {iters}")
    for name in WM_TRAIN:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by WatermarkTrainer.train ({tag})")
    if launches["K4_field_bwd"] + launches["K4_field_bwd_f32"] != 0:
        raise AssertionError(f"the frozen backbone's weight gradient was computed ({tag})")
    k4_route(launches, torch.bfloat16, ("K4_field", "K4_field_bwd_feat"),
             f"WatermarkTrainer.train ({tag})")
    return dict(model=model, trainer=trainer, make_loader=make_loader, loader=loader,
                launches=launches, steps=steps, seconds=seconds, peak=peak)


def phase_wm(dev, backbone_model, workdir):
    """The watermark stage at the README stage-2 recipe on the backbone the
    train phase trained (``wm_train``, 1000 iterations), then ownership
    verification and test images."""
    from nerf_signature_tpu_torch.ops import _cuda

    w = wm_train(dev, backbone_model, workdir)
    m, trainer, make_loader, loader = w["model"], w["trainer"], w["make_loader"], w["loader"]
    launches, steps, seconds, peak = w["launches"], w["steps"], w["seconds"], w["peak"]
    lossw, lossi = trainer.stats["lossw"], trainer.stats["lossi"]
    log(f"[wm] epoch lossi {[round(v, 7) for v in lossi]}")

    res = {"launches": launches, "steps": steps, "seconds": seconds,
           "rays_per_s": steps * WM_STEP_RAYS / seconds, "step_ms": seconds / steps * 1e3,
           "peak_gib": peak, "compact_frac": m.rc.compact_frac,
           "group_budget": m.rc.group_budget}
    meter = trainer.metrics_message[0]
    for kind in ("none", "noise"):
        trainer.distortion = kind
        trials = make_loader("test", 1, WM_TRIALS)  # renders the key view
        _cuda.reset_launch_counts()
        acc = trainer.test_bitacc(trials)
        per_msg = {k: v / WM_TRIALS for k, v in _cuda.launch_counts().items() if v}
        res[f"bitacc_{kind}"] = acc
        res[f"log10p_{kind}"] = meter.pvalue()
        res[f"s_per_message_{kind}"] = trainer.bitacc_seconds / WM_TRIALS
        log(f"[wm] test_bitacc --distortion {kind}: bit accuracy {acc:.4f} over {meter.N} "
            f"messages, log10 p {meter.pvalue():.1f}; {trainer.bitacc_seconds / WM_TRIALS:.4f} s "
            f"a message; launches a message {per_msg}")
    trainer.distortion = "none"
    images = trainer.test_image(make_loader("test_image", 2, 4))
    res["test_image_psnr"] = float(images["PSNR"])
    profile_steps(trainer, loader, tag="wm profile",
                  step=lambda data: trainer.train_step_data(data, trainer.random_message()))

    if not lossw[-1] <= 0.5 * lossw[0]:
        raise AssertionError(f"lossw did not halve: first epoch {lossw[0]}, last {lossw[-1]}")
    if not res["bitacc_none"] >= 0.95:
        raise AssertionError(f"bit accuracy {res['bitacc_none']:.4f} < 0.95")
    if not images["PSNR"] >= 30.0:
        raise AssertionError(f"test_image PSNR {images['PSNR']:.2f} dB < 30 dB")
    return res


SOURCES = {
    "K1_hash_encode": ("nerf_signature_tpu_torch/csrc/hashenc.cu",
                       "nerf_signature_tpu/ops/hashenc.py:250"),
    "K2_march": ("nerf_signature_tpu_torch/csrc/marcher.cu",
                 "nerf_signature_tpu/ops/marching.py:310"),
    "K3_composite": ("nerf_signature_tpu_torch/csrc/composite.cu",
                     "nerf_signature_tpu/ops/composite.py:25"),
    "K4_field": ("nerf_signature_tpu_torch/csrc/field_mma.cu",
                 "nerf_signature_tpu/models/mlp.py:30"),
    "K4_field_f32": ("nerf_signature_tpu_torch/csrc/field.cu",
                     "nerf_signature_tpu/models/mlp.py:30"),
    "K1_hash_encode_bwd": ("nerf_signature_tpu_torch/csrc/hashenc.cu",
                           "nerf_signature_tpu/ops/hashenc.py:124"),
    "K3_composite_bwd": ("nerf_signature_tpu_torch/csrc/composite.cu",
                         "nerf_signature_tpu/ops/composite.py:25"),
    "K4_field_bwd": ("nerf_signature_tpu_torch/csrc/field_mma_bwd_full.cu",
                     "nerf_signature_tpu/models/mlp.py:30"),
    "K4_field_bwd_f32": ("nerf_signature_tpu_torch/csrc/field.cu",
                         "nerf_signature_tpu/models/mlp.py:30"),
    "K4_field_bwd_feat": ("nerf_signature_tpu_torch/csrc/field_mma_bwd.cu",
                          "nerf_signature_tpu/models/mlp.py:30"),
    "K4_field_bwd_feat_f32": ("nerf_signature_tpu_torch/csrc/field_feat.cu",
                              "nerf_signature_tpu/models/mlp.py:30"),
    "K9_msg_table": ("nerf_signature_tpu_torch/csrc/msgtable.cu",
                     "nerf_signature_tpu/models/message.py:45"),
    "K9_msg_table_bwd": ("nerf_signature_tpu_torch/csrc/msgtable.cu",
                         "nerf_signature_tpu/models/message.py:45"),
    "P1_gather": ("nerf_signature_tpu_torch/csrc/gather.cu",
                  "scripts_dev/pallas_gather_probe.py:46"),
}
# rows of a kernel of SOURCES at another table geometry (the geometry phase's
# shapes, launches of that geometry's runs) or at another step's shapes
# (launches of that step's run): name -> (kernel, geometry, step run)
VARIANTS = {
    # the 8-level geometries: K1 with 4 features a row (8 x 4), K4 at
    # encoding width 16 (8 x 2) on each route
    "K1_hash_encode_f4": ("K1_hash_encode", "8x4", None),
    "K1_hash_encode_bwd_f4": ("K1_hash_encode_bwd", "8x4", None),
    "K4_field_in16": ("K4_field", "8x2", None),
    "K4_field_in16_f32": ("K4_field_f32", "8x2", None),
    "K4_field_bwd_in16": ("K4_field_bwd", "8x2", None),
    "K4_field_bwd_in16_f32": ("K4_field_bwd_f32", "8x2", None),
    "K4_field_bwd_feat_in16": ("K4_field_bwd_feat", "8x2", None),
    "K4_field_bwd_feat_in16_f32": ("K4_field_bwd_feat_f32", "8x2", None),
    # 16 x 4: K1 with 4 features a row at 16 levels, K4 at encoding width 64
    # on each route
    "K1_hash_encode_16x4": ("K1_hash_encode", "16x4", None),
    "K1_hash_encode_bwd_16x4": ("K1_hash_encode_bwd", "16x4", None),
    "K4_field_in64": ("K4_field", "16x4", None),
    "K4_field_in64_f32": ("K4_field_f32", "16x4", None),
    "K4_field_bwd_in64": ("K4_field_bwd", "16x4", None),
    "K4_field_bwd_in64_f32": ("K4_field_bwd_f32", "16x4", None),
    "K4_field_bwd_feat_in64": ("K4_field_bwd_feat", "16x4", None),
    "K4_field_bwd_feat_in64_f32": ("K4_field_bwd_feat_f32", "16x4", None),
    # 12 x 2: K4 at encoding width 24, run at the built 32 on features K1
    # writes zero-padded, on each route
    "K4_field_in24": ("K4_field", "12x2", None),
    "K4_field_in24_f32": ("K4_field_f32", "12x2", None),
    "K4_field_bwd_in24": ("K4_field_bwd", "12x2", None),
    "K4_field_bwd_in24_f32": ("K4_field_bwd_f32", "12x2", None),
    "K4_field_bwd_feat_in24": ("K4_field_bwd_feat", "12x2", None),
    "K4_field_bwd_feat_in24_f32": ("K4_field_bwd_feat_f32", "12x2", None),
    # K1 with rows of 1 feature (24 x 1, output pitch 32) and of 8 (8 x 8)
    "K1_hash_encode_f1": ("K1_hash_encode", "24x1", None),
    "K1_hash_encode_bwd_f1": ("K1_hash_encode_bwd", "24x1", None),
    "K1_hash_encode_f8": ("K1_hash_encode", "8x8", None),
    "K1_hash_encode_bwd_f8": ("K1_hash_encode_bwd", "8x8", None),
    # K1's backward into the message's effective table (the watermark step)
    "K1_hash_encode_bwd_wm": ("K1_hash_encode_bwd", None, "wm"),
    # K3 at the clean step's and the watermark step's shapes
    "K3_composite_clean": ("K3_composite", None, "train"),
    "K3_composite_wm": ("K3_composite", None, "wm"),
    "K3_composite_bwd_wm": ("K3_composite_bwd", None, "wm"),
}
FORWARD = ("K1_hash_encode", "K2_march", "K3_composite", "K4_field")
CLEAN_TRAIN = FORWARD + ("K1_hash_encode_bwd", "K3_composite_bwd", "K4_field_bwd")
# the watermark step: the forward kernels, K9 both ways, K1's and K3's
# backward and K4's feature-only backward (the backbone is frozen)
WM_TRAIN = FORWARD + ("K1_hash_encode_bwd", "K3_composite_bwd", "K4_field_bwd_feat",
                      "K9_msg_table", "K9_msg_table_bwd")
# rows measured in the kernels phase (the serving or the probe's shapes)
KERNEL_PHASE = FORWARD + ("K4_field_f32", "P1_gather")
# K4's fp32 route (SIMT): off the bf16 main path, run by the fp32 whole-step checks
FP32_ROUTE = ("K4_field_f32", "K4_field_bwd_f32", "K4_field_bwd_feat_f32")
# the sources of the tensor-core kernels, which must build without spills
TENSOR_CORE_SOURCES = ("field_mma.cu", "field_mma_bwd.cu", "field_mma_bwd_full.cu")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    import nerf_signature_tpu_torch  # noqa: F401  (fails outside the repo)

    gpu_line = phase_device()
    dev = torch.device("cuda")
    build_s = phase_build()
    kernels = phase_kernels(dev)
    train_kernels = phase_train_kernels(dev)
    geometry, geometry_launches, geometry_stats = phase_geometry(dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, view = phase_serve(dev, workdir)
    train = phase_train(dev)
    with tempfile.TemporaryDirectory() as workdir:
        wm = phase_wm(dev, train.pop("model"), workdir)
    rows, modelled = [], {}
    entries = [(name, name, None, None) for name in SOURCES] + [
        (name,) + v for name, v in VARIANTS.items()]
    for name, base, geo, run in entries:
        # forward kernels: the serving path's numbers and launches (slice 1);
        # backward kernels: the train step's shapes and Trainer.train's
        # launches (slice 2); the watermark kernels: the watermark step's
        # shapes and WatermarkTrainer.train's launches (slice 3); P1 is on no
        # entry point's path (0 launches there), timed at the probe's shapes;
        # K4's SIMT kernels are the fp32 route, off the bf16 main path; a
        # geometry's rows: the geometry phase's shapes, launches of
        # Trainer.train at that geometry (K4's feature-only backward: of
        # WatermarkTrainer.train there); a row at another step's shapes:
        # launches of that step's run.  Every row also carries the train
        # and watermark runs' launches.
        src, replaces = SOURCES[base]
        if geo:
            r = geometry[(base, geo)]
            train_n, wm_n = (geometry_launches[geo][k][base] for k in ("train", "wm"))
            if base in FP32_ROUTE:
                n, path = 0, f"fp32 route at {geo} (the fp32 whole-step checks)"
            elif base not in CLEAN_TRAIN:
                n, path = wm_n, f"wm at {geo}"
            else:
                n, path = train_n, f"train at {geo}"
        else:
            r = kernels[name] if name in KERNEL_PHASE else train_kernels[name]
            train_n, wm_n = train["launches"][base], wm["launches"][base]
            if run:
                n, path = {"train": train_n, "wm": wm_n}[run], run
            elif name in FORWARD:
                n, path = launches[name], "serve"
            elif name in CLEAN_TRAIN:
                n, path = train_n, "train"
            elif name in WM_TRAIN:
                n, path = wm_n, "wm"
            elif name in FP32_ROUTE:
                n, path = 0, "fp32 route (the fp32 whole-step checks)"
            else:
                n, path = 0, "none (dev probe)"
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "path": path, "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "train_launches": train_n, "wm_launches": wm_n}
        for extra in ("device_ms", "plain_device_ms", "library_device_ms", "rel_l2", "full_bwd_ms",
                      "share_not_equal", "rel_l2_vs_full_bwd", "needs"):
            if extra in r:
                row[extra] = r[extra]
        if name in FP32_ROUTE:
            row["fp32_step_launches"] = {
                step: c[name] for step, c in
                train_kernels["K4_field_bwd_feat_f32"]["fp32_step_launches"].items()
                if c.get(name)}
        if name == "K2_march":  # with perturbation noise at the train step's shapes
            t = train_kernels[name]
            row.update(train_ms=t["ms"], train_device_ms=t["device_ms"],
                       train_plain_ms=t["plain_ms"], train_bound_ms=t["bound_ms"],
                       train_max_abs_err=t["max_abs_err"])
        rows.append(row)
        if "atomics_modelled" in r:
            modelled[name] = r["atomics_modelled"]
    wm.pop("launches")
    # K1 backward's atomics as kernel_cases.k1_bwd_atomics counts them from
    # the design on each row's inputs: a model, not a reading of the card
    print(json.dumps({"k1_bwd_atomics_modelled": modelled}))
    print(json.dumps({"kernels": rows, "build_s": build_s, "view": view, "train": {
        k: train[k] for k in ("steps", "seconds", "rays_per_s", "psnr0", "psnr1")},
        "geometry": geometry_stats, "wm": wm,
        "device_ms_from_events": len(EVENT_FALLBACKS)}, default=float))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
