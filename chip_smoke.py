#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc).  Phases, each failing loudly:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the kernels (csrc/*.cu, sm_90a), one process a
               source, all started together; the tensor-core K4 kernels,
               K4's tiled SIMT forward, feature-only and full backward
               (every width) and K8's background colour (every row width)
               must report 0 spill bytes (ptxas -v);
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
               one through the plain versions, in bf16 and in fp32 (the fp32
               step once more under torch.profiler: K4's full backward's
               device ms and launches in it, its live samples); then at
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
               row, width 24), 8 x 8 (K1 with 8 features a row, width 64)
               and 16 x 8 (width 128: K4's tensor-core kernels alone, bf16):
               K1 forward (bit-exact; the padded columns exactly 0) and
               backward (its atomics modelled), K4 forward, full and
               feature-only backward on both routes (bf16 alone at 16 x 8;
               ptxas's registers and spills and the compiled plan's shared
               memory and blocks an SM, as the runtime reports them, beside
               its row), each against its plain
               version; a whole clean and a whole watermark step through the
               kernels against the plain versions (bf16, fp32; bf16 at 16 x
               8); but for 32 x 2, Trainer.train for 128 steps on the
               radius-0.7 ball (launches; at 8 x 4, 16 x 4, 12 x 2 and 16 x
               8 the held-out PSNR must rise 6 dB), then 64 watermark steps
               on that backbone; 16 x 8 in fp32 and 32 x 8 in bf16 (widths
               above the routes' widest builds, 64 and 128) must be refused
               before a model is built;
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
               >= 30 dB.  Then, on that model: test_bitacc with --distortion
               jpeg, jpeg_dct's time at the key blocks' shape and one whole
               jpeg step against the plain versions (the quantiser's
               rounding flips between the two paths counted and held to 1%
               of the 8x8 blocks); the attack suites as
               the CLI's --test calls them, each run's launches counted
               (``attack_launches``): the 13-attack sweep at 50 messages
               (one ``{"attacks": ...}`` line; ``none`` >= 0.95), the
               parameter attack at epsilon 1e-3 for 100 steps (every leaf in
               the ball, the decoder bit-identical; test_bitacc after), the
               finetuning attack for 100 steps on the hash table (only it
               moves; test_bitacc and test_image after) and 20 on every
               backbone leaf (K4's full backward), each profiled over 16
               more steps and one step of each against its plain version;
               finally a second WatermarkTrainer.train at the recipe with
               --n_views 2 for 400 steps (lossw halves; bit accuracy,
               watermark rays/s;
               one whole two-view step against the plain versions);
  9. device loop — K5 (sample compaction, csrc/compact.cu): pack, unpack
               and unpack backward bit-exact against their plain versions
               on kernel_cases' edges and at the clean step's (4096 x 128)
               and the watermark step's (8,704 x 256) shapes on the trained
               grid, Mc from the auto compaction, with times (device times
               with the L2 flushed before each call), bounds and the plain
               chain (cumsum, index_put_, the gather, indexing_backward) as
               the library yardstick; at the watermark step's shape the
               pack 200 times over and, captured once in a CUDA graph,
               replayed on 3 other marches, bit-exact each time (the
               look-back's order, the scratch's reset); the replayed CUDA
               graph of a step
               against eager steps (16 clean on RGBA and RGB views, 8
               watermark; bf16 and fp32; the losses over the run, and every
               step from the graph's own state -- its loss and Adam's
               moments, at the last step the grads and leaves -- within the
               whole-step limits; the final leaves' drift a reading; one
               launch of each kernel a step counted through the replays);
               Trainer.train_device with --steps_per_dispatch 64
               on the train phase's recipe (512 steps: the loss falls, the
               held-out PSNR rises >= 6 dB) and
               WatermarkTrainer.train_device at the README stage-2 recipe
               on phase 7's backbone (1000 steps: lossw halves, bit accuracy
               >= 0.95 over 200 messages), each with rays/s, peak memory,
               launches and one more dispatch profiled (busy ms a step, idle
               share).  Every per-step profile (train, wm, attacks) must
               hold K5's kernels where the step compacts and no
               indexing_backward;
 10. train options — K2's cull route (the float render grid of phase 7's
               trained grid) against its plain version at the serving
               (4096 x 256) and clean step's (4096 x 128, with noise) shapes
               at t_cull 1e-3 and 1e-5: equal on every ray but those at the
               cull's margin (counted), its time, device time (and the bool
               route's on the same rays), plain time and bound;
               Trainer.train_device with --t_cull 1e-5 on phase 9's recipe
               (512 steps at K = 64: the fog gate opens at step 256, the step
               is captured again exactly once, the cull route launched every
               step after it; rays/s, the culled share, one more dispatch
               profiled; the held-out PSNR no worse than 0.5 dB below the
               exact run's); --error_map for 64 steps of Trainer.train and
               128 of Trainer.train_device (the map changes; the loop's
               step captured); --patch_size 8 --lambda_ssim 0.1 for 128
               clean loop steps and, with --t_cull 1e-5, 64 watermark steps
               on each path (the loss falls; the cull route every step);
 11. K7 and K8 — K7 (csrc/hashenc_stoch.cu) at the clean step's shapes on
               phase 7's trained backbone (the noisy march of 4096 rays at
               budget 128): the one-corner forward bit-exact against its
               plain version, the backward at level strides 1 and 2 within
               1e-6 relative L2 with no row chosen differently, each with
               its times, bound, plain time, library yardstick (a gather of
               the chosen rows; index_add_ of their cotangents) and its
               atomics as modelled beside K1's; Trainer.train_device on
               phase 9's recipe with --stochastic_hash_grad, then with
               --hash_fwd_corners 1 --hash_level_stride 2 (512 steps each:
               +6 dB; rays/s, busy ms a step and the PSNR gap beside the
               exact loop's); the watermark recipe with
               --stochastic_hash_grad --hash_fwd_corners 1 for 64 steps and
               64 looped (lossw falls); then --bg_radius 8 on views of the
               ball over a sky that varies with the direction (no alpha):
               512 loop steps with the bg model and 512 without (the
               held-out PSNR must be higher with it, a gradient must reach
               the bg table; the bg colour launched once forward and once
               backward a step, K8's encoding alone never), K8's encoding
               (csrc/hashenc_bg.cu, off the path) forward and backward on
               its trained table at 4096 rays and at a served chunk against
               the plain versions (rays at phi's branch cut left out and
               counted), K8 as the whole bg colour (csrc/background.cu) in
               bf16 and fp32 at those shapes against the plain chain (in
               bf16 also the fp32 kernel on the rounded table and weights,
               the control the limits must refuse; its backward bit-equal
               on a repeat; its kernels a call counted by name, exactly,
               beside the chain's device work), one 800x800 view served
               through the
               kernels against the plain versions (>= 45 dB, one bg
               forward a chunk), and 64 watermark steps on that backbone
               (lossw falls; no bg backward).
 12. baselines — the paper's baselines on phase 7's backbone at the README
               stage-2 recipe: --copyrnerf for 64 WatermarkTrainer.train
               steps (every loss finite, lossw of the last 16 below the
               first 16's) and 64 through train_device (K = 64), K10
               (csrc/copyrnerf.cu) and K4's density-logit route on both
               dtypes against their plain versions on a step's own samples
               (times, device times, bounds; K10 also inside an eager step
               and the profiled dispatch), no launch of K9 or of K1's or
               K4's backward; --whole_image_wm the same (64 + 64);
               --finetune_decoder from phase 8's watermarked model with
               the decoder's last layer re-drawn from a seed, 64 looped
               steps in dispatches of 16 (the last dispatch's lossw below
               half the first's, the message tables bit-equal after, no
               backward but the decoder's); each with
               rays/s, one dispatch profiled (busy ms a step) and
               test_bitacc over 50 whole-image or block decodes (reported,
               not gated); --prewatermark: pretrain_hidden 200 steps on
               phase 7's views, the views watermarked, 512 clean loop steps
               on them, bit survival over 4 rendered views (reported);
               the FiLM encoder once on the card against the CPU;
 13. lpips, clip, fixed — on phase 7's backbone at the recipe's widths:
               --patch_size 32 with random lpips-alex weights (a torch.save
               file) through Trainer.train for 64 steps (4 patches a step;
               the LPIPS term in every step, finite losses), the LPIPS
               meter of an evaluation on the held-out view against the
               plain CPU value (1e-4 relative), the device loop's refusal;
               32 GT-free CLIP steps on 64 x 64 --rand_pose bundles with a
               random vision tower at ViT-B/32's widths injected (finite
               losses, nonzero table gradients) and the CLI's --clip_text
               refused (no weights; the hub offline); the fixed-step renderer
               (cuda_ray off) in fp32 and bf16 at 512 and 128 + 128 samples:
               an 800x800 view each (launches, busy ms, device ms by
               kernel), 4096 rays against the plain route (>= 45 dB), PSNR
               against the grid render; main_nerf --test without
               --cuda_ray.
 14. parallel, video, viewer, ingest — on a fresh full-width model: K5's
               pack with a cap (a rank's share of the global budget)
               bit-exact against its plain version; 64 clean steps per step
               and one --steps_per_dispatch 64 dispatch, each twice without
               a process group and once under a one-process NCCL group
               (``NGP_*``: every collective of every per-step step checked
               to give back its input bit for bit; the group run against
               the run without it, beside the two runs without it against
               each other; launches; busy ms a step and NCCL's device ms a
               step from one more profiled dispatch, the all-reduce inside
               the captured graph); ``main_nerf --devices 2`` refused
               before it starts a rank; ``main_nerf -O --test``'s video
               branch (mp4, GIF or skipped) and its PNGs; the --gui server
               on localhost (a train slice, /frame, an orbit /ctl; the last
               frame against the plain route >= 45 dB); a seeded torch-ngp
               .pth written here, ingested and rendered (>= 45 dB against
               the plain route); the decoder's logits, test_bitacc and the
               LPIPS meter with cuDNN's TF32 on and off against the CPU
               (the CLIs' setting must agree with the reading).
               ``--phase parallel`` runs the build and this phase alone.
               Every phase's wall seconds are logged.

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

# no network: transformers would otherwise try to fetch the CLIP model that
# the CLIP phase's --clip_text names (no CLIP weights ship with the repo)
os.environ.setdefault("HF_HUB_OFFLINE", "1")

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
              "24x1": (24, 1), "8x8": (8, 8), "16x8": (16, 8)}
# the geometries that also train and run the watermark stage (32 x 2, K4 at
# width 64 as 16 x 4 is: its kernels and whole steps only)
GEO_TRAINED = ("8x2", "8x4", "16x4", "12x2", "24x1", "8x8", "16x8")
# the geometries whose held-out PSNR must rise 6 dB in GEO_ITERS steps
GEO_QUALITY = ("8x4", "16x4", "12x2", "16x8")
# the geometries whose encoding width only the tensor-core kernels take
# (K4 at IN = 128): bf16 alone, the fp32 route refused
GEO_BF16_ONLY = ("16x8",)
# the geometries refused before a model is built: (levels, features, dtype)
GEO_REFUSED = {"16 x 8 in fp32": (16, 8, torch.float32),
               "32 x 8 in bf16": (32, 8, torch.bfloat16)}
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
# the --n_views 2 run's steps (cut from WM_ITERS to pay for phase 13's time;
# in a 1000-step run lossw fell from 2.58 to 0.72 over its first 3 epochs of 32)
WM_V2_ITERS = 400
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


# a trace's categories of device work, by kind
DEVICE_KINDS = {"kernel": "kernel", "gpu_memset": "memset", "gpu_memcpy": "memcpy"}


def trace_device_events(prof):
    """The device work's events (kernels, copies, memsets) of a
    torch.profiler trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("cat") in DEVICE_KINDS]


def device_events(prof):
    """{name: microseconds} of the device work (kernels, copies, memsets)
    in a torch.profiler trace."""
    by_name = {}
    for e in trace_device_events(prof):
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


# what a cold device_ms rewrites between calls to evict the L2 (four times
# the H100's 50 MB), and the name its device work carries, left out of the sum
L2_FLUSH_BYTES = 200 * 2**20
L2_FLUSH_KERNEL = "bitwise_not"


def device_ms_by_name(fn, reps=20, cold=False):
    """``device_ms`` by name: {the name of a piece of device work: its device
    ms a call}, from one torch.profiler trace of ``reps`` calls (``cold``:
    the L2 flushed before each, the flush's work left out); None where
    every trace came back empty."""
    fn()
    flush = torch.zeros((L2_FLUSH_BYTES // 4,), dtype=torch.int32, device="cuda") if cold else None

    def work():
        for _ in range(reps):
            if cold:
                flush.bitwise_not_()
            fn()

    by_name, _ = traced(work, "device_ms")
    if not by_name:
        return None
    return {name: us / reps / 1e3 for name, us in by_name.items()
            if not (cold and L2_FLUSH_KERNEL in name)}


def device_ms(fn, reps=20, cold=False, bound=None):
    """Device time of one call of ``fn``: the durations of the device work
    that ``reps`` calls launch, summed from a torch.profiler trace, over
    ``reps`` (the host's dispatch and the gaps between launches left out,
    which CUDA events around a call count).  ``cold``: the L2 cache flushed
    before each call (a buffer four times its size rewritten, that work left
    out of the sum; the buffer freed on return, so no later peak memory
    reading holds it), so that inputs the calls share come from memory each
    time, as they do in a step.  Where every trace comes back empty, or
    where ``bound`` (the row's bound_ms) is given and the trace reads under
    it (a trace that lost some of the calls' device events), ``events_ms``
    measures it instead, warm (counted in EVENT_FALLBACKS)."""
    by_name = device_ms_by_name(fn, reps, cold)
    traced = None if by_name is None else sum(by_name.values())
    if traced is not None and (bound is None or traced >= bound):
        return traced
    ms = events_ms(fn, reps)
    EVENT_FALLBACKS.append(ms)
    why = ("every trace came back empty" if traced is None else
           f"the trace read {traced:.4f} ms, under the bound {bound:.4f} ms")
    log(f"[trace] device_ms from CUDA events instead ({why}): {ms:.4f} ms a call")
    return ms


def call_split(fn, reps, bound=None):
    """One call of ``fn`` split into device and host time: ms a call (CUDA
    events, median), its device ms warm and cold (``device_ms``, held to
    ``bound``), and the host's µs a call: the ms a call less the warm device
    ms, the time the idle device waits for the host to launch and return."""
    ms = median_ms(fn, reps)
    warm = device_ms(fn, reps, bound=bound)
    return {"ms": ms, "device_ms_warm": warm,
            "device_ms_cold": device_ms(fn, reps, cold=True, bound=bound),
            "host_us": (ms - warm) * 1e3}


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
            spills[name] = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", sec)]
    log(f"[build] spill stores and loads of the tensor-core kernels (bytes, per instantiation): "
        f"{spills}")
    if sorted(spills) != sorted(TENSOR_CORE_SOURCES) or not all(spills.values()) or any(
            any(v) for v in spills.values()):
        raise AssertionError(f"the tensor-core kernels spill or were not reported: {spills}")
    mma = mma_ptxas(info["log"])
    log(f"[build] K4's tensor-core kernels by input width (registers, spill stores and loads "
        f"from ptxas; threads, dynamic shared bytes, blocks an SM and local bytes as the "
        f"runtime reports the compiled plan): {json.dumps(mma)}")
    want = {(k, w[0]) for k in MMA_KERNELS for w in _cuda.MMA_WIDTHS}
    if {(k, int(i)) for k, v in mma.items() for i in v} != want or any(
            r["spill_stores"] or r["spill_loads"] or r["local_bytes"] or r["smem"] > 232_448
            or r["blocks_per_sm"] < 1 for v in mma.values() for r in v.values()):
        raise AssertionError(f"K4's tensor-core kernels spill, exceed a block's shared memory "
                             f"or were not reported at every width: {mma}")
    # nor may K4's tiled SIMT kernels, at every width
    simt = ptxas_kernels(info["log"], SIMT_KERNELS)
    log(f"[build] K4's tiled SIMT kernels (registers, spill stores, spill loads): "
        f"{json.dumps(simt)}")
    want = {f"{src}[{','.join(map(str, w))}]" for src in SIMT_KERNELS for w in _cuda.FIELD_WIDTHS}
    if set(simt) != want or any(r["spill_stores"] or r["spill_loads"] for r in simt.values()):
        raise AssertionError(f"K4's tiled SIMT kernels spill or were not reported: {simt}")
    # nor may K8's background colour, at every row width
    bg = {}
    for sec in info["log"].split("== ")[1:]:
        name = sec.split()[0]
        if name.startswith("background.cu["):
            bg[name] = [int(n) for n in re.findall(r"(\d+) bytes spill stores", sec)]
    log(f"[build] spill stores of K8's background colour (bytes, per instantiation): {bg}")
    if (sorted(bg) != sorted(f"background.cu[F={f}]" for f in _cuda.BG_FEATURES)
            or not all(bg.values()) or any(any(v) for v in bg.values())):
        raise AssertionError(f"K8's background colour spills or was not reported: {bg}")
    return info["seconds"], simt, mma


def mma_ptxas(build_log):
    """{kernel: {IN: {registers, spill_stores, spill_loads, threads, smem,
    blocks_per_sm, local_bytes}}} of K4's tensor-core kernels (MMA_KERNELS)
    at every instantiated input width: registers and spills from ptxas -v's
    report in the build log, the rest as the card's runtime reports the
    compiled plan (ops/_cuda.py:mma_plan: blocks an SM from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Fails where the
    wrappers' plan (models/ngp.py:mma_launch) is not the compiled one or the
    runtime's registers are not ptxas's."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda

    out = {}
    for sec in build_log.split("== ")[1:]:
        if sec.split()[0] not in TENSOR_CORE_SOURCES:
            continue
        key = None
        for line in sec.splitlines():
            mt = re.search(r"Function properties for (\S+)", line)
            if mt:
                key = None
                width = re.search(r"MmaDimsILi(\d+)E", mt.group(1))
                for kind, kname in MMA_KERNELS.items():
                    if width and re.search(kname + r"I", mt.group(1)):
                        key = (kind, int(width.group(1)))
                continue
            if key is None:
                continue
            row = out.setdefault(key[0], {}).setdefault(key[1], {})
            mt = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if mt:
                row.update(spill_stores=int(mt.group(1)), spill_loads=int(mt.group(2)))
            mt = re.search(r"Used (\d+) registers", line)
            if mt:
                row["registers"] = int(mt.group(1))
                key = None
    for kind, by_in in out.items():
        for in_dim, row in by_in.items():
            widths = next(w for w in _cuda.MMA_WIDTHS if w[0] == in_dim)
            plan = _cuda.mma_plan(kind, widths)
            if ((plan["threads"], plan["smem"]) != t_ngp.mma_launch(widths, kind)
                    or plan["registers"] != row.get("registers")):
                raise AssertionError(f"K4 {kind} at IN={in_dim}: the compiled plan {plan} is not "
                                     f"the wrappers' {t_ngp.mma_launch(widths, kind)} or ptxas's "
                                     f"{row}")
            row.update({k: plan[k] for k in ("threads", "smem", "blocks_per_sm", "local_bytes")})
    return out


def ptxas_kernels(build_log, kernels):
    """{"<source>[<width>]": {registers, spill_stores, spill_loads,
    seconds}} of the kernel ``kernels[source]`` names, from ptxas -v's
    report of each width's object in the build log."""
    out = {}
    for sec in build_log.split("== ")[1:]:
        head = sec.split("\n", 1)[0]
        name = head.split()[0]
        src = name.split("[")[0]
        if src not in kernels or "[" not in name:
            continue
        fn = None
        for line in sec.splitlines():
            mt = re.search(r"Function properties for (\S+)", line)
            if mt:
                fn = mt.group(1)
                continue
            if fn is None or kernels[src] not in fn:
                continue
            mt = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if mt:
                out[name] = dict(spill_stores=int(mt.group(1)), spill_loads=int(mt.group(2)),
                                 seconds=float(re.search(r"\(([\d.]+) s\)", head).group(1)))
            mt = re.search(r"Used (\d+) registers", line)
            if mt and name in out:
                out[name]["registers"] = int(mt.group(1))
                fn = None
    return out


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
    run = lambda: t_ngp.field_heads(fp, cfg, feat, dirs)
    ms = median_ms(run, 20)
    pms = median_ms(lambda: t_ngp.field_heads_plain(fp, cfg, fw, dirs), 5, 1)
    M = feat.shape[0]
    n_w = sum(w.numel() for w in fp["sigma_net"] + fp["color_net"])
    bms, bby = bound_of(M * (cfg.enc_dim * 4 + 12 + 4 + 12), M * 2 * n_w,
                        PEAK_BF16 if bf16 else PEAK_FP32)
    row = dict(max_abs_err=e_rgb, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
               share_not_equal=steps, in_dim=feat.shape[1])
    # device times, the kernel's own (traced, and from CUDA events behind a
    # spin kernel, which no lost trace event can shorten) and the chain's
    dms, ems = device_ms(run, 20, bound=bms), events_ms(run, 20)
    lib, ldms = library_mlp_ms(fp, fw, dirs, cfg.compute_dtype, device=True)
    row.update(device_ms=dms, device_ms_events=ems, library_ms=lib, library_device_ms=ldms)
    log(f"[{tag}] M={M}, IN={feat.shape[1]}: per call {ms:.4f} ms, device {dms:.4f} ms "
        f"(CUDA events {ems:.4f}); library chain {lib:.4f} / {ldms:.4f} ms; bound {bms:.4f} ms "
        f"({bby}): {bms / ems:.1%} of the events' reading")
    return row, (sp, rp)


def library_mlp_ms(fp, feat, dirs, dtype=torch.bfloat16, device=False):
    """The same two MLPs as a chain of torch.matmul calls in ``dtype`` (a
    yardstick, never called by the port); inputs prepared outside the timed
    region.  With ``device``: (per call, device) ms."""
    from nerf_signature_tpu_torch.ops.sh import sh_encode

    ws = [w.to(dtype) for w in fp["sigma_net"]]
    wc = [w.to(dtype) for w in fp["color_net"]]
    xs = feat.to(dtype)
    xc = torch.cat([sh_encode(dirs, 4), feat[:, :15]], -1).to(dtype)

    def run():
        h = torch.relu(xs @ ws[0]) @ ws[1]
        c = torch.relu(torch.relu(xc @ wc[0]) @ wc[1]) @ wc[2]
        return h, c

    return (median_ms(run, 20), device_ms(run, 20)) if device else median_ms(run, 20)


# ---------------------------------------------------------------- phase 4
def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def rel_l1(a, b):
    return float((a.double() - b.double()).abs().sum() / b.double().abs().sum().clamp_min(1e-30))


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


def train_rays(dev, seed=3, n=TRAIN_RAYS):
    """n random pixels of an orbit view (the train sampler's draw)."""
    from nerf_signature_tpu_torch.data.rays import get_rays

    fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    r = get_rays(orbit_poses(1, ORBIT_RADIUS, seed=seed), (fl, fl, RES / 2, RES / 2), RES,
                 RES, n, rng=np.random.default_rng(seed))
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
    in_step = {}
    fp32_counts = {"train step": clean_steps(dev, ro, rd, bg, noise, in_step=in_step)["float32"]}
    results["K4_field_bwd_f32"]["in_step"] = in_step
    wm_kernels(dev, results, fp32_counts)
    results["K4_field_bwd_feat_f32"]["fp32_step_launches"] = fp32_counts
    for name, r in results.items():
        log(f"[{name}] ms {r['ms']:.4f} | plain {r['plain_ms']:.4f} | "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) | library {r['library_ms']}")
    return results


def clean_steps(dev, ro, rd, bg, noise, levels=16, features=2, in_step=None,
                dtypes=(torch.bfloat16, torch.float32)):
    """One whole train step through the kernels against one through the
    plain versions, in each of ``dtypes`` (bf16 and fp32), at a table
    geometry (``levels`` x ``features``).  K2 is bit-exact and K3/K1 differ by fp32 sum order, so
    what is left is K4's bf16 roundings of sums taken in another order than
    cuBLAS's.  The limits are a few times the readings on an H100 (loss
    7.0e-8 relative; per-leaf rel L2 2.6e-4 in bf16, 8.1e-7 in fp32).  Fails
    unless K4 ran on the dtype's route alone; returns each dtype's launches.
    With ``in_step`` (a dict) the fp32 step runs once more under
    torch.profiler (``k4_bwd_in_step``), into it."""
    from nerf_signature_tpu_torch.ops import _cuda

    counts = {}
    for dtype, lim_rel in ((torch.bfloat16, 2e-3), (torch.float32, 1e-5)):
        if dtype not in dtypes:
            continue
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
        if in_step is not None and dtype == torch.float32:
            in_step.update(k4_bwd_in_step(mt, ro, rd, bg, noise))
        del mt
    return counts


def k4_bwd_in_step(mt, ro, rd, bg, noise):
    """K4's fp32 full backward inside one fp32 clean step through the
    kernels (``train_step_grads``) under torch.profiler: its device ms in
    the step (field_bwd and its block-order reduce), its launches in the
    step, and how many of the call's samples carry a cotangent (its own
    inputs, recorded)."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda

    calls = []
    full = t_ngp.field_heads_bwd

    def recorded(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma=None):
        calls.append(((g_sigma != 0) | (g_rgb != 0).any(-1)))
        return full(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma)

    t_ngp.field_heads_bwd = recorded
    try:
        _cuda.reset_launch_counts()
        by_name, _ = traced(lambda: train_step_grads(mt, ro, rd, bg, noise, False),
                            "fp32 clean step")
        launches = _cuda.launch_counts()["K4_field_bwd_f32"]
    finally:
        t_ngp.field_heads_bwd = full
    if by_name is None:
        raise AssertionError("fp32 clean step: no trace held device events")
    kern = sum(us for n, us in by_name.items() if "field_bwd<" in n) / 1e3
    red = sum(us for n, us in by_name.items() if "wgrad_reduce" in n) / 1e3
    busy = sum(by_name.values()) / 1e3
    samples = [int(c.numel()) for c in calls]
    live = [int(c.sum()) for c in calls]
    log(f"[K4 bwd f32 in step] one fp32 clean step: {launches} launch(es); device "
        f"{kern + red:.4f} ms (field_bwd {kern:.4f} + reduce {red:.4f}) of the step's "
        f"{busy:.4f} busy ms; {live} of {samples} samples carry a nonzero cotangent")
    if launches != 1 or len(calls) != 1 or kern <= 0.0:
        raise AssertionError(f"fp32 clean step: K4's full backward launched {launches} times, "
                             f"traced {kern} ms")
    return {"device_ms": kern + red, "kernel_ms": kern, "reduce_ms": red, "launches": launches,
            "step_busy_ms": busy, "samples": samples[0], "live_samples": live[0]}


def wm_steps(dev, x, levels=16, features=2, dtypes=(torch.bfloat16, torch.float32)):
    """One whole watermark step through the kernels against one through the
    plain versions, in each of ``dtypes`` (bf16 and fp32), at a table
    geometry.  A conv bias
    before a batch norm has a zero gradient in exact arithmetic (noise of
    ~1e-9 either way) and is left out of the per-leaf comparison.  The
    limits are a few times the readings on an H100 (loss equal; worst leaf
    8.4e-4 in bf16, the message tables', and 2.0e-5 in fp32).  Fails unless
    K4 ran on the dtype's route alone; returns each dtype's launches."""
    from nerf_signature_tpu_torch.ops import _cuda

    counts = {}
    for dtype, lim_rel in ((torch.bfloat16, 5e-3), (torch.float32, 1e-4)):
        if dtype not in dtypes:
            continue
        lim_loss = 1e-6
        mt = make_wm_model(dev, dtype=dtype, levels=levels, features=features)
        _cuda.reset_launch_counts()
        (lk, gk_), (lp, gp_) = (wm_step_grads(mt, x, plain) for plain in (False, True))
        n = _cuda.launch_counts()
        k4_route(n, dtype, ("K4_field", "K4_field_bwd_feat"), "wm step")
        counts[str(dtype)[6:]] = n
        check_step(f"wm step {levels} x {features}, {str(dtype)[6:]}", lk, gk_, lp, gp_,
                   lim_rel, lim_loss)
        del mt, gk_, gp_
    return counts


def step_errors(lk, gk_, lp, gp_):
    """A whole step through the kernels (loss lk, gradients gk_) against one
    through the plain versions: the loss's relative error, the worst
    leaf's gradient rel L2, leaving out leaves whose plain gradient is below
    1e-5 of the largest (a conv bias before a batch norm: zero in exact
    arithmetic), and how many leaves were kept."""
    scale = max(float(g.norm()) for g in gp_)
    kept = [(a, b) for a, b in zip(gk_, gp_) if float(b.norm()) > 1e-5 * scale]
    return {"loss_rel": abs(float(lk) - float(lp)) / abs(float(lp)),
            "worst_rel_l2": max(rel_l2(a, b) for a, b in kept), "kept": len(kept)}


def check_step(tag, lk, gk_, lp, gp_, lim_rel, lim_loss=1e-6):
    """``step_errors``, logged; fails past the limits."""
    e = step_errors(lk, gk_, lp, gp_)
    log(f"[{tag}] loss {float(lk):.6g} vs plain {float(lp):.6g} (rel {e['loss_rel']:.3g}, "
        f"limit {lim_loss:g}); {e['kept']} of {len(gp_)} leaves' grads, worst rel L2 "
        f"{e['worst_rel_l2']:.3g} (limit {lim_rel:g}); first leaf {rel_l2(gk_[0], gp_[0]):.3g}")
    if not (e["loss_rel"] <= lim_loss and e["worst_rel_l2"] <= lim_rel):
        raise AssertionError(f"{tag}: the step through the kernels differs from the plain one")
    return e


# Whole steps of the trained model (the jpeg, attack and two-view checks of
# the wm phase): the watermark step's per-leaf limit, and a loss limit of
# 1e-5 relative.  The trained model's losses are small residuals (a
# watermark step's 2.8e-4, against ~0.1 on the random model of wm_steps),
# which the two paths' bf16 differences move by up to 1.52e-6 relative
# (H100, the finetune step); at check_step's 1e-6 one run failed on a
# reading of 1.04e-6.  The per-leaf gradient limit (rel L2 5e-3; readings
# 4e-5 to 2.6e-4) is the check that fails a wrong kernel: it reads every
# leaf's gradient, which a wrong product moves far more than the loss.
TRAINED_LOSS_LIM = 1e-5
# The attack steps' loss is an image MSE of a trained model (~7e-5), which
# a single sample's colour moves: the two routes give each sample's sigma
# and colour bit for bit, save a few in 10^5 whose colour logit rounds to
# the neighbouring bf16 value (one bf16 step: 4.7e-4 to 1.4e-3 in a
# sample's colour), and K3 may end a ray whose transmittance sits within
# rounding of T_thresh a sample apart (~1e-4 at most).  Readings on an
# H100, 300 attack steps of six trained models: 0 to 12 rays of 4096 part
# a step, their colours up to 3.2e-4 apart, the loss over the other rays
# at most 4.0e-6 relative; in ~500 steps such rays moved a step's whole
# loss past 1e-5 twice (1.3e-5, and 1.4e-5 in the finetune_full step).  So
# the rays where the routes part (a sample's sigma or colour not equal, or
# a sample composited by one route only) are counted and held to
# FLIP_RAY_SHARE and FLIP_RAY_LIM; the loss limit holds over the other
# rays, and the gradients over all of them.  One bf16 step of a logit x
# moves sigmoid(x) by at most ~1.6e-3 (near |x| = 2).
FLIP_RAY_LIM = 2e-3
FLIP_RAY_SHARE = 0.01  # at most 1% of the rays may part


class AttackRenderCapture:
    """Inside ``with``: each call of the attack losses' ``_render_mse``
    records its rendered image and its target, and the compositor call
    inside it its per-sample sigmas, colours, mask and weights (the calls
    the loss makes, wrapped, not run again)."""

    def __enter__(self):
        from nerf_signature_tpu_torch.render import renderer
        from nerf_signature_tpu_torch.train import attack as t_atk

        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (renderer, "composite_rays"), (renderer, "composite_rays_plain"),
            (t_atk, "render_rays_occ"), (t_atk, "_render_mse"))]
        orig = {name: fn for _, name, fn in self.saved}

        def composite(name):
            def run(sigmas, rgbs, deltas, ts, mask=None, T_thresh=1e-4):
                out = orig[name](sigmas, rgbs, deltas, ts, mask, T_thresh)
                self.sigmas, self.rgbs = sigmas.detach(), rgbs.detach()
                self.mask, self.weights = mask, out["weights"].detach()
                return out
            return run

        def render(*a, **k):
            out = orig["render_rays_occ"](*a, **k)
            self.image = out["image"].detach()
            return out

        def mse(fp, wcfg, grid, rays_o, rays_d, target, *a):
            self.target = target.detach()
            return orig["_render_mse"](fp, wcfg, grid, rays_o, rays_d, target, *a)

        renderer.composite_rays = composite("composite_rays")
        renderer.composite_rays_plain = composite("composite_rays_plain")
        t_atk.render_rays_occ, t_atk._render_mse = render, mse
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def attack_step_errors(loss, leaves):
    """An attack step (``loss(plain)``, an image MSE) through the kernels
    against one through the plain versions: ``step_errors`` with the loss
    compared over the rays where the routes do not part (see FLIP_RAY_LIM),
    the whole loss's relative error, and the rays that part, the samples
    whose outputs differ and the largest colour difference of those rays.
    Fails unless the two marches are one (every sample in the same slot)
    and each route's captured image gives its loss bit for bit."""
    runs = []
    for plain in (False, True):
        with AttackRenderCapture() as cap:
            l = loss(plain)
        runs.append((l.detach(), torch.autograd.grad(l, leaves), cap))
    (lk, gk, ck), (lp, gp, cp) = runs
    se = {}
    for name, l, c in (("kernel", lk, ck), ("plain", lp, cp)):
        se[name] = (c.image - c.target) ** 2
        if not torch.equal(torch.mean(se[name]), l):
            raise AssertionError(f"the captured {name} image does not give its loss")
    if not torch.equal(ck.mask, cp.mask):
        raise AssertionError("the two routes' marches differ")
    differ = ((ck.sigmas != cp.sigmas) | (ck.rgbs != cp.rgbs).any(-1)) & cp.mask
    apart = (differ | ((ck.weights > 0) != (cp.weights > 0))).any(-1)
    n_apart = int(apart.sum())
    keep = ~apart
    e = step_errors(se["kernel"][keep].mean(), gk, se["plain"][keep].mean(), gp)
    e.update(loss_rel_all=abs(float(lk) - float(lp)) / abs(float(lp)), rays=len(apart),
             rays_apart=n_apart, samples_apart=int(differ.sum()),
             rays_apart_max_abs=(float((ck.image - cp.image).abs()[apart].max())
                                 if n_apart else 0.0),
             loss=float(lk), loss_plain=float(lp), first_leaf_rel_l2=rel_l2(gk[0], gp[0]),
             leaves=len(gp))
    return e


def check_attack_step(tag, loss, leaves, lim_rel):
    """``attack_step_errors``, logged; fails past the limits: the loss over
    the rays that do not part (TRAINED_LOSS_LIM), every leaf's gradient
    (``lim_rel``), the share of rays that part (FLIP_RAY_SHARE) and their
    colours (FLIP_RAY_LIM)."""
    e = attack_step_errors(loss, leaves)
    log(f"[{tag}] loss {e['loss']:.6g} vs plain {e['loss_plain']:.6g} (rel "
        f"{e['loss_rel_all']:.3g}); {e['rays_apart']} of {e['rays']} rays part "
        f"({e['samples_apart']} samples' outputs differ; limit {FLIP_RAY_SHARE:g} of the "
        f"rays), their colours max abs {e['rays_apart_max_abs']:.3g} (limit {FLIP_RAY_LIM:g}); "
        f"the loss over the other rays rel {e['loss_rel']:.3g} (limit {TRAINED_LOSS_LIM:g}); "
        f"{e['kept']} of {e['leaves']} leaves' grads, worst rel L2 {e['worst_rel_l2']:.3g} "
        f"(limit {lim_rel:g}); first leaf {e['first_leaf_rel_l2']:.3g}")
    if not (e["loss_rel"] <= TRAINED_LOSS_LIM and e["worst_rel_l2"] <= lim_rel
            and e["rays_apart"] <= FLIP_RAY_SHARE * e["rays"]
            and e["rays_apart_max_abs"] <= FLIP_RAY_LIM):
        raise AssertionError(f"{tag}: the step through the kernels differs from the plain one")
    return e


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
    dms, ems = device_ms(run, bound=bms), events_ms(run, 10)
    log(f"[{tag}] {n_hot} of {M} samples carry a nonzero cotangent; per call {ms:.4f} ms, "
        f"device {dms:.4f} ms (CUDA events {ems:.4f}); library chain {lib:.4f} / {ldms:.4f} "
        f"ms; bound {bms:.4f} ms ({bby}); bit-equal repeat")
    return dict(max_abs_err=a4, rel_l2=e4, ms=ms, device_ms=dms, device_ms_events=ems,
                plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=lib,
                library_device_ms=ldms, in_dim=feat.shape[1])


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


def wm_step_grads(m, x, plain, distortion="none", draws=None):
    """The watermark step's loss (trainer_wtmk._wm_step_loss at the recipe's
    lambdas, one render at budget 256) and the trainable leaves' gradients,
    through the kernels or the plain versions; the distortion at the given
    draws."""
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm

    leaves = t_twm.trainable_leaves(m.trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = t_twm._wm_step_loss(
        m.backbone, m.trainable, m.occ.occupancy, x["ro_b"], x["rd_b"], x["ct_o"], x["ct_d"],
        x["ct_gt"], x["bits"], draws, 0.005, 1.0, m.wcfg, m.rc, 256, 256, distortion,
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
    run = lambda: t_ngp.field_heads_bwd_feat(cfg, widths, feat, dirs, flat, g_sigma, g_rgb, mma)
    ms = median_ms(run, 10)
    full_ms = median_ms(lambda: t_ngp.field_heads_bwd(cfg, widths, feat, dirs, flat, g_sigma,
                                                      g_rgb, mma), 5)
    log(f"[{tag}] {ms:.4f} ms; the full backward (with the weight gradient) on the same "
        f"inputs {full_ms:.4f} ms")
    pms = median_ms(plain_bwd, 5, 1)
    lib_run = library_mlp_bwd(fp, feat[:, :cfg.enc_dim], dirs, g_sigma, g_rgb,
                              weights_grad=False, dtype=cfg.compute_dtype)
    lib = median_ms(lib_run, 10)
    # bound: cotangents read and g_feat written for every sample; feat and
    # dirs read, the forward and the transposed products done (4 flops a
    # weight) only for samples with a nonzero cotangent; no weight gradient
    M = feat.shape[0]
    n_hot = int(((g_sigma != 0) | (g_rgb != 0).any(-1)).sum())
    bms, bby = bound_of(M * (4 + 12 + cfg.enc_dim * 4) + n_hot * (cfg.enc_dim * 4 + 12)
                        + flat.numel() * 4, n_hot * 4 * flat.numel(),
                        PEAK_BF16 if bf16 else PEAK_FP32)
    log(f"[{tag}] {n_hot} of {M} samples carry a nonzero cotangent")
    row = dict(max_abs_err=a4, rel_l2=e4, rel_l2_vs_full_bwd=e_full, ms=ms, plain_ms=pms,
               bound_ms=bms, bound_by=bby, library_ms=lib, full_bwd_ms=full_ms,
               in_dim=feat.shape[1])
    # device times, the kernel's own (traced, and from CUDA events) and the chain's
    dms, ems, ldms = device_ms(run, 10, bound=bms), events_ms(run, 10), device_ms(lib_run, 10)
    row.update(device_ms=dms, device_ms_events=ems, library_device_ms=ldms)
    log(f"[{tag}] IN={feat.shape[1]}: device {dms:.4f} ms (CUDA events {ems:.4f}); library "
        f"chain {lib:.4f} / {ldms:.4f} ms; bound {bms:.4f} ms ({bby}): {bms / ems:.1%} of the "
        f"events' reading")
    return row


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
    24), 8 x 8 (K1 with 8 features a row, width 64) and 16 x 8 (width 128:
    K4 on the tensor cores alone, GEO_BF16_ONLY).
    For each: K1's forward (bit-exact) and K4's forward on the serving
    chunk's samples, K1's and K4's full backward at the train step's shapes,
    K4's feature-only backward at the watermark step's, each kernel against
    its plain version on both of K4's routes (bf16 alone at GEO_BF16_ONLY);
    one whole clean step and one whole watermark step through the kernels
    against the plain versions (bf16 and fp32, the existing limits; bf16
    alone at GEO_BF16_ONLY).  For each of GEO_TRAINED: Trainer.train for
    GEO_ITERS steps on the radius-0.7 ball, the quality limit checked at
    GEO_QUALITY, then the watermark stage on the backbone that run trained:
    the README stage-2 recipe for GEO_WM_ITERS steps through the CLI's setup
    (``wm_train``).  And the refusal of GEO_REFUSED (16 x 8 in fp32, 32 x 8
    in bf16) before a model is built.  Returns each kernel's row at each
    geometry (keyed (kernel, geometry); K1's forward is timed only where
    VARIANTS has a row for it), each trained geometry's launches (under
    "train" its Trainer.train run's, under "wm" its WatermarkTrainer.train
    run's) and its training numbers."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    for what, (L, F, dtype) in GEO_REFUSED.items():
        try:
            NGPModel(t_ngp.NGPConfig(n_levels=L, n_features=F, compute_dtype=dtype), device=dev)
        except NotImplementedError as e:
            if "ROADMAP queue 3" not in str(e):
                raise
            log(f"[geometry] {what} refused up front: {str(e)[:160]}...")
        else:
            raise AssertionError(f"{what} (encoding width {L * F}) was not refused on the card")

    rows, launches, stats = {}, {}, {}

    def geometry_seconds(geo, t0):
        """A geometry's own seconds, every check and run of it included."""
        stats.setdefault(geo, {})["geometry_seconds"] = time.time() - t0
        log(f"[time] geometry {geo}: {stats[geo]['geometry_seconds']:.1f} s")

    for geo, (L, F) in GEOMETRIES.items():
        t_geo = time.time()
        gen = torch.Generator(device=dev).manual_seed(23)
        m = make_model(dev, levels=L, features=F)
        cfg, S_log2 = m.cfg, m.cfg.log2_hashmap_size
        fp = t_ngp.field_params(m.params, cfg)
        # the fp32 route where its SIMT kernels take the width
        f32 = geo not in GEO_BF16_ONLY
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        fp32 = t_ngp.field_params(m.params, cfg32) if f32 else None
        dtypes = (torch.bfloat16, torch.float32) if f32 else (torch.bfloat16,)
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
        krows = {"K4_field": k4_forward(fp, cfg, feat, dirs)[0]}
        if f32:
            krows["K4_field_f32"] = k4_forward(fp32, cfg32, feat, dirs)[0]
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
        if f32:
            krows["K4_field_bwd_f32"] = k4_bwd(fp32, cfg32, feat, dirs, g_sigma, g_rgb)
        del feat, x01, dirs, g_sigma, g_rgb, live
        bg = torch.rand((TRAIN_RAYS, 3), generator=gen, device=dev)
        clean_steps(dev, ro, rd, bg, noise, L, F, dtypes=dtypes)
        # watermark step shapes: K4's feature-only backward, then the whole step
        mw = make_wm_model(dev, levels=L, features=F)
        x = wm_step_inputs(dev)
        fpw = t_ngp.field_params(mw.backbone, cfg)
        fpw32 = t_ngp.field_params(mw.backbone, cfg32) if f32 else None
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
        if f32:
            krows["K4_field_bwd_feat_f32"] = k4_bwd_feat(fpw32, cfg32, feat, dirs, g_sigma,
                                                         g_rgb)
        del feat, x01, dirs, g_sigma, g_rgb, live, mw, fpw, fpw32, m, fp, fp32
        wm_steps(dev, x, L, F, dtypes=dtypes)
        rows.update({(k, geo): r for k, r in krows.items()})
        if geo not in GEO_TRAINED:
            gc.collect()
            geometry_seconds(geo, t_geo)
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
        geometry_seconds(geo, t_geo)
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
# every view's pixels by ball radius, made once (the loaders' preload)
_BALL_IMAGES = {}


class BallViews:
    """The train loader: TRAIN_VIEWS orbit views of the analytic ball of
    ``radius`` at RES x RES; each step draws TRAIN_RAYS random pixels of one
    view (shuffled per epoch) and colours them analytically (no images are
    stored).  ``error_map``: carry the provider's [views, 128 * 128] map of
    ones (``--error_map``), importance-sample each step's pixels from it and
    hand the trainer the view's index and cells.  ``patch_size``: draw the
    pixels as patch_size x patch_size patches (``--patch_size``)."""

    def __init__(self, radius, seed=5, error_map=False, patch_size=1):
        self.radius = radius
        self.patch_size = patch_size
        self.poses = orbit_poses(TRAIN_VIEWS, ORBIT_RADIUS, seed=seed)
        fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
        self.intrinsics = np.array([fl, fl, RES / 2, RES / 2])
        self.rng = np.random.default_rng(seed)
        self.error_map = np.ones((TRAIN_VIEWS, 128 * 128), np.float32) if error_map else None

    def __len__(self):
        return TRAIN_VIEWS

    def __iter__(self):
        from nerf_signature_tpu_torch.data.rays import get_rays

        for v in self.rng.permutation(TRAIN_VIEWS):
            em = None if self.error_map is None else self.error_map[v:v + 1]
            r = get_rays(self.poses[v:v + 1], self.intrinsics, RES, RES, TRAIN_RAYS,
                         rng=self.rng, error_map=em, patch_size=self.patch_size)
            batch = {"H": RES, "W": RES, "rays_o": r["rays_o"], "rays_d": r["rays_d"],
                     "images": self.pixels(r["rays_o"], r["rays_d"])}
            if em is not None:
                batch.update(index=int(v), inds_coarse=r["inds_coarse"])
            yield batch

    def pixels(self, rays_o, rays_d):
        """The views' pixels of these rays: the ball's RGBA."""
        return ball_rgba(rays_o, rays_d, radius=self.radius)

    def ground_truth(self, rays_o, rays_d):
        """[n, 3] what an evaluation compares a render with: the pixels,
        composited over white where they have alpha."""
        px = self.pixels(rays_o, rays_d)
        return px[:, :3] * px[:, 3:] + (1.0 - px[:, 3:]) if px.shape[-1] == 4 else px

    # what the device loop preloads: every view's pixels, made once
    H = W = RES

    @property
    def images(self):
        """[TRAIN_VIEWS, RES, RES, C] every pixel (RGBA: 327 MB)."""
        key = (type(self).__name__, self.radius)
        if key not in _BALL_IMAGES:
            views = []
            for v in range(TRAIN_VIEWS):
                r = view_rays(self.poses[v:v + 1])
                px = self.pixels(r["rays_o"][0], r["rays_d"][0])
                views.append(px.reshape(RES, RES, px.shape[-1]))
            _BALL_IMAGES[key] = np.stack(views)
        return _BALL_IMAGES[key]


def sky(rays_d):
    """A background that varies with the ray's direction (what the bg-sphere
    model can learn): 0.5 + 0.4 * the unit direction, per channel."""
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return (0.5 + 0.4 * d).astype(np.float32)


class SkyBallViews(BallViews):
    """BallViews of RGB pixels with no alpha: the ball over ``sky``, so the
    misses show a colour that varies with the direction."""

    def pixels(self, rays_o, rays_d):
        rgba = ball_rgba(rays_o, rays_d, radius=self.radius)
        return rgba[..., :3] * rgba[..., 3:] + sky(rays_d) * (1.0 - rgba[..., 3:])


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


def train_case(dev, radius, iters, group_budget=-1, levels=16, features=2,
               steps_per_dispatch=0, t_cull=0.0, error_map=False, patch_size=1,
               lambda_ssim=0.0, stochastic=False, level_stride=1, fwd_corners=8,
               bg_radius=-1.0, views=BallViews):
    """A fresh full-width model (standard init; ``levels`` x ``features``
    table geometry) trained by the port's Trainer.train with the CLI's train
    defaults on ``views``(radius) (BallViews), or with ``steps_per_dispatch``
    K by Trainer.train_device (the views preloaded to the card, a replayed
    CUDA graph of the step).  ``t_cull``, ``error_map``, ``patch_size`` and
    ``lambda_ssim``, ``stochastic`` (--stochastic_hash_grad),
    ``level_stride``, ``fwd_corners`` and ``bg_radius``: the train-step
    options of those names.
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
                          max_ray_batch=CHUNK, patch_size=patch_size, lambda_ssim=lambda_ssim,
                          color_space="srgb", hash_fwd_corners=fwd_corners)
    cfg = NGPConfig(bound=1.0, n_levels=levels, n_features=features,
                    stochastic_hash_grad=stochastic, hash_level_stride=level_stride,
                    bg_radius=bg_radius)
    model = NGPModel(cfg, min_near=0.2, density_thresh=10.0, dt_gamma=0.0, max_steps=1024,
                     grid_size=128, seed=2, train_budget=TRAIN_BUDGET, infer_budget=256,
                     t_cull=t_cull, device=dev)
    loader = views(radius, error_map=error_map)
    held = view_rays(orbit_poses(1, ORBIT_RADIUS, seed=9))
    gt = torch.from_numpy(loader.ground_truth(held["rays_o"][0], held["rays_d"][0])).to(dev)
    # no workspace: no per-epoch checkpoint (params, EMA and Adam's moments,
    # ~270 MB each) inside the timed loop; the CPU tests cover the ring buffer
    trainer = Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch")
    moves, note = watch_adaptations(trainer)
    psnr0 = held_out_psnr(model, trainer.eval_params(), held, gt)
    if steps_per_dispatch:
        loader.images  # made before the timed run, as a dataset is loaded

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    if steps_per_dispatch:
        trainer.train_device(loader, iters, steps_per_dispatch=steps_per_dispatch)
    else:
        trainer.train(loader, None, max_epochs=math.ceil(iters / TRAIN_VIEWS))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    note()
    psnr1 = held_out_psnr(model, trainer.eval_params(), held, gt)
    return dict(trainer=trainer, loader=loader, seconds=seconds, launches=launches,
                peak=peak, psnr0=psnr0, psnr1=psnr1, moves=moves, held=held, gt=gt)


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
    prof = profile_steps(trainer, r["loader"])
    peak = r["peak"]
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
    for name in K5_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by Trainer.train")
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
                peak_gib=peak, profile=prof, model=trained)


# K5's kernels by a substring of their names in a trace, and the plain
# compaction's backward, which no step may run any more
K5_TRACE = ("k5_pack", "k5_unpack")
PLAIN_K5_BWD = "indexing_backward"


def check_k5_trace(by_name, tag, compacting=True):
    """Fail if a train step's trace runs ``indexing_backward`` (the plain
    compaction's backward), or, where the step compacts, no K5 kernels."""
    plain = [n for n in by_name if PLAIN_K5_BWD in n]
    if plain:
        raise AssertionError(f"[{tag}] the trace runs {plain[0][:80]}: the plain "
                             "compaction's backward, where K5's gather belongs")
    for pat in K5_TRACE if compacting else ():
        if not any(pat in n for n in by_name):
            raise AssertionError(f"[{tag}] the trace holds no {pat} kernel (K5)")


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
    check_k5_trace(by_name, tag, trainer.model.rc.compact_frac > 0)
    log(f"[{tag}] {n} train steps: wall {wall_us / n / 1e3:.3f} ms a step, device busy "
        f"{busy_us / n / 1e3:.3f} ms a step (idle share {1 - busy_us / wall_us:.1%}), "
        f"{len(by_name)} distinct device functions")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        log(f"[{tag}]   {us / n / 1e3:8.4f} ms a step ({us / busy_us:6.1%})  {name}")
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


def pick_key_blocks(model, ws, seed, n_views=1):
    """The key poses (``n_views`` random orbit poses, as the provider draws
    them) and the 32 key blocks of view 0's render with the largest pixel
    variance, saved where the CLI loads them (the JPEG-ratio picker needs
    PIL, which this machine may lack)."""
    from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses

    pose = rand_poses(np.random.default_rng(seed), n_views, radius=ORBIT_RADIUS)
    fl = WM_RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    r = get_rays(pose[:1], (fl, fl, WM_RES / 2, WM_RES / 2), WM_RES, WM_RES, -1)
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


def wm_train(dev, backbone_model, workdir, iters=WM_ITERS, extra=(), tag="wm",
             steps_per_dispatch=0, step_losses=None, step_lossw=None,
             required=None, k4_names=("K4_field", "K4_field_bwd_feat"), ckpt=None):
    """The watermark stage's main path as its CLI drives it, on
    ``backbone_model`` saved as the clean checkpoint: main_nerf_wtmk's parser
    and setup (the README stage-2 recipe for ``iters`` steps, plus ``extra``
    flags), the key blocks, resolve_auto_compaction, then
    WatermarkTrainer.train with the launch counts set to 0 just before it,
    its epochs timed (no checkpoint I/O), or, with ``steps_per_dispatch`` K,
    WatermarkTrainer.train_device, its dispatches timed.  ``step_losses`` /
    ``step_lossw``: lists that take each per-step step's loss / lossw (a
    read-back a step).  With
    ``--t_cull`` in ``extra`` K2 runs its cull route.  ``required``: the
    kernels the run must launch (default: the watermark step's and K5's);
    ``k4_names``: K4's kernels that must run on the tensor-core route;
    ``ckpt``: the --ckpt to start from (default: the backbone, saved as a
    clean checkpoint).  Returns the model, trainer,
    loader factory, the run's launches, steps, rays a step, seconds and peak
    memory."""
    from nerf_signature_tpu_torch import main_nerf_wtmk
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.checkpoint import save_checkpoint

    clean = ckpt or os.path.join(workdir, "clean", "ngp_ep0016.ckpt")
    if ckpt is None:
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
    var_min = pick_key_blocks(model, ws, opt.seed, opt.n_views)
    loader = make_loader("train", opt.n_views, 100)
    step_rays = TRAIN_RAYS + WM_BITS * WM_BLOCK**2 * opt.n_views
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
    if step_losses is not None or step_lossw is not None:
        run_step = trainer.train_step_data

        def recorded(data, message):
            out = run_step(data, message)
            for lst, v in ((step_losses, out[0]), (step_lossw, out[1])):
                if lst is not None:
                    lst.append(float(v))
            return out

        trainer.train_step_data = recorded
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm

    run_dispatch = t_twm.wm_device_loop

    def timed_dispatch(*a, **k):
        t = time.time()
        out = run_dispatch(*a, **k)  # ends in a host sync (the dispatch's losses)
        epoch_s.append(time.time() - t)
        return out

    t_twm.wm_device_loop = timed_dispatch
    max_epochs = math.ceil(iters / len(loader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    try:
        if steps_per_dispatch:
            trainer.train_device(loader, iters, steps_per_dispatch=steps_per_dispatch)
        else:
            trainer.train(loader, None, None, max_epochs)
    finally:
        t_twm.wm_device_loop = run_dispatch
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.train_one_epoch = run_epoch
    steps, seconds = trainer.global_step, sum(epoch_s)
    log(f"[{tag}] {steps} steps of {step_rays} rays in {seconds:.2f} s: "
        f"{steps * step_rays / seconds:.0f} watermark rays/s, {seconds / steps * 1e3:.2f} ms "
        f"a step; peak memory {peak:.2f} GiB")
    log(f"[{tag}] {'dispatch' if steps_per_dispatch else 'epoch'} lossw "
        f"{[round(v, 5) for v in trainer.stats['lossw']]}")
    log(f"[{tag}] launches during WatermarkTrainer."
        f"{'train_device' if steps_per_dispatch else 'train'}: {launches}")
    if steps != iters:
        raise AssertionError(f"WatermarkTrainer.train ran {steps} steps, expected {iters}")
    culled = model.rc.t_cull > 0
    for name in WM_TRAIN + K5_KERNELS if required is None else required:
        if culled and name == "K2_march":
            name = "K2_march_cull"
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by WatermarkTrainer.train ({tag})")
    if launches["K4_field_bwd"] + launches["K4_field_bwd_f32"] != 0:
        raise AssertionError(f"the frozen backbone's weight gradient was computed ({tag})")
    k4_route(launches, torch.bfloat16, k4_names, f"WatermarkTrainer.train ({tag})")
    return dict(model=model, trainer=trainer, make_loader=make_loader, loader=loader,
                launches=launches, steps=steps, step_rays=step_rays, seconds=seconds, peak=peak)


ATTACK_TRIALS = 50       # --n_test_attack
ATTACK_STEPS = 100       # --adv_steps, --finetune_attack_steps
ATTACK_FULL_STEPS = 20   # the finetuning attack with --finetune_attack_full
ADV_EPSILON = 1e-3       # --adv_epsilon
BACKWARD = ("K1_hash_encode_bwd", "K3_composite_bwd", "K4_field_bwd", "K4_field_bwd_feat",
            "K9_msg_table_bwd")


def loader_step_inputs(trainer, data):
    """A watermark step's inputs from a train batch of the provider: its
    key-block bundles, content rays and pseudo-GT, and a fresh message."""
    m = trainer.model
    ro_b, rd_b = trainer._device_rays(data["watermark"])
    ct = data["content"]
    t = lambda k: torch.as_tensor(np.asarray(ct[k], np.float32), device=m.device).reshape(-1, 3)
    return dict(ro_b=ro_b, rd_b=rd_b, ct_o=t("rays_o"), ct_d=t("rays_d"), ct_gt=t("images"),
                bits=torch.as_tensor(trainer.random_message(), device=m.device))


# The jpeg step's quantiser may round a coefficient apart on the two paths
# where their bf16 renders differ by an ulp at a level's .5: the share of
# the key blocks' 8x8 blocks that hold such a flip (a flip moves its block's
# 64 pixels) is held to the CPU parity test's bound on the share of pixels
# moved (tests/test_torch_jpeg.py), 1%.  Readings on the H100: 0 of 24576
# coefficients in each of two runs.
JPEG_FLIP_BLOCKS_MAX = 0.01


def jpeg_levels(m, x, plain, quality):
    """The levels that one watermark step's jpeg distortion rounds the key
    blocks' DCT coefficients to (one view): the blocks rendered as
    ``wm_step_grads`` renders them (one march with the content rays at
    budget 256), through the kernels or the plain versions."""
    from nerf_signature_tpu_torch.train import trainer_wtmk as t_twm
    from nerf_signature_tpu_torch.utils import jpeg as t_jpeg

    with torch.no_grad():
        fp = t_twm.wtmk_field_params(m.backbone, m.trainable, m.wcfg, x["bits"], plain)
        n_b = x["ro_b"].numel() // 3
        out = t_twm.render_rays_occ(
            lambda p, d: t_twm.wtmk_field(fp, m.wcfg, p, d, plain=plain), m.occ.occupancy,
            torch.cat([x["ro_b"].reshape(-1, 3), x["ct_o"]], 0),
            torch.cat([x["rd_b"].reshape(-1, 3), x["ct_d"]], 0), m.rc, budget=256,
            bg_color=1.0, plain=plain)
        blocks = t_twm._blocks(out["image"][:n_b], x["ro_b"].shape)
        coef, _ = t_jpeg.dct_coefficients(blocks)
        return torch.round(coef / t_jpeg.quant_table(quality, blocks.device))


def wm_jpeg(trainer, make_loader, loader):
    """``--distortion jpeg`` on the trained model: test_bitacc over
    WM_TRIALS messages; jpeg_dct's time at the key blocks' shape; one whole
    step through the kernels against the plain versions at the same draws,
    each path rounding its own coefficients.  The quantiser's rounding
    turns the two paths' bf16 differences into whole steps at coefficients
    near .5: their count is reported and the share of 8x8 blocks holding
    one is held to JPEG_FLIP_BLOCKS_MAX."""
    from nerf_signature_tpu_torch.train.trainer_wtmk import view_batch_shape
    from nerf_signature_tpu_torch.utils import jpeg as t_jpeg
    from nerf_signature_tpu_torch.utils.image import distortion_draws

    m = trainer.model
    meter = trainer.metrics_message[0]
    trainer.distortion = "jpeg"
    try:
        acc = trainer.test_bitacc(make_loader("test", 1, WM_TRIALS))
    finally:
        trainer.distortion = "none"
    out = {"bitacc": acc, "log10p": meter.pvalue(),
           "s_per_message": trainer.bitacc_seconds / WM_TRIALS}
    log(f"[wm jpeg] test_bitacc --distortion jpeg: bit accuracy {acc:.4f} over {meter.N} "
        f"messages, log10 p {meter.pvalue():.1f}; {out['s_per_message']:.4f} s a message")

    x = loader_step_inputs(trainer, next(iter(loader)))
    shape = view_batch_shape(x["ro_b"].shape)
    blocks = torch.rand(shape, generator=m.generator, device=m.device)
    run = lambda: t_jpeg.jpeg_dct(blocks, 60.0)
    out.update(jpeg_dct_ms=median_ms(run, 20), jpeg_dct_device_ms=device_ms(run, 20))
    log(f"[wm jpeg] jpeg_dct at {list(shape)}: {out['jpeg_dct_ms']:.4f} ms a call, device "
        f"{out['jpeg_dct_device_ms']:.4f} ms")

    draws = distortion_draws("jpeg", shape, m.generator, m.device)
    quality = 40.0 + 10.0 * int(draws)
    (lk, gk), (lp, gp) = (wm_step_grads(m, x, plain, "jpeg", draws) for plain in (False, True))
    lv_k, lv_p = (jpeg_levels(m, x, plain, quality) for plain in (False, True))
    flips = lv_k != lv_p
    n_flips = int(flips.sum())
    block_share = float(flips.flatten(3).any(-1).to(torch.float32).mean())
    log(f"[wm jpeg] quality {quality:g}: {n_flips} of {lv_k.numel()} quantised coefficients "
        f"round apart between the kernel and the plain paths; share of 8x8 blocks holding one "
        f"{block_share:.3g} (limit {JPEG_FLIP_BLOCKS_MAX:g})")
    if block_share > JPEG_FLIP_BLOCKS_MAX:
        raise AssertionError(f"wm jpeg: {block_share:.3g} of the 8x8 blocks round apart between "
                             f"the kernel and the plain paths (limit {JPEG_FLIP_BLOCKS_MAX:g})")
    out.update(quality=quality, rounding_flips=n_flips, n_coefficients=lv_k.numel(),
               flip_block_share=block_share,
               step=check_step("wm step jpeg", lk, gk, lp, gp, 5e-3, TRAINED_LOSS_LIM))
    return out


def attack_run(fn, required, absent, what):
    """``fn()`` with the launch counts set to 0 just before it; fails unless
    every kernel in ``required`` launched (K4 on the bf16 route alone) and
    none in ``absent``.  Returns (its result, seconds, launches)."""
    from nerf_signature_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    n = _cuda.launch_counts()
    for name in required:
        if n[name] == 0:
            raise AssertionError(f"{name} was not launched by {what}")
    for name in absent:
        if n[name]:
            raise AssertionError(f"{name} was launched {n[name]} times by {what}")
    k4_route(n, torch.bfloat16, [k for k in ("K4_field", "K4_field_bwd", "K4_field_bwd_feat")
                                 if k in required], what)
    launches = {k: v for k, v in n.items() if v}
    log(f"[{what}] {seconds:.2f} s; launches {launches}")
    return out, seconds, launches


def wm_attacks(trainer, make_loader, loader):
    """The attack suites on the trained model, through the functions the
    CLI's ``--test`` calls: the 13-attack sweep at ``--n_test_attack 50``;
    the parameter attack at the CLI defaults (epsilon 1e-3, 100 steps), then
    test_bitacc on the attacked weights; the finetuning attack (100 steps,
    the hash table), then test_bitacc and test_image; 20 steps of it with
    every backbone leaf.  Each run's launches, its seconds, a profile of 16
    more steps (wall and busy ms a step, idle share) and one step through
    the kernels against the plain versions."""
    from nerf_signature_tpu_torch.train import attack as t_atk
    from nerf_signature_tpu_torch.train.trainer_wtmk import trainable_leaves

    m = trainer.model
    dev = m.device
    res, launches = {}, {}

    sweep_loader = make_loader("test", 1, ATTACK_TRIALS)
    sweep, seconds, launches["sweep"] = attack_run(
        lambda: t_atk.attack_sweep(trainer, sweep_loader, n_test=ATTACK_TRIALS),
        FORWARD + ("K9_msg_table",), BACKWARD, "attack_sweep")
    per_msg = seconds / (len(sweep) * ATTACK_TRIALS)
    print(json.dumps({"attacks": sweep, "s_per_message": per_msg}))
    res["sweep"] = {"bitacc": sweep, "s_per_message": per_msg, "seconds": seconds}
    if not sweep["none"] >= 0.95:
        raise AssertionError(f"attack sweep: bit accuracy {sweep['none']:.4f} < 0.95 with no "
                             "attack")

    # ---- the epsilon-ball parameter attack
    attacked, seconds, launches["parameter"] = attack_run(
        lambda: t_atk.parameter_attack(trainer, loader, epsilon=ADV_EPSILON, steps=ATTACK_STEPS,
                                       num_rays=TRAIN_RAYS),
        WM_TRAIN, ("K4_field_bwd",), "parameter_attack")
    a_leaves, o_leaves = trainable_leaves(attacked), trainable_leaves(m.trainable)
    dev_max = [float((a - o).abs().max()) for a, o in zip(a_leaves, o_leaves)]
    inside = all(bool(((a >= o - ADV_EPSILON) & (a <= o + ADV_EPSILON)).all())
                 for a, o in zip(a_leaves, o_leaves))
    dec_same = all(torch.equal(a, o) for a, o in zip(a_leaves[1:], o_leaves[1:]))
    log(f"[parameter attack] max |p - o|: message tables {dev_max[0]:.6g}, decoder "
        f"{max(dev_max[1:]):.3g} (epsilon {ADV_EPSILON:g}); every leaf inside the ball: "
        f"{inside}; decoder bit-identical: {dec_same}")
    if not (inside and dec_same and dev_max[0] > 0):
        raise AssertionError("parameter attack: a leaf left the epsilon ball, the decoder "
                             "moved, or the message tables did not")
    original, m.trainable = m.trainable, attacked
    try:
        acc = trainer.test_bitacc(make_loader("test", 1, WM_TRIALS), save_best=False)
    finally:
        m.trainable = original
    atk = t_atk.ParameterAttack(trainer, loader, ADV_EPSILON, num_rays=TRAIN_RAYS)
    rng = np.random.default_rng(1)
    msg = lambda: rng.integers(0, 2, WM_BITS).astype(np.int32)
    prof = profile_steps(trainer, loader, tag="parameter attack profile",
                         step=lambda data: atk.step(msg()))
    bits = torch.as_tensor(msg(), device=dev)
    step = check_attack_step("parameter attack step", lambda plain: atk.loss(bits, plain),
                             atk.leaves[:1], 5e-3)
    res["parameter"] = dict(bitacc_after=acc, seconds=seconds, steps=ATTACK_STEPS,
                            max_abs_change=dev_max[0], epsilon=ADV_EPSILON, profile=prof,
                            step=step)
    del attacked, atk, a_leaves

    # ---- the backbone finetuning attack: the hash table, then every leaf
    for full, steps in ((False, ATTACK_STEPS), (True, ATTACK_FULL_STEPS)):
        key = "finetune_full" if full else "finetune"
        k4 = ("K4_field_bwd",) if full else ("K4_field_bwd_feat",)
        attacked, seconds, launches[key] = attack_run(
            lambda: t_atk.finetune_attack(trainer, loader, steps=steps, num_rays=TRAIN_RAYS,
                                          full_backbone=full),
            FORWARD + ("K9_msg_table", "K1_hash_encode_bwd", "K3_composite_bwd") + k4,
            ("K9_msg_table_bwd", "K4_field_bwd_feat" if full else "K4_field_bwd"), key)
        moved = {k: [not torch.equal(a, b) for a, b in zip(t_atk._leaves({k: attacked[k]}),
                                                           t_atk._leaves({k: m.backbone[k]}))]
                 for k in m.backbone}
        log(f"[{key}] backbone leaves changed: {moved}")
        if not all(all(v) if (full or k == "hash_table") else not any(v)
                   for k, v in moved.items()):
            raise AssertionError(f"{key}: a trained leaf did not move, or another one did")
        out = dict(seconds=seconds, steps=steps,
                   table_max_abs_change=float((attacked["hash_table"]
                                               - m.backbone["hash_table"]).abs().max()))
        if not full:
            original, m.backbone = m.backbone, attacked
            try:
                out["bitacc_after"] = trainer.test_bitacc(make_loader("test", 1, WM_TRIALS),
                                                          save_best=False)
                out["test_image_psnr"] = float(trainer.test_image(
                    make_loader("test_image", 2, 4),
                    name="test_image_after_finetune_attack")["PSNR"])
            finally:
                m.backbone = original
        atk = t_atk.FinetuneAttack(trainer, num_rays=TRAIN_RAYS, full_backbone=full)
        out["profile"] = profile_steps(trainer, loader, tag=f"{key} profile", step=atk.step)
        ro, rd, target = t_atk._content(next(iter(loader)), TRAIN_RAYS, dev)
        out["step"] = check_attack_step(f"{key} step",
                                        lambda plain: atk.loss(ro, rd, target, plain),
                                        t_atk._leaves(atk.train_part), 5e-3)
        res[key] = out
        del attacked, atk
    res["attack_launches"] = launches
    return res


def wm_views2(dev, backbone_model, workdir):
    """``--n_views 2`` at the README recipe on the same backbone: the key
    blocks render from two key poses and reach the decoder
    channel-concatenated.  Fails unless lossw halves and one whole
    two-view step through the kernels matches the plain versions."""
    w = wm_train(dev, backbone_model, workdir, iters=WM_V2_ITERS, extra=["--n_views", "2"],
                 tag="wm V=2")
    trainer, lossw = w["trainer"], w["trainer"].stats["lossw"]
    if not lossw[-1] <= 0.5 * lossw[0]:
        raise AssertionError(f"V = 2: lossw did not halve: first epoch {lossw[0]}, last "
                             f"{lossw[-1]}")
    acc = trainer.test_bitacc(w["make_loader"]("test", 2, WM_TRIALS))
    x = loader_step_inputs(trainer, next(iter(w["loader"])))
    (lk, gk), (lp, gp) = (wm_step_grads(w["model"], x, plain) for plain in (False, True))
    out = dict(steps=w["steps"], seconds=w["seconds"], step_rays=w["step_rays"],
               rays_per_s=w["steps"] * w["step_rays"] / w["seconds"],
               step_ms=w["seconds"] / w["steps"] * 1e3, peak_gib=w["peak"], bitacc=acc,
               lossw_first=lossw[0], lossw_last=lossw[-1], launches=w["launches"],
               block_rays=list(x["ro_b"].shape),
               step=check_step("wm step V=2", lk, gk, lp, gp, 5e-3, TRAINED_LOSS_LIM))
    log(f"[wm V=2] bit accuracy {acc:.4f} over {WM_TRIALS} messages; "
        f"{out['rays_per_s']:.0f} watermark rays/s")
    return out


def phase_wm(dev, backbone_model, workdir):
    """The watermark stage at the README stage-2 recipe on the backbone the
    train phase trained (``wm_train``, 1000 iterations), then ownership
    verification and test images."""
    from nerf_signature_tpu_torch.ops import _cuda

    from nerf_signature_tpu_torch.train.checkpoint import to_state_dict

    w = wm_train(dev, backbone_model, workdir)
    m, trainer, make_loader, loader = w["model"], w["trainer"], w["make_loader"], w["loader"]
    launches, steps, seconds, peak = w["launches"], w["steps"], w["seconds"], w["peak"]
    # the trained watermark model as its checkpoint holds it (host numpy),
    # which the baselines phase's --finetune_decoder run starts from
    trained_state = to_state_dict(trainer._state(full=False))
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
    res["profile"] = profile_steps(
        trainer, loader, tag="wm profile",
        step=lambda data: trainer.train_step_data(data, trainer.random_message()))

    if not lossw[-1] <= 0.5 * lossw[0]:
        raise AssertionError(f"lossw did not halve: first epoch {lossw[0]}, last {lossw[-1]}")
    if not res["bitacc_none"] >= 0.95:
        raise AssertionError(f"bit accuracy {res['bitacc_none']:.4f} < 0.95")
    if not images["PSNR"] >= 30.0:
        raise AssertionError(f"test_image PSNR {images['PSNR']:.2f} dB < 30 dB")
    res["jpeg"] = wm_jpeg(trainer, make_loader, loader)
    res.update(wm_attacks(trainer, make_loader, loader))
    del w, m, trainer, loader, make_loader
    gc.collect()  # the trainers hold cycles: free the first model before the second
    res["views2"] = wm_views2(dev, backbone_model, os.path.join(workdir, "views2"))
    res["trained_state"] = trained_state
    return res


# ---------------------------------------------------------------- phase 9
DL_K = 64            # --steps_per_dispatch of the device-loop runs
DL_CHECK_CLEAN = 16  # graph against eager: clean steps
DL_CHECK_WM = 8      # and watermark steps
# the per-step limits of the whole-step checks (clean_steps, wm_steps) by dtype
DL_LIMITS = {"clean": {torch.bfloat16: 2e-3, torch.float32: 1e-5},
             "wm": {torch.bfloat16: 5e-3, torch.float32: 1e-4}}


def auto_mc(n_occupied, N, S):
    """Mc as the auto compaction sizes it from a batch's occupancy
    (Trainer._adapt_compaction's target: ceil(1.3 x fill x 16) / 16 of the
    slots, 1024-slot buckets), and that fraction."""
    fill = min(float(n_occupied.float().mean()), S) / S
    frac = min(1.0, math.ceil(1.3 * fill * 16.0) / 16.0)
    return min(int(math.ceil(N * S * frac / 1024.0)) * 1024, N * S), frac


def k5_march(m, n_rays, budget, seed):
    """The trained model's march at a step's shapes (n_rays random pixels of
    an orbit view, perturbation noise): (mask, xyzs, rays_d, n_occupied)."""
    from nerf_signature_tpu_torch.ops.marching import march_rays_aabb
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    dev, rc = m.device, m.rc
    ro, rd = train_rays(dev, seed, n_rays)
    noise = torch.rand((n_rays,), generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
    out = march_rays_aabb(ro, rd, default_aabb(rc), m.occ.occupancy, min_near=rc.min_near,
                          bound=rc.bound, dt_gamma=rc.dt_gamma, max_steps=rc.max_steps,
                          budget=budget, prefilter=rc.prefilter,
                          group_budget=rc.group_budget or None, noise=noise)
    return out["mask"], out["xyzs"], rd, out["n_occupied"]


def k5_check(mask, xyzs, rays_d, Mc, sig_c, rgb_c, g_sig, g_rgb, what):
    """K5's pack, unpack and unpack backward against their plain versions
    on one input: every output bit for bit.  Returns what k5_case times."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    comp = t_compact.compact(mask, xyzs, rays_d, Mc)
    plain = t_compact.compact_plain(mask, xyzs, rays_d, Mc)
    so, sa = t_compact.slot_maps_plain(plain)
    sk, rk = t_compact._unpack_kernel(sig_c, rgb_c, comp.slot_of)
    leaves = [sig_c.clone().requires_grad_(), rgb_c.clone().requires_grad_()]
    sp, rp = t_compact.uncompact_plain(*leaves, plain)
    pairs = {"K5_compact_pack": [(comp.xyz_c, plain.xyz_c), (comp.dir_c, plain.dir_c),
                                 (comp.slot_of, so), (comp.sample_of, sa)],
             "K5_compact_unpack": [(sk, sp), (rk, rp)]}
    if mask.numel():
        gp = torch.autograd.grad((sp, rp), leaves, (g_sig, g_rgb), retain_graph=True)
        gk = t_compact.unpack_bwd(g_sig, g_rgb, comp.sample_of)
        pairs["K5_compact_unpack_bwd"] = [(gk[0], gp[0]), (gk[1], gp[1])]
    torch.cuda.synchronize()
    for name, ab in pairs.items():
        if not all(torch.equal(a, b.detach()) for a, b in ab):
            raise AssertionError(f"{name} differs from its plain version ({what})")
    return comp, plain, leaves, (sp, rp)


def k5_case(dev, mask, xyzs, rays_d, Mc, what, reps=50, digest=None):
    """K5 at one step's shapes: bit-exact against the plain versions
    (k5_check), then each kernel's time a call (CUDA events), device time
    (cold: the L2 flushed before each call; and warm) and host µs a call
    (``call_split``), the plain version's time, the yardstick's
    (``library``: cumsum and index_put_ for the pack; for the unpack the
    gather alone through a ``src`` built beforehand, the keep mask's zeros
    excluded; indexing_backward -- index_put_ with accumulate -- for its
    backward) and the bound; with ``digest``, each row's "sha" holds the
    digests of the kernel's outputs.  Bytes
    the function must move: pack 1 B of mask and 4 B of slot map a sample,
    12 B of rays_d a ray, 12 B of position a kept sample, 28 B a slot
    (position, direction, sample index); unpack 4 B of slot map and 16 B of
    output a sample, 16 B of field output a kept sample; unpack backward 4 B
    of sample index and 16 B of gradient a slot, 16 B of cotangent a kept
    sample.  Returns {kernel: row}."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    N, S = mask.shape
    M = N * S
    g = torch.Generator(device=dev).manual_seed(M + Mc)
    sig_c = torch.randn((Mc,), generator=g, device=dev)
    rgb_c = torch.rand((Mc, 3), generator=g, device=dev)
    g_sig = torch.randn((M,), generator=g, device=dev)
    g_rgb = torch.randn((M, 3), generator=g, device=dev)
    comp, plain, leaves, outs = k5_check(mask, xyzs, rays_d, Mc, sig_c, rgb_c, g_sig, g_rgb,
                                         what)
    K = int(plain.keep.sum())
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    dst = torch.where(plain.keep, rank, Mc)
    src = torch.clamp(rank, 0, Mc - 1)
    gs_live = torch.where(plain.keep, g_sig, 0.0)
    gr_live = torch.where(plain.keep[:, None], g_rgb, 0.0)
    slots = torch.zeros((Mc + 1, 3), device=dev)
    xyz_flat = xyzs.reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(N, S, 3).reshape(-1, 3)

    def lib_pack():
        torch.cumsum(flat.to(torch.int64), 0)
        slots.index_put_((dst,), xyz_flat)
        slots.index_put_((dst,), dirs)

    def lib_bwd():
        torch.zeros((Mc,), device=dev).index_put_((src,), gs_live, accumulate=True)
        torch.zeros((Mc, 3), device=dev).index_put_((src,), gr_live, accumulate=True)

    fns = {
        "K5_compact_pack": (lambda: t_compact.compact(mask, xyzs, rays_d, Mc),
                            lambda: t_compact.compact_plain(mask, xyzs, rays_d, Mc), lib_pack,
                            "cumsum + index_put_ (the plain chain)",
                            M + 4 * M + 12 * N + 12 * K + 28 * Mc),
        "K5_compact_unpack": (lambda: t_compact._unpack_kernel(sig_c, rgb_c, comp.slot_of),
                              lambda: t_compact.uncompact_plain(sig_c, rgb_c, plain),
                              lambda: (sig_c[src], rgb_c[src]),
                              "the gather alone (keep mask excluded)", 4 * M + 16 * M + 16 * K),
        "K5_compact_unpack_bwd": (
            lambda: t_compact.unpack_bwd(g_sig, g_rgb, comp.sample_of),
            lambda: torch.autograd.grad(outs, leaves, (g_sig, g_rgb), retain_graph=True),
            lib_bwd, "indexing_backward (index_put_ with accumulate)", 4 * Mc + 16 * Mc + 16 * K),
    }
    rows = {}
    for name, (kernel, plain_fn, lib, lib_what, n_bytes) in fns.items():
        b_ms, b_by = bound_of(n_bytes, 0, PEAK_FP32)
        t, tl = call_split(kernel, reps, b_ms), call_split(lib, reps)
        rows[name] = {"ms": t["ms"], "device_ms": t["device_ms_cold"],
                      "device_ms_warm": t["device_ms_warm"], "host_us": t["host_us"],
                      "plain_ms": median_ms(plain_fn, reps),
                      "library_ms": tl["ms"], "library_device_ms": tl["device_ms_cold"],
                      "library_host_us": tl["host_us"], "library_what": lib_what,
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
                      "shape": f"{N} x {S}, Mc {Mc}, kept {K}"}
        if digest is not None:
            got = kernel()
            if name == "K5_compact_pack":
                got = [got.xyz_c, got.dir_c, got.slot_of, got.sample_of]
            rows[name]["sha"] = [digest(v) for v in got]
        r = rows[name]
        log(f"[k5] {name} at {r['shape']}: bit-exact; {r['ms']:.4f} ms a call, device "
            f"{r['device_ms']:.4f} cold, {r['device_ms_warm']:.4f} warm (bound {b_ms:.4f}, "
            f"{b_by}), host {r['host_us']:.1f} us a call; plain {r['plain_ms']:.4f}; "
            f"{lib_what} {r['library_ms']:.4f}, device {r['library_device_ms']:.4f} cold, "
            f"host {r['library_host_us']:.1f} us")
    return rows


# K5's pack at the watermark step's shape: packs of one input, each held bit
# for bit against the plain version, and replays of one captured pack on the
# masks of other marches
K5_REPEATS = 200
K5_REPLAYS = 3


def k5_same(comp, plain):
    """Whether the kernel's pack equals the plain version's, bit for bit."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    so, sa = t_compact.slot_maps_plain(plain)
    return all(torch.equal(a, b) for a, b in ((comp.xyz_c, plain.xyz_c),
                                              (comp.dir_c, plain.dir_c),
                                              (comp.slot_of, so), (comp.sample_of, sa)))


def k5_repeats(mask, xyzs, rays_d, Mc, what):
    """K5_REPEATS packs of one input, each bit-equal to the plain version: a
    look-back that read a status word out of order would show as a rare
    wrong offset."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    plain = t_compact.compact_plain(mask, xyzs, rays_d, Mc)
    bad = sum(not k5_same(t_compact.compact(mask, xyzs, rays_d, Mc), plain)
              for _ in range(K5_REPEATS))
    if bad:
        raise AssertionError(f"K5_compact_pack differs from its plain version in {bad} of "
                             f"{K5_REPEATS} packs ({what})")
    log(f"[k5] {K5_REPEATS} packs at {what}: every one bit-exact")
    return K5_REPEATS


def k5_graph(m, n_rays, budget, Mc):
    """The pack captured once in a CUDA graph, then replayed K5_REPLAYS times
    on the masks of other marches copied into its inputs: bit-exact each
    time, so the tile counter and the status words start clean on every
    replay.  Returns the kept counts of the replays."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    inputs = [t.clone() for t in k5_march(m, n_rays, budget, seed=50)[:3]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t_compact.compact(*inputs, Mc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        comp = t_compact.compact(*inputs, Mc)
    kept = []
    for seed in range(51, 51 + K5_REPLAYS):
        new = k5_march(m, n_rays, budget, seed=seed)[:3]
        for dst, src in zip(inputs, new):
            dst.copy_(src)
        graph.replay()
        plain = t_compact.compact_plain(*new, Mc)
        if not k5_same(comp, plain):
            raise AssertionError(f"K5_compact_pack replayed from a CUDA graph differs from its "
                                 f"plain version (replay {len(kept)}, {n_rays} x {budget})")
        kept.append(int(plain.keep.sum()))
    del graph
    log(f"[k5] the pack captured once, replayed on {K5_REPLAYS} other marches at {n_rays} x "
        f"{budget} (kept {kept} of Mc {Mc}): bit-exact each time")
    return kept


def k5_phase(dev, m):
    """K5 on kernel_cases' edges, then at the clean step's shapes (4096 rays
    x the train budget 128, Mc from the auto compaction) and the watermark
    step's (8,704 x 256) on the trained model's grid; at the latter also
    the pack's repeats and graph replays."""
    from nerf_signature_tpu_torch.kernel_cases import k5_edge_inputs

    for name, *case in k5_edge_inputs():
        mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb = (
            torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v for v in case)
        k5_check(mask, xyzs, rd, Mc, sig_c, rgb_c, g_sig, g_rgb, f"edge {name}")
    log(f"[k5] edge cases bit-exact: {[c[0] for c in k5_edge_inputs()]}")
    rows = {}
    for tag, n_rays, budget in (("", TRAIN_RAYS, TRAIN_BUDGET), ("_wm", WM_STEP_RAYS, 256)):
        mask, xyzs, rd, n_occ = k5_march(m, n_rays, budget, seed=41)
        Mc, frac = auto_mc(n_occ, n_rays, budget)
        if Mc >= n_rays * budget:
            raise AssertionError(f"K5 at {n_rays} x {budget}: the auto compaction packs nothing "
                                 f"(fraction {frac})")
        for name, row in k5_case(dev, mask, xyzs, rd, Mc, f"{n_rays} x {budget}").items():
            rows[name + tag] = dict(row, compact_frac=frac)
    rows["K5_compact_pack_wm"].update(
        repeats_bit_exact=k5_repeats(mask, xyzs, rd, Mc, f"{n_rays} x {budget}"),
        graph_replays_kept=k5_graph(m, n_rays, budget, Mc))
    return rows


def dl_clean_trainer(dev, dtype, compact_frac=0.5):
    """A fresh full-width clean model (the train phase's settings, compaction
    at ``compact_frac``) and its Trainer (no workspace)."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.train.trainer import Trainer

    opt = SimpleNamespace(lr=1e-2, iters=TRAIN_ITERS, num_rays=TRAIN_RAYS, max_steps=1024,
                          update_extra_interval=16, compact_frac=-1, group_budget=-1,
                          max_ray_batch=CHUNK, patch_size=1, color_space="srgb")
    model = NGPModel(NGPConfig(bound=1.0, compute_dtype=dtype), min_near=0.2,
                     density_thresh=10.0, dt_gamma=0.0, max_steps=1024, grid_size=128, seed=2,
                     train_budget=TRAIN_BUDGET, infer_budget=256, compact_frac=compact_frac,
                     device=dev)
    return Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch", mute=True)


def dl_wm_trainer(dev, dtype, distortion="noise", compact_frac=0.5):
    """The recipe's watermarked model with random weights (make_wm_model),
    compaction at ``compact_frac``, and its WatermarkTrainer (no
    workspace)."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch.train.trainer_wtmk import WatermarkTrainer

    m = make_wm_model(dev, dtype=dtype)
    m.rc = dataclasses.replace(m.rc, compact_frac=compact_frac)
    opt = SimpleNamespace(seed=0, iters=WM_ITERS, lr=1e-2, lambda_w=0.005, lambda_i=1.0,
                          loss_w="bce", distortion=distortion, message_dim=WM_BITS,
                          num_rays=TRAIN_RAYS, max_ray_batch=CHUNK, compact_frac=0,
                          group_budget=0, bitacc_batch=8)
    return WatermarkTrainer("wm", opt, m, workspace=None, use_checkpoint="scratch", mute=True)


def _rows(draws, lo, hi):
    """Rows [lo, hi) of a dispatch's draws."""
    return type(draws)(*(None if t is None else t[lo:hi] for t in draws))


def dl_check(tag, dtype, traj, steps, last_grads, final, lim):
    """A graph run against eager steps on the same draws.  ``traj``: the
    graph's and an eager run's losses over every step (each run on its own:
    the losses' worst relative gap).  ``steps``: for every step, one eager
    step (Adam on the host's lr) from the state the graph held before it,
    against the graph's step -- the loss (1e-6) and Adam's two moments after
    it, per leaf (rel L2 at the limit; leaves whose gradient is below 1e-5
    of the largest left out: a conv bias before a batch norm), so a replay
    that reads state of another step fails at that step.  The leaves after
    Adam are held to the limit at the last step, with the gradients
    (``last_grads``: the graph's and the eager step's); at the first steps
    Adam moves every entry by about lr whatever its gradient's size, so an
    entry whose gradient sits at the atomics' rounding can step either way
    (their worst per-step gap is a reading).  ``final``: the final leaves'
    worst rel L2 between the graph run and an eager run, two eager runs, and
    the eager run and the loop's body run eagerly (Adam capturable):
    readings, not checked (an ulp at one step grows over the run: bf16
    roundings flip, and Adam steps by about lr on any gradient)."""
    lg, le = traj
    traj_rel = float(np.max(np.abs(np.asarray(lg) - np.asarray(le)) / np.abs(np.asarray(le))))
    worst_loss, worst_m, worst_p = 0.0, 0.0, 0.0
    for lgj, le_j, ge, pg, pe, ag, ae in steps:
        worst_loss = max(worst_loss, abs(lgj - float(le_j)) / abs(float(le_j)))
        scale = max(float(g.norm()) for g in ge)
        live = [float(g.norm()) > 1e-5 * scale for g in ge]
        worst_m = max([worst_m] + [rel_l2(x[k], y[k]) for x, y, ok in zip(ag, ae, live) if ok
                                   for k in ("exp_avg", "exp_avg_sq")])
        worst_p = max([worst_p] + [rel_l2(x, y) for x, y, ok in zip(pg, pe, live) if ok])
    _, le_n, ge_n, pg_n, pe_n, _, _ = steps[-1]
    scale = max(float(g.norm()) for g in ge_n)
    last_p = max(rel_l2(x, y) for x, y, g in zip(pg_n, pe_n, ge_n)
                 if float(g.norm()) > 1e-5 * scale)
    e = step_errors(torch.tensor(lg[-1]), last_grads[0], le_n, last_grads[1])
    log(f"[graph vs eager] {tag} {str(dtype)[6:]}: {len(lg)} steps each, losses worst rel "
        f"{traj_rel:.3g}; each step from the graph's own state: loss rel {worst_loss:.3g}, "
        f"Adam's moments worst rel L2 {worst_m:.3g} (leaves after Adam {worst_p:.3g}, a "
        f"reading); the last step: {e['kept']} leaves' grads worst rel L2 "
        f"{e['worst_rel_l2']:.3g}, leaves after Adam {last_p:.3g} (limit {lim:g}, loss 1e-6); "
        f"final leaves worst rel L2 (readings): graph vs eager {final['graph_vs_eager']:.3g}, "
        f"eager vs eager {final['eager_vs_eager']:.3g}, eager capturable Adam vs eager "
        f"{final['capturable_vs_eager']:.3g}, graph vs eager capturable "
        f"{final['graph_vs_capturable']:.3g}")
    if not (traj_rel <= lim and worst_loss <= 1e-6 and worst_m <= lim
            and e["worst_rel_l2"] <= lim and last_p <= lim):
        raise AssertionError(f"graph vs eager, {tag} {dtype}: a replayed step differs")
    return dict({"traj_loss_rel": traj_rel, "loss_rel": worst_loss, "adam_rel_l2": worst_m,
                 "grad_rel_l2": e["worst_rel_l2"], "leaf_rel_l2": last_p,
                 "leaf_rel_l2_any_step": worst_p},
                **{f"final_{k}": v for k, v in final.items()})


class EagerSteps:
    """In a trainer's ``step_graph`` slot: the loop's steps run eagerly on
    the card (the same body and capturable Adam, no graph)."""

    captures = 0

    def drop(self):
        pass

    def run(self, body, key, held, n, before_step=None):
        for j in range(n):
            if before_step is not None:
                before_step(j)
            body()


def graph_vs_eager(dev, views):
    """device_train_loop (a replayed CUDA graph) against per-step
    Trainer._train_step calls through the kernels (Adam on the host's lr),
    on the same draws and grid updates: DL_CHECK_CLEAN clean steps on the
    RGBA views in bf16 and fp32 and on their RGB pixels (a white background)
    in fp32, and DL_CHECK_WM watermark steps the same way (noise
    distortion) in bf16 and fp32, compaction on (dl_check, the whole-step
    limits DL_LIMITS).  The graph runs in two dispatches, all steps but the
    last, then the last alone (a pure replay); the state before every step
    (after the grid update) is kept, and one eager step from it is held
    against the graph's step.  Fails unless each run counts one launch of
    K2, K3, K1's and K3's backward and K5 a step."""
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train.trainer import param_leaves
    from nerf_signature_tpu_torch.train.trainer_wtmk import trainable_leaves, view_batch_shape

    out = {}
    rgba = views.images
    P = len(views.poses)
    clean_leaves = lambda t: param_leaves(t.model.params)
    wm_leaves = lambda t: trainable_leaves(t.model.trainable)

    def state_of(t, leaves_of):
        return {"leaves": [p.detach().clone() for p in leaves_of(t)],
                "ema": ([p.detach().clone() for p in param_leaves(t.ema_params)]
                        if getattr(t, "ema_params", None) is not None else None),
                "adam": [{k: v.clone() for k, v in t.optimizer.state[p].items()}
                         for p in leaves_of(t)],
                "occ": [None if x is None else x.clone() for x in t.model.occ]}

    def graph_run(t, leaves_of, n, loop):
        """n steps in two dispatches: (losses, the state before each step and
        after the last, the last step's grads, the launch counts)."""
        states = []
        run_steps = t_dl.run_steps

        def keeping(owner, body, key, held, k, device, before_step=None):
            def before(j):
                if before_step is not None:
                    before_step(j)
                states.append(state_of(owner, leaves_of))
            return run_steps(owner, body, key, held, k, device, before)

        _cuda.reset_launch_counts()
        t_dl.run_steps = keeping
        try:
            losses = list(loop(t, 0, n - 1))
            captures = t.step_graph.captures
            losses += list(loop(t, n - 1, n))
        finally:
            t_dl.run_steps = run_steps
        if t.step_graph.captures != captures:
            raise AssertionError("the last dispatch captured the step again")
        counts = _cuda.launch_counts()
        states.append(state_of(t, leaves_of))
        return losses, states, [p.grad.clone() for p in leaves_of(t)], counts

    def per_step(make, leaves_of, states, lg, step):
        """One eager step from the graph's state before each step: (graph's
        loss, eager loss, eager grads, graph's leaves after, eager's, graph's
        Adam state after, eager's)."""
        t1 = make()
        rows = []
        for j in range(len(lg)):
            _copy_state(t1, states[j], leaves_of, j)
            l1 = step(t1, j)
            rows.append((lg[j], l1, [p.grad.clone() for p in leaves_of(t1)],
                         states[j + 1]["leaves"], [p.detach().clone() for p in leaves_of(t1)],
                         states[j + 1]["adam"],
                         [{k: v.clone() for k, v in t1.optimizer.state[p].items()}
                          for p in leaves_of(t1)]))
        return rows

    def eager_run(make, leaves_of, n, step, grid_updates):
        """n eager steps of a fresh trainer: (losses, final leaves)."""
        t = make()
        losses = []
        for j in range(n):
            if grid_updates and j % 16 == 0:
                t.model.update_extra_state(full=True)
            losses.append(float(step(t, j)))
        return losses, [p.detach().clone() for p in leaves_of(t)]

    def capturable_run(make, leaves_of, loop, n):
        """The loop's body run eagerly on a fresh trainer: final leaves."""
        t = make()
        t_dl.prepare_device_loop(t, leaves_of(t))
        t.step_graph = EagerSteps()
        loop(t, 0, n)
        return [p.detach().clone() for p in leaves_of(t)]

    def finals(pg, make, leaves_of, n, step, grid_updates, loop, grads):
        """Final-leaf readings (leaves whose last gradient is below 1e-5 of
        the largest left out) and the eager run's losses."""
        le, pe = eager_run(make, leaves_of, n, step, grid_updates)
        _, pe2 = eager_run(make, leaves_of, n, step, grid_updates)
        pc = capturable_run(make, leaves_of, loop, n)
        scale = max(float(g.norm()) for g in grads)
        live = [float(g.norm()) > 1e-5 * scale for g in grads]
        gap = lambda a, b: max(rel_l2(x, y) for x, y, ok in zip(a, b, live) if ok)
        return le, {"graph_vs_eager": gap(pg, pe), "eager_vs_eager": gap(pe2, pe),
                    "capturable_vs_eager": gap(pc, pe), "graph_vs_capturable": gap(pg, pc)}

    for dtype, C in ((torch.bfloat16, 4), (torch.float32, 4), (torch.float32, 3)):
        lim = DL_LIMITS["clean"][dtype]
        n = DL_CHECK_CLEAN
        data = t_dl.preload(views.poses, rgba[..., :C], views.intrinsics, RES, RES, dev)
        draws = t_dl.draw_clean(torch.Generator(device=dev).manual_seed(17), n, P, TRAIN_RAYS,
                                RES * RES, C == 4, dev)
        make = lambda: dl_clean_trainer(dev, dtype)
        tg = make()
        t_dl.prepare_device_loop(tg, clean_leaves(tg))

        def clean_loop(t, lo, hi):
            t.global_step = lo
            return t_dl.device_train_loop(t, data, hi - lo, draws=_rows(draws, lo, hi)).losses

        lg, states, grads, counts = graph_run(tg, clean_leaves, n, clean_loop)
        k4_route(counts, dtype, ("K4_field", "K4_field_bwd"), "graph of the clean step")
        for name in ("K2_march", "K3_composite", "K1_hash_encode_bwd", "K3_composite_bwd",
                     "K5_compact_pack", "K5_compact_unpack", "K5_compact_unpack_bwd"):
            if counts[name] != n:
                raise AssertionError(f"graph of the clean step: {name} counted {counts[name]} "
                                     f"launches in {n} steps")
        captures = tg.step_graph.captures
        del tg
        gc.collect()
        white = torch.ones((1, 3), device=dev)

        def clean_eager(t, j):
            pidx, pix = int(draws.pidx[j]), draws.pix[j]
            ro, rd = t_dl.rays_from_pixels(data.poses[pidx], data.intrinsics, pix, RES, RES)
            bg = draws.bg[j] if draws.bg is not None else white
            return t._train_step(ro, rd, data.images[pidx][pix], bg, draws.noise[j],
                                 t._rc_train(), t.model.train_budget)[0]

        steps = per_step(make, clean_leaves, states, lg, clean_eager)
        le, final = finals(states[-1]["leaves"], make, clean_leaves, n, clean_eager, True,
                           clean_loop, steps[-1][2])
        tag = "clean" if C == 4 else "clean rgb"
        out[f"{tag.replace(' ', '_')}_{str(dtype)[6:]}"] = dict(
            dl_check(tag, dtype, (lg, le), steps, (grads, steps[-1][2]), final, lim),
            captures=captures)
        del data, states, steps
        gc.collect()

    x = wm_step_inputs(dev)
    fl = WM_RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    poses = orbit_poses(4, ORBIT_RADIUS, seed=44)
    rng = np.random.default_rng(44)
    wdata = t_dl.preload(poses, rng.uniform(size=(4, WM_RES * WM_RES, 3)),
                         (fl, fl, WM_RES / 2, WM_RES / 2), WM_RES, WM_RES, dev)
    for dtype in (torch.bfloat16, torch.float32):
        lim = DL_LIMITS["wm"][dtype]
        n = DL_CHECK_WM
        wdraws = t_dl.draw_wm(torch.Generator(device=dev).manual_seed(18), n, WM_BITS, 4,
                              TRAIN_RAYS, WM_RES**2, "noise", view_batch_shape(x["ro_b"].shape),
                              dev)
        make = lambda: dl_wm_trainer(dev, dtype)
        wg = make()
        t_dl.prepare_device_loop(wg, wm_leaves(wg))

        def wm_loop(t, lo, hi):
            return t_dl.wm_device_loop(t, wdata, x["ro_b"], x["rd_b"], hi - lo,
                                       draws=_rows(wdraws, lo, hi))[0]

        lg, states, grads, counts = graph_run(wg, wm_leaves, n, wm_loop)
        k4_route(counts, dtype, ("K4_field", "K4_field_bwd_feat"), "graph of the wm step")
        for name in ("K2_march", "K9_msg_table", "K9_msg_table_bwd", "K5_compact_unpack_bwd"):
            if counts[name] != n:
                raise AssertionError(f"graph of the wm step: {name} counted {counts[name]} "
                                     f"launches in {n} steps")
        captures = wg.step_graph.captures
        del wg
        gc.collect()

        def wm_eager(t, j):
            pidx, pix = int(wdraws.pidx[j]), wdraws.pix[j]
            ct_o, ct_d = t_dl.rays_from_pixels(wdata.poses[pidx], wdata.intrinsics, pix, WM_RES,
                                               WM_RES)
            return t._train_step(x["ro_b"], x["rd_b"], ct_o, ct_d, wdata.images[pidx][pix],
                                 wdraws.message[j], wdraws.distortion[j], t.model.rc)[0]

        steps = per_step(make, wm_leaves, states, lg, wm_eager)
        le, final = finals(states[-1]["leaves"], make, wm_leaves, n, wm_eager, False, wm_loop,
                           steps[-1][2])
        out[f"wm_{str(dtype)[6:]}"] = dict(
            dl_check("wm", dtype, (lg, le), steps, (grads, steps[-1][2]), final, lim),
            captures=captures)
        del states, steps
        gc.collect()
    return out


def _copy_state(dst, before, leaves_of, step_count):
    """The trainer ``dst`` (per-step Adam) put in a graph run's saved state:
    its leaves (and EMA), Adam's moments and count, and the grid."""
    with torch.no_grad():
        for a, b in zip(leaves_of(dst), before["leaves"]):
            a.copy_(b)
        if before["ema"] is not None:
            from nerf_signature_tpu_torch.train.trainer import param_leaves

            for a, b in zip(param_leaves(dst.ema_params), before["ema"]):
                a.copy_(b)
        for a, st in zip(leaves_of(dst), before["adam"]):
            dst.optimizer.state[a] = {"step": torch.tensor(float(step_count)),
                                      "exp_avg": st["exp_avg"].clone(),
                                      "exp_avg_sq": st["exp_avg_sq"].clone()}
        for a, b in zip(dst.model.occ, before["occ"]):
            if a is not None:
                a.copy_(b)


# the kernels of K5's pack in a trace, by a substring of their names (an
# earlier design, still timed against this one, launched k5_count and
# k5_scan before its k5_pack)
K5_PACK_TRACE = ("k5_pack", "k5_count", "k5_scan")


def k6_bytes(m, full):
    """The bytes one grid update must move: the grid's decayed-max and live
    densities read and written (4 B each a cell), its bitfield written (1 B),
    each queried cell's jitter read (12 B; a partial update also its 12 B
    coordinates and 4 B uniform), and the hash table and MLP weights the
    density queries read once."""
    cells = m.occ.density.numel()
    queried = cells if full else 2 * (cells // 4)
    draws = queried * 12 + (0 if full else (cells // 4) * 16)
    params = sum(t.numel() * t.element_size() for t in
                 [m.params["hash_table"], *m.params["sigma_net"]])
    return cells * (4 + 4) * 2 + cells + draws + params


def k6_own_bytes(m, draws):
    """The bytes K6's own work must move, its queries' left out: the grid's
    decayed-max and live densities read and written (4 B each a cell), its
    bitfield written (1 B), the draws read (as their tensors hold them),
    each query's position written (12 B) and its sigma read (4 B)."""
    cells = m.occ.density.numel()
    drawn = sum(t.numel() * t.element_size() for d in draws for t in d if t is not None)
    queried = sum(d.jitter.shape[0] for d in draws)
    return cells * (4 + 4) * 2 + cells + drawn + queried * (12 + 4)


def k6_query_bytes(cfg, cells):
    """The bytes K6's queries (K1's forward and K4's density query on the
    update's ``cells`` positions) must move: a position read (12 B), its
    feature row of feature_pitch fp32 written by K1 and read back by K4, its
    sigma written (4 B), and the rows of the bf16 table the queries touch,
    read once: at a level of resolution r the update's cells (one jittered
    position a cell of the grid, which they fill) reach its (r + 1)^3
    corner points, which a hashed level spreads over its 2^S rows (expected
    distinct rows 2^S (1 - exp(-(r + 1)^3 / 2^S)))."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    size = float(1 << cfg.log2_hashmap_size)
    sides = cfg.dense_sides or (0,) * cfg.n_levels
    rows = sum((r + 1) ** 3 if side else size * -math.expm1(-(r + 1) ** 3 / size)
               for r, side in zip(cfg.resolutions, sides))
    return cells * (12 + 2 * 4 * t_ngp.feature_pitch(cfg) + 4) + rows * cfg.n_features * 2


# K6's own device work in a trace, by a substring of its names: its kernels
# (csrc/grid.cu), the memsets of its scratch and the mean's reduction
K6_OWN_TRACE = ("k6_", "Memset", "MeanOps")


def k6_split(m, full, draws, reps=5, plain=False):
    """One grid update of ``m`` (``update_extra_state``) on ``draws`` under
    torch.profiler, ``reps`` times: its device ms a call, split into its
    queries' (the device work of ``density_fn`` on the positions the update
    handed it, recorded from one update and traced alone), the query's
    setup (``m._density_query()``: the field's parameters, made once an
    update, traced alone) and K6's own, the rest (and, on the kernel route,
    its named work, K6_OWN_TRACE: the rest less the ~0.01-0.04 ms by which
    the queries read apart inside the update and alone); and by kernel
    (full names); ``plain``: of the plain route.  None where a trace came
    back empty."""
    kw = {"plain": True} if plain else {}  # (a parent tree's entry has no plain)
    run = lambda: m.update_extra_state(full=full, draws=draws, **kw)  # noqa: E731
    seen = []
    make = m._density_query

    def recording():
        fn = make()
        return lambda x: (seen.append(x.clone()), fn(x))[1]

    m._density_query = recording
    try:
        run()
    finally:
        del m._density_query  # the class's again
    with torch.no_grad():  # as the update queries
        fn = m._density_query()
        by_name, _ = traced(lambda: [run() for _ in range(reps)], "k6 split")
        queries, _ = traced(lambda: [[fn(x) for x in seen] for _ in range(reps)], "k6 queries")
        setup, _ = traced(lambda: [m._density_query() for _ in range(reps)], "k6 query setup")
    if by_name is None or queries is None or setup is None:
        return None
    total, q_us, s_us = (sum(d.values()) for d in (by_name, queries, setup))
    named = sum(us for name, us in by_name.items() if any(p in name for p in K6_OWN_TRACE))
    return {"device_ms": total / reps / 1e3, "queries_ms": q_us / reps / 1e3,
            "query_setup_ms": s_us / reps / 1e3, "own_ms": (total - q_us - s_us) / reps / 1e3,
            "own_named_ms": named / reps / 1e3,
            "by_kernel": {name: us / reps / 1e3 for name, us in
                          sorted(by_name.items(), key=lambda kv: -kv[1])},
            "queries_by_kernel": {name: us / reps / 1e3 for name, us in queries.items()},
            "query_setup_by_kernel": {name: us / reps / 1e3 for name, us in setup.items()}}


K6_SOURCE = ("nerf_signature_tpu_torch/csrc/grid.cu", "nerf_signature_tpu/ops/grid.py:136")
# K6's counters by update kind
K6_KERNELS = {"full": ("K6_full_points", "K6_full_finalize", "K6_full_threshold"),
              "partial": ("K6_partial_occupied", "K6_partial_points", "K6_partial_scatter",
                          "K6_partial_finalize", "K6_partial_threshold")}


def k6_launches_an_update(C, H, full, chunk=1 << 21):
    """K6's launches in one update of C cascades of H^3 cells (its queries
    in chunks of ``chunk``)."""
    n = H**3 if full else 2 * (H**3 // 4)
    chunks = -(-n // chunk)
    if full:
        return {"K6_full_points": C, "K6_full_finalize": C * chunks, "K6_full_threshold": 1}
    return {"K6_partial_occupied": 1, "K6_partial_points": C, "K6_partial_scatter": C * chunks,
            "K6_partial_finalize": 1, "K6_partial_threshold": 1}


def k6_bits_differ(a, b):
    """The elements where two tensors' bits differ (floats by their bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def k6_check(m, full, draws, what):
    """K6 on ``m``'s grid against its plain version, each from the grid as it
    is, on ``draws``: first the queries' cells and positions
    (``query_points``), then the update through ``update_extra_state``:
    density, density_live, occupancy, mean_density and iter_density bit for
    bit, the grid's tensors written in place; the grid is left as it was.
    Returns the largest |difference| of density and density_live (0)."""
    from nerf_signature_tpu_torch.ops import grid as t_grid

    kw = dict(bound=m.rc.bound, grid_size=m.rc.grid_size, full=full)
    for cas, ((kc, kx), (pc, px)) in enumerate(zip(
            t_grid.query_points(m.occ, draws, **kw),
            t_grid.query_points(m.occ, draws, plain=True, **kw))):
        bad = k6_bits_differ(kc, pc) + k6_bits_differ(kx, px)
        if bad:
            raise AssertionError(f"K6 {what}, cascade {cas}: {bad} query cells or position "
                                 f"floats differ from the plain version's")
    saved = [t.clone() for t in m.occ]
    ids = [t.data_ptr() for t in m.occ]
    outs = []
    for plain in (True, False):
        for a, b in zip(m.occ, saved):
            a.copy_(b)
        m.update_extra_state(full=full, draws=draws, plain=plain)
        outs.append([t.clone() for t in m.occ])
    if [t.data_ptr() for t in m.occ] != ids:
        raise AssertionError(f"K6 {what}: the grid's tensors were replaced, not written in place")
    for a, b in zip(m.occ, saved):
        a.copy_(b)
    for field, p, k in zip(m.occ._fields, *outs):
        bad = k6_bits_differ(k, p)
        if bad:
            raise AssertionError(f"K6 {what}: {field} differs from the plain version's in {bad} "
                                 f"elements")
    return max(float((k - p).abs().max()) for field, p, k in zip(m.occ._fields, *outs)
               if field in ("density", "density_live"))


def k6_edges(dev):
    """K6 on kernel_cases' edge grids (empty, untrained, one occupied cell,
    the resample's u at 0 and at the count, duplicates) at C = 1 and 2, full
    and partial, bit for bit against its plain version."""
    from nerf_signature_tpu_torch.kernel_cases import k6_density, k6_edge_grids
    from nerf_signature_tpu_torch.ops import grid as t_grid

    H, names = 32, []
    for C in (1, 2):
        for full in (True, False):
            for name, dens, live, raw in k6_edge_grids(C, H, full):
                draws = [t_grid.GridDraws(*(None if a is None else torch.from_numpy(a).to(dev)
                                            for a in d)) for d in raw]
                outs = []
                for plain in (True, False):
                    g = t_grid.OccupancyGrid(
                        torch.from_numpy(dens).to(dev),
                        torch.zeros((C, H, H, H), dtype=torch.bool, device=dev),
                        torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32,
                                                                 device=dev),
                        torch.from_numpy(live).to(dev))
                    outs.append(t_grid.update_occupancy_grid_(
                        g, k6_density, bound=float(C), grid_size=H, full=full, draws=draws,
                        density_thresh=10.0, chunk=5000, plain=plain))
                for field, p, k in zip(t_grid.OccupancyGrid._fields, *outs):
                    if k6_bits_differ(k, p):
                        raise AssertionError(f"K6 edge {name} (C {C}, full {full}): {field} "
                                             f"differs from the plain version's")
                names.append(f"{name} C{C} {'full' if full else 'partial'}")
    return names


def k6_phase(dev, m, launches):
    """K6 (csrc/grid.cu): its launches in the clean loop's run (``launches``:
    every update's kernels, by kind); against its plain version on the loop's
    trained grid (C = 1), on a random bound-2 model's grid (C = 2) and on
    the edge grids, full and partial, bit for bit; its device ms a call
    apart from its queries', the plain route's beside it, and the bound of
    its own bytes (k6_own_bytes), full and partial, on the trained grid."""
    from nerf_signature_tpu_torch.ops import grid as t_grid

    C, H = m.occ.density.shape[0], m.rc.grid_size
    updates = {"full": 16, "partial": TRAIN_ITERS // 16 - 16}
    for kind, n_updates in updates.items():
        for name, n in k6_launches_an_update(C, H, kind == "full").items():
            if launches[name] != n * n_updates:
                raise AssertionError(f"Trainer.train_device: {name} counted {launches[name]} "
                                     f"launches in {n_updates} {kind} grid updates")
    log(f"[k6] launches in the clean loop: "
        f"{ {k: launches[k] for names in K6_KERNELS.values() for k in names} }")
    out = {}
    for kind, full in (("full", True), ("partial", False)):
        draws = t_grid.draw_grid_randomness(torch.Generator(device=dev).manual_seed(21), C, H,
                                            full, dev)
        err = k6_check(m, full, draws, f"{kind}, trained grid")
        saved = [t.clone() for t in m.occ]
        split = k6_split(m, full, draws)
        plain = k6_split(m, full, draws, plain=True)
        run = lambda: m.update_extra_state(full=full, draws=draws)  # noqa: E731
        plain_run = lambda: m.update_extra_state(full=full, draws=draws, plain=True)  # noqa
        row = {"max_abs_err": err, "ms": None if split is None else split["own_named_ms"],
               "plain_ms": None if plain is None else plain["own_ms"],
               "own_by_difference_ms": None if split is None else split["own_ms"],
               "update_ms": median_ms(run, 10), "plain_update_ms": median_ms(plain_run, 5),
               "device_ms": None if split is None else split["device_ms"],
               "plain_device_ms": None if plain is None else plain["device_ms"],
               "queries_ms": None if split is None else split["queries_ms"],
               "query_setup_ms": None if split is None else split["query_setup_ms"],
               "library_ms": None,
               "ms_is": "device ms a call of K6's own work: its kernels, memsets and mean "
                        "(plain_ms: the plain route's device work less its queries' "
                        "(density_fn on its positions) and the query's setup)",
               **dict(zip(("bound_ms", "bound_by"),
                          bound_of(k6_own_bytes(m, draws), 0, PEAK_FP32))),
               "queries_cells": sum(d.jitter.shape[0] for d in draws),
               "by_kernel": None if split is None else split["by_kernel"]}
        row["queries_bound_ms"], row["queries_bound_by"] = bound_of(
            k6_query_bytes(m.cfg, row["queries_cells"]), 0, PEAK_FP32)
        for a, b in zip(m.occ, saved):
            a.copy_(b)
        out[kind] = row
        log(f"[k6] {kind} update on the trained grid: bit-equal to the plain version; own "
            f"{row['ms']} device ms a call (plain {row['plain_ms']}), queries "
            f"{row['queries_ms']}, their setup {row['query_setup_ms']}, whole update "
            f"{row['device_ms']} device ms (plain {row['plain_device_ms']}), "
            f"{row['update_ms']:.3f} ms a call (plain {row['plain_update_ms']:.3f}); bound of "
            f"its own bytes {row['bound_ms']:.4f} ms, of its {row['queries_cells']} queries' "
            f"{row['queries_bound_ms']:.4f} ms")
        if split is not None:
            for name, ms in list(split["by_kernel"].items())[:12]:
                log(f"[k6]   {ms:8.4f} ms  {name}")
    m2 = make_model(dev, bound=2.0, seed=4)
    for _ in range(2):
        m2.update_extra_state(full=True)
    for kind, full in (("full", True), ("partial", False)):
        draws = t_grid.draw_grid_randomness(torch.Generator(device=dev).manual_seed(22), 2, H,
                                            full, dev)
        k6_check(m2, full, draws, f"{kind}, bound 2 (C = 2)")
    del m2
    out["edges"] = k6_edges(dev)
    log(f"[k6] bit-equal to the plain version at C = 2 (a random bound-2 model) and on the "
        f"edge grids: {out['edges']}")
    return out


def profile_dispatch(run, n, tag, compacting, match=()):
    """torch.profiler over one more dispatch of n steps: wall and device busy
    ms a step and the idle share (as profile_steps reads them), the device
    ms a step of K5's pack kernels and of memsets (the pack's reset of its
    scratch among them), and of the device work whose names hold each
    string of ``match``."""
    def work():
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e6

    run()  # a dispatch first: a new shape or data is captured outside the trace
    by_name, wall_us = traced(work, tag)
    if by_name is None:
        log(f"[{tag}] device busy time not measured (no trace held device events)")
        return {"wall_ms": wall_us / n / 1e3, "busy_ms": None, "idle_share": None}
    check_k5_trace(by_name, tag, compacting)
    busy_us = sum(by_name.values())
    pack_us = sum(us for name, us in by_name.items() if any(p in name for p in K5_PACK_TRACE))
    memset_us = sum(us for name, us in by_name.items() if "Memset" in name)
    log(f"[{tag}] one dispatch of {n} steps: wall {wall_us / n / 1e3:.3f} ms a step, device "
        f"busy {busy_us / n / 1e3:.3f} ms a step (idle share {1 - busy_us / wall_us:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[{tag}]   {us / n / 1e3:8.4f} ms a step ({us / busy_us:6.1%})  {name}")
    log(f"[{tag}] K5 pack {pack_us / n / 1e3:.4f} ms a step, memsets "
        f"{memset_us / n / 1e3:.4f}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "idle_share": 1 - busy_us / wall_us, "k5_pack_ms": pack_us / n / 1e3,
            "memset_ms": memset_us / n / 1e3,
            "matched_ms": {pat: sum(us for name, us in by_name.items() if pat in name) / n / 1e3
                           for pat in match}}


def phase_device_loop(dev, backbone_model, workdir):
    """The on-device K-step loops (``--steps_per_dispatch``): K5 against its
    plain version (edges; the clean and watermark steps' shapes, on the
    trained backbone's grid), the replayed graph against eager steps, the
    clean loop (Trainer.train_device, 512 steps at K = 64 on the radius-0.7
    ball: the loss falls, the held-out PSNR rises >= 6 dB) and the
    watermark loop (WatermarkTrainer.train_device, the recipe's 1000 steps
    at K = 64 on the train phase's backbone: lossw halves, bit accuracy >=
    0.95 over 200 messages), each with its launches (graph replays
    counted), rays/s, peak memory and one more dispatch profiled."""
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train.trainer_wtmk import wm_device_loop

    res = {"k5": k5_phase(dev, backbone_model)}
    views = BallViews(TRAIN_BALL)
    res["graph_vs_eager"] = graph_vs_eager(dev, views)

    # ---- the clean loop: the train phase's run through Trainer.train_device
    r = train_case(dev, TRAIN_BALL, TRAIN_ITERS, steps_per_dispatch=DL_K)
    tr, seconds, launches = r["trainer"], r["seconds"], r["launches"]
    steps, losses = tr.global_step, tr.stats["loss"]
    clean = {"steps": steps, "seconds": seconds, "rays_per_s": steps * TRAIN_RAYS / seconds,
             "step_ms": seconds / steps * 1e3, "peak_gib": r["peak"], "psnr0": r["psnr0"],
             "psnr1": r["psnr1"], "captures": tr.step_graph.captures, "launches": launches}
    log(f"[device loop] {steps} steps of {TRAIN_RAYS} rays in dispatches of {DL_K}: {seconds:.2f} "
        f"s (preload, grid updates, captures included), {clean['rays_per_s']:.0f} train rays/s, "
        f"{clean['step_ms']:.3f} ms a step; peak memory {r['peak']:.2f} GiB; "
        f"{clean['captures']} captures; dispatch losses {[round(v, 6) for v in losses]}")
    log(f"[device loop] {adaptation_state(tr.model)}; moves {r['moves']}")
    log(f"[device loop] held-out view PSNR: untrained {r['psnr0']:.2f} dB, trained "
        f"{r['psnr1']:.2f} dB (limit: +6 dB)")
    log(f"[device loop] launches during Trainer.train_device: {launches}")
    if steps != TRAIN_ITERS:
        raise AssertionError(f"Trainer.train_device ran {steps} steps, expected {TRAIN_ITERS}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"the device loop's loss did not fall: {losses}")
    if not r["psnr1"] >= r["psnr0"] + 6.0:
        raise AssertionError(f"device loop: held-out PSNR {r['psnr1']:.2f} dB < untrained "
                             f"{r['psnr0']:.2f} + 6 dB")
    k4_route(launches, torch.bfloat16, ("K4_field", "K4_field_bwd"), "Trainer.train_device")
    for name in ("K2_march", "K3_composite", "K1_hash_encode_bwd", "K3_composite_bwd",
                 "K4_field_bwd"):
        if launches[name] != steps:
            raise AssertionError(f"Trainer.train_device: {name} counted {launches[name]} "
                                 f"launches in {steps} steps")
    for name in K5_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by Trainer.train_device")
    data = t_dl.preload(views.poses, r["loader"].images, views.intrinsics, RES, RES, dev)
    clean["profile"] = profile_dispatch(
        lambda: t_dl.device_train_loop(tr, data, DL_K), DL_K, "device loop profile",
        tr.model.rc.compact_frac > 0)
    res["clean"] = clean
    # K6, the grid update, on the trained grid: 32 a 512-step run (every 16
    # steps), full for the first 16
    res["k6"] = k6_phase(dev, tr.model, launches)
    del r, tr, data
    gc.collect()

    # ---- the watermark loop: WatermarkTrainer.train_device at the recipe
    w = wm_train(dev, backbone_model, workdir, tag="wm device loop", steps_per_dispatch=DL_K)
    trainer, loader, make_loader = w["trainer"], w["loader"], w["make_loader"]
    lossw = trainer.stats["lossw"]
    wm = {"steps": w["steps"], "seconds": w["seconds"],
          "rays_per_s": w["steps"] * w["step_rays"] / w["seconds"],
          "step_ms": w["seconds"] / w["steps"] * 1e3, "peak_gib": w["peak"],
          "captures": trainer.step_graph.captures, "launches": w["launches"],
          "lossw_first": lossw[0], "lossw_last": lossw[-1]}
    for name in ("K2_march", "K9_msg_table", "K9_msg_table_bwd", "K4_field_bwd_feat"):
        if w["launches"][name] != w["steps"]:
            raise AssertionError(f"WatermarkTrainer.train_device: {name} counted "
                                 f"{w['launches'][name]} launches in {w['steps']} steps")
    trials = make_loader("test", 1, WM_TRIALS)
    wm["bitacc"] = trainer.test_bitacc(trials)
    log(f"[wm device loop] {wm['captures']} captures; lossw {lossw[0]:.5f} -> {lossw[-1]:.5f}; "
        f"bit accuracy {wm['bitacc']:.4f} over {WM_TRIALS} messages")
    if not lossw[-1] <= 0.5 * lossw[0]:
        raise AssertionError(f"the wm device loop's lossw did not halve: {lossw}")
    if not wm["bitacc"] >= 0.95:
        raise AssertionError(f"wm device loop: bit accuracy {wm['bitacc']:.4f} < 0.95")
    ro_b, rd_b = trainer._device_rays(next(iter(loader))["watermark"])
    wdata = t_dl.preload(loader.poses, loader.train_images, loader.intrinsics, loader.H,
                         loader.W, dev)
    wm["profile"] = profile_dispatch(
        lambda: wm_device_loop(trainer, wdata, ro_b, rd_b, DL_K), DL_K,
        "wm device loop profile", trainer.model.rc.compact_frac > 0)
    res["wm"] = wm
    del w, trainer, loader, make_loader, wdata
    gc.collect()
    return res


# ---------------------------------------------------------------- phase 10
CULL_T = 1e-5                  # --t_cull of the train-options run
CULL_THRESHOLDS = (1e-3, 1e-5)  # K2's cull route against its plain version
OPT_EM_STEPS = 64              # --error_map: Trainer.train steps
OPT_EM_LOOP = 128              # and Trainer.train_device steps
OPT_SSIM_LOOP = 128            # --patch_size 8 --lambda_ssim 0.1: clean loop steps
OPT_SSIM_K = 32                # (4 dispatches: the loss must fall across them)
OPT_WM_STEPS = 64              # and watermark steps on each path
OPT_WM_K = 16
SSIM_FLAGS = ["--patch_size", "8", "--lambda_ssim", "0.1"]
K2_CULL_SOURCE = ("nerf_signature_tpu_torch/csrc/marcher.cu",
                  "nerf_signature_tpu/ops/marching.py:494")


def k2_cull_case(grid, ro, rd, budget, noise, t_cull, tag, time_it):
    """K2's cull route (the float render grid ``grid``) against its plain
    version on one chunk: equal on every ray but those at the cull's margin
    (counted: a candidate's entering transmittance within CULL_MARGIN of
    t_cull, where the two sums of tau may round apart); with ``time_it``
    its times, the bool route's on the same rays, and its bound."""
    from nerf_signature_tpu_torch.ops import marching as t_march

    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    kw = dict(min_near=0.2, bound=1.0, dt_gamma=0.0, max_steps=1024, budget=budget,
              noise=noise, t_cull=t_cull)
    plan = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                              budget=budget)
    coarse = t_march.coarse_grid(grid, plan)
    k = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
    p = t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, plain=True, audit=True, **kw)
    torch.cuda.synchronize()
    keep = ~p.pop("cull_margin")
    tested = p.pop("n_tested")
    err = 0.0
    for name in ("mask", "xyzs", "ts", "deltas", "nears", "fars", "n_occupied",
                 "n_occupied_raw", "n_groups_occ"):
        a, b = k[name][keep], p[name][keep]
        if name == "mask":
            if not torch.equal(a, b):
                raise AssertionError(f"K2 cull {tag}: mask differs off the margin")
            continue
        err = max(err, float((a.float() - b.float()).abs().max()) if a.numel() else 0.0)
    if err != 0.0:
        raise AssertionError(f"K2 cull {tag}: outputs differ by {err} off the margin; limit 0")
    N, S = k["mask"].shape
    raw, surv = int(k["n_occupied_raw"].sum()), int(k["n_occupied"].sum())
    r = {"max_abs_err": err, "margin_rays": int((~keep).sum()), "rays": N, "budget": S,
         "culled_share": 1.0 - surv / max(raw, 1), "samples": int(k["mask"].sum()),
         "tested": int(tested.sum())}
    log(f"[K2 cull] {tag} t_cull={t_cull:g}: {N} rays x {S}, equal off the margin (max abs "
        f"err {err}, limit 0), {r['margin_rays']} rays at the margin excepted; "
        f"{r['culled_share']:.1%} of {raw} occupied candidates culled, {r['samples']} samples "
        f"kept, {r['tested']} candidates tested")
    if time_it:
        run = lambda: t_march.march_rays_aabb(ro, rd, aabb, grid, coarse=coarse, **kw)
        boolean = grid > 0
        exact = lambda: t_march.march_rays_aabb(ro, rd, aabb, boolean, coarse=coarse,
                                                **dict(kw, t_cull=0.0))
        # the cull route against the bool route on the same rays, in turns
        # (bool, cull, cull, bool) after a warm-up of both: single readings
        # of a ~0.01 ms kernel spread by 2x between runs; the fastest of
        # each route's readings is its time
        for _ in range(100):
            run()
            exact()
        reads = {"bool": [], "cull": []}
        for which in ("bool", "cull", "cull", "bool"):
            reads[which].append(device_ms(exact if which == "bool" else run, 30))
        r.update(ms=median_ms(run, 30), device_ms=min(reads["cull"]),
                 bool_device_ms=min(reads["bool"]), device_ms_reads=reads,
                 plain_ms=median_ms(lambda: t_march.march_rays_aabb(
                     ro, rd, aabb, grid, coarse=coarse, plain=True, **kw), 5, 1))
        # each ray read once (24 B, 4 B of noise), a 4 B cell value for each
        # candidate tested, the coarse grid once, the outputs written once
        n_bytes = (N * (24 + (4 if noise is not None else 0)) + 4 * r["tested"]
                   + coarse.numel() + N * S * 21 + N * 20)
        r["bound_ms"], r["bound_by"] = bound_of(n_bytes, 0, PEAK_FP32)
        r["library_ms"] = None
        log(f"[K2 cull] {tag}: ms {r['ms']:.4f} | device {r['device_ms']:.4f} (bool grid, same "
            f"rays: {r['bool_device_ms']:.4f}; readings in turns {reads}) | plain "
            f"{r['plain_ms']:.4f} | bound {r['bound_ms']:.4f} ({r['bound_by']})")
    return r


def record_captures():
    """Wrap StepGraph.run to list the keys it captured under; returns the
    list and the function that restores it."""
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    keys, run = [], t_dl.StepGraph.run

    def recorded(self, body, key, held, n, before_step=None):
        before = self.captures
        run(self, body, key, held, n, before_step)
        if self.captures != before:
            keys.append(key)

    t_dl.StepGraph.run = recorded
    return keys, lambda: setattr(t_dl.StepGraph, "run", run)


def record_dispatches():
    """Wrap the trainer's device_train_loop to keep each dispatch's (first
    step, the t_cull its march runs at, LoopStats); returns the list and the
    restore function."""
    from nerf_signature_tpu_torch.train import trainer as t_trainer

    seen, loop = [], t_trainer.device_train_loop

    def recorded(trainer, data, n, **kw):
        step0, t_cull = trainer.global_step, trainer._rc_train().t_cull
        st = loop(trainer, data, n, **kw)
        seen.append((step0, t_cull, st))
        return st

    t_trainer.device_train_loop = recorded
    return seen, lambda: setattr(t_trainer, "device_train_loop", loop)


def phase_train_options(dev, backbone_model, exact_psnr, workdir):
    """The train-step options of slice 12: K2's cull route against its plain
    version at the serving and clean steps' shapes on the trained grid's
    float render grid (two thresholds); Trainer.train_device with --t_cull
    (the device loop's recipe: the gate opens at step 256, one recapture,
    the cull route launched every step after it; the held-out PSNR within
    0.5 dB of the exact run's); --error_map per step and in the loop (the
    map changes; the loop's capture holds no read-back); the SSIM patch
    guard in the clean loop and, with --t_cull, the watermark stage on each
    path (the loss falls)."""
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops.grid import render_grid
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    res = {}
    # ---- K2's cull route on the trained backbone's grid (real densities)
    gen = torch.Generator(device=dev).manual_seed(11)
    ro_s, rd_s, _ = serve_chunk(dev)
    ro_t, rd_t = train_rays(dev)
    noise = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
    cases = {}
    for t_cull in CULL_THRESHOLDS:
        grid = render_grid(backbone_model.occ, t_cull)
        for shape, (ro, rd, S, nz) in (("serve", (ro_s, rd_s, 256, None)),
                                       ("clean", (ro_t, rd_t, TRAIN_BUDGET, noise))):
            cases[(shape, t_cull)] = k2_cull_case(grid, ro, rd, S, nz, t_cull,
                                                  f"{shape} {TRAIN_RAYS} x {S}", True)
    res["k2_cull"] = {f"{shape} {t:g}": r for (shape, t), r in cases.items()}

    # ---- --t_cull 1e-5 through Trainer.train_device (K = 64, 512 steps)
    keys, restore_graph = record_captures()
    seen, restore_loop = record_dispatches()
    try:
        r = train_case(dev, TRAIN_BALL, TRAIN_ITERS, steps_per_dispatch=DL_K, t_cull=CULL_T)
    finally:
        restore_graph()
        restore_loop()
    tr, seconds, launches = r["trainer"], r["seconds"], r["launches"]
    steps = tr.global_step
    culls = [k[1].t_cull for k in keys]
    gate = next((s0 for s0, t, _ in seen if t > 0), None)
    after = [st for _, t, st in seen if t > 0]
    if gate is None:
        raise AssertionError("t_cull: the fog gate never opened")
    occ = sum(st.mean_occupied for st in after)
    raw = sum(st.mean_occupied_raw for st in after)
    cull = {"steps": steps, "seconds": seconds, "rays_per_s": steps * TRAIN_RAYS / seconds,
            "step_ms": seconds / steps * 1e3, "psnr0": r["psnr0"], "psnr1": r["psnr1"],
            "exact_psnr1": exact_psnr, "captures": tr.step_graph.captures,
            "captured_t_cull": culls, "gate_step": gate, "culled_share": 1.0 - occ / raw,
            "launches_after_gate": launches["K2_march_cull"], "launches": launches,
            "peak_gib": r["peak"]}
    log(f"[t_cull] {steps} steps at t_cull {CULL_T:g} in dispatches of {DL_K}: {seconds:.2f} s, "
        f"{cull['rays_per_s']:.0f} train rays/s, {cull['step_ms']:.3f} ms a step; captures "
        f"{cull['captures']} (t_cull of each: {culls}); the gate opened at step {gate}; "
        f"{cull['culled_share']:.1%} of the occupied candidates culled after it (mean "
        f"survivors {occ / len(after):.1f} of {raw / len(after):.1f} a ray)")
    log(f"[t_cull] held-out PSNR {r['psnr0']:.2f} -> {r['psnr1']:.2f} dB; the exact run's "
        f"{exact_psnr:.2f} dB (limit: no worse than 0.5 dB below); launches {launches}")
    switches = sum(1 for a, b in zip(culls, culls[1:]) if a == 0.0 and b > 0.0)
    if switches != 1 or culls[-1] != CULL_T or any(
            c == 0.0 for c in culls[culls.index(CULL_T):]):
        raise AssertionError(f"t_cull: the step was not captured again exactly once when the "
                             f"gate opened: {culls}")
    # the gate opens after the grid's 16 full updates (every 16 steps: 256)
    if gate != 256 or launches["K2_march_cull"] != steps - gate or launches["K2_march"] != gate:
        raise AssertionError(f"t_cull: K2's routes {launches['K2_march']} / "
                             f"{launches['K2_march_cull']} launches, gate at {gate}")
    if not r["psnr1"] >= exact_psnr - 0.5:
        raise AssertionError(f"t_cull: held-out PSNR {r['psnr1']:.2f} dB more than 0.5 dB "
                             f"below the exact run's {exact_psnr:.2f}")
    if not cull["culled_share"] > 0.0:
        raise AssertionError("t_cull: the cull never bit after the gate")
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, RES,
                        RES, dev)
    cull["profile"] = profile_dispatch(
        lambda: t_dl.device_train_loop(tr, data, DL_K), DL_K, "t_cull loop profile",
        tr.model.rc.compact_frac > 0)
    res["t_cull"] = cull
    del r, tr, data
    gc.collect()

    # ---- --error_map: per step, then in the loop
    em = {}
    for path, iters, k in (("per_step", OPT_EM_STEPS, 0), ("loop", OPT_EM_LOOP, DL_K)):
        r = train_case(dev, TRAIN_BALL, iters, steps_per_dispatch=k, error_map=True)
        emap = r["loader"].error_map
        moved = int((emap != 1.0).sum())
        em[path] = {"steps": r["trainer"].global_step, "seconds": r["seconds"],
                    "cells_moved": moved, "map_min": float(emap.min()),
                    "captures": getattr(r["trainer"].step_graph, "captures", 0) if k else None}
        log(f"[error_map] {path}: {em[path]['steps']} steps in {r['seconds']:.2f} s; "
            f"{moved} of {emap.size} cells moved (min {emap.min():.4g}); held-out PSNR "
            f"{r['psnr0']:.2f} -> {r['psnr1']:.2f} dB")
        if moved == 0 or not np.isfinite(emap).all():
            raise AssertionError(f"error_map {path}: the map did not change or is not finite")
        if k and em[path]["captures"] < 1:
            raise AssertionError("error_map loop: the step was never captured")
        del r
        gc.collect()
    res["error_map"] = em

    # ---- the SSIM patch guard: 128 clean loop steps
    r = train_case(dev, TRAIN_BALL, OPT_SSIM_LOOP, steps_per_dispatch=OPT_SSIM_K,
                   patch_size=8, lambda_ssim=0.1)
    losses = r["trainer"].stats["loss"]
    res["ssim_clean_loop"] = {"steps": r["trainer"].global_step, "seconds": r["seconds"],
                              "dispatch_losses": losses}
    log(f"[ssim] clean loop: {r['trainer'].global_step} steps with 8 x 8 patches, dispatch "
        f"losses {[round(v, 6) for v in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ssim clean loop: the loss did not fall: {losses}")
    del r
    gc.collect()

    # ---- the SSIM patch guard with --t_cull: watermark steps per step, then looped
    step_losses = []
    w = wm_train(dev, backbone_model, workdir, iters=OPT_WM_STEPS,
                 extra=SSIM_FLAGS + ["--t_cull", str(CULL_T)], tag="wm ssim t_cull",
                 step_losses=step_losses)
    trainer, loader = w["trainer"], w["loader"]
    q = OPT_WM_STEPS // 4
    wm_per_step = {"steps": w["steps"], "seconds": w["seconds"],
                   "loss_first_quarter": float(np.mean(step_losses[:q])),
                   "loss_last_quarter": float(np.mean(step_losses[-q:])),
                   "k2_cull_launches": w["launches"]["K2_march_cull"]}
    _cuda.reset_launch_counts()
    t0 = time.time()
    trainer.train_device(loader, 2 * OPT_WM_STEPS, steps_per_dispatch=OPT_WM_K)
    torch.cuda.synchronize()
    n = _cuda.launch_counts()
    dl_losses = trainer.stats["loss"][-OPT_WM_STEPS // OPT_WM_K:]
    wm_loop = {"steps": trainer.global_step - OPT_WM_STEPS, "seconds": time.time() - t0,
               "dispatch_losses": dl_losses, "k2_cull_launches": n["K2_march_cull"],
               "k2_launches": n["K2_march"]}
    log(f"[wm ssim t_cull] per step: loss {wm_per_step['loss_first_quarter']:.5f} (first "
        f"{q}) -> {wm_per_step['loss_last_quarter']:.5f} (last {q}); loop: dispatch losses "
        f"{[round(v, 5) for v in dl_losses]}; K2 cull launches {wm_per_step['k2_cull_launches']}"
        f" / {n['K2_march_cull']}")
    if not wm_per_step["loss_last_quarter"] < wm_per_step["loss_first_quarter"]:
        raise AssertionError(f"wm ssim per step: the loss did not fall: {step_losses}")
    if not dl_losses[-1] < dl_losses[0]:
        raise AssertionError(f"wm ssim loop: the loss did not fall: {dl_losses}")
    if (wm_per_step["k2_cull_launches"] != OPT_WM_STEPS or n["K2_march_cull"] != OPT_WM_STEPS
            or n["K2_march"] != 0):
        raise AssertionError(f"wm ssim t_cull: K2's cull route launched "
                             f"{wm_per_step['k2_cull_launches']} / {n['K2_march_cull']} "
                             f"times (bool route {n['K2_march']}) in {OPT_WM_STEPS} steps each")
    res["ssim_wm"] = {"per_step": wm_per_step, "loop": wm_loop}
    del w, trainer, loader
    gc.collect()
    return res



# ---------------------------------------------------------------- phase 11
K7_STRIDES = (1, 2)        # --hash_level_stride of K7's backward rows
K7_FLAGS = ["--stochastic_hash_grad", "--hash_fwd_corners", "1"]
OPT11_WM_STEPS = 64        # watermark steps with K7 (per step, then looped) and on the bg backbone
OPT11_WM_K = 16
BG_RADIUS = 8.0            # --bg_radius (the JAX tests'; the cameras orbit at 3.2)
# K8 on rays against sph_from_ray + the plain encoder: atan2f and the
# division differ from PyTorch's by ulps, and an ulp of the sphere point
# moves a weight by up to res * 1.2e-7 (2.4e-4 at 2048)
K8_FWD_LIM = 1e-3
K8_BWD_LIM = 1e-3
K7_SOURCE = "nerf_signature_tpu_torch/csrc/hashenc_stoch.cu"
K8_SOURCE = "nerf_signature_tpu_torch/csrc/hashenc_bg.cu"
# K8 as the whole background colour against the plain chain
# (ops/background.py).  fp32: 1e-3 absolute on the colour and 1e-3 relative
# L2 on each gradient (atan2f's ulps at resolution 2048, as K8's encoding
# from the rays; fmaf sums in another order than cuBLAS's).  bf16: 4e-3
# absolute on the colour (a bf16 step of bg_net's output where an fp32 sum
# rounds the other way, through the sigmoid: at most ~2e-3), and on each
# output a relative L1 limit (BG_RL1_BF16) set between the kernel's reading
# and a control's, the fp32 kernel on the bf16-rounded table and weights
# (mlp_apply's activation roundings skipped): a few entries a bf16 step apart
# against every entry half a step apart.  On random bg models
# (tests/test_torch_kernels.py's cases) the kernel read at most colour
# 2.3e-5, table 5.0e-4, W1 2.2e-3, W2 5.3e-4, the control at least 4.5e-4,
# 8.9e-3, 2.4e-2, 2.4e-3 (scripts_port/bg_limits.py on an H100).
BG_LIM = {"bf16": 4e-3, "fp32": 1e-3}
# fp32's backward leaves out (and counts) the rays at bg_net's ReLU kink as
# well: a layer-1 pre-activation of the chain within BG_KINK of 0
# (background.relu_margin), where the two sums' orders may set the mask
# either way and move that ray's share of the table's and W1's gradients
# whole (W2's not: the activation is ~0 either way).  On an H100 such flips
# sat within a few 1e-6 of 0 and, over all rays, put W1's rel L2 near 1e-2
# in about one batch in twelve; at 1e-4 the rest read ~3e-5 and under 100
# rays of 4096 are left out (scripts_port/bg_kink.py; PERF.md section 6).
# bf16's relative L1 limits take a flip whole (one is ~2e-4 of W1's), so
# bf16 leaves none out.
BG_KINK = 1e-4
BG_KINK_MAX_SHARE = 0.1   # more rays than this at the kink: the check says too little
BG_RL1_BF16 = {"colour": 1e-4, "bg_table": 2e-3, "W1": 7e-3, "W2": 1.1e-3}
K8_BG_SOURCE = "nerf_signature_tpu_torch/csrc/background.cu"
K8_BG_REPLACES = "nerf_signature_tpu/models/ngp.py:211"


def k7_clean_inputs(dev, m):
    """K7's inputs at the clean step's shape on model m: the noisy march of
    4096 train rays at budget 128 on its grid -> (x01 [M, 3] in [0, 1], the
    live mask [M] as floats, cotangents [M, feature_pitch] of 1e-4 normals on
    the live samples' first L*F columns, zero elsewhere), from seed 13."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    cfg = m.cfg
    ro, rd = train_rays(dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    noise = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
    march = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), m.occ.occupancy,
                                    **{**march_kwargs(m, None), "budget": TRAIN_BUDGET},
                                    noise=noise)
    M = march["mask"].numel()
    live = march["mask"].reshape(-1).float()
    x01 = ((march["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    LF = cfg.n_levels * cfg.n_features
    g_feat = torch.zeros((M, t_ngp.feature_pitch(cfg)), device=dev)
    g_feat[:, :LF] = torch.randn((M, LF), generator=gen, device=dev) * 1e-4 * live[:, None]
    return x01, live, g_feat


def k7_rows(dev, backbone_model):
    """K7 at the clean step's shapes on phase 7's trained backbone (the noisy
    march of 4096 rays at budget 128): the one-corner forward bit-exact
    against its plain version, the backward at strides 1 and 2 within 1e-6
    relative L2 (the atomics' order) with no row chosen differently; each
    with its time, device time, bound (bytes), plain time and the library
    yardstick (a gather of the chosen rows; index_add_ of their
    cotangents; the backward's device time split into its kernel and the
    zeroing of the table's gradient, each with its bound: ``k7_bwd_row``),
    and K7's atomics as its design issues them (modelled, beside K1's on the
    same cotangents)."""
    from nerf_signature_tpu_torch.kernel_cases import k1_bwd_atomics, k7_bwd_atomics
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    m = backbone_model
    cfg = m.cfg
    x01, live, g_feat = k7_clean_inputs(dev, m)
    M = x01.shape[0]
    fp = t_ngp.field_params(m.params, cfg)
    table, tg = fp["hash_table"].detach(), fp["hash_table_g"]
    res, log2, F, L = cfg.resolutions, cfg.log2_hashmap_size, cfg.n_features, cfg.n_levels
    n_rows, pitch = table.shape[0], t_ngp.feature_pitch(cfg)
    chosen, _ = t_hash.stochastic_choice(x01, res, log2)
    out = {}

    # ---- the one-corner forward
    run = lambda: t_hash._hash_encode_1c_kernel(x01, tg, n_rows, res, log2, False, None, pitch)
    k = run()
    p = t_hash.hash_encode_1c_plain(x01, table, res, log2, table_g=tg)
    err = float((k[:, :L * F] - p).abs().max())
    log(f"[K7 fwd 1c] M={M} ({int(live.sum())} live) L={L} F={F} pitch {pitch}: max abs err "
        f"{err} (limit 0); padded columns zero: {not bool(k[:, L * F:].any())}")
    if not (torch.equal(k[:, :L * F], p) and not bool(k[:, L * F:].any())):
        raise AssertionError("K7's one-corner forward differs from its plain version")
    del k, p
    flat = chosen.reshape(-1)
    distinct = int(torch.unique(flat).numel())
    bms, bby = bound_of(M * 12 + M * L * F * 4 + distinct * F * 2, 0, PEAK_FP32)
    t, tl = call_split(run, 20, bms), call_split(lambda: tg.index_select(0, flat), 20)
    out["K7_hash_encode_1c"] = dict(
        max_abs_err=err, ms=t["ms"], device_ms=t["device_ms_warm"],
        device_ms_cold=t["device_ms_cold"], host_us=t["host_us"],
        plain_ms=median_ms(lambda: t_hash.hash_encode_1c_plain(x01, table, res, log2,
                                                               table_g=tg), 3, 1),
        bound_ms=bms, bound_by=bby, library_ms=tl["ms"], library_device_ms=tl["device_ms_warm"],
        library_host_us=tl["host_us"], library_what="the gather alone (choice excluded)",
        distinct_rows=distinct)
    r = out["K7_hash_encode_1c"]
    log(f"[K7 fwd 1c] {distinct} distinct rows chosen; per call {r['ms']:.4f} ms, device "
        f"{r['device_ms']:.4f} ms ({r['device_ms_cold']:.4f} cold), host {r['host_us']:.1f} "
        f"us a call, bound {bms:.4f} ms ({bby}); plain {r['plain_ms']:.4f} ms; "
        f"{r['library_what']} {r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}, "
        f"host {r['library_host_us']:.1f} us)")

    # ---- the backward at strides 1 and 2, on cotangents of the live samples
    g_w = g_feat[:, :L * F].contiguous()
    modelled = {"K1_hash_encode_bwd (same cotangents)":
                k1_bwd_atomics(x01, g_w, F, res, log2, torch.bfloat16)}
    for stride in K7_STRIDES:
        name = "K7_hash_encode_bwd_stoch" + ("" if stride == 1 else f"_s{stride}")
        out[name] = k7_bwd_row(x01, g_feat, n_rows, res, log2, F, stride, "K7 bwd")
        modelled[name] = k7_bwd_atomics(x01, g_w, F, res, log2, level_stride=stride)
        log(f"[K7 bwd] stride {stride}: atomics {modelled[name]} (modelled; K1's on these "
            f"cotangents {modelled['K1_hash_encode_bwd (same cotangents)']})")
    return out, modelled


# the name of K7's backward kernel in a trace; the rest of a call's device
# work is the zeroing of the table's gradient
K7_BWD_TRACE = "hash_bwd_stoch"


def k7_bwd_row(x01, g_feat, n_rows, res, log2, F, stride, tag, reps=20):
    """K7's backward at one input (positions x01 [M, 3], cotangents g_feat
    [M, pitch]) and one level stride: within 1e-6 relative L2 of its plain
    version (the atomics' order) with no row chosen differently (else
    AssertionError); ms a call; device ms warm and cold (L2 flushed), each
    split by name into the kernel (K7_BWD_TRACE) and the zeroing of the
    table's gradient before it; the bounds (bytes): the whole call's -- the
    cotangent's L*F columns of every row and a live sample's position read,
    the gradient written once (the sectors the adds touch lie inside it) --;
    the kernel's -- that cotangent and those positions, and each 32-byte
    sector of the zeroed gradient its adds touch --; the kernel's on the
    live pairs alone -- one F-float cotangent slice per kept (level, live
    sample) with a nonzero slice in place of every row's L*F columns (what
    the adds need: a row's zeros are known only once read, and the slots
    past K5's kept count are rows of zeros) --; and the zeroing's -- the
    gradient written once; the plain version's ms and index_add_'s of the
    same adds."""
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    M, L = x01.shape[0], len(res)
    g_w = g_feat[:, :L * F].contiguous()
    run = lambda: t_hash._hash_encode_stoch_bwd_kernel(x01, g_feat, n_rows, res, log2,  # noqa
                                                       False, None, F, stride)
    gk = run()
    gp = t_hash.hash_encode_stoch_bwd_plain(x01, g_w, n_rows, res, log2, stride)
    e, a = rel_l2(gk, gp), float((gk - gp).abs().max())
    moved = int((gk.ne(0).any(-1) != gp.ne(0).any(-1)).sum())
    log(f"[{tag}] stride {stride}: rel L2 {e:.3g} (limit 1e-6), max abs err {a:.3g}, rows "
        f"chosen differently {moved} (limit 0)")
    if not (e <= 1e-6 and moved == 0):
        raise AssertionError(f"K7's backward (stride {stride}, {tag}) differs from its plain "
                             f"version: rel L2 {e}, {moved} rows")
    del gk, gp
    chosen, phase_bits = t_hash.stochastic_choice(x01, res, log2)
    g3 = g_w.reshape(M, L, F).permute(1, 0, 2)
    keep = (t_hash.level_keep(phase_bits, L, stride) if stride > 1
            else torch.ones((L, M), dtype=torch.bool, device=x01.device))
    vals = torch.where(keep[..., None], g3 * float(stride), 0.0)
    adding = (vals != 0).any(-1)
    n_live = int((g_w != 0).any(-1).sum())
    sectors = int(torch.unique(chosen[adding] * (F * 4) // 32).numel())
    idx = torch.cat([(chosen * F + f).reshape(-1) for f in range(F)])
    val = torch.cat([vals[..., f].reshape(-1) for f in range(F)])
    n_adds = int((val != 0).sum())
    buf = torch.zeros(n_rows * F, device=x01.device)
    lib = median_ms(lambda: buf.index_add_(0, idx, val), 10)
    del idx, val, buf, vals, keep, g3
    read_bytes, zero_bytes = M * L * F * 4 + n_live * 12, n_rows * F * 4
    live_bytes = int(adding.sum()) * F * 4 + n_live * 12 + sectors * 32
    bms, bby = bound_of(read_bytes + zero_bytes, n_adds, PEAK_FP32)
    kbms, _ = bound_of(read_bytes + sectors * 32, n_adds, PEAK_FP32)
    klbms, _ = bound_of(live_bytes, n_adds, PEAK_FP32)
    zbms, _ = bound_of(zero_bytes, 0, PEAK_FP32)
    row = dict(max_abs_err=a, rel_l2=e, rows_chosen_differently=moved, ms=median_ms(run, reps),
               plain_ms=median_ms(lambda: t_hash.hash_encode_stoch_bwd_plain(
                   x01, g_w, n_rows, res, log2, stride), 3, 1),
               bound_ms=bms, bound_by=bby, kernel_bound_ms=kbms, kernel_live_bound_ms=klbms,
               zeroing_bound_ms=zbms,
               library_ms=lib, n_adds=n_adds, pairs_added=int(adding.sum()), samples=M,
               live_samples=n_live, sectors=sectors)
    for kind, cold in (("", False), ("_cold", True)):
        by_name = device_ms_by_name(run, reps, cold)
        if by_name is None or sum(by_name.values()) < bms:  # empty, or short of events
            row["device_ms" + kind] = device_ms(run, reps, cold, bound=bms)
            row["kernel_ms" + kind] = row["zeroing_ms" + kind] = None
            continue
        kernel = sum(ms for name, ms in by_name.items() if K7_BWD_TRACE in name)
        row["device_ms" + kind] = sum(by_name.values())
        row["kernel_ms" + kind], row["zeroing_ms" + kind] = kernel, row["device_ms" + kind] - kernel
    log(f"[{tag}] stride {stride}: {n_live} of {M} samples live, {row['pairs_added']} (level, "
        f"sample) adds into {sectors} sectors; per call {row['ms']:.4f} ms, device "
        f"{row['device_ms']:.4f} ms warm ({row['device_ms_cold']:.4f} cold): kernel "
        f"{row['kernel_ms']} / {row['kernel_ms_cold']} (bound {kbms:.4f}; on the live pairs "
        f"alone {klbms:.4f}), zeroing "
        f"{row['zeroing_ms']} / {row['zeroing_ms_cold']} (bound {zbms:.4f}); bound {bms:.4f} ms "
        f"({bby}); index_add_ {lib:.4f} ms")
    return row


def k7_loop_inputs(tr, data):
    """What K7's backward is handed in a K7 loop: one more dispatch of the
    trainer's loop, its graph dropped so that its WARMUP_STEPS steps run
    eagerly, with the backward's wrapper recording its first call's inputs:
    (x01 [Mc, 3], g_feat [Mc, pitch], n_rows), the compacted samples and
    the cotangent that K4's backward hands it.  The graph is dropped again
    after (the next dispatch captures without the recorder)."""
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    seen = []
    real = t_hash._hash_encode_stoch_bwd_kernel

    def record(x, g_feat, n_rows, *args):
        if not seen:
            seen.append((x.clone(), g_feat.clone(), n_rows))
        return real(x, g_feat, n_rows, *args)

    t_hash._hash_encode_stoch_bwd_kernel = record
    try:
        t_dl.drop_graph(tr)
        t_dl.device_train_loop(tr, data, t_dl.WARMUP_STEPS)
        torch.cuda.synchronize()
    finally:
        t_hash._hash_encode_stoch_bwd_kernel = real
        t_dl.drop_graph(tr)
    if not seen:
        raise AssertionError("the K7 loop's steps never called K7's backward")
    return seen[0]


def k8_rows(dev, bg_model):
    """K8 on ``bg_model``'s trained background table at the clean step's
    4096 rays and at a served chunk: forward and backward from the rays (the
    sphere point inside the kernels) against sph_from_ray and the plain
    encoder, the rays at phi's branch cut (within 1e-6) left out and
    counted; times, device times, bounds (bytes), plain times and the
    library yardsticks (a gather of the 4 L corner rows; index_add_ of
    their cotangents)."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    cfg = bg_model.cfg
    bp = t_ngp.bg_params(bg_model.params, cfg)
    table, tg = bp["bg_table"].detach(), bp["bg_table_g"]
    res, log2, F, L = cfg.bg_resolutions, cfg.bg_log2_hashmap_size, cfg.n_features, \
        cfg.bg_n_levels
    n_rows = table.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    ro_s, rd_s, _ = serve_chunk(dev)
    for shape, (ro, rd) in (("train", train_rays(dev)), ("serve", (ro_s, rd_s))):
        N = ro.shape[0]
        cut = t_hash.sphere_cut(ro, rd, cfg.bg_radius)
        x = t_hash.sphere_x01(ro, rd, cfg.bg_radius)
        run = lambda: t_hash._hash_encode_2d_kernel(None, ro, rd, cfg.bg_radius, tg, res, log2)
        k = run()
        p = t_hash.hash_encode_2d_plain(x, table, res, log2, table_g=tg)
        err = float((k - p)[~cut].abs().max())
        idx = torch.stack([i for i, _ in t_hash._corners_2d(x, res, log2, torch.float32)])
        distinct = int(torch.unique(idx).numel())
        bms, bby = bound_of(N * 24 + N * L * F * 4 + distinct * F * 2, 0, PEAK_FP32)
        flat = idx.reshape(-1)
        name = "K8_hash_encode_2d" + ("" if shape == "train" else "_serve")
        out[name] = dict(
            max_abs_err=err, cut_rays=int(cut.sum()), ms=median_ms(run, 20),
            device_ms=device_ms(run, 20),
            plain_ms=median_ms(lambda: t_hash.hash_encode_2d_plain(
                t_hash.sphere_x01(ro, rd, cfg.bg_radius), table, res, log2, table_g=tg), 5, 1),
            bound_ms=bms, bound_by=bby, library_ms=median_ms(lambda: tg.index_select(0, flat), 20),
            library_device_ms=device_ms(lambda: tg.index_select(0, flat), 20), rays=N)
        log(f"[K8 fwd] {shape} {N} rays ({int(cut.sum())} at phi's cut, left out): max abs err "
            f"{err:.3g} (limit {K8_FWD_LIM:g}); {distinct} rows touched; per call "
            f"{out[name]['ms']:.4f} ms, device {out[name]['device_ms']:.4f}, bound {bms:.5f} "
            f"({bby}); the gather {out[name]['library_ms']:.4f} ms")
        if not err <= K8_FWD_LIM:
            raise AssertionError(f"K8's forward ({shape}) differs from its plain version: {err}")
        if shape != "train":
            continue
        g = torch.randn((N, L * F), generator=gen, device=dev) * 1e-3
        g[cut] = 0.0
        run = lambda: t_hash._hash_encode_2d_bwd_kernel(None, ro, rd, cfg.bg_radius, g, n_rows,
                                                        res, log2, tg.dtype, F)
        gk = run()
        gp = t_hash.hash_encode_2d_bwd_plain(x, g, n_rows, res, log2, tg.dtype)
        e, a = rel_l2(gk, gp), float((gk - gp).abs().max())
        log(f"[K8 bwd] {shape} {N} rays: rel L2 {e:.3g} (limit {K8_BWD_LIM:g}), max abs err "
            f"{a:.3g}")
        if not e <= K8_BWD_LIM:
            raise AssertionError(f"K8's backward differs from its plain version: rel L2 {e}")
        gi = torch.cat([(idx * F + f).reshape(-1) for f in range(F)])
        vals = []
        g3 = g.reshape(N, L, F).permute(1, 0, 2)
        for _, cw in t_hash._corners_2d(x, res, log2, torch.float32):
            vals.append((cw[..., None] * g3).to(tg.dtype).float())
        gv = torch.cat([torch.stack(vals)[..., f].reshape(-1) for f in range(F)])
        buf = torch.zeros(n_rows * F, device=dev)
        bms, bby = bound_of(N * L * F * 4 + N * 24 + n_rows * F * 4, int((gv != 0).sum()),
                            PEAK_FP32)
        out["K8_hash_encode_2d_bwd"] = dict(
            max_abs_err=a, rel_l2=e, ms=median_ms(run, 20), device_ms=device_ms(run, 20),
            plain_ms=median_ms(lambda: t_hash.hash_encode_2d_bwd_plain(x, g, n_rows, res, log2,
                                                                       tg.dtype), 5, 1),
            bound_ms=bms, bound_by=bby, library_ms=median_ms(lambda: buf.index_add_(0, gi, gv),
                                                             20), rays=N)
        log(f"[K8 bwd] per call {out['K8_hash_encode_2d_bwd']['ms']:.4f} ms, device "
            f"{out['K8_hash_encode_2d_bwd']['device_ms']:.4f}, bound {bms:.5f} ({bby}); "
            f"index_add_ {out['K8_hash_encode_2d_bwd']['library_ms']:.4f} ms")
    return out


def device_work(fn, reps=10):
    """The device work one call of ``fn`` launches, by kind ({"kernel",
    "memset", "memcpy"}: the events of ``reps`` calls in a torch.profiler
    trace over ``reps``); None where every trace came back empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = dict.fromkeys(DEVICE_KINDS.values(), 0)
        for e in trace_device_events(prof):
            n[DEVICE_KINDS[e["cat"]]] += 1
        if sum(n.values()):
            return {k: v / reps for k, v in n.items()}
    return None


def graph_work(fn):
    """The device work one call of ``fn`` puts on its stream, from a CUDA
    graph that captures the call (every kernel, memset and copy is a node):
    {(kind, name): count}, kind "kernel", "memset", "memcpy" or another
    node type's name in lower case."""
    from nerf_signature_tpu_torch.ops import _cuda

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with _cuda.capturing(), torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del graph
    n = {}
    for kind, body in re.findall(r'label="\{(\w+)(.*?)\}"\]', dot, re.S):
        name = re.search(r"topoId: \d+\) \| ([^\s\\|]+)", body) if kind == "KERNEL" else None
        key = (kind.lower(), name.group(1) if name else "")
        n[key] = n.get(key, 0) + 1
    if not n:
        raise AssertionError(f"a CUDA graph of one call holds no node:\n{dot[:2000]}")
    return n


def kernel_work(fn, expect, what, reps=10):
    """The kernels one call of ``fn`` launches, counted by name, exactly:
    ``expect`` the substrings of their names, each launched once a call.
    A torch.profiler trace over ``reps`` calls, retried (TRACE_TRIES) while
    a kernel of ``expect`` reads fewer than ``reps`` (a trace may lose an
    event, never add one); where no trace comes back whole, the nodes of a
    CUDA graph of one call (complete by construction).  Raises on any other
    kernel, memset or copy, and on an expected kernel launched more than
    once a call.  Returns {"kernels": {name: a call}, "memset": 0,
    "memcpy": 0, "from": "trace" or "graph"}."""
    from torch.profiler import ProfilerActivity, profile

    def by_name(counts, per_call):
        other = {k: v for k, v in counts.items()
                 if k[0] != "kernel" or not any(x in k[1] for x in expect)}
        got = {x: sum(v for k, v in counts.items() if k[0] == "kernel" and x in k[1])
               for x in expect}
        if other or any(v > per_call for v in got.values()):
            raise AssertionError(f"{what}: one call launched {got} of {expect} and {other} "
                                 f"(in {per_call} calls), not one kernel of each")
        return got

    fn()
    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts = {}
        for e in trace_device_events(prof):
            key = (DEVICE_KINDS[e["cat"]], e["name"])
            counts[key] = counts.get(key, 0) + 1
        got = by_name(counts, reps)
        if all(v == reps for v in got.values()):
            return {"kernels": {x: v / reps for x, v in got.items()}, "memset": 0, "memcpy": 0,
                    "from": "trace"}
        log(f"[trace] {what}: the trace holds {got} of {reps} calls (try {attempt} of "
            f"{TRACE_TRIES})")
        time.sleep(0.5)
    got = by_name(graph_work(fn), 1)
    if not all(v == 1 for v in got.values()):
        raise AssertionError(f"{what}: a CUDA graph of one call holds {got}, not one of each")
    log(f"[trace] {what}: counted from a CUDA graph of one call instead: {got}")
    return {"kernels": got, "memset": 0, "memcpy": 0, "from": "graph"}


def k8_bg_rows(dev, bg_model):
    """K8 as the whole background colour (csrc/background.cu) on
    ``bg_model``'s trained bg table and bg_net, in bf16 and fp32: the
    forward through ngp_background (BackgroundFn) at the clean step's 4096
    rays and at a served chunk against the plain chain (``BG_LIM``, and in
    bf16 ``BG_RL1_BF16``, which the control, the fp32 kernel on the
    bf16-rounded table and weights, must exceed; the rays at phi's cut left
    out and counted), the backward (bg_color_bwd + bg_finish) at the clean step's
    rays against the chain's written-out backward (the same limits and
    control; in fp32 the rays at bg_net's ReLU kink, ``BG_KINK``, left out
    and counted as well), repeated bit for bit; each with its ms a call (CUDA events),
    the wrapper's alone, device ms (CUDA events back to back: a
    launch-sized kernel), its kernels a call counted by name (one forward,
    bg_color_bwd and bg_finish backward, nothing else: ``kernel_work``)
    beside the chain's device work (a trace), the bound and the chain's
    times (its forward; its autograd's backward alone; device ms traced)."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import background as t_bg
    from nerf_signature_tpu_torch.ops import hashenc as t_hash

    params = bg_model.params
    table = params["bg_table"].detach()
    net = [w.detach() for w in params["bg_net"]]
    n_rows, F = table.shape
    gen = torch.Generator(device=dev).manual_seed(19)
    ro_s, rd_s, _ = serve_chunk(dev)
    shapes = {"train": train_rays(dev), "serve": (ro_s, rd_s)}
    out = {}
    for dname, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg = dataclasses.replace(bg_model.cfg, compute_dtype=dtype)
        meta = t_ngp.bg_meta(cfg)
        bp = t_ngp.bg_params({"bg_table": table, "bg_net": net}, cfg)
        tg, packed = bp["bg_table_g"], bp["bg_packed"]
        # the control: the fp32 kernel on the table and weights as rounded
        # (packed holds them rounded), the activations' roundings skipped
        meta_c, tg_c = meta._replace(compute_dtype=torch.float32), tg.float()
        L = len(meta.resolutions)
        IN = L * F + 16
        gb = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32

        def ops_at_peak(products, other):
            # bg_net's products at the compute dtype's peak, the rest (the
            # sphere point, the corners, SH4, the sigmoid) at fp32's
            return products + other * peak / PEAK_FP32

        suffix = "" if dname == "bf16" else "_f32"
        for shape, (ro, rd) in shapes.items():
            N = ro.shape[0]
            cut = t_hash.sphere_cut(ro, rd, meta.radius)

            def run():
                with torch.no_grad():
                    return t_ngp.ngp_background(bp, cfg, ro, rd)

            wrapper = lambda: t_bg.bg_color_kernel(ro, rd, tg, packed, meta)
            chain = lambda: t_bg.background_plain(ro, rd, table, net, meta, tg)
            k, p = run(), chain()
            err = float((k - p)[~cut].abs().max())
            limits = {"max_abs": BG_LIM[dname]}
            checks = {"max_abs": err}
            if dname == "bf16":
                ctrl = t_bg.bg_color_kernel(ro, rd, tg_c, packed, meta_c)
                limits["rel_l1"] = BG_RL1_BF16["colour"]
                checks["rel_l1"] = rel_l1(k[~cut], p[~cut])
                checks["control_rel_l1"] = rel_l1(ctrl[~cut], p[~cut])
            x = t_hash.sphere_x01(ro, rd, meta.radius)
            idx = torch.stack([i for i, _ in t_hash._corners_2d(x, meta.resolutions,
                                                               meta.log2_hashmap_size,
                                                               torch.float32)])
            distinct = int(torch.unique(idx).numel())
            # bytes: the rays read and the colour written, the touched rows
            # and the packed weights read; operations: layer 1 and 2's
            # multiply-adds (2 each), and the 4 corners' F products and sums
            # a level, SH4 and the sphere point (~100)
            bms, bby = bound_of(N * 36 + distinct * F * gb + packed.numel() * 4,
                                ops_at_peak(N * (2 * IN * 64 + 2 * 64 * 3),
                                            N * (L * 8 * F + 100)), peak)
            work = kernel_work(run, ("bg_color_fwd",), f"ngp_background ({shape}, {dname})")
            chain_work = device_work(chain)
            name = "K8_background" + ("" if shape == "train" else "_serve") + suffix
            # the kernel's device ms from CUDA events back to back (launch-
            # sized); the chain's from a trace: it waits for a copy a call
            out[name] = dict(
                max_abs_err=err, checks=checks, limits=limits, cut_rays=int(cut.sum()), rays=N,
                dtype=dname, ms=median_ms(run, 20), wrapper_ms=median_ms(wrapper, 20),
                device_ms=events_ms(run, 20), plain_ms=median_ms(chain, 10),
                plain_device_ms=device_ms(chain, 10), bound_ms=bms, bound_by=bby,
                library_ms=None, device_work=work, chain_device_work=chain_work,
                distinct_rows=distinct)
            r = out[name]
            log(f"[K8 bg {dname}] {shape} {N} rays ({r['cut_rays']} at phi's cut, left out): "
                f"{checks} (limits {limits}); per call {r['ms']:.4f} ms (the wrapper alone "
                f"{r['wrapper_ms']:.4f}), device {r['device_ms']:.4f}, bound {bms:.6f} ({bby}); "
                f"kernels a call {work}; the chain {r['plain_ms']:.4f} ms, device "
                f"{r['plain_device_ms']:.4f}, {chain_work}")
            if not (all(checks[k] <= v for k, v in limits.items())
                    and bool(torch.isfinite(k).all())):
                raise AssertionError(f"K8's background colour ({shape}, {dname}) differs from "
                                     f"the chain: {checks} (limits {limits})")
            if dname == "bf16" and not checks["control_rel_l1"] > limits["rel_l1"]:
                raise AssertionError(f"the bf16 limit {limits['rel_l1']} does not refuse the "
                                     f"control ({shape}): {checks}")
            if shape != "train":
                continue
            g = torch.randn((N, 3), generator=gen, device=dev) * 1e-2
            kink = torch.zeros_like(cut)
            if dname == "fp32":
                kink = t_bg.relu_margin(ro, rd, table, net, meta, tg) < BG_KINK
            g[cut | kink] = 0.0
            n_kink = int((kink & ~cut).sum())
            if n_kink > BG_KINK_MAX_SHARE * N:
                raise AssertionError(f"K8's background backward ({dname}): {n_kink} of {N} rays "
                                     f"at bg_net's ReLU kink (margin {BG_KINK}), more than "
                                     f"{BG_KINK_MAX_SHARE:.0%}")
            run_b = lambda: t_bg._bg_color_bwd_kernel(ro, rd, tg, packed, g, n_rows, meta)
            plain_b = lambda: t_bg.background_bwd_plain(ro, rd, table, net, g, meta, tg)
            gk, gp = run_b(), plain_b()
            outs = ("bg_table", "W1", "W2")
            errs = [rel_l2(a, b) for a, b in zip(gk, gp)]
            checks = {"rel_l2": dict(zip(outs, errs))}
            if dname == "bf16":
                gc_ = t_bg._bg_color_bwd_kernel(ro, rd, tg_c, packed, g, n_rows, meta_c)
                checks = {"rel_l1": {o: rel_l1(a, b) for o, a, b in zip(outs, gk, gp)},
                          "control_rel_l1": {o: rel_l1(a, b) for o, a, b in zip(outs, gc_, gp)},
                          **checks}
                ok = all(checks["rel_l1"][o] <= BG_RL1_BF16[o] < checks["control_rel_l1"][o]
                         for o in outs)
                limits = {"rel_l1": {o: BG_RL1_BF16[o] for o in outs}}
            else:
                ok = max(errs) <= BG_LIM[dname]
                limits = {"rel_l2": BG_LIM[dname]}
            again = run_b()
            repeats = all(torch.equal(a, b) for a, b in zip(gk, again))
            # the chain's backward alone: autograd through one recorded forward
            leaves = [table.clone().requires_grad_(True)] + [
                w.clone().requires_grad_(True) for w in net]
            rec = t_bg.background_plain(ro, rd, leaves[0], leaves[1:], meta, tg)
            chain_b = lambda: torch.autograd.grad(rec, leaves, g, retain_graph=True)
            # bytes: the rays and g_rgb read, the touched rows and the packed
            # weights read, every row of the table's gradient and dW written;
            # operations: the backward's own (the forward's recompute left
            # out), a ray: dW2 and g_h1 (2 x 64 x 3 each), dW1 (2 x IN x 64)
            # and g_x (2 x L F x 64) as products; the sigmoid's derivative
            # (9) and the 4 corners' F products and sums a level
            nw = packed.numel()
            bms, bby = bound_of(N * 36 + distinct * F * gb + nw * 8 + n_rows * F * 4,
                                ops_at_peak(N * (2 * 2 * 64 * 3 + 2 * IN * 64 + 2 * L * F * 64),
                                            N * (9 + L * 8 * F)), peak)
            work = kernel_work(run_b, ("bg_color_bwd", "bg_finish"),
                               f"K8's background backward ({dname})")
            chain_work = device_work(chain_b)
            name = "K8_background_bwd" + suffix
            out[name] = dict(
                max_abs_err=max(float((a - b).abs().max()) for a, b in zip(gk, gp)),
                rel_l2=max(errs), checks=checks, limits=limits, repeats_bit_equal=repeats,
                rays=N, dtype=dname, ms=median_ms(run_b, 20), device_ms=events_ms(run_b, 20),
                plain_ms=median_ms(plain_b, 10), plain_device_ms=device_ms(plain_b, 10),
                chain_ms=median_ms(chain_b, 10), chain_device_ms=device_ms(chain_b, 10),
                bound_ms=bms, bound_by=bby, library_ms=None, device_work=work,
                chain_device_work=chain_work, cut_rays=int(cut.sum()), kink_rays=n_kink)
            r = out[name]
            log(f"[K8 bg bwd {dname}] {N} rays ({r['cut_rays']} at phi's cut and {n_kink} at "
                f"the ReLU kink, left out): {checks} (limits {limits}); a repeat "
                f"bit-equal: {repeats}; per call {r['ms']:.4f} ms, device {r['device_ms']:.4f}, "
                f"bound {bms:.6f} ({bby}); kernels a call {work}; the written-out plain "
                f"backward {r['plain_ms']:.4f} ms; the chain's autograd {r['chain_ms']:.4f} ms, "
                f"device {r['chain_device_ms']:.4f}, {chain_work}")
            if not ok:
                raise AssertionError(f"K8's background backward ({dname}) differs from the "
                                     f"chain's, or the limits do not refuse the control "
                                     f"({checks}, limits {limits}; {r['cut_rays']} rays at "
                                     f"phi's cut, {n_kink} at the ReLU kink left out)")
            if not repeats:
                raise AssertionError(f"K8's background backward ({dname}) does not repeat bit "
                                     f"for bit")
            del leaves, rec
    return out


def k7_loop(dev, exact, tag, loop_shape=False, **k7):
    """Trainer.train_device at K = 64 on phase 7's recipe with K7's options:
    rays/s, busy ms a step (one more dispatch profiled; K7's backward
    kernel's ms a step in it) beside the exact loop's of phase 9, held-out
    PSNR (gate: +6 dB over untrained; its gap to the exact run's reported,
    not gated), launches (K7's backward every step, K1's never; the
    one-corner forward every step where asked).  ``loop_shape``: also K7's
    backward rows (``k7_bwd_row``, strides 1 and 2) on the inputs the loop
    hands it (``k7_loop_inputs``), as "bwd_loop_shape"."""
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    r = train_case(dev, TRAIN_BALL, TRAIN_ITERS, steps_per_dispatch=DL_K, stochastic=True, **k7)
    tr, seconds, launches = r["trainer"], r["seconds"], r["launches"]
    steps = tr.global_step
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, RES,
                        RES, dev)
    prof = profile_dispatch(lambda: t_dl.device_train_loop(tr, data, DL_K), DL_K,
                            f"{tag} profile", tr.model.rc.compact_frac > 0,
                            match=(K7_BWD_TRACE,))
    log(f"[{tag}] K7's backward kernel {prof.get('matched_ms', {}).get(K7_BWD_TRACE)} ms a step")
    shape = {}
    if loop_shape:
        # K7's backward at the loop's own shape: the compacted slots and the
        # cotangent K4's backward hands it, at strides 1 and 2
        x01, g_feat, n_rows = k7_loop_inputs(tr, data)
        cfg = tr.model.cfg
        for stride in K7_STRIDES:
            name = "K7_hash_encode_bwd_stoch" + ("" if stride == 1 else f"_s{stride}")
            shape[name] = k7_bwd_row(x01, g_feat, n_rows, cfg.resolutions, cfg.log2_hashmap_size,
                                     cfg.n_features, stride, f"{tag} shape")
        del x01, g_feat
    res = {"steps": steps, "seconds": seconds, "rays_per_s": steps * TRAIN_RAYS / seconds,
           "step_ms": seconds / steps * 1e3, "psnr0": r["psnr0"], "psnr1": r["psnr1"],
           "exact_psnr1": exact["psnr1"], "psnr_gap": exact["psnr1"] - r["psnr1"],
           "exact_busy_ms": exact["profile"]["busy_ms"], "profile": prof,
           "captures": tr.step_graph.captures, "launches": launches, "peak_gib": r["peak"],
           "bwd_loop_shape": shape}
    log(f"[{tag}] {steps} steps at K = {DL_K}: {seconds:.2f} s, {res['rays_per_s']:.0f} train "
        f"rays/s; busy {prof['busy_ms']} ms a step (the exact loop's {res['exact_busy_ms']}); "
        f"held-out PSNR {r['psnr0']:.2f} -> {r['psnr1']:.2f} dB (the exact run's "
        f"{exact['psnr1']:.2f}: gap {res['psnr_gap']:.2f} dB, not gated); launches {launches}")
    if not r["psnr1"] >= r["psnr0"] + 6.0:
        raise AssertionError(f"{tag}: held-out PSNR {r['psnr1']:.2f} dB < untrained "
                             f"{r['psnr0']:.2f} + 6 dB")
    one_corner = steps if k7.get("fwd_corners", 8) == 1 else 0
    if (launches["K7_hash_encode_bwd_stoch"] != steps or launches["K1_hash_encode_bwd"] != 0
            or launches["K7_hash_encode_1c"] != one_corner):
        raise AssertionError(f"{tag}: K7 launched {launches['K7_hash_encode_1c']} forward and "
                             f"{launches['K7_hash_encode_bwd_stoch']} backward, K1's backward "
                             f"{launches['K1_hash_encode_bwd']}, in {steps} steps")
    del r, tr, data
    gc.collect()
    return res


def wm_falls(dev, backbone_model, workdir, extra, tag, loop):
    """``extra`` flags on the watermark recipe for OPT11_WM_STEPS per-step
    steps (lossw falls: the last quarter's mean below the first's) and, with
    ``loop``, as many again through train_device in dispatches of OPT11_WM_K
    (the last dispatch's lossw below the first's).  Returns the numbers and
    the runs' launches."""
    from nerf_signature_tpu_torch.ops import _cuda

    lossws = []
    # a workspace of its own: a watermark workspace holding another run's
    # checkpoints would be resumed
    w = wm_train(dev, backbone_model, os.path.join(workdir, tag.replace(" ", "_")),
                 iters=OPT11_WM_STEPS, extra=extra, tag=tag, step_lossw=lossws)
    trainer, loader = w["trainer"], w["loader"]
    q = OPT11_WM_STEPS // 4
    res = {"steps": w["steps"], "seconds": w["seconds"],
           "lossw_first_quarter": float(np.mean(lossws[:q])),
           "lossw_last_quarter": float(np.mean(lossws[-q:])), "launches": w["launches"]}
    log(f"[{tag}] per step: lossw {res['lossw_first_quarter']:.5f} (first {q}) -> "
        f"{res['lossw_last_quarter']:.5f} (last {q})")
    if not res["lossw_last_quarter"] < res["lossw_first_quarter"]:
        raise AssertionError(f"{tag} per step: lossw did not fall: {lossws}")
    if loop:
        _cuda.reset_launch_counts()
        t0 = time.time()
        trainer.train_device(loader, 2 * OPT11_WM_STEPS, steps_per_dispatch=OPT11_WM_K)
        torch.cuda.synchronize()
        dl = trainer.stats["lossw"][-OPT11_WM_STEPS // OPT11_WM_K:]
        res["loop"] = {"steps": trainer.global_step - OPT11_WM_STEPS, "seconds": time.time() - t0,
                       "dispatch_lossw": dl, "launches": _cuda.launch_counts()}
        log(f"[{tag}] loop: dispatch lossw {[round(v, 5) for v in dl]}")
        if not dl[-1] < dl[0]:
            raise AssertionError(f"{tag} loop: lossw did not fall: {dl}")
    del w, trainer, loader
    gc.collect()
    return res


def phase_k7_k8(dev, backbone_model, exact, workdir):
    """K7 and K8 (slice 13): K7's kernels at the clean step's shapes on the
    trained backbone; the clean loop with --stochastic_hash_grad, then with
    --hash_fwd_corners 1 --hash_level_stride 2 (against the exact loop of
    phase 9); the watermark stage with --stochastic_hash_grad
    --hash_fwd_corners 1 (64 steps per step and 64 looped: lossw falls);
    then --bg_radius 8 on views whose misses show a sky: 512 loop steps with
    the bg model against the same run without it (the held-out PSNR above;
    the bg table moved; the bg colour's kernels once each way a step), K8's
    kernels on its trained table (the encoding alone and the whole colour),
    one 800x800 view served through the kernels against the plain versions
    (>= 45 dB; one bg forward a chunk), and 64 watermark steps on that
    backbone (lossw falls; no bg backward)."""
    res = {}
    res["k7_rows"], res["k7_atomics_modelled"] = k7_rows(dev, backbone_model)
    res["k7_loop"] = k7_loop(dev, exact, "k7 loop", loop_shape=True)
    for name, row in res["k7_loop"].pop("bwd_loop_shape").items():
        res["k7_rows"][name]["loop_shape"] = row
    res["k7_1c_s2_loop"] = k7_loop(dev, exact, "k7 1c stride 2 loop", fwd_corners=1,
                                   level_stride=2)
    w = wm_falls(dev, backbone_model, workdir, K7_FLAGS, "wm k7", loop=True)
    for run, n in (("per step", w["launches"]), ("loop", w["loop"]["launches"])):
        if n["K7_hash_encode_1c"] == 0 or n["K7_hash_encode_bwd_stoch"] != 0:
            raise AssertionError(f"wm k7 {run}: K7's one-corner forward launched "
                                 f"{n['K7_hash_encode_1c']} times, its backward "
                                 f"{n['K7_hash_encode_bwd_stoch']} (the backbone is frozen)")
    res["wm_k7"] = w

    # ---- --bg_radius 8 on the sky views, against the same run without it
    runs = {}
    for name, radius in (("bg", BG_RADIUS), ("no_bg", -1.0)):
        r = train_case(dev, TRAIN_BALL, TRAIN_ITERS, steps_per_dispatch=DL_K, bg_radius=radius,
                       views=SkyBallViews)
        tr = r["trainer"]
        runs[name] = {"steps": tr.global_step, "seconds": r["seconds"],
                      "rays_per_s": tr.global_step * TRAIN_RAYS / r["seconds"],
                      "psnr0": r["psnr0"], "psnr1": r["psnr1"], "launches": r["launches"]}
        log(f"[bg {name}] {tr.global_step} steps on the sky views: {r['seconds']:.2f} s, "
            f"{runs[name]['rays_per_s']:.0f} train rays/s, held-out PSNR {r['psnr0']:.2f} -> "
            f"{r['psnr1']:.2f} dB; launches {r['launches']}")
        if name == "bg":
            m = tr.model
            # rows of the bg table whose gradient was ever nonzero (Adam's
            # second moment)
            nu = tr.optimizer.state[m.params["bg_table"]]["exp_avg_sq"]
            hot = int((nu > 0).any(-1).sum())
            runs[name]["bg_table_rows_with_gradient"] = hot
            n = r["launches"]
            # the bg colour: one forward and one backward launch a step;
            # K8's encoding alone is off the path
            k8 = {k: n[k] for k in ("K8_background", "K8_background_bwd", "K8_hash_encode_2d",
                                    "K8_hash_encode_2d_bwd")}
            log(f"[bg] {tr.global_step} loop steps: {hot} bg table rows with a gradient; K8 "
                f"launches {k8} (expected {tr.global_step} forward and backward, 0 and 0)")
            if (hot == 0 or k8["K8_background"] != tr.global_step
                    or k8["K8_background_bwd"] != tr.global_step
                    or k8["K8_hash_encode_2d"] or k8["K8_hash_encode_2d_bwd"]):
                raise AssertionError(f"bg: the bg colour's launches {k8} in {tr.global_step} "
                                     f"steps, or no gradient reached the bg table ({hot} rows)")
            # one 800x800 view served through the kernels and through the plain versions
            from nerf_signature_tpu_torch.ops import _cuda

            _cuda.reset_launch_counts()
            held = r["held"]
            img_k = m.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"]
            serve_launches = _cuda.launch_counts()
            img_p = m.render(held["rays_o"][0], held["rays_d"][0], staged=True,
                             plain=True)["image"]
            chunks = math.ceil(RES * RES / CHUNK)
            runs[name]["serve_kernel_vs_plain_db"] = psnr(img_k, img_p)
            runs[name]["serve_k8_launches"] = serve_launches["K8_background"]
            log(f"[bg] an 800x800 view served: kernels vs plain {psnr(img_k, img_p):.2f} dB "
                f"(limit 45); K8's background colour launched "
                f"{serve_launches['K8_background']} times (expected {chunks}), its encoding "
                f"alone {serve_launches['K8_hash_encode_2d']} (expected 0)")
            if not (psnr(img_k, img_p) >= 45.0 and serve_launches["K8_background"] == chunks
                    and serve_launches["K8_hash_encode_2d"] == 0):
                raise AssertionError("bg: the served view through the kernels differs from "
                                     "the plain versions (or K8 did not run once a chunk)")
            res["k8_rows"] = k8_rows(dev, m)
            res["k8_bg_rows"] = k8_bg_rows(dev, m)
            bg_model = m
        del r, tr
        gc.collect()
    res["bg"] = runs
    if not runs["bg"]["psnr1"] > runs["no_bg"]["psnr1"]:
        raise AssertionError(f"bg: held-out PSNR with the bg model {runs['bg']['psnr1']:.2f} dB "
                             f"not above the run without it ({runs['no_bg']['psnr1']:.2f})")
    w = wm_falls(dev, bg_model, workdir, ["--bg_radius", str(BG_RADIUS)], "wm bg", loop=False)
    if w["launches"]["K8_background"] == 0 or w["launches"]["K8_background_bwd"] != 0:
        raise AssertionError(f"wm bg: K8 launched {w['launches']['K8_background']} forward, "
                             f"{w['launches']['K8_background_bwd']} backward (frozen)")
    res["wm_bg"] = w
    del bg_model
    gc.collect()
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
    "K4_field_bwd_f32": ("nerf_signature_tpu_torch/csrc/field_bwd.cu",
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
    # 16 x 8: K1 with 8 features a row at 16 levels (its staged tiles past
    # 48 KB), K4 at input width 128 on the tensor cores (bf16 alone)
    "K1_hash_encode_16x8": ("K1_hash_encode", "16x8", None),
    "K1_hash_encode_bwd_16x8": ("K1_hash_encode_bwd", "16x8", None),
    "K4_field_in128": ("K4_field", "16x8", None),
    "K4_field_bwd_in128": ("K4_field_bwd", "16x8", None),
    "K4_field_bwd_feat_in128": ("K4_field_bwd_feat", "16x8", None),
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
# K5, sample compaction (slice 10): its rows at the clean and the watermark
# steps' shapes, launches of the device-loop runs
K5_KERNELS = ("K5_compact_pack", "K5_compact_unpack", "K5_compact_unpack_bwd")
K5_SOURCE = ("nerf_signature_tpu_torch/csrc/compact.cu",
             "nerf_signature_tpu/render/renderer.py:123")
# the sources of the tensor-core kernels, which must build without spills
TENSOR_CORE_SOURCES = ("field_mma.cu", "field_mma_bwd.cu", "field_mma_bwd_full.cu")
# their kernels by models/ngp.py:mma_launch's kind (a part of ptxas's mangled
# name, before the template's "I")
MMA_KERNELS = {"fwd": "field_mma_fwd", "bwd_feat": "field_mma_bwd_feat",
               "bwd": "field_mma_bwd_full"}
# the kernels line's tensor-core K4 rows and their kind
MMA_ROWS = {"K4_field": "fwd", "K4_field_bwd": "bwd", "K4_field_bwd_feat": "bwd_feat"}
# K4's tiled SIMT kernels, which must too, at every width: source ->
# the kernel's name (a part of ptxas's mangled one)
SIMT_KERNELS = {"field.cu": "field_fwd", "field_feat.cu": "field_bwd_feat",
                "field_bwd.cu": "field_bwd"}


# ---------------------------------------------------------------- phase 12
BASE_STEPS = 64           # per-step watermark steps of a baseline, and as many looped
BASE_K = 64               # their --steps_per_dispatch
BASE_TRIALS = 50          # test_bitacc messages of a baseline
FT_K = 16                 # --finetune_decoder: dispatches of 16 (lossw first 16 vs last 16)
# --finetune_decoder starts from phase 8's model with the decoder's last
# layer zeroed (every logit 0: lossw ln 2, chance), and the last dispatch's
# mean lossw must fall below FT_MARGIN of the first's
FT_MARGIN = 0.5
PRE_BITS = 16             # --prewatermark_bits (the CLI's default)
PRE_STEPS = 200           # pretrain_hidden steps (--prewatermark_steps)
PRE_VIEWS = 4             # rendered views bit_survival decodes
K10_SOURCE = ("nerf_signature_tpu_torch/csrc/copyrnerf.cu",
              "nerf_signature_tpu/models/copyrnerf.py:68")
K4_RAW_SOURCES = {"K4_field_raw": "nerf_signature_tpu_torch/csrc/field_mma.cu",
                  "K4_field_raw_f32": "nerf_signature_tpu_torch/csrc/field.cu"}
# the backward kernels no CopyRNeRF step may launch (nothing upstream of the
# colour MLP takes a gradient) and the message-table kernels it never needs
COPYRNERF_ABSENT = ("K9_msg_table", "K9_msg_table_bwd", "K1_hash_encode_bwd",
                    "K4_field_bwd", "K4_field_bwd_feat", "K4_field_bwd_f32",
                    "K4_field_bwd_feat_f32")
COPYRNERF_REQUIRED = ("K1_hash_encode", "K2_march", "K3_composite", "K3_composite_bwd",
                      "K4_field_raw", "K10_copyrnerf_input") + K5_KERNELS
# --finetune_decoder: only the decoder trains, so no backward reaches the field
FINETUNE_ABSENT = ("K9_msg_table_bwd", "K1_hash_encode_bwd", "K4_field_bwd_feat",
                   "K4_field_bwd", "K3_composite_bwd", "K5_compact_unpack_bwd")
FINETUNE_REQUIRED = ("K1_hash_encode", "K2_march", "K3_composite", "K4_field",
                     "K9_msg_table", "K5_compact_pack", "K5_compact_unpack")


def record_field_inputs(trainer, data):
    """One eager watermark step of ``trainer`` (the CopyRNeRF model) with the
    inputs of its K4 (want_raw) and K10 calls recorded: the step's own
    compacted samples."""
    from nerf_signature_tpu_torch.models import copyrnerf as t_crn
    from nerf_signature_tpu_torch.models import watermark as t_wm

    rec = {}
    heads, build = t_wm.field_heads, t_crn.copyrnerf_input

    def heads_rec(params, cfg, feat, dirs=None, **kw):
        if kw.get("want_raw") and "k4" not in rec:
            rec["k4"] = (params, cfg, feat.detach().clone(), dirs.detach().clone())
        return heads(params, cfg, feat, dirs, **kw)

    def build_rec(*args):
        if "k10" not in rec:
            rec["k10"] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
        return build(*args)

    t_wm.field_heads, t_crn.copyrnerf_input = heads_rec, build_rec
    try:
        trainer.train_step_data(data, trainer.random_message())
    finally:
        t_wm.field_heads, t_crn.copyrnerf_input = heads, build
    torch.cuda.synchronize()
    return rec


def k10_row(args):
    """K10 on a CopyRNeRF step's own samples against its plain version:
    sines and cosines within 1e-6 absolute (sinf/cosf against torch's, a
    few ulps of values in [-1, 1]), the rest bit for bit; its times, device
    time (L2 flushed) and bound (bytes: M x (40 + (88 + D) x 4))."""
    from nerf_signature_tpu_torch.ops import copyrnerf as t_k10

    x, d, rgb, raw, msg, bound = args
    k = t_k10.copyrnerf_input(x, d, rgb, raw, msg, bound)
    p = t_k10.copyrnerf_input_plain(x, d, rgb, raw, msg, bound)
    err = float((k[:, :84] - p[:, :84]).abs().max())
    exact = torch.equal(k[:, 84:], p[:, 84:])
    M, D = x.shape[0], msg.shape[0]
    log(f"[K10] {M} samples, message {D} bits: sin/cos max abs err {err:.3g} (limit 1e-6), "
        f"rgb/raw/message bit-equal: {exact}")
    if not (err <= 1e-6 and exact and bool(torch.isfinite(k).all())):
        raise AssertionError("K10 differs from its plain version beyond its limits")
    run = lambda: t_k10.copyrnerf_input(x, d, rgb, raw, msg, bound)
    ms = median_ms(run, 20)
    # device time from CUDA events over back-to-back calls: at the recipe's
    # step a trace of these calls (device_ms, cold) has held a half or a
    # tenth of their events, from one run to the next; the traced reading
    # stays beside it as the record of that fault (the output's 725 MB
    # leave nothing of a call in the L2 for the next)
    dms, dtr = events_ms(run, 10), device_ms(run, cold=True)
    pms = median_ms(lambda: t_k10.copyrnerf_input_plain(x, d, rgb, raw, msg, bound), 10)
    pdms = device_ms(lambda: t_k10.copyrnerf_input_plain(x, d, rgb, raw, msg, bound), cold=True)
    # a sample reads x, d, rgb and raw and writes 88 + D floats; its ops: x01
    # and 2 x01 - 1 (12), 84 products and 84 sines or cosines (one op each)
    bms, bby = bound_of(M * (40 + (88 + D) * 4) + D * 4, M * (12 + 84 + 84), PEAK_FP32)
    log(f"[K10] {ms:.4f} ms ({dms:.4f} device from CUDA events; {dtr:.4f} from 20 traced "
        f"calls), plain {pms:.4f} ms ({pdms:.4f} device), bound {bms:.4f} ms ({bby})")
    return dict(max_abs_err=err, ms=ms, device_ms=dms, traced_device_ms=dtr,
                plain_ms=pms, plain_device_ms=pdms, bound_ms=bms, bound_by=bby, library_ms=None,
                samples=M, message_dim=D)


def k10_in_step(trainer, data):
    """K10 inside one eager CopyRNeRF watermark step (after one more to
    warm up) under torch.profiler: its device ms and launches in the step
    and each call's samples, beside its bound at those samples."""
    from nerf_signature_tpu_torch.models import copyrnerf as t_crn

    calls = []
    build = t_crn.copyrnerf_input

    def recorded(x, d, rgb, raw, message, bound):
        calls.append((x.shape[0], message.shape[0]))
        return build(x, d, rgb, raw, message, bound)

    t_crn.copyrnerf_input = recorded
    try:
        trainer.train_step_data(data, trainer.random_message())
        calls.clear()
        by_name, _ = traced(lambda: trainer.train_step_data(data, trainer.random_message()),
                            "copyrnerf step")
    finally:
        t_crn.copyrnerf_input = build
    if by_name is None:
        raise AssertionError("copyrnerf step: no trace held device events")
    ms = sum(us for n, us in by_name.items() if "copyrnerf_input" in n) / 1e3
    bms = sum(bound_of(M * (40 + (88 + D) * 4) + D * 4, M * (12 + 84 + 84), PEAK_FP32)[0]
              for M, D in calls)
    log(f"[K10] in an eager step: {len(calls)} call(s) on {[M for M, _ in calls]} samples, "
        f"{ms:.4f} device ms against a bound of {bms:.4f} ms at those samples")
    return {"device_ms": ms, "launches": len(calls), "samples": [M for M, _ in calls],
            "bound_ms": bms}


def k4_raw_rows(params, cfg, feat, dirs):
    """K4 with the density logit on both routes (bf16: the tensor-core
    kernel; fp32: the SIMT one) on a CopyRNeRF step's samples: sigma, geo
    and rgb bit-equal to the launch without it; the logit against the plain
    version's (bf16 a bf16 step: rtol 2e-2, atol 1e-2; fp32 1e-5); times
    and bound as K4's, plus the logit's 4 bytes a sample."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp

    rows = {}
    for name, dtype in (("K4_field_raw", torch.bfloat16), ("K4_field_raw_f32", torch.float32)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        fp = params if dtype == cfg.compute_dtype else t_ngp.field_params(
            {k: params[k] for k in ("hash_table", "sigma_net", "color_net")}, c)
        s0, g0, r0 = t_ngp.field_heads(fp, c, feat, dirs, want_geo=True)
        s1, g1, r1, raw = t_ngp.field_heads(fp, c, feat, dirs, want_geo=True, want_raw=True)
        same = torch.equal(s0, s1) and torch.equal(g0, g1) and torch.equal(r0, r1)
        fw = feat[:, :c.enc_dim]
        *_, raw_p = t_ngp.field_heads_plain(fp, c, fw, dirs, want_raw=True)
        rtol, atol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
        share = float(((raw - raw_p).abs() / (atol + rtol * raw_p.abs())).max())
        err = float((raw - raw_p).abs().max())
        log(f"[{name}] logit max abs err {err:.3g}, worst share of its limit {share:.3g} "
            f"(limit 1); other outputs equal to the launch without it: {same}")
        if not (same and share <= 1.0 and bool(torch.isfinite(raw).all())):
            raise AssertionError(f"{name} differs from its plain version beyond its limits")
        M = feat.shape[0]
        n_w = sum(w.numel() for w in fp["sigma_net"] + fp["color_net"])
        bms, bby = bound_of(M * (c.enc_dim * 4 + 12 + 4 + 12 + 4), M * 2 * n_w,
                            PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        ms = median_ms(lambda: t_ngp.field_heads(fp, c, feat, dirs, want_raw=True), 20)
        dms = device_ms(lambda: t_ngp.field_heads(fp, c, feat, dirs, want_raw=True), bound=bms)
        pms = median_ms(lambda: t_ngp.field_heads_plain(fp, c, fw, dirs, want_raw=True), 5, 1)
        lib = library_mlp_ms(fp, fw, dirs, dtype)
        rows[name] = dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                          bound_by=bby, library_ms=lib, samples=M)
    return rows


def baseline_run(dev, backbone_model, workdir, tag, extra, required, absent, k4_names,
                 per_step=True, loop_steps=BASE_STEPS, loop_k=BASE_K, ckpt=None, match=(),
                 margin=1.0):
    """One baseline through main_nerf_wtmk's setup (``wm_train``): with
    ``per_step`` BASE_STEPS steps of WatermarkTrainer.train (each step's
    lossw; every loss finite; lossw of the last 16 below the first 16's),
    then ``loop_steps`` through train_device in dispatches of ``loop_k``
    (finite; with several dispatches the last one's lossw below ``margin``
    times the first's), one more dispatch profiled (busy ms a step), and test_bitacc
    over BASE_TRIALS messages (reported, not gated).  Every run must launch
    ``required`` and none of ``absent``.  ``match``: names of device work
    whose ms a step the profiled dispatch reports (``profile_dispatch``)."""
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train import device_loop as t_dl

    losses, lossw = [], []
    iters = BASE_STEPS if per_step else loop_steps
    w = wm_train(dev, backbone_model, os.path.join(workdir, tag.replace(" ", "_")),
                 iters=iters, extra=extra, tag=tag, step_losses=losses, step_lossw=lossw,
                 required=required, k4_names=k4_names, ckpt=ckpt,
                 steps_per_dispatch=0 if per_step else loop_k)
    trainer, loader, make_loader = w["trainer"], w["loader"], w["make_loader"]
    ro_b, rd_b = trainer._device_rays(next(iter(loader))["watermark"])
    step_rays = TRAIN_RAYS + ro_b.numel() // 3  # content rays + the decoder's
    res = {"launches": w["launches"], "steps": w["steps"], "seconds": w["seconds"],
           "step_rays": step_rays, "rays_per_s": w["steps"] * step_rays / w["seconds"],
           "step_ms": w["seconds"] / w["steps"] * 1e3, "peak_gib": w["peak"]}
    runs = [("per step" if per_step else "loop", w["launches"])]
    if per_step:
        q = 16
        res.update(lossw_first_16=float(np.mean(lossw[:q])), lossw_last_16=float(np.mean(lossw[-q:])))
        log(f"[{tag}] per step: lossw {res['lossw_first_16']:.5f} (first {q}) -> "
            f"{res['lossw_last_16']:.5f} (last {q})")
        if not all(math.isfinite(v) for v in losses + lossw):
            raise AssertionError(f"{tag}: a loss is not finite: {losses}")
        if not res["lossw_last_16"] < res["lossw_first_16"]:
            raise AssertionError(f"{tag} per step: lossw did not fall: {lossw}")
        _cuda.reset_launch_counts()
        t0 = time.time()
        trainer.train_device(loader, BASE_STEPS + loop_steps, steps_per_dispatch=loop_k)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        n = _cuda.launch_counts()
        runs.append(("loop", n))
        res["loop"] = {"steps": loop_steps, "seconds": seconds,
                       "rays_per_s": loop_steps * step_rays / seconds, "launches": n}
    dl = trainer.stats["lossw"][-max(1, loop_steps // loop_k):]
    res["dispatch_lossw"] = dl
    res["lossw_last_over_first"] = dl[-1] / dl[0]
    log(f"[{tag}] loop: dispatch lossw {[round(v, 5) for v in dl]}; the last over the first "
        f"{dl[-1] / dl[0]:.4f} (limit {margin:g})")
    if not all(math.isfinite(v) for v in trainer.stats["loss"] + dl):
        raise AssertionError(f"{tag} loop: a loss is not finite: {trainer.stats['loss']}")
    if len(dl) > 1 and not dl[-1] < margin * dl[0]:
        raise AssertionError(f"{tag} loop: lossw did not fall below {margin:g} of the first "
                             f"dispatch's: {dl}")
    for run, n in runs:
        bad = {k: n[k] for k in absent if n[k]}
        missing = [k for k in required if n[k] == 0]
        log(f"[{tag}] {run}: launches {n}")
        if bad or missing:
            raise AssertionError(f"{tag} {run}: launched what it must not {bad}, or not "
                                 f"{missing}")
    wdata = t_dl.preload(loader.poses, loader.train_images, loader.intrinsics, loader.H,
                         loader.W, dev)
    res["profile"] = profile_dispatch(
        lambda: t_dl.wm_device_loop(trainer, wdata, ro_b, rd_b, loop_k), loop_k,
        f"{tag} profile", trainer.model.rc.compact_frac > 0, match)
    res["bitacc"] = trainer.test_bitacc(make_loader("test", 1, BASE_TRIALS))
    res["decoded_shape"] = list(ro_b.shape)
    log(f"[{tag}] {res['rays_per_s']:.0f} watermark rays/s; busy "
        f"{res['profile']['busy_ms']} ms a step; bit accuracy {res['bitacc']:.4f} over "
        f"{BASE_TRIALS} messages (decoder rays {tuple(ro_b.shape)})")
    return res, w


def zeroed_decoder_head(state):
    """A watermark checkpoint's state with the decoder's last layer (the
    linear map after the head) zeroed: every logit 0 and lossw ln 2 at the
    first step, whatever the scale of the trained features it reads; every
    other array shared with ``state``."""
    dec = state["trainable"]["decoder"]
    linear = {k: np.zeros_like(v) for k, v in dec["linear"].items()}
    return {**state, "trainable": {**state["trainable"], "decoder": {**dec, "linear": linear}}}


class PrewatermarkViews(BallViews):
    """The train loader's views with their pixels replaced by the
    watermarked copies (over white, three channels), as --prewatermark
    replaces ``train_set.images``; a held-out view's ground truth stays the
    analytic ball's."""

    WATERMARKED = None

    @property
    def images(self):
        return PrewatermarkViews.WATERMARKED


def phase_baselines(dev, backbone_model, wm_state, workdir):
    """The paper's baselines (slice 14) at the README recipe's full width on
    phase 7's backbone: --copyrnerf (64 steps + 64 looped, K4's logit and
    K10 against their plain versions on the step's own samples, no K9 and
    no backward of K1 or K4), --whole_image_wm (64 + 64), --finetune_decoder
    from phase 8's watermarked model, the decoder's last layer re-drawn (64
    looped: lossw below half the first dispatch's, the message tables
    bit-equal after, no backward but the decoder's), --prewatermark
    (pretrain_hidden 200 steps on phase 7's views, 512 clean loop steps on
    the watermarked views, bit survival over 4 rendered views) and FiLM
    once."""
    from nerf_signature_tpu_torch.models import film as t_film
    from nerf_signature_tpu_torch.train import device_loop as t_dl
    from nerf_signature_tpu_torch.train import prewatermark as t_pre
    from nerf_signature_tpu_torch.train.checkpoint import save_checkpoint

    res = {}
    t_phase = time.time()
    # ---- CopyRNeRF: the colour MLP (K10's input) and whole-image decodes
    r, w = baseline_run(dev, backbone_model, workdir, "copyrnerf", ["--copyrnerf"],
                        COPYRNERF_REQUIRED, COPYRNERF_ABSENT, ("K4_field_raw",),
                        match=("copyrnerf_input",))
    rec = record_field_inputs(w["trainer"], next(iter(w["loader"])))
    res["k10"] = k10_row(rec["k10"])
    res["k10"]["in_step"] = k10_in_step(w["trainer"], next(iter(w["loader"])))
    res["k10"]["in_loop_ms"] = r["profile"].get("matched_ms", {}).get("copyrnerf_input")
    log(f"[K10] in the profiled dispatch (CUDA graph of {BASE_K} steps): "
        f"{res['k10']['in_loop_ms']} device ms a step")
    res["k4_raw"] = k4_raw_rows(*rec["k4"])
    res["copyrnerf"] = r
    del r, w, rec
    gc.collect()
    # ---- the codebook tables with whole-image extraction
    r, w = baseline_run(dev, backbone_model, workdir, "whole image", ["--whole_image_wm"],
                        WM_TRAIN + K5_KERNELS, (), ("K4_field", "K4_field_bwd_feat"))
    res["whole_image"] = r
    del r, w
    gc.collect()
    # ---- --finetune_decoder from phase 8's watermarked model, its decoder's
    # last layer zeroed: from phase 8's converged decoder lossw starts at
    # its floor, and whether the last dispatch's mean fell below the first's
    # was a coin flip (8 runs: first 0.0088-0.099, last 0.0019-0.0167, one
    # failed); from a head re-drawn at its init (seed 19) it starts above
    # chance by as much as the trained features' scale sets (9 models:
    # first dispatch 2.31-2.90, the last over the first 0.05-0.62, one of 9
    # looped runs past FT_MARGIN); from a zeroed head it starts at chance
    # and falls alike on every model (4 models: first dispatch 0.488-0.494,
    # the last over the first 0.256-0.278; scripts_port/ft_decoder_spread.py)
    # and must fall clearly (FT_MARGIN), while the message tables stay
    # bit-equal
    ckpt = os.path.join(workdir, "wm_trained", "ngp_ep0001.ckpt")
    save_checkpoint(ckpt, zeroed_decoder_head(wm_state))
    r, w = baseline_run(dev, backbone_model, workdir, "finetune decoder", ["--finetune_decoder"],
                        FINETUNE_REQUIRED, FINETUNE_ABSENT, ("K4_field",), per_step=False,
                        loop_k=FT_K, ckpt=ckpt, margin=FT_MARGIN)
    tables = w["model"].trainable["msg_tables"].cpu().numpy()
    r["msg_tables_bit_equal"] = bool(np.array_equal(tables, wm_state["trainable"]["msg_tables"]))
    log(f"[finetune decoder] message tables bit-equal to phase 8's after {r['steps']} steps: "
        f"{r['msg_tables_bit_equal']}")
    if not r["msg_tables_bit_equal"]:
        raise AssertionError("finetune decoder: the message tables moved")
    res["finetune_decoder"] = r
    del r, w, tables
    gc.collect()
    # ---- --prewatermark: watermark phase 7's views, train on them, decode renders
    views = BallViews(TRAIN_BALL)
    px = views.images
    imgs = px[..., :3] * px[..., 3:] + (1.0 - px[..., 3:])
    message = np.random.default_rng(0).integers(0, 2, PRE_BITS)
    t0 = time.time()
    enc, dec, enc_cfg, dec_cfg = t_pre.pretrain_hidden(imgs, PRE_BITS, steps=PRE_STEPS, seed=0,
                                                       device=dev, log=log)
    PrewatermarkViews.WATERMARKED = t_pre.watermark_images(enc, enc_cfg, imgs, message)
    torch.cuda.synchronize()
    pre = {"pretrain_and_embed_s": time.time() - t0}
    pre["own_views_bitacc"], _ = t_pre.bit_survival(dec, dec_cfg,
                                                    PrewatermarkViews.WATERMARKED[:PRE_VIEWS],
                                                    message)
    r = train_case(dev, TRAIN_BALL, TRAIN_ITERS, steps_per_dispatch=DL_K,
                   views=lambda radius, error_map=False: PrewatermarkViews(radius))
    tr = r["trainer"]
    held = view_rays(orbit_poses(PRE_VIEWS, ORBIT_RADIUS, seed=11))
    backup, tr.model.params = tr.model.params, tr.eval_params()
    try:
        renders = np.stack([tr.model.render(held["rays_o"][i], held["rays_d"][i],
                                            staged=True)["image"].float().cpu().numpy()
                            .reshape(RES, RES, 3) for i in range(PRE_VIEWS)])
    finally:
        tr.model.params = backup
    pre["bit_survival"], pre["per_view"] = t_pre.bit_survival(dec, dec_cfg, renders, message)
    data = t_dl.preload(r["loader"].poses, r["loader"].images, r["loader"].intrinsics, RES, RES,
                        dev)
    pre["profile"] = profile_dispatch(lambda: t_dl.device_train_loop(tr, data, DL_K), DL_K,
                                      "prewatermark profile", tr.model.rc.compact_frac > 0)
    pre.update(steps=tr.global_step, seconds=r["seconds"],
               rays_per_s=tr.global_step * TRAIN_RAYS / r["seconds"], psnr0=r["psnr0"],
               psnr1=r["psnr1"], launches=r["launches"])
    log(f"[prewatermark] pretrain + embed {pre['pretrain_and_embed_s']:.2f} s; the decoder on "
        f"its own watermarked views {pre['own_views_bitacc']:.4f}; {tr.global_step} loop steps: "
        f"{pre['rays_per_s']:.0f} train rays/s, busy {pre['profile']['busy_ms']} ms a step, "
        f"held-out PSNR {r['psnr0']:.2f} -> {r['psnr1']:.2f} dB; bit survival over "
        f"{PRE_VIEWS} rendered views {pre['bit_survival']:.4f} {pre['per_view']}")
    if not (all(math.isfinite(v) for v in tr.stats["loss"]) and r["psnr1"] > r["psnr0"]):
        raise AssertionError(f"prewatermark: the clean loop did not train: {tr.stats['loss']}")
    res["prewatermark"] = pre
    PrewatermarkViews.WATERMARKED = None
    del r, tr, data, renders, views, px, imgs
    gc.collect()
    # ---- FiLM, once on the card against the same call on the CPU
    p = t_film.init_film_msg_encoder(torch.Generator().manual_seed(0), message_dim=WM_BITS)
    feat = torch.randn((1 << 16, 2), generator=torch.Generator().manual_seed(1))
    bits = torch.randint(0, 2, (WM_BITS,), generator=torch.Generator().manual_seed(2))
    out_c = t_film.film_msg_encode(p, feat, bits)
    p_dev = {k: ([{kk: vv.to(dev) for kk, vv in layer.items()} for layer in v]
                 if isinstance(v, list) else {kk: vv.to(dev) for kk, vv in v.items()})
             for k, v in p.items()}
    out_d = t_film.film_msg_encode(p_dev, feat.to(dev), bits.to(dev))
    err = float((out_d.cpu() - out_c).abs().max())
    res["film"] = {"max_abs_err_vs_cpu": err, "shape": list(out_d.shape)}
    log(f"[film] {tuple(out_d.shape)} on the card, max abs err against the CPU {err:.3g} "
        f"(limit 1e-4)")
    if not (err <= 1e-4 and bool(torch.isfinite(out_d).all())):
        raise AssertionError("film: the card's output differs from the CPU's")
    res["seconds"] = time.time() - t_phase
    log(f"[baselines] phase {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------- phase 13
LPIPS_PATCH = 32          # --patch_size of the LPIPS run: 4096 rays = 4 patches
LPIPS_STEPS = 64          # per-step clean steps with the patch LPIPS loss
LPIPS_CPU_LIMIT = 1e-4    # the meter on the card against the plain CPU value, relative
CLIP_STEPS = 32           # GT-free steps on --rand_pose bundles
CLIP_SEED = 13
# openai/clip-vit-base-patch32's vision tower: image, patch, width, layers,
# heads, MLP, projection (the weights random: none ship, none are fetched)
CLIP_B32 = dict(image=224, patch=32, width=768, layers=12, heads=12, mlp=3072, proj=512)
# the fixed-step path: (--num_steps, --upsample_steps) of each served view
FIXED_RUNS = {"512": (512, 0), "128+128": (128, 128)}
FIXED_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# the device time of a fixed view by kernel, by a substring of their names
FIXED_KERNELS = {"K1": "hash_encode_fwd", "K3": "composite_fwd", "K4 bf16": "field_mma_fwd",
                 "K4 fp32": "field_fwd"}
# JAX's refusal of the LPIPS loss in the device loop (trainer.py:699-705)
LPIPS_LOOP_REFUSAL = ("--patch_size LPIPS loss is not supported with --steps_per_dispatch "
                      "scan training; drop --steps_per_dispatch (per-step path) or unset the "
                      "LPIPS weights")


def clone_model(backbone, dev, dtype, cuda_ray=True, num_steps=512, upsample_steps=0):
    """A model at ``dtype`` holding a copy of phase 7's backbone (params and
    grid), with the occupancy grid or, ``cuda_ray`` off, the fixed-step
    renderer at ``num_steps`` + ``upsample_steps``."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.train.trainer import param_leaves

    cfg = dataclasses.replace(backbone.cfg, compute_dtype=dtype)
    m = NGPModel(cfg, cuda_ray=cuda_ray, min_near=backbone.rc.min_near,
                 density_thresh=backbone.density_thresh, dt_gamma=0.0, max_steps=1024,
                 grid_size=backbone.rc.grid_size, seed=3, train_budget=backbone.train_budget,
                 infer_budget=256,
                 num_steps=num_steps, upsample_steps=upsample_steps, device=dev)
    with torch.no_grad():
        for a, b in zip(param_leaves(m.params), param_leaves(backbone.params)):
            a.copy_(b)
    m.occ = type(backbone.occ)(*(v.clone() if torch.is_tensor(v) else v for v in backbone.occ))
    return m


def check_launched(launches, want, tag, exact=False):
    """Fail unless every kernel of ``want`` launched (a dict: exactly these
    counts and no other kernel, where ``exact``)."""
    if exact:
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{tag}: launches {launches}, expected {want}")
        return
    missing = [k for k in want if not launches.get(k)]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched ({launches})")


def lpips_state_dict(seed):
    """Random weights in the ``lpips.LPIPS(net='alex')`` key layout."""
    from nerf_signature_tpu_torch.utils import lpips as t_lpips

    g = torch.Generator().manual_seed(seed)
    p = t_lpips.init_lpips_params(g)
    sd = {}
    for i, ci in enumerate(t_lpips._CONV_IDX):
        sd[f"net.slice{i + 1}.{ci}.weight"] = p["convs"][i]["w"]
        sd[f"net.slice{i + 1}.{ci}.bias"] = torch.randn(p["convs"][i]["b"].shape,
                                                        generator=g) * 0.01
        sd[f"lin{i}.model.1.weight"] = p["lins"][i].view(1, -1, 1, 1)
    return sd


def random_clip_tower(dev, seed):
    """The port's vision-tower params at CLIP_B32's widths, random (normal,
    std 0.02; LayerNorms at 1 and 0), and its meta."""
    w = CLIP_B32
    g = torch.Generator().manual_seed(seed)
    D, F = w["width"], w["mlp"]

    def n(*shape):
        return (torch.randn(shape, generator=g) * 0.02).to(dev)

    def ln():
        return {"scale": torch.ones(D, device=dev), "bias": torch.zeros(D, device=dev)}

    tokens = (w["image"] // w["patch"]) ** 2 + 1
    params = {"class_embedding": n(D), "patch_embedding": n(D, 3, w["patch"], w["patch"]),
              "position_embedding": n(tokens, D), "pre_ln": ln(), "post_ln": ln(),
              "proj": n(D, w["proj"]), "layers": []}
    for _ in range(w["layers"]):
        layer = {"ln1": ln(), "ln2": ln(), "fc1_w": n(D, F), "fc1_b": n(F), "fc2_w": n(F, D),
                 "fc2_b": n(D)}
        for k in "qkvo":
            layer[f"{k}_w"], layer[f"{k}_b"] = n(D, D), n(D)
        params["layers"].append(layer)
    meta = {"n_heads": w["heads"], "patch": w["patch"], "image_size": w["image"],
            "act": "quick_gelu"}
    return params, meta


def step_opt(**kw):
    from types import SimpleNamespace

    opt = dict(lr=1e-2, iters=1000, num_rays=TRAIN_RAYS, max_steps=1024,
               update_extra_interval=16, compact_frac=-1, group_budget=-1, max_ray_batch=CHUNK,
               patch_size=1, lambda_ssim=0.0, color_space="srgb")
    opt.update(kw)
    return SimpleNamespace(**opt)


def recorded_losses(trainer):
    """Record the loss of every train step (a wrapper of train_step_data)."""
    losses = []
    step = trainer.train_step_data

    def recorded(data):
        out = step(data)
        if out[0] is not None:
            losses.append(float(out[0]))
        return out

    trainer.train_step_data = recorded
    return losses


def held_view():
    """The held-out view of the train phase (seed 9) and its RGBA pixels."""
    held = view_rays(orbit_poses(1, ORBIT_RADIUS, seed=9))
    rgba = ball_rgba(held["rays_o"][0], held["rays_d"][0], radius=TRAIN_BALL)
    return held, rgba


def lpips_run(dev, backbone, workdir):
    """--patch_size 32 with LPIPS weights through the clean per-step trainer
    on phase 7's backbone: LPIPS_STEPS steps on 4 patches of 32 x 32 a step,
    the LPIPS term in every step, finite losses; the LPIPS meter of an
    evaluation (as --test runs it) on the held-out view, against the plain
    CPU value on the same images; the device loop's refusal."""
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.metrics import LPIPSMeter, PSNRMeter
    from nerf_signature_tpu_torch.train.trainer import Trainer
    from nerf_signature_tpu_torch.utils import lpips as t_lpips

    path = os.path.join(workdir, "alex.pth")
    torch.save(lpips_state_dict(CLIP_SEED), path)
    trainer = Trainer("ngp", step_opt(patch_size=LPIPS_PATCH, lpips_weights=path),
                      clone_model(backbone, dev, torch.bfloat16), workspace=None,
                      use_checkpoint="scratch")
    if trainer._lpips_params is None:
        raise AssertionError("lpips: the trainer resolved no weights from the file")
    losses = recorded_losses(trainer)
    calls = [0]
    distance = t_lpips.lpips_distance

    def counted(*a):
        calls[0] += 1
        return distance(*a)

    loader = BallViews(TRAIN_BALL, patch_size=LPIPS_PATCH)
    t_lpips.lpips_distance = counted
    try:
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.time()
        trainer.train(loader, None, max_epochs=LPIPS_STEPS // TRAIN_VIEWS)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = _cuda.launch_counts()
    finally:
        t_lpips.lpips_distance = distance
    steps = trainer.global_step
    losses = list(losses)
    prof = profile_steps(trainer, loader, tag="lpips profile")
    r = {"steps": steps, "seconds": seconds, "rays_per_s": steps * TRAIN_RAYS / seconds,
         "loss_first": losses[0], "loss_last": losses[-1], "lpips_calls": calls[0],
         "profile": prof, "launches": launches}
    log(f"[lpips] {steps} steps of {TRAIN_RAYS} rays (4 patches of {LPIPS_PATCH}^2) in "
        f"{seconds:.2f} s: {r['rays_per_s']:.0f} train rays/s; loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; the LPIPS term in {calls[0]} steps; launches {launches}")
    if not (steps == LPIPS_STEPS and len(losses) == steps and calls[0] == steps
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"lpips: {steps} steps, {calls[0]} LPIPS terms, losses {losses}")
    check_launched(launches, CLEAN_TRAIN, "lpips steps")
    # ---- the meter, as --test runs it, on the card and on the CPU
    held, rgba = held_view()
    meter = LPIPSMeter(weights_path=path, device=dev)
    trainer.metrics = [PSNRMeter(), meter]
    trainer.evaluate_one_epoch([{"H": RES, "W": RES, "rays_o": held["rays_o"],
                                 "rays_d": held["rays_d"],
                                 "images": rgba.reshape(1, RES, RES, 4)}])
    backup, trainer.model.params = trainer.model.params, trainer.eval_params()
    try:
        pred = trainer.model.render(held["rays_o"][0], held["rays_d"][0],
                                    staged=True)["image"].float().cpu().numpy()
    finally:
        trainer.model.params = backup
    gt = rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])
    pred, gt = pred.reshape(1, RES, RES, 3), gt.reshape(1, RES, RES, 3)
    on_card = t_lpips.lpips_metric(meter._params, pred, gt)
    on_cpu = t_lpips.lpips_metric(t_lpips.load_lpips_params(path), pred, gt)
    rel = abs(on_card - on_cpu) / max(abs(on_cpu), 1e-12)
    r.update(meter=meter.measure(), lpips_card=on_card, lpips_cpu=on_cpu, lpips_rel=rel)
    log(f"[lpips] the evaluation's {meter.report()}; the held-out view's LPIPS on the card "
        f"{on_card:.6f}, on the CPU {on_cpu:.6f} (relative {rel:.2e}, limit {LPIPS_CPU_LIMIT})")
    if not (meter.measure() is not None and math.isfinite(meter.measure())
            and rel <= LPIPS_CPU_LIMIT):
        raise AssertionError("lpips: the meter on the card differs from the CPU's")
    try:
        trainer.train_device(loader, 8, steps_per_dispatch=8)
    except RuntimeError as e:
        if str(e) != LPIPS_LOOP_REFUSAL:
            raise
        log(f"[lpips] the device loop refuses the LPIPS loss: {e}")
    else:
        raise AssertionError("lpips: the device loop took the LPIPS loss")
    return r


def clip_bundles(n, seed):
    """n --rand_pose bundles as the provider collates them for 800 x 800 at
    4096 rays: a 64 x 64 image of a random pose."""
    from nerf_signature_tpu_torch.data.rays import get_rays, rand_poses

    s = np.sqrt(RES * RES / TRAIN_RAYS)
    rh = int(RES / s)
    fl = RES / (2 * np.tan(BLENDER_ANGLE_X / 2))
    poses = rand_poses(np.random.default_rng(seed), n, radius=ORBIT_RADIUS)
    out = []
    for i in range(n):
        r = get_rays(poses[i:i + 1], np.array([fl, fl, RES / 2, RES / 2]) / s, rh, rh, -1)
        out.append({"H": rh, "W": rh, "rays_o": r["rays_o"], "rays_d": r["rays_d"]})
    return out


def clip_run(dev, backbone, workdir):
    """GT-free CLIP guidance on phase 7's backbone: a random vision tower at
    ViT-B/32's widths and a random unit text vector injected into the clean
    trainer (as JAX's test injects them), CLIP_STEPS steps on 64 x 64
    --rand_pose bundles (each upsampled to 224); finite losses, nonzero hash
    table gradients; the CLI's --clip_text refused with JAX's message (no
    weights here, and the hub offline)."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.trainer import Trainer

    params, meta = random_clip_tower(dev, CLIP_SEED)
    text = torch.randn((1, CLIP_B32["proj"]), generator=torch.Generator().manual_seed(1))
    text = (text / text.norm()).to(dev)
    trainer = Trainer("ngp", step_opt(), clone_model(backbone, dev, torch.bfloat16),
                      workspace=None, use_checkpoint="scratch")
    trainer._clip = SimpleNamespace(params=params, meta=meta, text_features=text)
    bundles = clip_bundles(CLIP_STEPS + 16, seed=CLIP_SEED)
    table = trainer.model.params["hash_table"]
    losses, grads = [], []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.time()
    for data in bundles[:CLIP_STEPS]:
        losses.append(float(trainer.train_step_data(data)[0]))
        grads.append(float(table.grad.abs().max()))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _cuda.launch_counts()
    prof = profile_steps(trainer, bundles[CLIP_STEPS:], tag="clip profile")
    r = {"steps": CLIP_STEPS, "seconds": seconds, "image": bundles[0]["H"],
         "rays_per_s": CLIP_STEPS * TRAIN_RAYS / seconds, "loss_first": losses[0],
         "loss_last": losses[-1], "table_grad_max_min": min(grads), "profile": prof,
         "launches": launches}
    log(f"[clip] {CLIP_STEPS} GT-free steps of a {r['image']}x{r['image']} bundle in "
        f"{seconds:.2f} s ({seconds / CLIP_STEPS * 1e3:.1f} ms a step); loss {losses[0]:.6f} "
        f"-> {losses[-1]:.6f}; smallest max |table grad| {min(grads):.3g}; launches {launches}")
    if not (all(math.isfinite(v) for v in losses) and min(grads) > 0):
        raise AssertionError(f"clip: losses {losses}, table grads {grads}")
    check_launched(launches, CLEAN_TRAIN, "clip steps")
    try:
        t_main.main([os.path.join(workdir, "no_scene"), "--workspace",
                     os.path.join(workdir, "ws_clip"), "--test", "--clip_text", "a red ball"])
    except RuntimeError as e:
        msg = str(e)
        if not (msg.startswith("CLIP weights unavailable (openai/clip-vit-base-patch32): ")
                and msg.endswith("Provide a local model path via --clip_model.")):
            raise
        log(f"[clip] the CLI's --clip_text without weights: {msg}")
        r["cli_error"] = msg
    else:
        raise AssertionError("clip: the CLI took --clip_text without weights")
    return r


def fixed_view(m, held, tag):
    """One 800 x 800 view through the fixed-step path: the staged render
    timed, its launches, and again under torch.profiler (busy ms, idle
    share, device ms by kernel)."""
    from nerf_signature_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.time()
    img = m.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _cuda.launch_counts()

    def work():
        t = time.time()
        m.render(held["rays_o"][0], held["rays_d"][0], staged=True)
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3

    by_name, wall_prof = traced(work, tag)
    r = {"wall_s": wall, "launches": {k: v for k, v in launches.items() if v}}
    if by_name is None:
        r.update(busy_ms=None, idle_share=None, by_kernel=None)
    else:
        busy = sum(by_name.values()) / 1e3
        by_kernel = {k: sum(us for n, us in by_name.items() if pat in n) / 1e3
                     for k, pat in FIXED_KERNELS.items()}
        by_kernel["other"] = busy - sum(by_kernel.values())
        r.update(busy_ms=busy, idle_share=1 - busy / wall_prof, by_kernel=by_kernel)
    return img, r


def fixed_runs(dev, backbone, workdir):
    """The fixed-step path (cuda_ray off) on phase 7's backbone, in fp32 (the
    CLI without -O: K4's SIMT route) and bf16 (--fp16), at the defaults
    (512 samples) and at 128 + 128 (the pdf upsample): one 800 x 800 view
    each through the kernels (K1, K4, K3 launched; no K2), the first 4096
    rays against the plain route (>= 45 dB), the view's PSNR against the
    grid render of the same backbone and against the analytic ball; then
    the port's main_nerf --test without --cuda_ray on a checkpoint of the
    backbone (11 views of 400 x 400 at the defaults, fp32)."""
    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.trainer import Trainer

    held, rgba = held_view()
    gt = torch.from_numpy(rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])).to(dev)
    grid_model = clone_model(backbone, dev, torch.bfloat16)
    img_grid = grid_model.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"]
    out = {"grid_psnr_vs_ball": psnr(img_grid, gt)}
    counts = {}
    for dname, dtype in FIXED_DTYPES.items():
        for run, (steps, up) in FIXED_RUNS.items():
            tag = f"fixed {dname} {run}"
            m = clone_model(backbone, dev, dtype, cuda_ray=False, num_steps=steps,
                            upsample_steps=up)
            img, r = fixed_view(m, held, tag)
            n = r["launches"]
            k4 = "K4_field" if dtype == torch.bfloat16 else "K4_field_f32"
            chunks = math.ceil(RES * RES / CHUNK)
            check_launched(n, {"K1_hash_encode": chunks * (2 if up else 1),
                               k4: chunks * (2 if up else 1), "K3_composite": chunks}, tag,
                           exact=True)
            ro = torch.from_numpy(held["rays_o"][0, :CHUNK]).to(dev)
            rd = torch.from_numpy(held["rays_d"][0, :CHUNK]).to(dev)
            k, p = (m.render(ro, rd, plain=plain)["image"] for plain in (False, True))
            r.update(kernel_vs_plain_db=psnr(k, p), kernel_vs_plain_max=float((k - p).abs().max()),
                     psnr_vs_grid=psnr(img, img_grid), psnr_vs_ball=psnr(img, gt),
                     samples=RES * RES * (steps + up))
            log(f"[{tag}] 800x800 view, {steps} + {up} samples a ray: {r['wall_s']:.2f} s, "
                f"busy {r['busy_ms']} ms (idle share {r['idle_share']}), device ms by kernel "
                f"{r['by_kernel']}; launches {n}; kernel vs plain (4096 rays) "
                f"{r['kernel_vs_plain_db']:.2f} dB (limit 45); PSNR vs the grid render "
                f"{r['psnr_vs_grid']:.2f} dB, vs the ball {r['psnr_vs_ball']:.2f} dB (the grid "
                f"render's {out['grid_psnr_vs_ball']:.2f})")
            if not (bool(torch.isfinite(img).all()) and r["kernel_vs_plain_db"] >= 45.0):
                raise AssertionError(f"{tag}: kernel vs plain {r['kernel_vs_plain_db']:.2f} dB")
            out[f"{dname} {run}"] = r
            counts[f"{dname} {run}"] = n
            del m
    # ---- the CLI: main_nerf --test without --cuda_ray (fp32, the defaults)
    ws = os.path.join(workdir, "ws_fixed")
    writer = Trainer("ngp", step_opt(), clone_model(backbone, dev, torch.bfloat16),
                     workspace=ws, use_checkpoint="scratch", mute=True)
    writer.save_checkpoint(full=False)
    del writer
    # a COLMAP-style transforms.json (half resolution): the clean provider's
    # test path then renders 11 poses slerped between two frames, and reads
    # no image (this machine has no cv2)
    scene = write_scene(os.path.join(workdir, "scene_fixed"))
    with open(os.path.join(scene, "transforms_test.json")) as f:
        transforms = json.load(f)
    transforms.update(h=RES // 2, w=RES // 2)
    with open(os.path.join(scene, "transforms.json"), "w") as f:
        json.dump(transforms, f)
    _cuda.reset_launch_counts()
    t0 = time.time()
    rc = t_main.main([scene, "--workspace", ws, "--test", "--bound", "1.0", "--scale", "0.8",
                      "--dt_gamma", "0", "--mesh_resolution", "64"])
    torch.cuda.synchronize()
    cli = {"rc": rc, "seconds": time.time() - t0, "launches": {
        k: v for k, v in _cuda.launch_counts().items() if v}}
    names = sorted(os.listdir(os.path.join(ws, "results")))
    frames = [n for n in names if n.endswith(".png")]  # and the video beside them
    log(f"[fixed cli] main_nerf --test without --cuda_ray: rc {rc}, {cli['seconds']:.2f} s, "
        f"results {names}, launches {cli['launches']}")
    if rc != 0 or len(frames) != 11:
        raise AssertionError(f"fixed cli: {cli}")
    check_launched(cli["launches"], ("K1_hash_encode", "K4_field_f32", "K3_composite"),
                   "fixed cli")
    if cli["launches"].get("K2_march", 0):
        raise AssertionError(f"fixed cli: K2 launched without the grid: {cli}")
    out["cli"] = cli
    return out, counts


def phase_lpips_clip_fixed(dev, backbone, workdir):
    """The patch LPIPS loss and the LPIPS meter, GT-free CLIP
    guidance, and the fixed-step renderer (cuda_ray off), each on phase 7's
    backbone at the README recipe's widths (see lpips_run, clip_run,
    fixed_runs)."""
    t_phase = time.time()
    res = {"lpips": lpips_run(dev, backbone, workdir)}
    gc.collect()
    res["clip"] = clip_run(dev, backbone, workdir)
    gc.collect()
    res["fixed"], counts = fixed_runs(dev, backbone, workdir)
    gc.collect()
    res["seconds"] = time.time() - t_phase
    log(f"[lpips clip fixed] phase {res['seconds']:.1f} s")
    return res, counts


# --------------------------------------------------------------- phase 14
# the one-rank NCCL runs: two epochs of the 32 views per step, one dispatch
# of 64 in the loop; the TF32 tolerance (relative L2 against the CPU's fp32)
PAR_STEPS = 64
PAR_K = 64
TF32_TOL = 1e-4
PAR_KERNELS = CLEAN_TRAIN + ("K5_compact_pack", "K5_compact_unpack", "K5_compact_unpack_bwd")


def par_trainer(dev):
    """A fresh full-width clean model (the train phase's settings and seed)
    and its Trainer for PAR_STEPS steps; under a formed process group the
    trainer shards over it (``--devices 0``)."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.train.trainer import Trainer

    opt = SimpleNamespace(lr=1e-2, iters=PAR_STEPS, num_rays=TRAIN_RAYS, max_steps=1024,
                          update_extra_interval=16, compact_frac=0, group_budget=-1,
                          max_ray_batch=CHUNK, patch_size=1, color_space="srgb", devices=0)
    # compaction fixed at half the slots: K5 (and its cap) in every step
    model = NGPModel(NGPConfig(bound=1.0), min_near=0.2, density_thresh=10.0, dt_gamma=0.0,
                     max_steps=1024, grid_size=128, seed=2, train_budget=TRAIN_BUDGET,
                     infer_budget=256, compact_frac=0.5, device=dev)
    return Trainer("ngp", opt, model, workspace=None, use_checkpoint="scratch", mute=True)


def par_state(tr):
    """The trainer's params, EMA, Adam moments and grid densities, cloned."""
    from nerf_signature_tpu_torch.train.trainer import param_leaves

    leaves = param_leaves(tr.model.params)
    return ([p.detach().clone() for p in leaves]
            + [p.detach().clone() for p in param_leaves(tr.ema_params)]
            + [tr.optimizer.state[p][k].clone() for p in leaves
               for k in ("exp_avg", "exp_avg_sq")] + [tr.model.occ.density.clone()])


def par_diff(a, b):
    """(bit-equal, the largest relative L2 over the leaves) of two states."""
    return (all(torch.equal(x, y) for x, y in zip(a, b)),
            max(rel_l2(x, y) for x, y in zip(a, b)))


def identity_checks(mesh):
    """Wrap a one-rank mesh's collectives to check at each call that they
    give back their input bit for bit (a mean over one rank), and that
    K5's cap is the whole budget; per step only (they read values back).
    Returns the checks' results and the function that takes the wrappers
    off."""
    seen = {"grads": [], "stats": [], "cap": []}
    mean_grads, step_stats, cap = mesh.mean_grads_, mesh.step_stats, mesh.compaction_cap

    def grads(leaves):
        before = [p.grad.clone() for p in leaves]
        mean_grads(leaves)
        seen["grads"].append(all(torch.equal(a, p.grad) for a, p in zip(before, leaves)))

    def stats(loss, *per_ray):
        out = step_stats(loss, *per_ray)
        seen["stats"].append(bool(torch.equal(out[0], loss.detach())) and all(
            torch.equal(a, b) for a, b in zip(out[1:], per_ray)))
        return out

    def caps(mask, n_rep, Mc):
        c = cap(mask, n_rep, Mc)
        seen["cap"].append(int(c) == Mc)
        return c

    mesh.mean_grads_, mesh.step_stats, mesh.compaction_cap = grads, stats, caps

    def restore():
        mesh.mean_grads_, mesh.step_stats, mesh.compaction_cap = mean_grads, step_stats, cap

    return seen, restore


def par_profile(work, n, tag):
    """torch.profiler over ``work`` (n steps): the device's busy ms a step
    and the ms a step of NCCL's device work (kernels or copies whose names
    hold "nccl"), or None where every trace came back empty."""
    def timed_work():
        t0 = time.time()
        work()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e6

    by_name, wall_us = traced(timed_work, tag)
    if by_name is None:
        log(f"[{tag}] device busy time not measured (no trace held device events)")
        return {"wall_ms": wall_us / n / 1e3, "busy_ms": None, "nccl_ms": None}
    busy = sum(by_name.values())
    nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
    copies = sum(v for k, v in by_name.items() if "Memcpy DtoD" in k)
    out = {"wall_ms": wall_us / n / 1e3, "busy_ms": busy / n / 1e3,
           "nccl_ms": sum(nccl.values()) / n / 1e3, "idle_share": 1 - busy / wall_us,
           "dtod_copy_ms": copies / n / 1e3, "nccl_functions": sorted(k[:80] for k in nccl)}
    log(f"[{tag}] {n} steps: wall {out['wall_ms']:.3f} ms a step, device busy "
        f"{out['busy_ms']:.4f} ms a step (idle share {out['idle_share']:.1%}), NCCL's device "
        f"work {out['nccl_ms']:.4f} ms a step ({out['nccl_functions']}), device-to-device "
        f"copies {out['dtod_copy_ms']:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[{tag}]   {us / n / 1e3:8.4f} ms a step  {name}")
    return out


def par_run(dev, loop, group):
    """PAR_STEPS clean steps (Trainer.train, or one Trainer.train_device
    dispatch of PAR_K) of a fresh model on the train phase's views, with or
    without the formed one-rank group; then one more profiled dispatch (the
    loop) or 16 more profiled steps.  Returns the state after the run, its
    launches, the identity checks (per step, under the group) and the
    profile."""
    from nerf_signature_tpu_torch.ops import _cuda

    tr = par_trainer(dev)
    if (tr.mesh is not None) != group:
        raise AssertionError(f"trainer mesh {tr.mesh} under group={group}")
    checks, restore = identity_checks(tr.mesh) if group and not loop else (None, None)
    loader = BallViews(TRAIN_BALL)
    if loop:
        loader.images  # made before the run, as a dataset is loaded
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.time()
    if loop:
        tr.train_device(loader, PAR_STEPS, steps_per_dispatch=PAR_K)
    else:
        tr.train(loader, None, max_epochs=PAR_STEPS // TRAIN_VIEWS)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _cuda.launch_counts()
    if tr.global_step != PAR_STEPS:
        raise AssertionError(f"ran {tr.global_step} steps, expected {PAR_STEPS}")
    state = par_state(tr)
    if restore is not None:
        restore()  # the profile reads the collectives as the trainer runs them
    tag = f"parallel {'loop' if loop else 'step'} {'group' if group else 'no group'}"
    if loop:
        from nerf_signature_tpu_torch.train import device_loop as t_dl

        # one more dispatch on the views preloaded once, captured outside the
        # trace (a new data object is a new capture)
        data = t_dl.preload(loader.poses, loader.images, loader.intrinsics, RES, RES, dev)
        t_dl.device_train_loop(tr, data, PAR_K)
        prof = par_profile(lambda: t_dl.device_train_loop(tr, data, PAR_K), PAR_K, tag)
    else:
        from itertools import islice

        batches = list(islice(iter(loader), 16))
        prof = par_profile(lambda: [tr.train_step_data(b) for b in batches], 16, tag)
    losses = [float(v) for v in tr.stats["loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    return dict(state=state, launches=launches, checks=checks, profile=prof, seconds=seconds,
                losses=losses, captures=tr.step_graph.captures if loop else None)


def k5_cap_rows(dev, m):
    """K5's pack with a cap (one rank's share of a global budget) against
    its plain version at the clean step's shapes, bit for bit: caps of 0, a
    third of Mc, Mc and past Mc."""
    from nerf_signature_tpu_torch.ops import compact as t_compact

    mask, xyzs, rd, n_occ = k5_march(m, TRAIN_RAYS, TRAIN_BUDGET, seed=60)
    Mc, _ = auto_mc(n_occ, TRAIN_RAYS, TRAIN_BUDGET)
    out = {}
    for cap in (0, Mc // 3, Mc, Mc + 4096):
        c = torch.tensor(cap, dtype=torch.int64, device=dev)
        comp = t_compact.compact(mask, xyzs, rd, Mc, cap=c)
        plain = t_compact.compact_plain(mask, xyzs, rd, Mc, cap=c)
        if not k5_same(comp, plain):
            raise AssertionError(f"K5_compact_pack with cap {cap} differs from its plain version")
        out[cap] = int(plain.keep.sum())
    log(f"[parallel] K5 pack with a cap at {TRAIN_RAYS} x {TRAIN_BUDGET}, Mc {Mc}: kept "
        f"{out} by cap, each bit-exact against the plain version")
    return {"Mc": Mc, "kept_by_cap": out}


def par_refusal(workdir):
    """``main_nerf --devices 2`` with one GPU visible: a non-zero exit and
    the clear error, before any rank starts."""
    scene = write_scene(os.path.join(workdir, "scene_refusal"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "nerf_signature_tpu_torch.main_nerf", scene,
                        "-O", "--devices", "2", "--workspace", os.path.join(workdir, "ws_r")],
                       capture_output=True, text=True, timeout=300, cwd=os.getcwd())
    err = (r.stderr or "").strip().splitlines()
    line = next((x for x in reversed(err) if "--devices 2" in x), "")
    out = {"rc": r.returncode, "seconds": time.time() - t0, "error": line}
    log(f"[parallel] main_nerf --devices 2 on {torch.cuda.device_count()} GPU: rc "
        f"{r.returncode} in {out['seconds']:.1f} s: {line}")
    if torch.cuda.device_count() < 2 and (r.returncode == 0 or "needs 2 CUDA devices" not in line
                                          or "spawn" in r.stderr):
        raise AssertionError(f"--devices 2 was not refused before spawning: {r.stderr[-2000:]}")
    return out


def par_video(dev, backbone, workdir):
    """The CLI's --test on a checkpoint of the backbone: 11 views of
    400 x 400 to PNGs and the video, whichever branch this machine takes
    (imageio's mp4, PIL's GIF, or none, logged)."""
    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.trainer import Trainer

    ws = os.path.join(workdir, "ws_video")
    Trainer("ngp", step_opt(), clone_model(backbone, dev, torch.bfloat16), workspace=ws,
            use_checkpoint="scratch", mute=True).save_checkpoint(full=False)
    scene = write_scene(os.path.join(workdir, "scene_video"))
    with open(os.path.join(scene, "transforms_test.json")) as f:
        transforms = json.load(f)
    transforms.update(h=RES // 2, w=RES // 2)
    with open(os.path.join(scene, "transforms.json"), "w") as f:
        json.dump(transforms, f)
    from nerf_signature_tpu_torch.utils.device import CUDNN_TF32

    # flags the CLI must set itself
    torch.backends.cudnn.allow_tf32 = not CUDNN_TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    _cuda.reset_launch_counts()
    t0 = time.time()
    rc = t_main.main([scene, "--workspace", ws, "-O", "--test", "--bound", "1.0", "--scale",
                      "0.8", "--dt_gamma", "0", "--mesh_resolution", "64"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    results = os.path.join(ws, "results")
    names = sorted(os.listdir(results))
    pngs = [n for n in names if n.endswith(".png")]
    video = [n for n in names if n.endswith((".mp4", ".gif"))]
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        lines = [x.strip() for x in f if x.startswith("[test]")]
    branch = ("mp4" if any(n.endswith(".mp4") for n in video) else
              "gif" if video else "skipped")
    out = {"rc": rc, "seconds": time.time() - t0, "pngs": len(pngs), "video": video,
           "branch": branch, "log": lines, "launches": launches, "cli_tf32": tf32}
    log(f"[parallel] main_nerf -O --test: rc {rc}, {out['seconds']:.1f} s, {len(pngs)} PNGs, "
        f"video branch {branch} ({video}; log {lines}); TF32 after the CLI {tf32}; "
        f"launches {launches}")
    if rc != 0 or len(pngs) != 11 or (branch == "skipped") != any(
            "video write skipped" in x for x in lines) or tf32 != (CUDNN_TF32, False):
        raise AssertionError(f"--test video: {out}")
    check_launched(launches, FORWARD, "--test video")
    return out


def decode_png(data):
    """[H, W, 3] uint8 of a PNG the port's encoder wrote (filter 0 rows)."""
    import struct
    import zlib

    W, H = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    return raw[:, 1:].reshape(H, W, 3)


def par_viewer(dev, backbone):
    """The --gui server on localhost with a train slice: /frame twice, an
    orbit /ctl, the page; then the last frame against the plain route."""
    import urllib.request

    from nerf_signature_tpu_torch.data.rays import get_rays
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.parallel.multihost import free_port
    from nerf_signature_tpu_torch.train.trainer import Trainer
    from nerf_signature_tpu_torch.viewer_server import ViewerServer

    m = clone_model(backbone, dev, torch.bfloat16)
    tr = Trainer("ngp", step_opt(), m, workspace=None, use_checkpoint="scratch", mute=True)
    port = free_port()
    srv = ViewerServer(tr, BallViews(TRAIN_BALL), W=RES // 2, H=RES // 2, radius=ORBIT_RADIUS,
                       fovy=math.degrees(BLENDER_ANGLE_X), port=port)
    base = f"http://127.0.0.1:{port}"

    def post(msg):
        req = urllib.request.Request(base + "/ctl", data=json.dumps(msg).encode(),
                                     method="POST")
        return urllib.request.urlopen(req, timeout=30).status

    def frame():
        for _ in range(600):
            try:
                r = urllib.request.urlopen(base + "/frame", timeout=30)
                return r.read(), r.headers["Content-Type"], r.headers["X-Stats"]
            except Exception:
                time.sleep(0.1)
        raise AssertionError("the viewer served no frame in 60 s")

    _cuda.reset_launch_counts()
    t0 = time.time()
    srv.serve(blocking=False)
    try:
        if post({"train": 1}) != 204:
            raise AssertionError("/ctl train refused")
        f1 = frame()
        deadline = time.time() + 60
        while tr.global_step < 16 and time.time() < deadline:
            time.sleep(0.1)
        f2 = frame()
        if post({"train": 0}) != 204 or post({"orbit": [40, 10]}) != 204:
            raise AssertionError("/ctl refused")
        time.sleep(1.0)
        f3 = frame()
        page = urllib.request.urlopen(base + "/", timeout=30).read()
    finally:
        srv.stop()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    v = srv.viewer
    last, last_type = srv.frame, srv.content_type
    out = {"seconds": time.time() - t0, "train_steps": tr.global_step,
           "frames": [len(f[0]) for f in (f1, f2, f3)], "content_type": f3[1], "stats": f3[2],
           "page_ok": b"tpu-ngp-signature" in page, "downscale": v.downscale,
           "launches": launches}
    if tr.global_step < 1 or not out["page_ok"]:
        raise AssertionError(f"viewer: {out}")
    check_launched(launches, CLEAN_TRAIN, "viewer")
    # the server's last frame is the viewer's last image (one sample at the
    # pixel centres, max_spp 1) at its camera: held against the same rays
    # through the plain route
    img = v._accum
    H, W = img.shape[:2]
    if last_type == "image/png":
        out["png_equals_render"] = bool(np.array_equal(decode_png(last),
                                                       (img * 255).astype(np.uint8)))
    rays = get_rays(v.cam.pose[None], v.cam.intrinsics * (H / v.cam.H), H, W, -1)
    plain = m.render(rays["rays_o"], rays["rays_d"], staged=True, plain=True,
                     bg_color=np.full((1, 3), v.bg_color, np.float32))["image"]
    plain = plain.float().clamp(0, 1).reshape(H, W, 3)
    out["kernel_vs_plain_db"] = psnr(torch.from_numpy(img).to(dev), plain)
    log(f"[parallel] viewer: {out['train_steps']} train steps in slices, frames "
        f"{out['frames']} bytes ({out['content_type']}), {out['stats']!r}; the last frame "
        f"against the plain route {out['kernel_vs_plain_db']:.2f} dB (limit 45)"
        + (f", PNG equals the render: {out['png_equals_render']}" if "png_equals_render" in out
           else "") + f"; launches {launches}")
    if out["kernel_vs_plain_db"] < 45.0 or out.get("png_equals_render") is False:
        raise AssertionError(f"viewer frame: {out}")
    return out


def torch_ngp_pth(path, seed, grid):
    """A torch-ngp clean checkpoint at the recipe's widths from a seed: 16
    level tables of 2^19 x 2 at U(+-1), the tcnn-packed MLPs (each layer a
    row-major [out, in] matrix, widths padded to 16) and the row-major
    ``grid`` [1, H^3] stored in Morton order."""
    from nerf_signature_tpu_torch.ops.morton import morton3d

    g = torch.Generator().manual_seed(seed)
    state = {f"encoder.embeddings.{i}.weight": torch.rand((2**19, 2), generator=g) * 2 - 1
             for i in range(16)}

    def pack(dims):
        flat = []
        for a, b in zip(dims[:-1], dims[1:]):
            pa, pb = -(-a // 16) * 16, -(-b // 16) * 16
            w = torch.zeros((pb, pa))
            w[:b, :a] = torch.randn((b, a), generator=g) / math.sqrt(a)
            flat.append(w.reshape(-1))
        return torch.cat(flat)

    state["sigma_net.params"] = pack([32, 64, 16])
    state["color_net.params"] = pack([31, 64, 64, 3])
    H = round(grid.shape[-1] ** (1 / 3))
    ax = torch.arange(H)
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    codes = morton3d(torch.stack([x, y, z], -1).reshape(-1, 3))
    morton = torch.empty_like(grid)
    morton[:, codes] = grid
    state["density_grid"] = morton
    torch.save({"model": state, "mean_density": float(grid.mean())}, path)


def par_ingest(dev, workdir):
    """A seeded torch-ngp .pth (written here), ingested onto the card: the
    grid back in row-major order, one view through the kernels against the
    plain route."""
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.train.torch_ingest import ingest_clean_pth

    path = os.path.join(workdir, "torch_ngp.pth")
    grid = ball_grid(1, 128).reshape(1, -1).float() * 20.0
    torch_ngp_pth(path, 7, grid)
    cfg = NGPConfig(bound=1.0, compute_dtype=torch.bfloat16)
    t0 = time.time()
    params, extras = ingest_clean_pth(path, cfg, device=dev)
    ingest_s = time.time() - t0
    if not np.array_equal(extras["density_grid"], grid.numpy()):
        raise AssertionError("ingest: the density grid did not come back in row-major order")
    m = NGPModel(cfg, min_near=0.2, density_thresh=10.0, dt_gamma=0.0, max_steps=1024,
                 grid_size=128, seed=0, infer_budget=256, device=dev)
    m.params = params
    occ = torch.from_numpy(extras["density_grid"] > 10.0).reshape(1, 128, 128, 128)
    m.occ = m.occ._replace(occupancy=occ.expand(m.cascade, -1, -1, -1).contiguous().to(dev))
    held, _ = held_view()
    _cuda.reset_launch_counts()
    img = m.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    plain = m.render(held["rays_o"][0], held["rays_d"][0], staged=True, plain=True)["image"]
    out = {"ingest_s": ingest_s, "launches": launches,
           "kernel_vs_plain_db": psnr(img, plain), "ptp": float(img.max() - img.min())}
    log(f"[parallel] ingest: a seeded torch-ngp .pth (16 x 2^19 x 2 tables, tcnn-packed MLPs, "
        f"a Morton-ordered 128^3 grid) ingested in {ingest_s:.2f} s; an 800x800 view through "
        f"the kernels against the plain route {out['kernel_vs_plain_db']:.2f} dB (limit 45), "
        f"image range {out['ptp']:.3f}; launches {launches}")
    if out["kernel_vs_plain_db"] < 45.0 or out["ptp"] < 0.05 or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"ingest render: {out}")
    check_launched(launches, FORWARD, "ingest render")
    return out


def par_tf32(dev):
    """The watermark decoder's logits, test_bitacc and the LPIPS meter with
    cuDNN's TF32 on and off on the card (fp32 matrix products in full fp32
    both times), each against the CPU's fp32, at the recipe's widths
    (random weights from a seed): the CLIs take cuDNN's TF32
    (``utils/device.py:CUDNN_TF32``) only where both gaps are within
    TF32_TOL, and this fails where they disagree with the reading."""
    from types import SimpleNamespace

    from nerf_signature_tpu_torch.models.hidden import hidden_decoder_apply
    from nerf_signature_tpu_torch.train.metrics import LPIPSMeter
    from nerf_signature_tpu_torch.train.trainer_wtmk import (
        WatermarkTrainer, _distort_and_normalize, _render_blocks)
    from nerf_signature_tpu_torch.models.watermark import wtmk_field_params
    from nerf_signature_tpu_torch.utils.device import CUDNN_TF32

    m = make_wm_model(dev)
    x = wm_step_inputs(dev)
    fp = wtmk_field_params(m.backbone, m.trainable, m.wcfg, x["bits"])
    with torch.no_grad():
        blocks = _render_blocks(fp, m.occ.occupancy, x["ro_b"], x["rd_b"], m.wcfg, m.rc,
                                m.infer_budget)
        inp = _distort_and_normalize(blocks, "none", None).float()
        dec_cpu = {k: v for k, v in m.trainable.items() if k == "decoder"}

        def cpu_tree(t):
            if isinstance(t, dict):
                return {k: cpu_tree(v) for k, v in t.items()}
            if isinstance(t, list):
                return [cpu_tree(v) for v in t]
            return t.detach().cpu()

        ref = hidden_decoder_apply(cpu_tree(dec_cpu["decoder"]), m.wcfg.decoder, inp.cpu())
    opt = SimpleNamespace(seed=0, iters=1, lr=1e-2, lambda_w=0.005, lambda_i=1.0, loss_w="bce",
                          distortion="none", message_dim=WM_BITS, num_rays=TRAIN_RAYS,
                          max_ray_batch=CHUNK, compact_frac=0, group_budget=0, bitacc_batch=8,
                          lpips_weights=None)
    wm = {"rays_o_block": x["ro_b"].cpu().numpy(), "rays_d_block": x["rd_b"].cpu().numpy()}
    lp_path = os.path.join(tempfile.mkdtemp(), "alex.pth")
    torch.save(lpips_state_dict(11), lp_path)
    held, rgba = held_view()
    a = m.render(held["rays_o"][0], held["rays_d"][0], staged=True)["image"].float()
    a = a.cpu().numpy().reshape(1, RES, RES, 3)
    b = rgba[:, :3].reshape(1, RES, RES, 3)
    cpu_meter = LPIPSMeter(weights_path=lp_path, device="cpu")
    cpu_meter.update(a, b)
    out = {"tol": TF32_TOL, "lpips_cpu": cpu_meter.measure()}
    try:
        for on in (False, True):
            torch.backends.cudnn.allow_tf32 = on
            torch.backends.cuda.matmul.allow_tf32 = False
            with torch.no_grad():
                logits = hidden_decoder_apply(m.trainable["decoder"], m.wcfg.decoder, inp)
            tr = WatermarkTrainer("wm", opt, m, workspace=None, use_checkpoint="scratch",
                                  mute=True)
            acc = tr.test_bitacc([{"watermark": wm}] * 20)
            meter = LPIPSMeter(weights_path=lp_path, device=dev)
            meter.update(a, b)
            key = "tf32" if on else "fp32"
            out[key] = {"logits_rel_l2": rel_l2(logits.cpu(), ref), "bitacc": acc,
                        "records": [str(r) for r in tr.metrics_message[0].records[:3]],
                        "lpips": meter.measure(),
                        "lpips_rel": abs(meter.measure() - out["lpips_cpu"])
                        / max(abs(out["lpips_cpu"]), 1e-12)}
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t = out["tf32"]
    out["tf32_within_tol"] = t["logits_rel_l2"] <= TF32_TOL and t["lpips_rel"] <= TF32_TOL
    out["cli_cudnn_tf32"] = CUDNN_TF32
    log(f"[parallel] cuDNN's TF32 against the CPU's fp32: decoder logits rel L2 fp32 "
        f"{out['fp32']['logits_rel_l2']:.3g}, TF32 {t['logits_rel_l2']:.3g}; bit accuracy over "
        f"20 messages fp32 {out['fp32']['bitacc']}, TF32 {t['bitacc']}; LPIPS meter CPU "
        f"{out['lpips_cpu']:.6f}, card fp32 rel {out['fp32']['lpips_rel']:.3g}, TF32 rel "
        f"{t['lpips_rel']:.3g}; tolerance {TF32_TOL}: within {out['tf32_within_tol']}; the "
        f"CLIs set cuDNN's TF32 {CUDNN_TF32}")
    if out["fp32"]["logits_rel_l2"] > TF32_TOL or out["fp32"]["lpips_rel"] > TF32_TOL:
        raise AssertionError(f"the card's fp32 decoder or LPIPS is off the CPU's: {out}")
    if out["tf32_within_tol"] != CUDNN_TF32:
        raise AssertionError(f"the CLIs' cuDNN TF32 ({CUDNN_TF32}) disagrees with the reading "
                             f"against tolerance {TF32_TOL}: {out}")
    return out


def phase_parallel(dev, workdir):
    """Phase 14: --devices (a one-process NCCL group: 64 clean steps per
    step and one captured dispatch of 64, each against the same run without
    a group), the --devices 2 refusal, --test's video, the --gui viewer,
    .pth ingestion and the TF32 measurement, on a fresh full-width model."""
    from nerf_signature_tpu_torch.parallel import multihost

    t_phase = time.time()
    backbone = make_model(dev, seed=5)
    res = {"k5_cap": k5_cap_rows(dev, backbone)}
    runs = {}
    for loop in (False, True):
        key = "loop" if loop else "step"
        runs[key, "A"] = par_run(dev, loop, group=False)
        runs[key, "B"] = par_run(dev, loop, group=False)
    env = {"NGP_COORDINATOR": f"127.0.0.1:{multihost.free_port()}", "NGP_NUM_PROCESSES": "1",
           "NGP_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        if not multihost.maybe_initialize(cpu=False):
            raise AssertionError("NGP_COORDINATOR formed no group")
        import torch.distributed as dist

        res["backend"] = dist.get_backend()
        for loop in (False, True):
            runs["loop" if loop else "step", "C"] = par_run(dev, loop, group=True)
    finally:
        multihost.shutdown()
        for k in env:
            os.environ.pop(k, None)
    for key in ("step", "loop"):
        a, b, c = runs[key, "A"], runs[key, "B"], runs[key, "C"]
        eq_ab, d_ab = par_diff(a["state"], b["state"])
        eq_ac, d_ac = par_diff(a["state"], c["state"])
        r = {"bit_equal_to_no_group": eq_ac, "rel_l2_to_no_group": d_ac,
             "no_group_repeat_bit_equal": eq_ab, "no_group_repeat_rel_l2": d_ab,
             "launches": {k: v for k, v in c["launches"].items() if v},
             "seconds": {"no_group": a["seconds"], "group": c["seconds"]},
             "profile_no_group": a["profile"], "profile_group": c["profile"],
             "losses_group": c["losses"], "captures": c["captures"]}
        if c["checks"] is not None:
            r["identity_checks"] = {k: (sum(v), len(v)) for k, v in c["checks"].items()}
            if not all(all(v) and v for v in c["checks"].values()):
                raise AssertionError(f"{key}: a collective on one rank changed its input: "
                                     f"{r['identity_checks']}")
        check_launched(c["launches"], PAR_KERNELS, f"parallel {key} under NCCL")
        log(f"[parallel] {key}: one-rank NCCL run against the run without a group: bit-equal "
            f"{eq_ac} (largest rel L2 {d_ac:.3g}); the run without a group against itself: "
            f"bit-equal {eq_ab} ({d_ab:.3g}); identity checks {r.get('identity_checks')}; "
            f"busy ms a step {a['profile']['busy_ms']} without, {c['profile']['busy_ms']} with "
            f"the group (NCCL {c['profile']['nccl_ms']})")
        if eq_ab and not eq_ac:
            raise AssertionError(f"{key}: the one-rank group changed a deterministic run")
        if d_ac > max(10 * d_ab, 1e-6):
            raise AssertionError(f"{key}: the group run is further from the run without it "
                                 f"({d_ac:.3g}) than run-to-run noise allows ({d_ab:.3g})")
        res[key] = r
    del runs
    gc.collect()
    res["refusal"] = par_refusal(workdir)
    res["video"] = par_video(dev, backbone, workdir)
    res["viewer"] = par_viewer(dev, backbone)
    res["ingest"] = par_ingest(dev, workdir)
    res["tf32"] = par_tf32(dev)
    res["seconds"] = time.time() - t_phase
    log(f"[parallel] phase {res['seconds']:.1f} s")
    return res


# each phase's wall seconds, by name (printed as it ends, and in the JSON line)
PHASE_SECONDS = {}


def timed(name, phase, *args, workdir=False):
    """Run one phase (with a fresh temporary directory as its last argument
    where ``workdir``), log and record its wall seconds, then collect the
    garbage its trainers leave in cycles."""
    t0 = time.time()
    if workdir:
        with tempfile.TemporaryDirectory() as d:
            out = phase(*args, d)
    else:
        out = phase(*args)
    PHASE_SECONDS[name] = time.time() - t0
    log(f"[time] phase {name}: {PHASE_SECONDS[name]:.1f} s")
    gc.collect()
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    import nerf_signature_tpu_torch  # noqa: F401  (fails outside the repo)

    gpu_line = timed("device", phase_device)
    dev = torch.device("cuda")
    build_s, simt_build, mma_build = timed("build", phase_build)
    if sys.argv[1:] == ["--phase", "parallel"]:
        # phase 14 alone (development): its result, then the device line
        print(json.dumps({"parallel": timed("parallel", phase_parallel, dev, workdir=True),
                          "build_s": build_s}, default=float))
        print(gpu_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kernels = timed("kernels", phase_kernels, dev)
    train_kernels = timed("train-kernels", phase_train_kernels, dev)
    geometry, geometry_launches, geometry_stats = timed("geometry", phase_geometry, dev)
    launches, view = timed("serve", phase_serve, dev, workdir=True)
    train = timed("train", phase_train, dev)
    backbone = train.pop("model")
    wm = timed("wm", phase_wm, dev, backbone, workdir=True)
    wm_state = wm.pop("trained_state")
    dl = timed("device loop", phase_device_loop, dev, backbone, workdir=True)
    opts = timed("train options", phase_train_options, dev, backbone, dl["clean"]["psnr1"],
                 workdir=True)
    k78 = timed("k7 k8", phase_k7_k8, dev, backbone, dl["clean"], workdir=True)
    baselines = timed("baselines", phase_baselines, dev, backbone, wm_state, workdir=True)
    del wm_state
    slice15, fixed_counts = timed("lpips clip fixed", phase_lpips_clip_fixed, dev, backbone,
                                  workdir=True)
    del backbone
    gc.collect()
    par = timed("parallel", phase_parallel, dev, workdir=True)
    # the launches of phase 14's paths (the one-rank NCCL runs, the viewer,
    # the ingested model's render, --test), by kernel
    par_paths = {k: par[k]["launches"] for k in ("step", "loop")}
    par_paths.update({k: par[k]["launches"] for k in ("viewer", "ingest", "video")})

    def par_of(counter):
        return {k: v.get(counter, 0) for k, v in par_paths.items()}

    dl_launches = {"clean": dl["clean"].pop("launches"), "wm": dl["wm"].pop("launches")}
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
                      "share_not_equal", "rel_l2_vs_full_bwd", "needs", "in_step", "in_dim",
                      "device_ms_events"):
            if extra in r:
                row[extra] = r[extra]
        if base in MMA_ROWS:  # the tensor-core kernel's build at this row's input width
            row["plan"] = mma_build[MMA_ROWS[base]][r["in_dim"]]
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
        row["device_loop_launches"] = {k: v[base] for k, v in dl_launches.items()}
        row["parallel_launches"] = par_of(base)
        row["fixed_launches"] = {k: v[base] for k, v in fixed_counts.items() if v.get(base)}
        rows.append(row)
        if "atomics_modelled" in r:
            modelled[name] = r["atomics_modelled"]
    # K5 (slice 10) at the clean step's shapes and the watermark step's; its
    # launches: the device loops' runs (this slice's main path), besides the
    # per-step train and watermark runs'
    for name, r in dl["k5"].items():
        base, run = (name[:-3], "wm") if name.endswith("_wm") else (name, "clean")
        rows.append({"name": name, "route": "cuda", "source": K5_SOURCE[0],
                     "replaces": K5_SOURCE[1], "path": f"device loop ({run})",
                     "launches": dl_launches[run][base], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
                     **{k: r[k] for k in ("device_ms_warm", "host_us", "library_host_us",
                                          "library_what")},
                     "shape": r["shape"], "compact_frac": r["compact_frac"],
                     **{k: r[k] for k in ("repeats_bit_exact", "graph_replays_kept") if k in r},
                     "train_launches": train["launches"][base],
                     "wm_launches": wm["launches"][base],
                     "device_loop_launches": {k: v[base] for k, v in dl_launches.items()},
                     "parallel_launches": par_of(base)})
    # K6 on the clean loop's trained grid: its own work, the
    # queries apart; its launches: the clean device loop's run (one
    # threshold pass an update, every kernel counted in kernel_launches)
    for kind, names in K6_KERNELS.items():
        r = dl["k6"][kind]
        rows.append({"name": f"K6_{kind}", "route": "cuda", "source": K6_SOURCE[0],
                     "replaces": K6_SOURCE[1], "path": "device loop (clean)",
                     "launches": dl_launches["clean"][f"K6_{kind}_threshold"],
                     "kernel_launches": {k: dl_launches["clean"][k] for k in names},
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "ms_is",
                                          "own_by_difference_ms", "device_ms",
                                          "plain_device_ms", "queries_ms", "query_setup_ms",
                                          "update_ms", "plain_update_ms", "queries_cells",
                                          "queries_bound_ms", "queries_bound_by")},
                     "train_launches": {k: train["launches"][k] for k in names},
                     "wm_launches": {k: wm["launches"][k] for k in names},
                     "parallel_launches": {k: par_of(k) for k in names}})
    # K2's cull route (slice 12): the clean step's shape at the train run's
    # t_cull is the row's headline, the serving shape and the other threshold
    # beside it; its launches: the --t_cull device loop's run (after the
    # gate), then the per-step train, watermark and device loops' runs (exact)
    cull_launches = opts["t_cull"].pop("launches")
    head = opts["k2_cull"][f"clean {CULL_T:g}"]
    rows.append({"name": "K2_march_cull", "route": "cuda", "source": K2_CULL_SOURCE[0],
                 "replaces": K2_CULL_SOURCE[1], "path": "device loop with --t_cull (clean)",
                 "launches": cull_launches["K2_march_cull"],
                 "max_abs_err": max(r["max_abs_err"] for r in opts["k2_cull"].values()),
                 **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "bool_device_ms",
                                         "device_ms_reads", "culled_share", "margin_rays")},
                 "shapes": opts["k2_cull"],
                 "train_launches": train["launches"]["K2_march_cull"],
                 "wm_launches": wm["launches"]["K2_march_cull"],
                 "wm_ssim_t_cull_launches": opts["ssim_wm"]["per_step"]["k2_cull_launches"],
                 "parallel_launches": par_of("K2_march_cull"),
                 "device_loop_launches": {k: v["K2_march_cull"] for k, v in dl_launches.items()}})
    # K7 and K8 (slice 13): K7 at the clean step's shapes, its launches those
    # of the device-loop runs with its options (the one-corner forward and
    # the stride-2 backward: --hash_fwd_corners 1 --hash_level_stride 2; the
    # stride-1 backward: --stochastic_hash_grad alone); K8 at the clean
    # step's rays and a served chunk, its launches those of the --bg_radius
    # loop run
    runs11 = {"K7_hash_encode_1c": ("k7_1c_s2_loop", "K7_hash_encode_1c"),
              "K7_hash_encode_bwd_stoch": ("k7_loop", "K7_hash_encode_bwd_stoch"),
              "K7_hash_encode_bwd_stoch_s2": ("k7_1c_s2_loop", "K7_hash_encode_bwd_stoch"),
              "K8_hash_encode_2d": ("bg", "K8_hash_encode_2d"),
              "K8_hash_encode_2d_serve": ("bg", "K8_hash_encode_2d"),
              "K8_hash_encode_2d_bwd": ("bg", "K8_hash_encode_2d_bwd")}
    k78_rows = {**k78["k7_rows"], **k78["k8_rows"]}
    for name, (run, counter) in runs11.items():
        r = k78_rows[name]
        launched = (k78["bg"]["bg"] if run == "bg" else k78[run])["launches"]
        k7 = name.startswith("K7")
        rows.append({"name": name, "route": "cuda", "source": K7_SOURCE if k7 else K8_SOURCE,
                     "replaces": ("nerf_signature_tpu/ops/hashenc.py:355" if "1c" in name else
                                  "nerf_signature_tpu/ops/hashenc.py:178" if k7 else
                                  "nerf_signature_tpu/ops/hashenc.py:448"),
                     "path": (f"device loop ({run})" if k7 else "off the main path (bg_encode, "
                              "hash_encode_2d; the bg loop's launches)"),
                     "launches": launched[counter],
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
                     **{k: r[k] for k in ("device_ms", "library_device_ms", "rel_l2",
                                          "rows_chosen_differently", "cut_rays", "rays",
                                          "distinct_rows", "n_adds", "device_ms_cold",
                                          "host_us", "library_host_us", "library_what",
                                          "kernel_ms", "kernel_ms_cold", "zeroing_ms",
                                          "zeroing_ms_cold", "kernel_bound_ms",
                                          "kernel_live_bound_ms", "zeroing_bound_ms", "live_samples", "sectors",
                                          "loop_shape")
                        if k in r},
                     "train_launches": train["launches"][counter],
                     "wm_launches": wm["launches"][counter],
                     "device_loop_launches": {k: v[counter] for k, v in dl_launches.items()},
                     "parallel_launches": par_of(counter)})
    # K8 as the whole background colour: its launches those of the
    # --bg_radius loop run (the train shape's rows) and of the served bg view
    # (the serving chunk's); the fp32 rows are off the bf16 main path
    bg_run = k78["bg"]["bg"]
    for name, r in k78["k8_bg_rows"].items():
        counter = "K8_background_bwd" if "bwd" in name else "K8_background"
        fp32, serve = name.endswith("_f32"), "_serve" in name
        rows.append({"name": name, "route": "cuda", "source": K8_BG_SOURCE,
                     "replaces": K8_BG_REPLACES,
                     "path": ("fp32 route (off the bf16 main path)" if fp32 else
                              "a served bg view" if serve else "device loop (bg)"),
                     "launches": (0 if fp32 else bg_run["serve_k8_launches"] if serve
                                  else bg_run["launches"][counter]),
                     **r,
                     "train_launches": train["launches"][counter],
                     "wm_launches": wm["launches"][counter],
                     "device_loop_launches": {k: v[counter] for k, v in dl_launches.items()},
                     "parallel_launches": par_of(counter)})
    # K10 and K4 with the density logit (slice 14) on the CopyRNeRF step's own
    # samples; their launches: the CopyRNeRF run's (WatermarkTrainer.train,
    # then train_device); K4's SIMT route is off the bf16 main path
    crn = baselines["copyrnerf"]
    for name, r, src, replaces in (
            ("K10_copyrnerf_input", baselines["k10"], K10_SOURCE[0], K10_SOURCE[1]),
            *((n, baselines["k4_raw"][n], K4_RAW_SOURCES[n],
               "nerf_signature_tpu/models/mlp.py:30")
              for n in K4_RAW_SOURCES)):
        fp32 = name.endswith("_f32")
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "path": "fp32 route (off the bf16 main path)" if fp32 else "copyrnerf",
                     "launches": crn["launches"][name],
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "device_ms", "samples")},
                     **{k: r[k] for k in ("plain_device_ms", "in_step", "in_loop_ms",
                                          "traced_device_ms") if k in r},
                     "loop_launches": crn["loop"]["launches"][name],
                     "train_launches": train["launches"][name],
                     "wm_launches": wm["launches"][name],
                     "device_loop_launches": {k: v[name] for k, v in dl_launches.items()},
                     "parallel_launches": par_of(name)})
    modelled.update(k78.pop("k7_atomics_modelled"))
    for run in ("k7_loop", "k7_1c_s2_loop"):
        k78[run].pop("launches")
    wm.pop("launches")
    # K1's and K7's backward atomics as kernel_cases counts them from each
    # design on each row's inputs: a model, not a reading of the card
    print(json.dumps({"k1_bwd_atomics_modelled": modelled}))
    print(json.dumps({"kernels": rows, "build_s": build_s, "simt_build": simt_build,
                      "mma_build": mma_build,
                      "view": view, "train": {
        k: train[k] for k in ("steps", "seconds", "rays_per_s", "psnr0", "psnr1", "peak_gib",
                              "profile")},
        "geometry": geometry_stats, "wm": wm,
        "device_loop": {k: dl[k] for k in ("graph_vs_eager", "clean", "wm", "k6")},
        "train_options": {k: opts[k] for k in ("t_cull", "error_map", "ssim_clean_loop",
                                               "ssim_wm")},
        "k7_k8": {k: k78[k] for k in ("k7_loop", "k7_1c_s2_loop", "wm_k7", "bg", "wm_bg")},
        "baselines": {k: baselines[k] for k in ("copyrnerf", "whole_image", "finetune_decoder",
                                                "prewatermark", "film", "seconds")},
        "lpips_clip_fixed": slice15, "parallel": par, "phase_seconds": PHASE_SECONDS,
        "device_ms_from_events": len(EVENT_FALLBACKS)}, default=float))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
