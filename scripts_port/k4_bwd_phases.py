#!/usr/bin/env python3
"""Where K4's fp32 full backward spends its time, phase by phase, on one
NVIDIA GPU.

    python3 scripts_port/k4_bwd_phases.py [--out FILE]

Builds ``csrc/field_bwd.cu`` alone at the 16 x 2 widths (IN 32, hidden 64,
1 + geo 16, colour hidden 64) with each block's first thread adding the SM
cycles (``clock64``, behind a barrier) of each phase of ``field_bwd`` --
the scan rounds (with the previous tile's dequeue), the forward (feature
gather and sigma MLP; SH4 and colour MLP), gc3, the five weight gradients,
the input cotangents (g2, g1, gh, gh1, g_feat) and the sigma MLP's
recompute -- and the block's tiles.  It runs at the train step's samples
(``chip_smoke.py``'s train-kernels phase: 4096 random rays, budget 128, ~8%
of the 524,288 samples live) as they come and with the live samples moved
first (as a compacted step holds them).  Prints, for each input, the port's
kernel's device ms (torch.profiler), the busiest block's cycles by phase,
each phase's mean cycles a tile, and the tiles a block takes; then one JSON
line (also to ``--out``) and the card's name and power limit.  The
instrumented build is timed, never used by the port; its barriers cost a
few percent.
"""

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WIDTHS = (32, 64, 16, 64)
PHASES = ("scan", "feat + sigma fwd", "SH4 + colour fwd", "gc3", "dWc2", "g2", "dWc1", "g1",
          "dWc0", "gh", "gh0 + recompute", "dWs1", "gh1", "dWs0", "g_feat")
# (text in field_bwd, the stamp that goes before it (True) or after it)
MARKS = (("    if (queued == 0) break;\n", 0, True),
         ("    const float h0 = P[(SH_DIM - 1) * LD + t];\n", 1, True),
         ("    // ---- per sample: the colour output's cotangent gc3 -> G3\n", 2, True),
         ("    WgradTile<T, LD, HC, 3>::run(R, G3, n, dWc2, first);", 3, True),
         ("    WgradTile<T, LD, HC, 3>::run(R, G3, n, dWc2, first);  // dWc2 = c2^T gc3\n", 4,
          False),
         ("    WgradTile<T, LD, HC, HC>::run(Q, R, n, dWc1, first);", 5, True),
         ("    WgradTile<T, LD, HC, HC>::run(Q, R, n, dWc1, first);  // dWc1 = c1^T g2\n", 6,
          False),
         ("    WgradTile<T, LD, CIN, HC>::run(P, Q, n, dWc0, first);", 7, True),
         ("    WgradTile<T, LD, CIN, HC>::run(P, Q, n, dWc0, first);  // dWc0 = c^T g1\n", 8,
          False),
         ("    R[t] = gs * expf(", 9, True),
         ("    WgradTile<T, LD, HID, OUT1>::run(Q, R, n, dWs1, first);", 10, True),
         ("    WgradTile<T, LD, HID, OUT1>::run(Q, R, n, dWs1, first);  // dWs1 = h^T gh\n", 11,
          False),
         ("    WgradTile<T, LD, IN, HID>::run(P, Q, n, dWs0, first);", 12, True),
         ("    WgradTile<T, LD, IN, HID>::run(P, Q, n, dWs0, first);  // dWs0 = feat^T gh1\n",
          13, False),
         ("    first = false;\n", 14, True))
RECORD = len(PHASES) + 2  # the phases, the block's cycles, its tiles


def stamp(i):
    return (f"    __syncthreads();\n    if (threadIdx.x == 0) {{ const long long now_ = clock64(); "
            f"ph_[{i}] += now_ - last_; last_ = now_; }}\n")


def instrumented_source(src):
    """field_bwd.cu with the stamps and a C entry point that sets where the
    records go."""
    src = src.replace('#include "field_common.cuh"\n', '#include "field_common.cuh"\n'
                      "__device__ long long* k4_phase_cycles;\n"
                      'extern "C" int ngp_phase_buffer(void* p) {\n'
                      "  return (int)cudaMemcpyToSymbol(k4_phase_cycles, &p, sizeof(p));\n}\n", 1)
    start = "  bool first = true;             // no tile summed yet\n  __syncthreads();\n"
    assert start in src
    src = src.replace(start, start + f"  long long ph_[{len(PHASES)}] = {{0}}, last_ = clock64();\n"
                      "  const long long t0_ = last_;\n  int tiles_ = 0;\n", 1)
    for text, i, before in MARKS:
        assert text in src, text
        src = src.replace(text, stamp(i) + text if before else text + stamp(i), 1)
    src = src.replace("    first = false;\n", "    first = false;\n    ++tiles_;\n", 1)
    end = "  if (first) {  // no live sample: this block adds nothing\n"
    assert end in src
    src = src.replace(end, "  if (threadIdx.x == 0) {\n"
                      f"    long long* o_ = k4_phase_cycles + (long long)blockIdx.x * {RECORD};\n"
                      f"    for (int i = 0; i < {len(PHASES)}; ++i) o_[i] = ph_[i];\n"
                      f"    o_[{len(PHASES)}] = clock64() - t0_;\n"
                      f"    o_[{len(PHASES) + 1}] = tiles_;\n  }}\n" + end, 1)
    # one width: the entry point calls only the launcher it instantiates
    return src.replace("NGP_FIELD_WIDTHS(NGP_EXTERN)\n", "", 1)


def build(out_dir):
    from nerf_signature_tpu_torch.ops import _cuda

    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(_cuda.CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(_cuda.CSRC, name), out_dir)
    common = os.path.join(out_dir, "field_common.cuh")
    with open(common) as f:
        text = f.read()
    with open(common, "w") as f:
        f.write(text.replace("#define NGP_FIELD_WIDTHS(X) X(32, 64, 16, 64) X(16, 64, 16, 64) "
                             "X(64, 64, 16, 64) X(8, 16, 16, 16)",
                             "#define NGP_FIELD_WIDTHS(X) X(%d, %d, %d, %d)" % WIDTHS))
    with open(os.path.join(_cuda.CSRC, "field_bwd.cu")) as f:
        src = instrumented_source(f.read())
    cu, so = os.path.join(out_dir, "field_bwd_phases.cu"), os.path.join(out_dir, "libphases.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = ([_cuda._nvcc()] + _cuda._ARCH + _cuda._COMMON + _cuda.SOURCES["field_bwd.cu"] +
           ["-I", out_dir, "-shared", cu, "-o", so])
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented field_bwd.cu:\n{r.stdout}")
    lib = ctypes.CDLL(so)
    lib.ngp_field_bwd.argtypes = _cuda._SIGNATURES["ngp_field_bwd"]
    lib.ngp_phase_buffer.argtypes = [ctypes.c_void_p]
    return lib


def train_step_inputs(cs, dev):
    """chip_smoke.py's train-kernels inputs at 16 x 2: features, directions
    and cotangents (zero on the padded samples) of 4096 random rays."""
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import hashenc as t_hash
    from nerf_signature_tpu_torch.ops import marching as t_march
    from nerf_signature_tpu_torch.render.renderer import default_aabb

    m = cs.make_model(dev)
    cfg = dataclasses.replace(m.cfg, compute_dtype=torch.float32)
    fp = t_ngp.field_params(m.params, cfg)
    ro, rd = cs.train_rays(dev)
    noise = torch.rand((cs.TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev)
    grid = m.occ.occupancy
    plan = t_march.march_plan(grid.shape[0], grid.shape[1], bound=1.0, max_steps=1024,
                              budget=cs.TRAIN_BUDGET)
    mk = t_march.march_rays_aabb(ro, rd, default_aabb(m.rc), grid,
                                 coarse=t_march.coarse_grid(grid, plan),
                                 **dict(cs.march_kwargs(m, None), budget=cs.TRAIN_BUDGET,
                                        noise=noise))
    live = mk["mask"].reshape(-1).float()
    x01 = ((mk["xyzs"].reshape(-1, 3) + 1.0) / 2.0).contiguous()
    dirs = mk["dirs"].reshape(-1, 3).contiguous()
    with torch.no_grad():
        feat = t_hash.hash_encode(x01, fp["hash_table"], cfg.resolutions, cfg.log2_hashmap_size,
                                  table_g=fp["hash_table_g"])
    gen = torch.Generator(device=dev).manual_seed(5)
    g_sigma = torch.randn((x01.shape[0],), generator=gen, device=dev) * 1e-4 * live
    g_rgb = torch.randn((x01.shape[0], 3), generator=gen, device=dev) * 1e-4 * live[:, None]
    return cfg, fp, feat, dirs, g_sigma, g_rgb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_bwd_phases: no CUDA GPU visible; this script runs on the card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nerf_signature_tpu_torch.models import ngp as t_ngp
    from nerf_signature_tpu_torch.ops import _cuda

    gpu = cs.phase_device()
    dev = torch.device("cuda")
    lib = build(os.path.join(_cuda.BUILD_ROOT, "k4_phases"))
    cfg, fp, feat, dirs, g_sigma, g_rgb = train_step_inputs(cs, dev)
    w = t_ngp._kernel_widths(fp, cfg)
    assert tuple(w) == WIDTHS, w
    live_first = torch.argsort((g_sigma == 0).to(torch.int8) & (g_rgb == 0).all(-1).to(torch.int8),
                               stable=True)
    inputs = {"as they come": (feat, dirs, g_sigma, g_rgb),
              "live first": tuple(t[live_first].contiguous() for t in (feat, dirs, g_sigma, g_rgb))}
    out = {"gpu": gpu, "phases": PHASES}
    for tag, (f, d, gs, gr) in inputs.items():
        M = f.shape[0]
        _, smem, blocks = t_ngp.simt_launch(w, "bwd", M, _cuda.sm_count(dev))
        rec = torch.zeros((blocks, RECORD), dtype=torch.int64, device=dev)
        if lib.ngp_phase_buffer(rec.data_ptr()) != 0:
            raise RuntimeError("cudaMemcpyToSymbol failed")
        g_feat = torch.empty((M, w[0]), device=dev)
        g_w = torch.empty_like(fp["mlp_flat"])
        part = torch.empty((blocks, g_w.numel()), device=dev)
        call = (f.data_ptr(), d.data_ptr(), fp["mlp_flat"].data_ptr(), gs.data_ptr(),
                gr.data_ptr(), g_feat.data_ptr(), part.data_ptr(), g_w.data_ptr(), M, blocks,
                *w, smem)
        for _ in range(3):  # the last run's records stay
            rec.zero_()
            rc = lib.ngp_field_bwd(*call, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"instrumented field_bwd: CUDA error {rc}")
        torch.cuda.synchronize()
        r = rec.cpu().numpy().astype(np.float64)
        cycles, tiles = r[:, len(PHASES)], r[:, len(PHASES) + 1]
        busiest = int(cycles.argmax())
        dms = cs.device_ms(lambda: t_ngp.field_heads_bwd(cfg, w, f, d, fp["mlp_flat"], gs, gr), 10)
        res = {"samples": M, "live": int(((gs != 0) | (gr != 0).any(-1)).sum()),
               "blocks": blocks, "device_ms": dms,
               "tiles_max": int(tiles.max()), "tiles_mean": float(tiles.mean()),
               "block_cycles_max": float(cycles.max()), "block_cycles_mean": float(cycles.mean()),
               "busiest_block": {p: float(r[busiest, i]) for i, p in enumerate(PHASES)},
               "busiest_block_tiles": int(tiles[busiest]),
               "mean_a_tile": {p: float(r[:, i].sum() / max(1.0, tiles.sum()))
                               for i, p in enumerate(PHASES) if p != "scan"}}
        out[tag] = res
        print(f"[k4 bwd phases] {tag}: {res['live']} of {M} samples live; the port's kernel "
              f"{dms:.4f} device ms; tiles a block max {res['tiles_max']}, mean "
              f"{res['tiles_mean']:.2f}; block cycles max {res['block_cycles_max']:.0f}, mean "
              f"{res['block_cycles_mean']:.0f}", flush=True)
        for p in PHASES:
            a_tile = res["mean_a_tile"].get(p)
            print(f"[k4 bwd phases]   {p:18s} busiest block {res['busiest_block'][p]:9.0f}"
                  + (f"   mean a tile {a_tile:8.0f}" if a_tile is not None else ""), flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
