#!/usr/bin/env python3
"""Where a K5 pack's time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts_port/k5_pack_phases.py [--out FILE]

Builds ``csrc/compact.cu`` alone with a timestamp (``%globaltimer``, ns)
taken by each block's first thread at the end of each phase of ``k5_pack``
-- entry, tile id (the counter's atomicAdd), mask (its read and the bits),
scan (the block's scan and the count's publication), look-back (the copies
issued, the first warp's look-back and its prefix's publication), wait (the
copies landed, the barrier), writes (slot_of, xyz_c, dir_c, sample_of) --
one record a tile, and runs it on masks of rays whose samples are a prefix
of their slots (as K2 writes them; lengths uniform up to twice the fill) at
the clean step's shape (4096 x 128, fill 0.3, Mc 294,912) and the watermark
step's (8,704 x 256, fill 0.25, Mc 835,584), the L2 flushed before each call
(as ``chip_smoke.py``'s cold device times).  Prints, per shape and run, the
kernel's span, the spread of the blocks' entries, and each phase's median,
90th percentile and maximum over the tiles; then one JSON line (also to
``--out``) and the card's name and power limit.  The instrumented build is
timed, never used by the port.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("tile id", "mask", "scan", "look-back", "wait", "writes")
# (text in k5_pack after which the phase's stamp goes, stamp index)
MARKS = (("  const int tile = s_tile;\n", 1), ("  son[threadIdx.x] = on;\n", 2),
         ("  slr[threadIdx.x] = lr;\n", 3), ("    if (lane == 0) s_off = excl;\n", 4),
         ("  const long long off = s_off;\n", 5))
MAX_TILES = 8192


def stamp(i):
    return ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, "
            f"%%globaltimer;\" : \"=l\"(t_)); k5_phase_ns[8 * tile + {i}] = t_; }}")


def instrumented_source(src):
    """compact.cu with the stamps: entry (taken first, stored once the tile
    is known), the MARKS, and the end (after a barrier behind the writes)."""
    decl = f"__device__ unsigned long long k5_phase_ns[8 * {MAX_TILES}];\n"
    src = src.replace("namespace {\n", decl + "namespace {\n", 1)
    entry = "  if (threadIdx.x == 0) s_tile = (int)atomicAdd("
    src = src.replace(entry, "  unsigned long long t0_;\n  asm volatile(\"mov.u64 %0, "
                      "%%globaltimer;\" : \"=l\"(t0_));\n" + entry, 1)
    for text, i in MARKS:
        assert text in src, text
        extra = "  if (threadIdx.x == 0) k5_phase_ns[8 * tile] = t0_;\n" if i == 1 else ""
        src = src.replace(text, text + extra + "  " + stamp(i) + "\n", 1)
    end = "                  [&](long long q) { return sidx[q - off]; });\n}\n"
    assert end in src
    src = src.replace(end, end[:-2] + "  __syncthreads();\n  " + stamp(6) + "\n}\n", 1)
    return src + ('\nextern "C" int k5_phase_read(void* dst) {\n  return (int)cudaMemcpyFromSymbol('
                  'dst, k5_phase_ns, sizeof(k5_phase_ns));\n}\n'
                  'extern "C" const char* ngp_error_string(int c) {\n'
                  '  return cudaGetErrorString((cudaError_t)c);\n}\n')


def build(out_dir):
    from nerf_signature_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "compact.cu")) as f:
        src = instrumented_source(f.read())
    cu, so = os.path.join(out_dir, "compact_phases.cu"), os.path.join(out_dir, "libk5phases.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = ([_cuda._nvcc()] + _cuda._ARCH + _cuda._COMMON + ["-I", _cuda.CSRC, "-shared", cu, "-o",
                                                            so])
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented compact.cu:\n{r.stdout}")
    lib = ctypes.CDLL(so)
    fn = lib.ngp_compact_pack
    fn.argtypes, fn.restype = _cuda._SIGNATURES["ngp_compact_pack"], ctypes.c_int
    lib.ngp_error_string.argtypes, lib.ngp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    lib.k5_phase_read.argtypes, lib.k5_phase_read.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def step_inputs(dev, N, S, fill, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = (torch.rand((N, 1), generator=g, device=dev) * 2 * fill * S).long()
    mask = torch.arange(S, device=dev)[None] < n
    xyzs = torch.where(mask[..., None], torch.rand((N, S, 3), generator=g, device=dev), 0.0)
    return mask, xyzs, torch.randn((N, 3), generator=g, device=dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_pack_phases: no CUDA GPU visible; this script runs on the card", file=sys.stderr)
        return 1
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import compact as t_compact

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        lib = build(d)
        _cuda._lib = lib  # the wrappers now launch the instrumented build
        _cuda.COMPACT_PACK._fn = None
        flush = torch.zeros((200 * 2**20 // 4,), dtype=torch.int32, device=dev)
        buf = np.zeros((8 * MAX_TILES,), np.uint64)
        res = {}
        for tag, N, S, fill, Mc in (("clean", 4096, 128, 0.3, 294_912),
                                    ("wm", 8704, 256, 0.25, 835_584)):
            mask, xyzs, rd = step_inputs(dev, N, S, fill, 1)
            nt = -(-N * S // t_compact.PACK_TILE)
            plain = t_compact.compact_plain(mask, xyzs, rd, Mc)
            so, sa = t_compact.slot_maps_plain(plain)
            runs = []
            for _ in range(args.runs):
                flush.bitwise_not_()
                comp = t_compact.compact(mask, xyzs, rd, Mc)
                torch.cuda.synchronize()
                if not (torch.equal(comp.slot_of, so) and torch.equal(comp.sample_of, sa)
                        and torch.equal(comp.xyz_c, plain.xyz_c)
                        and torch.equal(comp.dir_c, plain.dir_c)):
                    raise AssertionError(f"the instrumented pack differs from the plain version "
                                         f"({tag})")
                if lib.k5_phase_read(buf.ctypes.data) != 0:
                    raise RuntimeError("reading the stamps failed")
                t = buf.reshape(-1, 8)[:nt, :7].astype(np.int64)
                rel = (t - t[:, 0].min()) / 1e3
                ph = np.diff(t, axis=1) / 1e3
                run = {"span_us": float(rel[:, 6].max()), "entry_spread_us": float(rel[:, 0].max()),
                       "phases_us": {name: [float(np.median(ph[:, i])),
                                            float(np.percentile(ph[:, i], 90)),
                                            float(ph[:, i].max())]
                                     for i, name in enumerate(PHASES)}}
                runs.append(run)
                print(f"{tag} ({N} x {S}, {nt} tiles, kept {int(plain.keep.sum())} of Mc {Mc}): "
                      f"span {run['span_us']:.2f} us, entries spread over "
                      f"{run['entry_spread_us']:.2f}; phase median / p90 / max us: " + "; ".join(
                          f"{k} {v[0]:.2f} / {v[1]:.2f} / {v[2]:.2f}"
                          for k, v in run["phases_us"].items()), flush=True)
            res[tag] = {"tiles": nt, "kept": int(plain.keep.sum()), "Mc": Mc, "runs": runs}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    res["gpu"] = gpu
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
