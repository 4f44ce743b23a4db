#!/usr/bin/env python3
"""K5's unpack (``csrc/compact.cu:k5_unpack``) against other designs of
the same kernel, side by side on one NVIDIA GPU.

    python3 scripts_port/k5_unpack_variants.py [--out FILE]

Builds ``csrc/compact.cu`` once per variant, each alone into a library of
its own (the package's flags), with ``k5_unpack`` swapped:

- ``tiles``: the source as it stands (a tile of 1024 samples a block, the
  slot map read as one int4 a thread into shared memory, the gathers with
  a warp's lanes on consecutive samples, the tile's outputs stored as
  16-byte spans from shared memory);
- ``tiles_loop``: the same design with the int4 read written as a loop over
  the thread's int4s (a control for ``tiles_8``);
- ``tiles_8``: that loop at 8 samples a thread (tiles of 2048);
- ``registers``: no shared memory, one thread 4 consecutive samples (one
  int4 of slot map), its gathers and its 16-byte stores of 1 x 4 sigmas
  and 3 x 4 rgb floats straight from registers.

Then, on the procedural ball model of ``chip_smoke.py`` (``make_model``), at
the clean step's shape (4096 rays x 128) and the watermark step's (8,704 x
256), Mc from ``auto_mc``: each variant's outputs against
``uncompact_plain`` (bit for bit) and its device time with the L2 flushed
before each call (``chip_smoke.py:device_ms``), in three rounds of turns.
Prints one JSON line of the times (also to ``--out``) and the card's name
and power limit.  The variants are timed, never used by the port.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TILES_LOOP = '''__global__ void __launch_bounds__(THREADS)
    k5_unpack(const float* __restrict__ sig_c, const float* __restrict__ rgb_c,
              const int* __restrict__ slot_of, long long M, float* __restrict__ sig,
              float* __restrict__ rgb) {
  __shared__ __align__(16) int sslot[UNPACK_TILE];
  __shared__ __align__(16) float osig[UNPACK_TILE];
  __shared__ __align__(16) float orgb[3 * UNPACK_TILE];
  const long long m0 = (long long)blockIdx.x * UNPACK_TILE;
  const int len = (int)(m0 + UNPACK_TILE < M ? UNPACK_TILE : M - m0);
#pragma unroll
  for (int u = 0; u < UNPACK_ITEMS / 4; ++u) {
    const int g = threadIdx.x + THREADS * u, first = 4 * g;
    if (first + 4 <= len && aligned16(slot_of + m0)) {
      reinterpret_cast<int4*>(sslot)[g] = reinterpret_cast<const int4*>(slot_of + m0)[g];
    } else {
      for (int c = 0; c < 4; ++c) sslot[first + c] = first + c < len ? slot_of[m0 + first + c] : -1;
    }
  }
  __syncthreads();
  float v[UNPACK_ITEMS][4];
#pragma unroll
  for (int k = 0; k < UNPACK_ITEMS; ++k) {
    const int s = sslot[threadIdx.x + THREADS * k];
    if (s >= 0) {
      v[k][0] = sig_c[s];
#pragma unroll
      for (int a = 0; a < 3; ++a) v[k][1 + a] = rgb_c[3LL * s + a];
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) v[k][a] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < UNPACK_ITEMS; ++k) {
    const int j = threadIdx.x + THREADS * k;
    osig[j] = v[k][0];
#pragma unroll
    for (int a = 0; a < 3; ++a) orgb[3 * j + a] = v[k][1 + a];
  }
  __syncthreads();
  store_span(sig + m0, osig, len);
  store_span(rgb + 3 * m0, orgb, 3 * len);
}

'''

REGISTERS = '''__global__ void __launch_bounds__(THREADS)
    k5_unpack(const float* __restrict__ sig_c, const float* __restrict__ rgb_c,
              const int* __restrict__ slot_of, long long M, float* __restrict__ sig,
              float* __restrict__ rgb) {
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (i0 >= M) return;
  const bool full = i0 + 4 <= M && aligned16(slot_of) && aligned16(sig) && aligned16(rgb);
  int s[4];
  if (full) {
    const int4 w = reinterpret_cast<const int4*>(slot_of)[i0 >> 2];
    s[0] = w.x; s[1] = w.y; s[2] = w.z; s[3] = w.w;
  } else {
    for (int c = 0; c < 4; ++c) s[c] = i0 + c < M ? slot_of[i0 + c] : -1;
  }
  float v[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (s[c] >= 0) {
      v[c][0] = sig_c[s[c]];
#pragma unroll
      for (int a = 0; a < 3; ++a) v[c][1 + a] = rgb_c[3LL * s[c] + a];
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) v[c][a] = 0.0f;
    }
  }
  if (full) {
    reinterpret_cast<float4*>(sig)[i0 >> 2] = make_float4(v[0][0], v[1][0], v[2][0], v[3][0]);
    float4* r = reinterpret_cast<float4*>(rgb + 3 * i0);
    r[0] = make_float4(v[0][1], v[0][2], v[0][3], v[1][1]);
    r[1] = make_float4(v[1][2], v[1][3], v[2][1], v[2][2]);
    r[2] = make_float4(v[2][3], v[3][1], v[3][2], v[3][3]);
  } else {
    for (int c = 0; c < 4 && i0 + c < M; ++c) {
      sig[i0 + c] = v[c][0];
      for (int a = 0; a < 3; ++a) rgb[3 * (i0 + c) + a] = v[c][1 + a];
    }
  }
}

'''

LAUNCH = ("k5_unpack<<<(unsigned int)((M + UNPACK_TILE - 1) / UNPACK_TILE), THREADS, 0, s>>>(",
          "k5_unpack<<<(unsigned int)((M + 4LL * THREADS - 1) / (4LL * THREADS)), THREADS, 0, "
          "s>>>(")
ITEMS = ("constexpr int UNPACK_ITEMS = 4;", "constexpr int UNPACK_ITEMS = 8;")


def variants(src):
    """{name: compact.cu with that k5_unpack}."""
    start = src.index("// unpack: a block takes a tile")
    end = src.index("__global__ void __launch_bounds__(THREADS)\n    k5_unpack_bwd(")
    swap = lambda body: src[:start] + body + src[end:]
    for text in LAUNCH[:1] + ITEMS[:1]:
        assert text in src, text
    return {"tiles": src, "tiles_loop": swap(TILES_LOOP),
            "tiles_8": swap(TILES_LOOP).replace(*ITEMS),
            "registers": swap(REGISTERS).replace(*LAUNCH)}


def build(_cuda, out_dir):
    """Each variant built into its own library, in parallel: {name: the
    C entry ngp_compact_unpack}, and the registers ptxas gave k5_unpack."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, "compact.cu")) as f:
        srcs = variants(f.read())
    procs = {}
    for name, src in srcs.items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = ([_cuda._nvcc()] + _cuda._ARCH + _cuda._COMMON + _cuda.SOURCES["compact.cu"] +
               ["-I", _cuda.CSRC, "-shared", cu, "-o", so])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        fn = ctypes.CDLL(so).ngp_compact_unpack
        fn.argtypes, fn.restype = _cuda._SIGNATURES["ngp_compact_unpack"], ctypes.c_int
        fns[name] = fn
        m = re.search(r"9k5_unpackE[^\n]*\n[^\n]*\n[^\n]*\nptxas info\s*: (Used [^\n]*)", log)
        regs[name] = m.group(1) if m else None
    return fns, regs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_unpack_variants: no CUDA GPU visible; this script runs on the card",
              file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nerf_signature_tpu_torch.ops import _cuda
    from nerf_signature_tpu_torch.ops import compact as t_compact

    gpu = cs.phase_device()
    fns, regs = build(_cuda, os.path.join(_cuda.BUILD_ROOT, "k5_unpack_variants"))
    dev = torch.device("cuda")
    m = cs.make_model(dev)
    out = {"gpu": gpu, "registers": regs, "cold_device_ms": {}}
    for tag, n_rays, budget in (("clean", cs.TRAIN_RAYS, cs.TRAIN_BUDGET),
                                ("wm", cs.WM_STEP_RAYS, 256)):
        mask, xyzs, rd, n_occ = cs.k5_march(m, n_rays, budget, seed=41)
        Mc, _ = cs.auto_mc(n_occ, n_rays, budget)
        comp = t_compact.compact(mask, xyzs, rd, Mc)
        plain = t_compact.compact_plain(mask, xyzs, rd, Mc)
        g = torch.Generator(device=dev).manual_seed(1)
        sig_c = torch.randn((Mc,), generator=g, device=dev)
        rgb_c = torch.rand((Mc, 3), generator=g, device=dev)
        sp, rp = t_compact.uncompact_plain(sig_c, rgb_c, plain)
        M = mask.numel()
        sig, rgb = torch.empty((M,), device=dev), torch.empty((M, 3), device=dev)
        stream = _cuda.current_stream_handle()
        for _ in range(3):
            for name, fn in fns.items():
                def run(fn=fn):
                    rc = fn(sig_c.data_ptr(), rgb_c.data_ptr(), comp.slot_of.data_ptr(), M,
                            sig.data_ptr(), rgb.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                sig.fill_(7.0)
                rgb.fill_(7.0)
                run()
                torch.cuda.synchronize()
                if not (torch.equal(sig, sp) and torch.equal(rgb, rp)):
                    raise AssertionError(f"the {name} variant differs from uncompact_plain "
                                         f"({tag})")
                t = cs.device_ms(run, 30, cold=True)
                out["cold_device_ms"].setdefault(f"{tag} {name}", []).append(t)
                print(f"[k5 unpack] {tag} ({n_rays} x {budget}, Mc {Mc}) {name}: bit-equal, "
                      f"{t:.5f} ms cold", flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
