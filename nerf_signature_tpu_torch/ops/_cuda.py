"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``nerf_signature_tpu_torch/csrc/*.cu``.  At first use
they are compiled by ``nvcc`` for ``sm_90a`` (one process per source, and
per K4 width for the SIMT field sources and per row width for K8's
background colour, all started together) into ONE
shared library with a plain C interface, which
is loaded with ``ctypes``.  The library goes into ``_build/<hash>/``, where
the hash covers the sources and the flags, so an edited source never loads
a stale build.  Nothing here runs at import time: the CPU tests import every
module, and this path is reached only when a wrapper is handed a CUDA
tensor.

Every C entry point returns ``cudaGetLastError()``; a launch that fails to
start (too many threads, too much shared memory) raises here instead of
being lost.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# -fmad=false: these kernels must round each product and sum like their plain
# PyTorch versions (separate ops, no FMA contraction).  The K4 sources write
# their matrix-product FMAs explicitly and keep the rest uncontracted too.
SOURCES = {
    "marcher.cu": ["-fmad=false"],
    "hashenc.cu": ["-fmad=false"],
    "hashenc_stoch.cu": ["-fmad=false"],
    "hashenc_bg.cu": ["-fmad=false"],
    "background.cu": ["-fmad=false"],
    "composite.cu": ["-fmad=false"],
    "field.cu": ["-fmad=false"],
    "field_feat.cu": ["-fmad=false"],
    "field_bwd.cu": ["-fmad=false"],
    "field_mma.cu": ["-fmad=false"],
    "field_mma_bwd.cu": ["-fmad=false"],
    "field_mma_bwd_full.cu": ["-fmad=false"],
    "msgtable.cu": ["-fmad=false"],
    "copyrnerf.cu": ["-fmad=false"],
    "grid.cu": ["-fmad=false"],
    "gather.cu": [],
    "compact.cu": [],
}
# K4's widths (IN, hidden, 1 + geo, colour hidden) on the SIMT route (fp32),
# the list csrc/field_common.cuh:NGP_FIELD_WIDTHS instantiates: 16 levels x
# 2 features and 8 x 4 (IN = 32), 8 x 2 (IN = 16), 16 x 4 and 32 x 2 (IN =
# 64), the narrow test model
FIELD_WIDTHS = ((32, 64, 16, 64), (16, 64, 16, 64), (64, 64, 16, 64), (8, 16, 16, 16))
# and on the tensor cores (bf16, NGP_MMA_WIDTHS): those and IN = 128 (16 x 8
# and 32 x 4)
MMA_WIDTHS = FIELD_WIDTHS + ((128, 64, 16, 64),)
# the SIMT sources, on which ptxas takes tens of seconds a width: compiled
# once a width (-DNGP_IN=...) and once for their C entry points, all in
# parallel
SPLIT_BY_WIDTH = ("field.cu", "field_feat.cu", "field_bwd.cu")
# K8's background colour (background.cu), ~40 s of ptxas a row width:
# compiled once a width (-DNGP_BG_F=...) and once for its C entry points
BG_FEATURES = (1, 2, 4, 8)
SPLIT_BY_FEATURES = ("background.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_UP = ctypes.POINTER(ctypes.c_uint)

# symbol -> argtypes, the stream (last argument) included
_SIGNATURES = {
    # K1 and K7 take their geometry's level block (csrc/hashenc.cuh:HashLevels,
    # prepared once: ops/hashenc.py:level_args) by its address
    "ngp_hash_encode": [_P, _P, _I, _I, _P, _I, _L, _P, _P],
    "ngp_hash_encode_bwd": [_P, _P, _I, _I, _I, _P, _L, _P, _U, _P],
    "ngp_hash_encode_1c": [_P, _P, _I, _I, _P, _I, _L, _P, _P],
    "ngp_hash_encode_bwd_stoch": [_P, _P, _I, _I, _P, _L, _P, _U, _I, _I, _P],
    "ngp_hash_encode_2d": [_P, _P, _P, _F, _P, _I, _I, _P, _L, _I, _FP, _I, _P],
    "ngp_hash_encode_2d_bwd": [_P, _P, _P, _F, _P, _I, _I, _P, _L, _I, _FP, _I, _U, _P],
    "ngp_bg_color": [_P, _P, _F, _P, _I, _I, _P, _P, _L, _I, _FP, _I, _P],
    "ngp_bg_color_bwd": [_P, _P, _F, _P, _I, _I] + [_P] * 6 + [_L, _I, _FP, _I, _I, _I, _P],
    "ngp_field": [_P] * 6 + [_L] + [_I] * 5 + [_L, _P],
    "ngp_field_raw": [_P] * 7 + [_L] + [_I] * 5 + [_L, _P],
    "ngp_field_bwd": [_P] * 8 + [_L] + [_I] * 5 + [_L, _P],
    "ngp_field_bwd_feat": [_P] * 6 + [_L] + [_I] * 4 + [_P, _I, _L, _P],
    "ngp_field_mma": [_P] * 6 + [_L] + [_I] * 4 + [_L, _P],
    "ngp_field_mma_raw": [_P] * 7 + [_L] + [_I] * 4 + [_L, _P],
    "ngp_field_mma_bwd_feat": [_P] * 6 + [_L] + [_I] * 4 + [_L, _P],
    "ngp_field_mma_bwd": [_P] * 9 + [_L] + [_I] * 5 + [_L, _P],
    "ngp_field_mma_plan": [_I] * 4 + [_P],
    "ngp_field_mma_bwd_feat_plan": [_I] * 4 + [_P],
    "ngp_field_mma_bwd_plan": [_I] * 4 + [_P],
    "ngp_msg_table": [_P, _P, _I, _L, _P, _P, _I, _P],
    "ngp_msg_table_bwd": [_P, _P, _I, _L, _P, _P],
    "ngp_table_gather": [_P, _P, _L, _L, _P, _P],
    "ngp_copyrnerf_input": [_P] * 5 + [_I, _F, _P, _L, _P],
    "ngp_composite": [_P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P],
    "ngp_composite_bwd": [_P] * 5 + [_F, _I, _I] + [_P] * 7,
    "ngp_march": ([_P, _P, _FP, _P, _P, _P] + [_I] * 10 + [_F] * 7 + [_P] * 9 + [_P]),
    "ngp_compact_pack": [_P, _P, _P, _L, _I, _L] + [_P] * 6 + [_P],
    "ngp_compact_unpack": [_P, _P, _P, _L, _P, _P, _P],
    "ngp_compact_unpack_bwd": [_P, _P, _P, _L, _P, _P, _P],
    "ngp_grid_occupied": [_P, _L, _I, _P, _P, _P, _P],
    "ngp_grid_points": [_L, _I, _L, _P, _P, _I, _P, _P, _P, _F, _F, _F, _P, _P, _P],
    "ngp_grid_scatter": [_P, _P, _L, _L, _F, _P, _P],
    "ngp_grid_finalize": [_P, _P, _P, _P, _P, _L, _F, _F, _P],
    "ngp_grid_threshold": [_P, _L, _P, _F, _P, _P, _P],
}

_lib = None
build_info = {}  # "seconds", "path", "log" of the build this process loaded


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _jobs():
    """(tag, source, flags) of every nvcc process of the build."""
    jobs = []
    for name, flags in SOURCES.items():
        jobs.append((name, name, flags))
        if name in SPLIT_BY_WIDTH:
            for w in FIELD_WIDTHS:
                defs = [f"-DNGP_{k}={v}" for k, v in zip(("IN", "HID", "OUT1", "HC"), w)]
                jobs.append((f"{name}[{','.join(map(str, w))}]", name, flags + defs))
        if name in SPLIT_BY_FEATURES:
            for f in BG_FEATURES:
                jobs.append((f"{name}[F={f}]", name, flags + [f"-DNGP_BG_F={f}"]))
    return jobs


def _fingerprint():
    h = hashlib.sha256()
    h.update(repr((_ARCH, _COMMON, _jobs())).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path."""
    out_dir = os.path.join(BUILD_ROOT, _fingerprint())
    lib_path = os.path.join(out_dir, "libngp_kernels.so")
    if os.path.exists(lib_path):
        log_path = os.path.join(out_dir, "build.log")
        log = "(cached build)"
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        build_info.update(seconds=0.0, path=lib_path, log=log)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for i, (name, src, flags) in enumerate(_jobs()):
        obj = os.path.join(out_dir, f"{i}.{os.getpid()}.o")
        cmd = [nvcc] + _ARCH + _COMMON + flags + ["-c", os.path.join(CSRC, src), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # each source's compile time: the slowest sets the build's pace
    done = {}
    while len(done) < len(procs):
        for name, _, p in procs:
            if name not in done and p.poll() is not None:
                done[name] = time.time() - t0
        time.sleep(0.1)
    logs, failed = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name} ({done[name]:.1f} s)\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc] + _ARCH + ["-shared", "-o", tmp] + [o for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        os.remove(obj)
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    build_info.update(seconds=time.time() - t0, path=lib_path, log=log)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for sym, argtypes in _SIGNATURES.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ngp_error_string.argtypes = [ctypes.c_int]
        lib.ngp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# the current stream's handle as an int without building a torch.cuda.Stream
# or going through torch.cuda.current_device's Python (a few microseconds a
# launch on the host); the public calls where a build of PyTorch lacks them
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def current_stream_handle():
    if _RAW_STREAM is not None and _GET_DEVICE is not None:
        return _RAW_STREAM(_GET_DEVICE())
    return torch.cuda.current_stream().cuda_stream


class CudaKernel:
    """One C entry point of the library.  ``launches`` counts the calls that
    launched the kernel (a wrapper's CPU path never comes here)."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            self._fn = getattr(library(), self.symbol)
        rc = self._fn(*args, current_stream_handle())
        if rc != 0:
            msg = library().ngp_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


HASH_ENCODE = CudaKernel("ngp_hash_encode")
HASH_ENCODE_BWD = CudaKernel("ngp_hash_encode_bwd")
HASH_ENCODE_1C = CudaKernel("ngp_hash_encode_1c")
HASH_ENCODE_BWD_STOCH = CudaKernel("ngp_hash_encode_bwd_stoch")
HASH_ENCODE_2D = CudaKernel("ngp_hash_encode_2d")
HASH_ENCODE_2D_BWD = CudaKernel("ngp_hash_encode_2d_bwd")
BG_COLOR = CudaKernel("ngp_bg_color")
BG_COLOR_BWD = CudaKernel("ngp_bg_color_bwd")
FIELD = CudaKernel("ngp_field")
FIELD_MMA = CudaKernel("ngp_field_mma")
FIELD_BWD = CudaKernel("ngp_field_bwd")
# the same kernels writing the density logit too (the CopyRNeRF input)
FIELD_MMA_RAW = CudaKernel("ngp_field_mma_raw")
FIELD_RAW = CudaKernel("ngp_field_raw")
FIELD_BWD_MMA = CudaKernel("ngp_field_mma_bwd")
COMPOSITE = CudaKernel("ngp_composite")
COMPOSITE_BWD = CudaKernel("ngp_composite_bwd")
MARCH = CudaKernel("ngp_march")
MARCH_CULL = CudaKernel("ngp_march")  # the same entry point on the float render grid
FIELD_BWD_FEAT = CudaKernel("ngp_field_bwd_feat")
FIELD_BWD_FEAT_MMA = CudaKernel("ngp_field_mma_bwd_feat")
MSG_TABLE = CudaKernel("ngp_msg_table")
MSG_TABLE_BWD = CudaKernel("ngp_msg_table_bwd")
TABLE_GATHER = CudaKernel("ngp_table_gather")
COMPACT_PACK = CudaKernel("ngp_compact_pack")
COMPACT_UNPACK = CudaKernel("ngp_compact_unpack")
COMPACT_UNPACK_BWD = CudaKernel("ngp_compact_unpack_bwd")
COPYRNERF_INPUT = CudaKernel("ngp_copyrnerf_input")
# K6, the grid update (csrc/grid.cu): the full update's kernels and the
# partial update's, counted apart (the same entry points)
GRID_POINTS_FULL = CudaKernel("ngp_grid_points")
GRID_FINALIZE_FULL = CudaKernel("ngp_grid_finalize")
GRID_THRESHOLD_FULL = CudaKernel("ngp_grid_threshold")
GRID_OCCUPIED = CudaKernel("ngp_grid_occupied")
GRID_POINTS = CudaKernel("ngp_grid_points")
GRID_SCATTER = CudaKernel("ngp_grid_scatter")
GRID_FINALIZE = CudaKernel("ngp_grid_finalize")
GRID_THRESHOLD = CudaKernel("ngp_grid_threshold")

# K4's forward, full backward and feature-only backward have two routes
# each, counted apart: the tensor-core kernels (bf16) and the SIMT ones
# (fp32, ``_f32``); K2 on the bool grid and on the float render grid (the
# transmittance cull, ``_cull``); K7, the stochastic hash estimators (the
# one-corner forward and the one-corner backward); K8, the background
# colour (its forward, and its backward: two kernels a launch), and the
# background sphere's 2D encoding alone (off the main path); K4's
# forward that also writes the density logit (``_raw``); K10, the CopyRNeRF
# MLP's input; K6, the grid update's kernels, full and partial
KERNELS = {"K1_hash_encode": HASH_ENCODE, "K2_march": MARCH, "K2_march_cull": MARCH_CULL,
           "K3_composite": COMPOSITE, "K4_field": FIELD_MMA, "K4_field_f32": FIELD,
           "K1_hash_encode_bwd": HASH_ENCODE_BWD, "K3_composite_bwd": COMPOSITE_BWD,
           "K4_field_raw": FIELD_MMA_RAW, "K4_field_raw_f32": FIELD_RAW,
           "K4_field_bwd": FIELD_BWD_MMA, "K4_field_bwd_f32": FIELD_BWD,
           "K4_field_bwd_feat": FIELD_BWD_FEAT_MMA, "K4_field_bwd_feat_f32": FIELD_BWD_FEAT,
           "K9_msg_table": MSG_TABLE, "K9_msg_table_bwd": MSG_TABLE_BWD,
           "P1_gather": TABLE_GATHER, "K5_compact_pack": COMPACT_PACK,
           "K5_compact_unpack": COMPACT_UNPACK, "K5_compact_unpack_bwd": COMPACT_UNPACK_BWD,
           "K7_hash_encode_1c": HASH_ENCODE_1C, "K7_hash_encode_bwd_stoch": HASH_ENCODE_BWD_STOCH,
           "K8_hash_encode_2d": HASH_ENCODE_2D, "K8_hash_encode_2d_bwd": HASH_ENCODE_2D_BWD,
           "K8_background": BG_COLOR, "K8_background_bwd": BG_COLOR_BWD,
           "K10_copyrnerf_input": COPYRNERF_INPUT,
           "K6_full_points": GRID_POINTS_FULL, "K6_full_finalize": GRID_FINALIZE_FULL,
           "K6_full_threshold": GRID_THRESHOLD_FULL, "K6_partial_occupied": GRID_OCCUPIED,
           "K6_partial_points": GRID_POINTS, "K6_partial_scatter": GRID_SCATTER,
           "K6_partial_finalize": GRID_FINALIZE, "K6_partial_threshold": GRID_THRESHOLD}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def capturing():
    """Around the capture of a CUDA graph: the wrappers run and count, but
    a capture launches nothing, so the counts go back to what they were;
    the context's dict gets the captured launches by kernel, which
    ``count_replay`` adds once a replay."""
    before = launch_counts()
    captured = {}
    try:
        yield captured
    finally:
        for name, k in KERNELS.items():
            n = k.launches - before[name]
            k.launches = before[name]
            if n:
                captured[name] = n


def count_replay(captured, replays=1):
    """Add a graph's captured launches (``capturing``) for its replays."""
    for name, n in captured.items():
        KERNELS[name].launches += n * replays


# the C entries that report K4's tensor-core plans, by kind
_MMA_PLAN_ENTRIES = {"fwd": "ngp_field_mma_plan", "bwd_feat": "ngp_field_mma_bwd_feat_plan",
                     "bwd": "ngp_field_mma_bwd_plan"}
MMA_PLAN_KEYS = ("threads", "smem", "blocks_per_sm", "registers", "local_bytes")


def mma_plan(kind, widths):
    """The compiled plan of K4's tensor-core ``kind`` ("fwd", "bwd_feat",
    "bwd") at built ``widths``, as the current card's runtime reports it
    (nothing is launched): threads a block and dynamic shared bytes (the
    sources' plan), blocks an SM at those bytes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    (spill) bytes a thread (cudaFuncGetAttributes)."""
    out = (ctypes.c_longlong * len(MMA_PLAN_KEYS))()
    entry = _MMA_PLAN_ENTRIES[kind]
    rc = getattr(library(), entry)(*widths, ctypes.addressof(out))
    if rc != 0:
        msg = library().ngp_error_string(rc).decode()
        raise RuntimeError(f"{entry}{tuple(widths)}: CUDA error {rc} ({msg})")
    return dict(zip(MMA_PLAN_KEYS, out))


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The card's streaming multiprocessors (persistent grids size by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t):
    """Device pointer of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check(t, name, dtype, shape=None, device=None):
    """Validate what a kernel is handed: dtype, shape, contiguity, device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name}: must be a CUDA tensor on {device}")


def check_many(*specs, name_device=False):
    """``check`` of several tensors, each spec (tensor, name, dtype, shape),
    all on the first one's CUDA device: one pass of comparisons where every
    check holds; where one fails, ``check`` of each in turn (the first on
    any CUDA device, or with ``name_device`` on its own, which its error
    then names; the rest on its device) raises that check's own error."""
    first = specs[0][0]
    dev = first.get_device()  # -1 on the CPU
    ok = dev >= 0
    for t, _, dtype, shape in specs:
        if not ok:
            break
        ok = (t.dtype == dtype and t.get_device() == dev and t.is_contiguous()
              and (shape is None or t.shape == shape))
    if ok:
        return
    device = first.device
    for i, (t, name, dtype, shape) in enumerate(specs):
        check(t, name, dtype, shape, device if i or name_device else None)


def needs_grad(*tensors):
    """Whether autograd will differentiate through a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
