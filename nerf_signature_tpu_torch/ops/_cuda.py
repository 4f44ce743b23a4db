"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``nerf_signature_tpu_torch/csrc/*.cu``.  At first use
they are compiled by ``nvcc`` for ``sm_90a`` (one process per source, all
started together) into ONE shared library with a plain C interface, which
is loaded with ``ctypes``.  The library goes into ``_build/<hash>/``, where
the hash covers the sources and the flags, so an edited source never loads
a stale build.  Nothing here runs at import time: the CPU tests import every
module, and this path is reached only when a wrapper is handed a CUDA
tensor.

Every C entry point returns ``cudaGetLastError()``; a launch that fails to
start (too many threads, too much shared memory) raises here instead of
being lost.
"""

import ctypes
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
# PyTorch versions (separate ops, no FMA contraction).  field.cu writes its
# matrix-product FMAs explicitly and keeps the rest uncontracted too.
SOURCES = {
    "marcher.cu": ["-fmad=false"],
    "hashenc.cu": ["-fmad=false"],
    "composite.cu": ["-fmad=false"],
    "field.cu": ["-fmad=false"],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_UP = ctypes.POINTER(ctypes.c_uint)

# symbol -> argtypes, the stream (last argument) included
_SIGNATURES = {
    "ngp_hash_encode": [_P, _P, _I, _P, _L, _I, _FP, _UP, _UP, _I, _P],
    "ngp_field": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "ngp_composite": [_P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P],
    "ngp_march": ([_P, _P, _FP, _P, _P] + [_I] * 9 + [_F] * 6 + [_P] * 9 + [_P]),
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


def _fingerprint():
    h = hashlib.sha256()
    h.update(repr((_ARCH, _COMMON, sorted(SOURCES.items()))).encode())
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
        build_info.update(seconds=0.0, path=lib_path, log="(cached build)")
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name, flags in SOURCES.items():
        obj = os.path.join(out_dir, name.replace(".cu", f".{os.getpid()}.o"))
        cmd = [nvcc] + _ARCH + _COMMON + flags + [
            "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
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


class CudaKernel:
    """One C entry point of the library.  ``launches`` counts the calls that
    launched the kernel (a wrapper's CPU path never comes here)."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args):
        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, self.symbol)(*args, stream)
        if rc != 0:
            msg = lib.ngp_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


HASH_ENCODE = CudaKernel("ngp_hash_encode")
FIELD = CudaKernel("ngp_field")
COMPOSITE = CudaKernel("ngp_composite")
MARCH = CudaKernel("ngp_march")

KERNELS = {"K1_hash_encode": HASH_ENCODE, "K2_march": MARCH,
           "K3_composite": COMPOSITE, "K4_field": FIELD}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}


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


def no_grad_inputs(name, *tensors):
    """The backward kernels come with the training slice: refuse to build a
    graph through a forward-only kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; its backward lands with "
            "the training slice (ROADMAP queue 2). Call it under torch.no_grad().")
