"""Marching cubes through the repo's native C++ core
(``native/marching_cubes.cpp``), compiled with g++ into this package's
ignored build directory and loaded with ctypes.  The source is only read:
the library never goes into ``native/``."""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "marching_cubes.cpp")
_BUILD = os.path.join(_PKG, "_build")
_lib = None


def _build_lib():
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD, f"libmarching_cubes-{tag}.so")
    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = out + f".{os.getpid()}.tmp"
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp])
        os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_lib())
        lib.mc_run.restype = ctypes.c_int
        lib.mc_run.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
    return _lib


def marching_cubes(field, iso):
    """field: [nx, ny, nz] float32 numpy.  Returns (verts [V, 3] in grid
    coords, tris [T, 3] int32)."""
    lib = _get_lib()
    field = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = field.shape
    max_verts = max(1024, int(field.size * 3))
    max_tris = max(1024, int(field.size * 5))
    verts = np.empty((max_verts, 3), np.float32)
    tris = np.empty((max_tris, 3), np.int32)
    nverts = ctypes.c_long(0)
    ntris = ctypes.c_long(0)
    rc = lib.mc_run(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, float(iso),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_verts, ctypes.byref(nverts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_tris, ctypes.byref(ntris),
    )
    if rc != 0:
        raise RuntimeError(f"marching_cubes buffer overflow (rc={rc})")
    return verts[: nverts.value].copy(), tris[: ntris.value].copy()
