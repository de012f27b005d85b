"""Loader for the port's host builders (csrc/scene_core.cpp).

The spring / barrier pairs and the elastic triads of a particle group are
built on the host, once, by the C++ of csrc/scene_core.cpp: a grid-hashed
proximity search and a flood-fill Voronoi diagram (the JAX package's
native/scene_core.cpp, copied). It is compiled with g++ into the
git-ignored _build/ directory at its first use and bound with ctypes.
There is no NumPy fallback: another triangulation would give the same
scene other physics, so a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .cuda_build import BUILD_DIR, HERE

SOURCE = os.path.join(HERE, "csrc", "scene_core.cpp")

_LOCK = threading.Lock()
_LIB = None


def load() -> ctypes.CDLL:
    """The built library, compiled first where _build/ holds none older
    than the source. Raises RuntimeError if g++ fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = os.path.join(BUILD_DIR, "libscene_core.so")
        if (not os.path.exists(out)
                or os.path.getmtime(out) < os.path.getmtime(SOURCE)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # built to a file of this process, then renamed into place, so
            # a concurrent build never loads a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                   tmp, SOURCE]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"g++ not found: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.build_pairs.restype = ctypes.c_int
        lib.build_triads.restype = ctypes.c_int
        _LIB = lib
        return lib


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def build_pairs(pos: np.ndarray, max_dist: float,
                max_pairs: int | None = None):
    """Every pair of points closer than max_dist, as (a, b, dist) int32 /
    int32 / float32 arrays (box2d_tpu/native.py build_pairs_native)."""
    lib = load()
    pos = np.ascontiguousarray(pos, np.float32).reshape(-1, 2)
    n = len(pos)
    cap = max_pairs or max(16, n * 8)
    a = np.zeros(cap, np.int32)
    b = np.zeros(cap, np.int32)
    d = np.zeros(cap, np.float32)
    k = lib.build_pairs(_ptr(pos, ctypes.c_float), n,
                        ctypes.c_float(max_dist),
                        _ptr(a, ctypes.c_int32), _ptr(b, ctypes.c_int32),
                        _ptr(d, ctypes.c_float), cap)
    return a[:k], b[:k], d[:k]


def build_triads(pos: np.ndarray, stride: float,
                 max_triads: int | None = None):
    """The Voronoi triads of the points, as (tri (k, 3) int32, rest
    offsets from each triad's midpoint (k, 3, 2) float32)
    (box2d_tpu/native.py build_triads_native)."""
    lib = load()
    pos = np.ascontiguousarray(pos, np.float32).reshape(-1, 2)
    n = len(pos)
    cap = max_triads or max(16, n * 2)
    tri = np.zeros((cap, 3), np.int32)
    rest = np.zeros((cap, 3, 2), np.float32)
    k = lib.build_triads(_ptr(pos, ctypes.c_float), n,
                         ctypes.c_float(stride),
                         _ptr(tri, ctypes.c_int32),
                         _ptr(rest, ctypes.c_float), cap)
    return tri[:k], rest[:k]
