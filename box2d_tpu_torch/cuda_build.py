"""Builds a csrc/ source into a shared library with a plain C interface.

Each kernel module of the port compiles its source with nvcc for sm_90a
into the git-ignored _build/ directory at its first CUDA use and loads it
with ctypes. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")


def nvcc_build(source: str, name: str) -> tuple[ctypes.CDLL, str, float]:
    """Compile `source` with $CUDA_HOME/bin/nvcc (default /usr/local/cuda)
    into _build/lib<name>.so and load it. Returns (library, the ptxas
    lines nvcc printed, wall seconds of the build). Raises if nvcc fails."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    # each process builds to its own file and renames it into place, so
    # concurrent builds never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    # -fmad=false: no fused multiply-add contraction, so a kernel rounds
    # each operation as its PyTorch twin does (the twin's elementwise ops
    # are separate kernels and never fuse)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return ctypes.CDLL(out), proc.stderr, seconds
