"""Build and load the port's CUDA kernels.

Every source in ``csrc/`` is compiled at first use with its own ``nvcc``
(all started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface (``build/kernels/`` at the
repository root, named by a hash of the sources and flags) that is loaded
with ctypes. Each C entry point takes device pointers, ints and the CUDA
stream, launches on that stream and returns ``cudaGetLastError()``.

The wrappers that call the entry points live beside their plain PyTorch
versions: ``ops/rasterizer/composite_cuda.py`` (K1, K2) and
``ops/rasterizer/table_gather.py`` (K3, K4).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (pointers, then ints, then the stream)
SIGNATURES = {
    "composite_fwd": [_VP] * 9 + [_CI] * 4 + [_VP],
    "composite_bwd": [_VP] * 11 + [_CI] * 4 + [_VP],
    "table_gather": [_VP] * 3 + [_CI] * 2 + [_VP],
    "table_scatter_add": [_VP] * 3 + [_CI] * 2 + [_VP],
}


def sources() -> list:
    return sorted(p.name for p in CSRC.glob("*.cu"))


class _Library:
    """The loaded kernel library (one per process)."""

    handle = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "nvcc at first use")
    return path


def build_kernels() -> dict:
    """Compile every source in ``csrc/`` with one nvcc each, all started
    together, link them into one shared library and load it. Returns
    {source: {"seconds": s, "ptxas": text}} (empty when already built)."""
    if _Library.handle is not None:
        return {}
    names = sources()
    digest = hashlib.sha256()
    for name in names:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libkernels_{tag}.so"
    log = {}
    if not lib_path.exists():
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
            procs[name] = (obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (obj, proc) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
            log[name] = {"seconds": time.perf_counter() - t0,
                         "ptxas": text.strip()}
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp)] + [str(o) for o, _ in procs.values()],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _CI
    _Library.handle = lib
    return log


def library():
    if _Library.handle is None:
        build_kernels()
    return _Library.handle


def check(name, x, dtype, shape, device):
    """Raise unless x is on `device`, of `dtype` and `shape`, contiguous and
    16-byte aligned (the kernels use float4 accesses)."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(x):
    return ctypes.c_void_p(x.data_ptr())
