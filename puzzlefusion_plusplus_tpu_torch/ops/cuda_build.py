"""Builds the port's CUDA kernels (``csrc/*.cu``) at first use and binds them with ctypes.

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface; the compilers all start together and the build waits for the slowest.
Libraries go to ``csrc/build/`` (listed in ``.gitignore``) and are rebuilt when a source is
newer than its library. Nothing is built at import: the CPU tests import every module of
the package on machines without ``nvcc``, and only a launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source -> {exported function: argtypes}; every function returns its launch's error code
SIGNATURES = {
    "gather": {
        "pfpp_gather": [_P, _P, _P, _LL, _LL, _LL, _LL, _P],
        "pfpp_error_string": [_I],
    },
    "fps": {"pfpp_fps": [_P, _P, _I, _I, _I, _P, _P]},
    "nn": {
        "pfpp_nn_distance": [_P, _P, _I, _I, _I, _P, _P, _P],
        "pfpp_masked_pairwise_nn": [_P, _P, _I, _I, _I, _P, _P],
    },
    "sa_cached": {"pfpp_sa_cached": [_P] * 10 + [_I] * 7 + [_P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # per source, from the last build in this process


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _stale(name: str) -> bool:
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(lib):
        return True
    newest = max(
        os.path.getmtime(os.path.join(CSRC, f))
        for f in (f"{name}.cu", "common.cuh")
    )
    return os.path.getmtime(lib) < newest


def build_all() -> None:
    """Compile every stale source, one nvcc process each, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        if not _stale(name):
            continue
        tmp = os.path.join(BUILD_DIR, f"lib{name}.{os.getpid()}.tmp.so")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log,
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, log, tmp, t0) in procs.items():
        rc = proc.wait()
        log.close()
        build_seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, os.path.join(BUILD_DIR, f"lib{name}.so"))
    if failed:
        tails = []
        for name in failed:
            with open(os.path.join(BUILD_DIR, f"{name}.log")) as fh:
                tails.append(f"--- {name}.cu ---\n" + fh.read()[-4000:])
        raise RuntimeError("nvcc failed:\n" + "\n".join(tails))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all kernels on first use."""
    with _lock:
        if name not in _libs:
            build_all()
            for src, funcs in SIGNATURES.items():
                lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{src}.so"))
                for fn, argtypes in funcs.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _I
                _libs[src] = lib
            _libs["gather"].pfpp_error_string.restype = ctypes.c_char_p
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library("gather").pfpp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the launch functions take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            align16: bool = False) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, rank, contiguity (and 16-byte
    alignment for operands a kernel reads as float4)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
