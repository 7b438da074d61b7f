"""ctypes bindings to the native host core (port of ``puzzlefusion_plusplus_tpu/utils/native.py``).

The port keeps its own copy of the C++ source, ``csrc/pfpp_native.cpp``: an OpenMP chamfer,
FPS and batched part augmentation, exact counterparts of the numpy fallbacks below. It is
built at first use with ``g++ -O3 -march=native -fopenmp`` into ``csrc/build/`` (git-ignored;
``-march=native`` makes the library host-specific, so it is built where it runs), under a
file lock so that concurrent processes build it once. Without a compiler every function
falls back to numpy with the same semantics; ``route()`` says which one runs.

The port's datasets (``data/datasets.py``) augment through ``augment_parts_cpu``, as the JAX
package's do.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "pfpp_native.cpp")
BUILD_DIR = os.path.join(_CSRC, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libpfpp_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None | bool = None  # None = untried, False = unavailable
build_error = ""  # the compiler's message when the build failed


def _stale() -> bool:
    return not os.path.exists(LIB_PATH) or os.path.getmtime(_SRC) > os.path.getmtime(LIB_PATH)


def _build() -> bool:
    """Compile into a temporary file and move it into place, under a lock file, so that a
    process never loads a half-written library."""
    global build_error
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "pfpp_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it meanwhile
            return True
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired) as exc:
            build_error = str(getattr(exc, "stderr", b"") or exc)[-2000:]
            return False
        os.replace(tmp, LIB_PATH)
        return True


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale() and not _build():
                _lib = False
                return None
            lib = ctypes.CDLL(LIB_PATH)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.pfpp_nn_distance.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, f32p, i32p]
            lib.pfpp_fps.argtypes = [f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     i32p]
            lib.pfpp_augment_parts.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                               f32p, f32p, f32p, ctypes.c_int]
            lib.pfpp_num_threads.restype = ctypes.c_int
            _lib = lib
        return _lib if _lib is not False else None


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def nn_distance_cpu(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, N, 3] x [B, M, 3] -> (sqdist [B, N], idx [B, N]). Native or numpy fallback."""
    x, y = _f32(x), _f32(y)
    B, N, _ = x.shape
    M = y.shape[1]
    lib = get_lib()
    if lib is not None:
        dist = np.empty((B, N), np.float32)
        idx = np.empty((B, N), np.int32)
        lib.pfpp_nn_distance(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float), B, N, M,
                             _ptr(dist, ctypes.c_float), _ptr(idx, ctypes.c_int32))
        return dist, idx
    d = np.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, axis=-1)
    return d.min(-1).astype(np.float32), d.argmin(-1).astype(np.int32)


def fps_cpu(xyz: np.ndarray, npoint: int, mask: np.ndarray | None = None) -> np.ndarray:
    """Deterministic FPS [B, N, 3] -> [B, npoint] i32 (first valid point first, lowest index
    on ties). Native or numpy fallback."""
    xyz = _f32(xyz)
    B, N, _ = xyz.shape
    lib = get_lib()
    if lib is not None:
        out = np.empty((B, npoint), np.int32)
        mp = ctypes.POINTER(ctypes.c_uint8)()
        if mask is not None:
            m = np.ascontiguousarray(mask, np.uint8)
            mp = _ptr(m, ctypes.c_uint8)
        lib.pfpp_fps(_ptr(xyz, ctypes.c_float), mp, B, N, npoint, _ptr(out, ctypes.c_int32))
        return out
    if mask is None:
        mask = np.ones((B, N), bool)
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        dist = np.where(mask[b], 1e10, -1e10)
        cur = int(np.argmax(mask[b]))
        for s in range(npoint):
            out[b, s] = cur
            d = np.sum((xyz[b] - xyz[b, cur]) ** 2, axis=-1)
            d = np.where(mask[b], d, -1e10)
            dist = np.minimum(dist, d)
            cur = int(np.argmax(dist))
    return out


def augment_parts_cpu(
    pcs: np.ndarray, rots: np.ndarray, normalize: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recenter + rotate (+ max-abs normalize) all parts: [P, N, 3], [P, 3, 3] ->
    (out [P, N, 3], centroids [P, 3], scales [P])."""
    pcs, rots = _f32(pcs), _f32(rots)
    P, N, _ = pcs.shape
    lib = get_lib()
    if lib is not None:
        out = np.empty_like(pcs)
        centroids = np.empty((P, 3), np.float32)
        scales = np.empty((P,), np.float32)
        lib.pfpp_augment_parts(_ptr(pcs, ctypes.c_float), _ptr(rots, ctypes.c_float), P, N,
                               _ptr(out, ctypes.c_float), _ptr(centroids, ctypes.c_float),
                               _ptr(scales, ctypes.c_float), 1 if normalize else 0)
        return out, centroids, scales
    centroids = pcs.mean(axis=1)
    centered = pcs - centroids[:, None, :]
    out = np.einsum("pij,pnj->pni", rots, centered)
    scales = np.maximum(np.abs(out).reshape(P, -1).max(-1), 1e-38)
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    if normalize:
        out = out / scales[:, None, None]
    return out.astype(np.float32), centroids.astype(np.float32), scales


def available() -> bool:
    return get_lib() is not None


def route() -> str:
    """"native" when the library runs, else "numpy" (the fallback)."""
    return "native" if available() else "numpy"
