"""ctypes bindings for the native (C++) host data pipeline.

Loads the library built from ``native/data_core.cpp`` (multithreaded
synthetic data, psi embedding, pooling, shuffling and row gathers),
compiling it with ``g++`` at first use into the package's ``_build/``
directory under a name that carries a hash of the source, so an edited
source is rebuilt and an unchanged one reused. The source itself is shared
with the JAX package and is not modified here.

Every entry point gives the NumPy result when the library cannot be built
or loaded (no compiler), so the library speeds the host path up and is not
a dependency. ``available()`` says whether it loaded, and ``build_error()``
why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG.parent / "native" / "data_core.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    """Where ``native/data_core.cpp`` is built, keyed by the hash of its source."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libtnml_data_{digest}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exited {proc.returncode}: {proc.stderr[-2000:]}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
    f64p, f32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float)
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    lib.tnml_diagonals_dataset.argtypes = [
        i64, i32, ctypes.c_double, ctypes.c_double, u64, f64p, i32p,
    ]
    lib.tnml_psi_embed_f32.argtypes = [f32p, i64, f32p]
    lib.tnml_psi_embed_f64.argtypes = [f64p, i64, f64p]
    lib.tnml_max_pool_2x2_f64.argtypes = [f64p, i64, i32, i32, f64p]
    lib.tnml_shuffle_indices.argtypes = [i64p, i64, u64]
    lib.tnml_gather_rows_f32.argtypes = [f32p, i64p, i64, i64, f32p]
    lib.tnml_version.restype = i32
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it cannot be built or loaded."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = f"{type(exc).__name__}: {exc}"
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, once ``get_lib`` has tried; else None."""
    get_lib()
    return _error


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def diagonals_dataset(
    n_samples: int, linear_dim: int = 5, sigma: float = 0.5,
    prob_zero: float = 0.5, seed: int = 0,
):
    """Native noisy-diagonals generator: the distribution of
    ``data.diagonals.create_dataset`` with per-sample PRNG streams, so a
    seed gives the same data whatever the thread count."""
    lib = get_lib()
    if lib is None:
        from tensornetworkforml_torch.data.diagonals import create_dataset

        return create_dataset(n_samples, linear_dim, sigma, prob_zero, seed)
    data = np.empty((n_samples, linear_dim, linear_dim), dtype=np.float64)
    labels = np.empty(n_samples, dtype=np.int32)
    lib.tnml_diagonals_dataset(
        n_samples, linear_dim, sigma, prob_zero,
        np.uint64(seed if seed is not None else 0),
        _ptr(data, ctypes.c_double), _ptr(labels, ctypes.c_int32),
    )
    return data, labels.astype(np.int64)


def psi_embed(x: np.ndarray) -> np.ndarray:
    """Host psi embedding ``(..., N) -> (..., N, 2)`` in the dtype of ``x``."""
    lib = get_lib()
    x = np.ascontiguousarray(x)
    if lib is None:
        half_pi_x = (np.pi / 2.0) * x
        return np.stack([np.sin(half_pi_x), np.cos(half_pi_x)], axis=-1)
    out = np.empty(x.shape + (2,), dtype=x.dtype)
    if x.dtype == np.float32:
        lib.tnml_psi_embed_f32(_ptr(x, ctypes.c_float), x.size, _ptr(out, ctypes.c_float))
    elif x.dtype == np.float64:
        lib.tnml_psi_embed_f64(_ptr(x, ctypes.c_double), x.size, _ptr(out, ctypes.c_double))
    else:
        raise TypeError(f"unsupported dtype {x.dtype}")
    return out


def max_pool_2x2(x: np.ndarray) -> np.ndarray:
    """2x2 max-pool of ``(B, H, W)`` in float64."""
    lib = get_lib()
    if lib is None:
        from tensornetworkforml_torch.data.mnist import max_pool_2x2 as np_pool

        return np_pool(x)
    x = np.ascontiguousarray(x, dtype=np.float64)
    b, h, w = x.shape
    out = np.empty((b, h // 2, w // 2), dtype=np.float64)
    lib.tnml_max_pool_2x2_f64(_ptr(x, ctypes.c_double), b, h, w, _ptr(out, ctypes.c_double))
    return out


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` fixed by ``seed`` (Fisher-Yates)."""
    lib = get_lib()
    if lib is None:
        return np.random.default_rng(seed).permutation(n)
    idx = np.arange(n, dtype=np.int64)
    lib.tnml_shuffle_indices(_ptr(idx, ctypes.c_int64), n, np.uint64(seed))
    return idx


def gather_rows(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Contiguous batch gather ``out[k] = data[idx[k]]`` (float32 2-D)."""
    lib = get_lib()
    if lib is None or data.dtype != np.float32 or data.ndim != 2:
        return data[idx]
    data = np.ascontiguousarray(data)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx), data.shape[1]), dtype=np.float32)
    lib.tnml_gather_rows_f32(
        _ptr(data, ctypes.c_float), _ptr(idx, ctypes.c_int64),
        len(idx), data.shape[1], _ptr(out, ctypes.c_float),
    )
    return out
