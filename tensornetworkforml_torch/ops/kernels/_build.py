"""Build and load the package's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which is loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited source
is rebuilt and an unchanged one is reused. Nothing here runs at import
time: a machine without ``nvcc`` or a card can import the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by the hash of its source and
    of the shared headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it.

    ``nvcc``'s output (with ``ptxas``'s register and shared-memory report)
    is kept beside the library as ``<library>.log``.
    """
    if name in _loaded:
        return _loaded[name]
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        Path(f"{so}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                + proc.stderr[-4000:]
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
