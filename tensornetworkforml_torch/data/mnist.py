"""MNIST ingestion on the host, in numpy (no torchvision dependency).

* a standalone IDX-format reader loads the standard
  ``*-images-idx3-ubyte[.gz]`` / ``*-labels-idx1-ubyte[.gz]`` files from a
  local directory (also found under ``<dir>/MNIST/raw`` as torchvision lays
  them out). No network access is attempted.
* ``max_pool_2x2`` is a reshape-max.
* ``synthetic_mnist`` generates a deterministic MNIST-shaped stand-in
  (digit-dependent patterns + noise) so the 10-class pipeline can be
  exercised on machines without the real data.

The models take pixels in [0, 1], pooled to 14x14: ``max_pool_2x2(x / 255)``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    """Read one IDX file (optionally gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        zero, dtype_code, ndim = struct.unpack(">HBB", fh.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an IDX file")
        dims = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        dtype = {
            0x08: np.uint8,
            0x09: np.int8,
            0x0B: np.int16,
            0x0C: np.int32,
            0x0D: np.float32,
            0x0E: np.float64,
        }[dtype_code]
        data = np.frombuffer(fh.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def _find(data_dir: str, base: str) -> str | None:
    for sub in ("", "MNIST/raw", "raw"):
        for ext in ("", ".gz"):
            p = os.path.join(data_dir, sub, base + ext)
            if os.path.exists(p):
                return p
    return None


def get_MNIST_dataset(
    data_root_dir: str = "./datasets", download: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load MNIST from local IDX files.

    Returns ``(train_data (60000,28,28) float, train_labels, test_data,
    test_labels)``. ``download`` is accepted for signature parity with the
    JAX package; no network access is ever attempted. A FileNotFoundError
    is raised if the files are absent.
    """
    arrays = {}
    for key, base in _FILES.items():
        path = _find(data_root_dir, base)
        if path is None:
            raise FileNotFoundError(
                f"MNIST file {base}[.gz] not found under {data_root_dir!r}. "
                "Place the standard IDX files there, or use "
                "tensornetworkforml_torch.data.mnist.synthetic_mnist() for a "
                "local stand-in."
            )
        arrays[key] = _read_idx(path)
    return (
        arrays["train_images"].astype(np.float64),
        arrays["train_labels"].astype(np.int64),
        arrays["test_images"].astype(np.float64),
        arrays["test_labels"].astype(np.int64),
    )


def max_pool_2x2(x: np.ndarray) -> np.ndarray:
    """2x2 max-pool over the trailing two (even) spatial dims of ``(B,H,W)``."""
    b, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"spatial dims must be even, got {h}x{w}")
    return x.reshape(b, h // 2, 2, w // 2, 2).max(axis=(2, 4))


def synthetic_mnist(
    n_train: int = 6000,
    n_test: int = 1000,
    side: int = 28,
    n_classes: int = 10,
    noise: float = 0.15,
    seed: int = 0,
):
    """Deterministic MNIST-shaped stand-in: class-dependent low-frequency
    patterns plus uniform noise, values in [0, 255] like the real data.

    NOT a substitute for real-data accuracy numbers.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / (side - 1)
    protos = []
    for c in range(n_classes):
        k1, k2 = 1 + c % 3, 1 + (c // 3) % 3
        phase = 2 * np.pi * c / n_classes
        protos.append(0.5 + 0.5 * np.sin(2 * np.pi * (k1 * xx + k2 * yy) + phase))
    protos = np.stack(protos)  # (C, side, side)

    def make(n):
        y = rng.integers(0, n_classes, size=n)
        base = protos[y]
        imgs = base * (1 - noise) + rng.random(base.shape) * noise
        return imgs * 255.0, y

    train = make(n_train)
    test = make(n_test)
    return train[0], train[1], test[0], test[1]
