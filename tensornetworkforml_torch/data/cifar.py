"""CIFAR-10 ingestion as grayscale, on the host in numpy.

Reads the standard CIFAR-10 binary batches (``data_batch_*.bin``,
``test_batch.bin``; 3073 bytes per record) from a local directory -- no
network access -- and converts them to grayscale in [0, 1] for the psi
embedding (N = 1024 sites at full resolution, 256 pooled).
``synthetic_cifar10`` is a deterministic stand-in built like
``data.mnist.synthetic_mnist``.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
from typing import Tuple

import numpy as np

from tensornetworkforml_torch.data.mnist import synthetic_mnist

_RECORD = 3073  # 1 label byte + 3*32*32 pixels

# Published MD5 of the canonical archive (torchvision's CIFAR10 binary
# resource constant). Batches are checked by their structure.
CIFAR10_BINARY_TGZ_MD5 = "c32a1d4ab5d03f1284b67883e8d87530"


def _find_batches(data_dir: str):
    for sub in ("", "cifar-10-batches-bin"):
        base = os.path.join(data_dir, sub)
        if os.path.exists(os.path.join(base, "data_batch_1.bin")):
            train = [os.path.join(base, f"data_batch_{i}.bin") for i in range(1, 6)]
            return train, os.path.join(base, "test_batch.bin")
    # a still-packed archive
    p = os.path.join(data_dir, "cifar-10-binary.tar.gz")
    if os.path.exists(p):
        with tarfile.open(p) as tf:
            tf.extractall(data_dir, filter="data")
        return _find_batches(data_dir)
    return None, None


def _read_batch(path: str):
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % _RECORD:
        raise ValueError(f"{path}: corrupt CIFAR batch")
    raw = raw.reshape(-1, _RECORD)
    labels = raw[:, 0].astype(np.int64)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).astype(np.float64)
    return imgs, labels


def verify_checksums(data_dir: str) -> dict:
    """Validate the CIFAR-10 files under ``data_dir``.

    ``archive``: ``"ok"`` / ``"mismatch"`` / ``"missing"`` for the md5 of
    ``cifar-10-binary.tar.gz``. Each batch file: ``"shape-ok"`` when it
    holds exactly 10000 records of 3073 bytes with labels in [0, 10),
    ``"mismatch"`` otherwise, ``"missing"`` if absent.
    """
    out = {}
    p = os.path.join(data_dir, "cifar-10-binary.tar.gz")
    if os.path.exists(p):
        with open(p, "rb") as fh:
            md5 = hashlib.md5(fh.read()).hexdigest()
        out["archive"] = "ok" if md5 == CIFAR10_BINARY_TGZ_MD5 else "mismatch"
    else:
        out["archive"] = "missing"
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        found = next((q for q in (os.path.join(data_dir, sub, name)
                                  for sub in ("", "cifar-10-batches-bin"))
                      if os.path.exists(q)), None)
        if found is None:
            out[name] = "missing"
            continue
        raw = np.fromfile(found, dtype=np.uint8)
        ok = raw.size == 10000 * _RECORD and np.all(raw.reshape(-1, _RECORD)[:, 0] < 10)
        out[name] = "shape-ok" if ok else "mismatch"
    return out


def rgb_to_gray(imgs: np.ndarray) -> np.ndarray:
    """(B, 3, H, W) -> (B, H, W) luma grayscale."""
    r, g, b = imgs[:, 0], imgs[:, 1], imgs[:, 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def get_CIFAR10_grayscale(
    data_root_dir: str = "./datasets",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load CIFAR-10 from local binary batches as grayscale in [0, 1].

    Returns ``(train_data (50000,32,32), train_labels, test_data
    (10000,32,32), test_labels)``.
    """
    train_files, test_file = _find_batches(data_root_dir)
    if train_files is None:
        raise FileNotFoundError(
            f"CIFAR-10 binary batches not found under {data_root_dir!r}. "
            "Place cifar-10-batches-bin/ (or the cifar-10-binary.tar.gz "
            "archive) there, or use synthetic_cifar10() for a stand-in."
        )
    xs, ys = zip(*(_read_batch(f) for f in train_files))
    train_x = rgb_to_gray(np.concatenate(xs)) / 255.0
    tx, ty = _read_batch(test_file)
    return train_x, np.concatenate(ys), rgb_to_gray(tx) / 255.0, ty


def synthetic_cifar10(n_train: int = 5000, n_test: int = 1000, seed: int = 0):
    """Deterministic CIFAR-shaped stand-in (32x32 grayscale in [0, 1])."""
    a, y1, b, y2 = synthetic_mnist(n_train, n_test, side=32, seed=seed)
    return a / 255.0, y1, b / 255.0, y2
