"""The port's host-numpy data helpers give the JAX package's arrays."""

import gzip
import struct

import numpy as np
import pytest

from tensornetworkforml_tpu.data import diagonals as jd
from tensornetworkforml_tpu.data import mnist as jmn
from tensornetworkforml_torch.data import diagonals as td
from tensornetworkforml_torch.data import mnist as tmn


def test_create_dataset_matches_jax():
    for a, b in zip(td.create_dataset(50, linear_dim=4, seed=3),
                    jd.create_dataset(50, linear_dim=4, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_mnist_and_pooling_match_jax():
    got = tmn.synthetic_mnist(n_train=20, n_test=7, seed=2)
    want = jmn.synthetic_mnist(n_train=20, n_test=7, seed=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pooled = tmn.max_pool_2x2(got[0] / 255.0)
    assert pooled.shape == (20, 14, 14) and 0.0 <= pooled.min() <= pooled.max() <= 1.0
    np.testing.assert_array_equal(pooled, jmn.max_pool_2x2(want[0] / 255.0))
    with pytest.raises(ValueError):
        tmn.max_pool_2x2(np.zeros((1, 3, 4)))


def _write_idx(path, arr, gz):
    header = struct.pack(">HBB", 0, 0x08, arr.ndim)
    header += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(header + arr.astype(np.uint8).tobytes())


def test_mnist_idx_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for i, base in enumerate(tmn._FILES.values()):
        shape = (6, 28, 28) if "images" in base else (6,)
        gz = i % 2 == 0
        _write_idx(raw / (base + (".gz" if gz else "")), rng.integers(0, 256, shape), gz)
    got = tmn.get_MNIST_dataset(str(tmp_path))
    want = jmn.get_MNIST_dataset(str(tmp_path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the JAX signature's ``download`` keyword: accepted, and no network
    got = tmn.get_MNIST_dataset(str(tmp_path), download=False)
    want = jmn.get_MNIST_dataset(str(tmp_path), download=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tmn.get_MNIST_dataset(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        tmn.get_MNIST_dataset(str(tmp_path / "missing"), download=False)
