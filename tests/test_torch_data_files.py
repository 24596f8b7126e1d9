"""The port's MNIST checksums and CIFAR-10 readers against the JAX package's,
on the files ``tests/test_data_mnist.py`` writes into ``tmp_path``.

Everything here is host NumPy in both packages, so every output is held
exactly: the same arrays bit for bit, the same dtypes, the same verdicts.
"""

import hashlib
import os
import tarfile

import numpy as np
import pytest

from tensornetworkforml_tpu.data import cifar as jc
from tensornetworkforml_tpu.data import mnist as jm
from tensornetworkforml_torch.data import cifar as tc
from tensornetworkforml_torch.data import mnist as tm
from tests.test_data_mnist import _write_idx_images


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_mnist_checksum_tables_match_jax():
    assert tm.MNIST_GZ_MD5 == jm.MNIST_GZ_MD5
    assert tm.MNIST_IDX_SHAPES == jm.MNIST_IDX_SHAPES
    assert tc.CIFAR10_BINARY_TGZ_MD5 == jc.CIFAR10_BINARY_TGZ_MD5


def test_mnist_verify_checksums_matches_jax(tmp_path, monkeypatch):
    """The stages of ``test_mnist_verify_checksums``: all missing; canonical
    geometry, wrong geometry and absent files; a gz whose md5 is the
    (patched) published one; the same gz against the real constant."""
    def both():
        got, want = tm.verify_checksums(str(tmp_path)), jm.verify_checksums(str(tmp_path))
        assert got == want
        return got

    assert set(both().values()) == {"missing"}
    rng = np.random.default_rng(0)
    _write_idx_images(str(tmp_path / "train-images-idx3-ubyte"),
                      rng.integers(0, 256, (60000, 28, 28), dtype=np.uint8))
    _write_idx_images(str(tmp_path / "train-labels-idx1-ubyte"),
                      rng.integers(0, 10, (60000,), dtype=np.uint8))
    _write_idx_images(str(tmp_path / "t10k-images-idx3-ubyte"),
                      rng.integers(0, 256, (8, 28, 28), dtype=np.uint8))
    out = both()
    assert out["train-images-idx3-ubyte"] == "shape-ok"
    assert out["t10k-images-idx3-ubyte"] == "mismatch"
    assert out["t10k-labels-idx1-ubyte"] == "missing"

    pz = tmp_path / "t10k-labels-idx1-ubyte.gz"
    _write_idx_images(str(pz), rng.integers(0, 10, (10000,), dtype=np.uint8), gz=True)
    md5 = hashlib.md5(pz.read_bytes()).hexdigest()
    for table in (tm.MNIST_GZ_MD5, jm.MNIST_GZ_MD5):
        monkeypatch.setitem(table, "t10k-labels-idx1-ubyte.gz", md5)
    assert both()["t10k-labels-idx1-ubyte"] == "ok"
    monkeypatch.undo()
    assert both()["t10k-labels-idx1-ubyte"] == "shape-ok"
    # a file that is not IDX at all
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(b"\x01\x02not idx")
    assert both()["train-labels-idx1-ubyte"] == "mismatch"


def _write_cifar(root, rng, n_train=6, n_test=4):
    os.makedirs(root / "cifar-10-batches-bin")
    for name, n in [(f"data_batch_{i}.bin", n_train) for i in range(1, 6)] + [
        ("test_batch.bin", n_test)
    ]:
        labels = rng.integers(0, 10, n, dtype=np.uint8)
        imgs = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        raw = np.concatenate([labels[:, None], imgs], axis=1)
        (root / "cifar-10-batches-bin" / name).write_bytes(raw.tobytes())


def test_cifar_readers_match_jax(tmp_path):
    """``test_cifar_batch_roundtrip``'s files, read by both packages."""
    _write_cifar(tmp_path, np.random.default_rng(0))
    got = tc.get_CIFAR10_grayscale(str(tmp_path))
    _same(got, jc.get_CIFAR10_grayscale(str(tmp_path)))
    assert got[0].shape == (30, 32, 32) and got[2].shape == (4, 32, 32)
    assert got[0].min() >= 0 and got[0].max() <= 1.0
    for path in sorted((tmp_path / "cifar-10-batches-bin").iterdir()):
        _same(tc._read_batch(str(path)), jc._read_batch(str(path)))
    assert tc._find_batches(str(tmp_path)) == jc._find_batches(str(tmp_path))
    assert tc._find_batches(str(tmp_path / "nowhere")) == (None, None)
    imgs = np.random.default_rng(1).random((3, 3, 5, 4))
    np.testing.assert_array_equal(tc.rgb_to_gray(imgs), jc.rgb_to_gray(imgs))
    _same(tc.synthetic_cifar10(50, 10, seed=2), jc.synthetic_cifar10(50, 10, seed=2))
    with pytest.raises(FileNotFoundError):
        tc.get_CIFAR10_grayscale(str(tmp_path / "nowhere"))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="corrupt"):
        tc._read_batch(str(bad))


def test_cifar_packed_archive_is_unpacked_as_in_jax(tmp_path):
    """A ``cifar-10-binary.tar.gz`` and nothing else: both packages unpack it
    and read the same arrays."""
    src = tmp_path / "src"
    _write_cifar(src, np.random.default_rng(3), n_train=2, n_test=2)
    for who in ("torch", "jax"):
        root = tmp_path / who
        root.mkdir()
        with tarfile.open(root / "cifar-10-binary.tar.gz", "w:gz") as tf:
            tf.add(src / "cifar-10-batches-bin", arcname="cifar-10-batches-bin")
    _same(tc.get_CIFAR10_grayscale(str(tmp_path / "torch")),
          jc.get_CIFAR10_grayscale(str(tmp_path / "jax")))
    got = tc.verify_checksums(str(tmp_path / "torch"))
    assert got == jc.verify_checksums(str(tmp_path / "jax"))
    assert got["archive"] == "mismatch" and got["data_batch_1.bin"] == "mismatch"


def test_cifar_verify_checksums_matches_jax(tmp_path):
    """``test_cifar_verify_checksums``'s stages."""
    def both():
        got, want = tc.verify_checksums(str(tmp_path)), jc.verify_checksums(str(tmp_path))
        assert got == want
        return got

    out = both()
    assert out["archive"] == "missing" and out["data_batch_1.bin"] == "missing"
    rng = np.random.default_rng(0)
    rec = np.zeros((10000, 3073), dtype=np.uint8)
    rec[:, 0] = rng.integers(0, 10, 10000)
    rec[:, 1:] = rng.integers(0, 256, (10000, 3072))
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    rec.tofile(str(d / "data_batch_1.bin"))
    bad = rec.copy()
    bad[0, 0] = 99  # label out of range
    bad.tofile(str(d / "test_batch.bin"))
    rec[:5].tofile(str(tmp_path / "data_batch_2.bin"))  # too short, at the top level
    out = both()
    assert out["data_batch_1.bin"] == "shape-ok"
    assert out["test_batch.bin"] == "mismatch" and out["data_batch_2.bin"] == "mismatch"
