"""The port's native host pipeline (``data/native.py``) against the JAX
package's, on the CPU.

Both load a library built from the same ``native/data_core.cpp``, so every
output is held exactly. The port builds its own copy under
``tensornetworkforml_torch/_build/``, never ``native/libtnml_data.so``.
Without a library (no compiler) each entry point gives the NumPy result,
held against the JAX package's NumPy paths, also exactly.
"""

import os

import numpy as np
import pytest

from tensornetworkforml_tpu.data import native as jn
from tensornetworkforml_torch.data import loader as tld
from tensornetworkforml_torch.data import native as tn

PKG = os.path.dirname(os.path.dirname(os.path.abspath(tn.__file__)))


def test_library_builds_under_the_package_build_dir():
    assert tn.available(), tn.build_error()
    assert tn.build_error() is None
    assert tn.get_lib().tnml_version() == 1
    path = tn.library_path()
    assert path.parent == tn.BUILD_DIR
    assert str(path).startswith(os.path.join(PKG, "_build") + os.sep)
    assert path.exists() and path.name.startswith("libtnml_data_") and path.suffix == ".so"
    assert os.path.basename(jn._LIB_PATH) != path.name  # not the JAX package's library
    assert str(tn.SRC.resolve()) == os.path.realpath(jn._SRC)  # the same source


def test_diagonals_match_jax():
    for seed in (0, 7):
        got = tn.diagonals_dataset(700, 6, sigma=0.4, seed=seed)
        want = jn.diagonals_dataset(700, 6, sigma=0.4, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_psi_embed_matches_jax(dtype):
    x = np.random.default_rng(0).random((13, 7, 3)).astype(dtype)
    got = tn.psi_embed(x)
    assert got.dtype == dtype and got.shape == (13, 7, 3, 2)
    np.testing.assert_array_equal(got, jn.psi_embed(x))
    np.testing.assert_array_equal(tld.psi_embed_host(x), jn.psi_embed(x))
    with pytest.raises(TypeError):
        tn.psi_embed(x.astype(np.float16))


def test_pool_shuffle_and_gather_match_jax():
    x = np.random.default_rng(1).random((5, 8, 10))
    np.testing.assert_array_equal(tn.max_pool_2x2(x), jn.max_pool_2x2(x))
    idx = tn.shuffled_indices(1000, seed=3)
    np.testing.assert_array_equal(idx, jn.shuffled_indices(1000, seed=3))
    assert sorted(idx.tolist()) == list(range(1000)) and not np.array_equal(idx, np.arange(1000))
    data = np.random.default_rng(2).random((100, 17)).astype(np.float32)
    sel = idx[:32] % 100
    np.testing.assert_array_equal(tn.gather_rows(data, sel), jn.gather_rows(data, sel))
    np.testing.assert_array_equal(tn.gather_rows(data, sel), data[sel])
    # not float32 2-D: NumPy indexing in both
    d64 = data.astype(np.float64)
    np.testing.assert_array_equal(tn.gather_rows(d64, sel), jn.gather_rows(d64, sel))


def test_prepare_dataset_embeds_through_the_library(monkeypatch):
    calls = []
    real = tn.psi_embed

    def spy(x):
        calls.append(x.shape)
        return real(x)

    monkeypatch.setattr(tn, "psi_embed", spy)
    data = np.random.default_rng(4).random((40, 3, 3))
    tld.prepare_dataset(data, np.arange(40) % 2, 0.5, 0.0, 4, 4, 4, embed=True, seed=0)
    assert calls == [(40, 9)]


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A fresh loader state whose build fails: a source that does not compile."""
    bad = tmp_path / "data_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SRC", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_tried", False)
    monkeypatch.setattr(tn, "_error", None)


def test_without_a_library_every_entry_gives_the_numpy_result(no_library):
    from tensornetworkforml_tpu.data.diagonals import create_dataset
    from tensornetworkforml_tpu.data.mnist import max_pool_2x2

    assert not tn.available()
    assert "g++ exited" in tn.build_error()
    x = np.random.default_rng(5).random((4, 6)).astype(np.float32)
    half = (np.pi / 2.0) * x
    np.testing.assert_array_equal(tn.psi_embed(x), np.stack([np.sin(half), np.cos(half)], -1))
    for a, b in zip(tn.diagonals_dataset(50, 4, seed=3), create_dataset(50, 4, 0.5, 0.5, 3)):
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(6).random((2, 4, 6))
    np.testing.assert_array_equal(tn.max_pool_2x2(img), max_pool_2x2(img))
    np.testing.assert_array_equal(tn.shuffled_indices(20, 9),
                                  np.random.default_rng(9).permutation(20))
    data = np.random.default_rng(7).random((10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tn.gather_rows(data, np.array([3, 1])), data[[3, 1]])
