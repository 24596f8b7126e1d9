"""K6, the rangefinder split kernel (``ops/kernels/split_kernel.py``):
``hqr_orth`` and ``rangefinder_split_plain`` against the JAX package's
``_hqr_orth`` and ``rangefinder_split_pallas`` (interpret mode) on the CPU,
the dispatch of ``svd_method="rangefinder"`` by shape, and the CUDA kernel
against its plain version on a card.

JAX is imported inside the fixtures and tests, so that the tests marked
``cuda`` run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_split_kernel.py``.

Tolerances:
* ``hqr_orth`` against ``_hqr_orth`` in float32: 1e-5 on Q itself. Both form
  the same reflectors from the same columns and differ only in the order of
  their float32 sums (measured ~4e-7);
* ``rangefinder_split_plain`` against the Pallas kernel in float32, with the
  JAX package's Omega: 1e-4 on Q and on R relative to max|B|. Seven
  orthonormalisations and six products with G in another summation order
  (measured up to 3e-6);
* on the card, the kernel against the plain version: the projector
  ``Q Q^T`` 1e-3, ``Q R`` 1e-4 of max|B| and the isometry of Q 1e-4, the
  limits K1 is held to (measured at most 1.9e-6 on these shapes).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import split_kernel as tsk

HQR_TOL = 1e-5
SPLIT_TOL = 1e-4
CARD_PROJ_TOL, CARD_REC_TOL, CARD_ISO_TOL = 1e-3, 1e-4, 1e-4


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


def _gapped(I, J, rank, seed=0, scale=1.0, gap=0.05):
    """A float32 matrix whose spectrum drops by ``gap`` after ``rank``."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((I, I)))[0]
    V = np.linalg.qr(rng.standard_normal((J, I)))[0]
    s = np.concatenate([np.geomspace(1.0, 0.1, rank),
                        np.geomspace(0.1 * gap, 0.01 * gap, I - rank)])
    return (scale * (U * s) @ V.T).astype(np.float32)


def _hqr_inputs(kind):
    rng = np.random.default_rng(3)
    y = rng.standard_normal((24, 16)).astype(np.float32)
    if kind == "rank_deficient":
        y[:, 5:] = 0.0
    elif kind == "dependent":
        y[:, 3] = 2.0 * y[:, 1]
    elif kind == "zero_rows":  # an edge step: three live rows
        y[3:] = 0.0
    elif kind == "zero":
        y[:] = 0.0
    return y


@pytest.mark.parametrize("kind", ["full", "rank_deficient", "dependent", "zero_rows", "zero"])
def test_hqr_orth_matches_jax(kind):
    """Q itself agrees, except past a dependent column: there the reflector
    is formed from rounding noise, which differs between the two, so only
    the columns before it and the isometry are compared."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.split_kernel import _hqr_orth

    y = _hqr_inputs(kind)
    want = np.asarray(_hqr_orth(jnp.asarray(y)))
    got = tsk.hqr_orth(torch.as_tensor(y)).numpy()
    cols = slice(0, 3) if kind == "dependent" else slice(None)
    np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=0, atol=HQR_TOL)
    np.testing.assert_allclose(got.T @ got, np.eye(16), rtol=0, atol=1e-5)


def test_hqr_orth_gives_unit_columns_for_zero_columns():
    y = _hqr_inputs("zero")
    assert torch.equal(tsk.hqr_orth(torch.as_tensor(y)), torch.eye(24, 16))
    y = _hqr_inputs("zero_rows")  # columns past the live rank: e_j exactly
    q = tsk.hqr_orth(torch.as_tensor(y))
    assert torch.equal(q[:, 3:], torch.eye(24, 16)[:, 3:])


@pytest.mark.parametrize("shape,scale", [((32, 160, 16), 1.0), ((32, 160, 16), 1e10),
                                         ((128, 1280, 64), 1.0), ((256, 2560, 128), 1.0)])
def test_plain_version_matches_the_pallas_kernel(shape, scale, jax_omega):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.split_kernel import rangefinder_split_pallas

    I, J, rank = shape
    b = _gapped(I, J, rank, scale=scale)
    jq, jr = rangefinder_split_pallas(jnp.asarray(b), rank, interpret=True)
    q, r = tsk.rangefinder_split_plain(torch.as_tensor(b), rank)
    assert q.shape == (I, rank) and r.shape == (rank, J) and q.dtype == torch.float32
    bmax = float(np.abs(b).max())
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=SPLIT_TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=SPLIT_TOL * bmax)


def test_plain_version_computes_in_float32_and_keeps_the_dtype():
    b = _gapped(32, 160, 16).astype(np.float64)
    q, r = tsk.rangefinder_split_plain(torch.as_tensor(b), 16)
    q32, r32 = tsk.rangefinder_split_plain(torch.as_tensor(b.astype(np.float32)), 16)
    assert q.dtype == r.dtype == torch.float64
    assert torch.equal(q, q32.double()) and torch.equal(r, r32.double())


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    b = torch.as_tensor(_gapped(40, 200, 12))
    before = tsk.rangefinder_split.launches
    q, r = tsk.rangefinder_split(b, 12, n_iter=3, mid_orth=2)
    q2, r2 = tsk.rangefinder_split_plain(b, 12, n_iter=3, mid_orth=2)
    assert torch.equal(q, q2) and torch.equal(r, r2)
    assert tsk.rangefinder_split.launches == before  # the plain version counts nothing


@pytest.mark.parametrize("method,I,route", [
    ("rangefinder", 127, "xla"), ("rangefinder", 128, "kernel"),
    ("rangefinder_pallas", 40, "kernel"), ("rangefinder_pallas", 128, "kernel"),
])
def test_rangefinder_methods_dispatch_by_shape(method, I, route, monkeypatch):
    calls = []
    monkeypatch.setattr(tsk, "rangefinder_split", lambda b, r: calls.append("kernel") or (b, r))
    monkeypatch.setattr(tsvd, "_rangefinder_split",
                        lambda b, r, *a: calls.append("xla") or (b, r))
    tsvd.truncated_svd_split(torch.zeros((I, 2 * I)), 8, method, split_mode="canonical")
    assert calls == [route]


@pytest.mark.parametrize("method", ["rangefinder", "rangefinder_pallas"])
def test_rangefinder_methods_reject_unsupported_modes(method):
    b = torch.as_tensor(_gapped(128, 300, 8))
    with pytest.raises(ValueError, match="canonical"):
        tsvd.truncated_svd_split(b, 8, method, split_mode="shared")
    with pytest.raises(ValueError, match="reference"):
        tsvd.truncated_svd_split(b, 8, method, keep=4, split_mode="canonical")
    with pytest.raises(ValueError, match="spectrum"):
        tsvd.truncated_svd_split(b, 8, method, split_mode="canonical", adaptive_tol=0.1)


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsk.rangefinder_split(torch.zeros((8, 12), device="meta"), 4)


# ---- the CUDA kernel on a card ---------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_input(case):
    """The rangefinder phase's shapes: a flagship-sized gapped matrix, a
    ragged one, one whose panel does not fit in shared memory, and an edge
    step with three live rows."""
    I, J, rank = {"flagship": (256, 2560, 128), "ragged": (130, 1000, 60),
                  "global_panel": (512, 5120, 256), "edge": (256, 2560, 128)}[case]
    if case == "edge":
        b = np.zeros((I, J), np.float32)
        b[:3] = np.random.default_rng(5).standard_normal((3, J))
    elif case == "ragged":
        b = np.random.default_rng(6).standard_normal((I, J)).astype(np.float32) / 30
    else:
        b = _gapped(I, J, rank, seed=7)
    return torch.as_tensor(b), rank


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "ragged", "global_panel", "edge"])
def test_kernel_matches_plain_on_card(case, cuda):
    b, rank = _card_input(case)
    b = b.to(cuda)
    before = tsk.rangefinder_split.launches
    q, r = tsk.rangefinder_split(b, rank)
    torch.cuda.synchronize()
    assert tsk.rangefinder_split.launches == before + 1
    qp, rp = tsk.rangefinder_split_plain(b, rank)
    assert q.shape == qp.shape and r.shape == rp.shape
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    q64, p64, b64 = q.double(), qp.double(), b.double()
    bmax = float(b64.abs().max())
    assert float((q64 @ q64.T - p64 @ p64.T).abs().max()) <= CARD_PROJ_TOL
    assert float((q64 @ r.double() - p64 @ rp.double()).abs().max()) <= CARD_REC_TOL * bmax
    eye = torch.eye(rank, dtype=torch.float64, device=cuda)
    assert float((q64.T @ q64 - eye).abs().max()) <= CARD_ISO_TOL


@pytest.mark.cuda
def test_zero_matrix_gives_the_unit_columns_on_card(cuda):
    q, r = tsk.rangefinder_split(torch.zeros((256, 2560), device=cuda), 128)
    assert torch.equal(q, torch.eye(256, 128, device=cuda))
    assert float(r.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "global_panel"])
def test_repeat_launches_are_bit_identical(case, cuda):
    b, rank = _card_input(case)
    b = b.to(cuda)
    q1, r1 = tsk.rangefinder_split(b, rank)
    q2, r2 = tsk.rangefinder_split(b, rank)
    assert torch.equal(q1, q2) and torch.equal(r1, r2)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    b = torch.zeros((16, 40), device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        tsk.rangefinder_split(b.half(), 4)
    with pytest.raises(ValueError, match="rank"):
        tsk.rangefinder_split(b, 17)
    with pytest.raises(ValueError, match="non-empty"):
        tsk.rangefinder_split(torch.zeros((0, 40), device=cuda), 4)
    q, r = tsk.rangefinder_split(b.double().T.contiguous().T, 4)  # float64, strided
    assert q.dtype == r.dtype == torch.float64 and q.shape == (16, 4)
