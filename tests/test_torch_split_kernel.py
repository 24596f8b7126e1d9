"""K6, the rangefinder split kernel (``ops/kernels/split_kernel.py``):
``hqr_orth`` and ``rangefinder_split_plain`` against the JAX package's
``_hqr_orth`` and ``rangefinder_split_pallas`` (interpret mode) on the CPU,
the dispatch of ``svd_method="rangefinder"`` by shape (K6 from 128 to 2048
rows, ``_rangefinder_split`` elsewhere), and the CUDA kernel against its plain
version on a card.

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
  limits K1 is held to (measured at most 1.9e-6 on these shapes);
* the blocked Householder QR of the card kernel (panels of NB columns, T by
  larft, the trailing and the accumulation updates as products), emulated
  here: in float64 against ``hqr_orth`` 1e-12 on Q itself (it re-associates
  the same reflectors; measured ~1e-15); in float32 against JAX's
  ``_hqr_orth`` by the projector and the isometry at K1's limits above.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import split_kernel as tsk

HQR_TOL = 1e-5
SPLIT_TOL = 1e-4
CARD_PROJ_TOL, CARD_REC_TOL, CARD_ISO_TOL = 1e-3, 1e-4, 1e-4
BLOCKED_F64_TOL = 1e-12
NB = 8  # the card kernel's panel width (csrc/rangefinder_split.cu)


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


def _blocked_hqr(y, nb=NB, eps=1e-30):
    """The card kernel's orthonormalisation, in torch in the dtype of ``y``:
    Householder QR in panels of ``nb`` columns (geqrf). A panel's reflectors
    are formed one after another as in ``hqr_orth`` and applied to the
    panel's own later columns; T comes from larft (``H_0 ... H_{w-1} =
    I - V T V^T``); the later columns take the panel at once, ``C -= V T^T
    V^T C``. Then Q = H_0 ... H_{q-1} [I_q; 0] by panels from the last
    (orgqr), ``C -= V T V^T C`` on the columns from the panel on. A dead
    reflector (``|v|^2 <= eps``) has beta = 0, and the kernel stores 0 on its
    diagonal."""
    I, q = y.shape
    a = y.clone()
    panels = []
    for kb in range(0, q, nb):
        w = min(nb, q - kb)
        V = torch.zeros((I - kb, w), dtype=y.dtype)
        betas = []
        for j in range(w):
            x = a[kb + j:, kb + j]
            tail = torch.dot(x[1:], x[1:])
            sigma = torch.sqrt(x[0] * x[0] + tail)
            v = x.clone()
            v[0] = x[0] + torch.sign(x[0] + eps) * sigma  # x0 - alpha
            vn2 = v[0] * v[0] + tail
            live = bool(vn2 > eps)
            beta = 2.0 / torch.clamp(vn2, min=eps) if live else torch.zeros((), dtype=y.dtype)
            if live:
                blk = a[kb + j:, kb + j + 1:kb + w]
                blk.sub_(torch.outer(beta * v, v @ blk))
            else:
                v[0] = 0.0
            V[j:, j] = v
            betas.append(beta)
        T = torch.zeros((w, w), dtype=y.dtype)
        for j in range(w):
            T[j, j] = betas[j]
            if j:
                T[:j, j] = -betas[j] * (T[:j, :j] @ (V[:, :j].T @ V[:, j]))
        trail = a[kb:, kb + w:]
        trail.sub_(V @ (T.T @ (V.T @ trail)))
        panels.append((kb, V, T))
    qacc = torch.eye(I, q, dtype=y.dtype)
    for kb, V, T in reversed(panels):
        blk = qacc[kb:, kb:]
        blk.sub_(V @ (T @ (V.T @ blk)))
    return qacc


def _blocked_inputs(case):
    """A random panel; one with exactly dead columns (zero columns, and the
    columns past an edge step's live rows) and a column whose leading entry
    is exactly 0; the zero matrix; a q that NB does not
    divide (the flagship's q = 136 = 17 NB, so a ragged 69 here)."""
    rng = np.random.default_rng(11)
    if case == "random":
        return rng.standard_normal((96, 40))
    if case == "dead":
        y = rng.standard_normal((64, 24))
        y[0, 0] = 0.0  # x0 = 0: sign(0 + eps) = +1
        y[:, [5, 9]] = 0.0  # dead reflectors inside the live block
        y[12:] = 0.0  # an edge step: columns past the 12 live rows are e_j exactly
        return y
    if case == "zero":
        return np.zeros((48, 20))
    return rng.standard_normal((200, 69))


@pytest.mark.parametrize("case", ["random", "dead", "zero", "ragged_q"])
def test_blocked_householder_matches_hqr_orth_in_float64(case):
    y = torch.as_tensor(_blocked_inputs(case))
    got, want = _blocked_hqr(y), tsk.hqr_orth(y)
    if case == "zero":
        assert torch.equal(got, torch.eye(*y.shape, dtype=torch.float64))
    assert float((got - want).abs().max()) <= BLOCKED_F64_TOL
    if case == "dead":  # the columns past the live rows are unit vectors, exactly
        assert torch.equal(got[:, 12:], torch.eye(*y.shape, dtype=torch.float64)[:, 12:])


@pytest.mark.parametrize("case", ["random", "dead", "zero", "ragged_q"])
def test_blocked_householder_matches_jax_in_float32(case):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.split_kernel import _hqr_orth

    y = _blocked_inputs(case).astype(np.float32)
    got = _blocked_hqr(torch.as_tensor(y)).double().numpy()
    want = np.asarray(_hqr_orth(jnp.asarray(y)), np.float64)
    if case == "zero":
        assert np.array_equal(got, np.eye(*y.shape))
    assert np.abs(got @ got.T - want @ want.T).max() <= CARD_PROJ_TOL
    assert np.abs(got.T @ got - np.eye(y.shape[1])).max() <= CARD_ISO_TOL


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


def _route(monkeypatch):
    """Spy on both rangefinder splits; returns the list of routes taken."""
    calls = []
    monkeypatch.setattr(tsk, "rangefinder_split", lambda b, r: calls.append("kernel") or (b, r))
    monkeypatch.setattr(tsvd, "_rangefinder_split",
                        lambda b, r, *a: calls.append("xla") or (b, r))
    return calls


@pytest.mark.parametrize("method,I,route", [
    ("rangefinder", 127, "xla"), ("rangefinder", 128, "kernel"),
    ("rangefinder_pallas", 40, "kernel"), ("rangefinder_pallas", 128, "kernel"),
    ("rangefinder", 2048, "kernel"), ("rangefinder", 2049, "xla"),
    ("rangefinder_pallas", 2049, "kernel"),
])
def test_rangefinder_methods_dispatch_by_shape(method, I, route, monkeypatch):
    calls = _route(monkeypatch)
    tsvd.truncated_svd_split(torch.zeros((I, 8)), 8, method, split_mode="canonical")
    assert calls == [route]


@pytest.mark.parametrize("I,route", [(127, "xla"), (128, "kernel"), (200, "kernel"),
                                     (201, "xla")])
def test_rangefinder_takes_the_plain_split_above_the_kernel_rows(I, route, monkeypatch):
    """The dispatch reads the kernel's row limit from ``_RANGEFINDER_KERNEL_MAX_I``
    (patched small here), by shape alone, on every device."""
    monkeypatch.setattr(tsvd, "_RANGEFINDER_KERNEL_MAX_I", 200)
    calls = _route(monkeypatch)
    tsvd.truncated_svd_split(torch.zeros((I, 8)), 8, "rangefinder", split_mode="canonical")
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
    ragged one, I = 512 (rank 256, a rangefinder step at M = 256; its columns
    lived in global memory before the cluster kernel and stay in the
    cluster's shared memory now, the case keeps its name), an edge step with
    three live rows, a q = 69 that the panel width 8 does not divide, and
    I = 1024 (q = 308), whose columns do not fit in the cluster's shared
    memory and live in global memory."""
    I, J, rank = {"flagship": (256, 2560, 128), "ragged": (130, 1000, 60),
                  "global_panel": (512, 5120, 256), "edge": (256, 2560, 128),
                  "ragged_q": (200, 1500, 61), "global_columns": (1024, 4096, 300)}[case]
    if case == "edge":
        b = np.zeros((I, J), np.float32)
        b[:3] = np.random.default_rng(5).standard_normal((3, J))
    elif case == "ragged":
        b = np.random.default_rng(6).standard_normal((I, J)).astype(np.float32) / 30
    else:
        b = _gapped(I, J, rank, seed=7)
    return torch.as_tensor(b), rank


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "ragged", "global_panel", "edge", "ragged_q",
                                  "global_columns"])
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
def test_kernel_keeps_the_columns_where_they_fit_on_card(cuda):
    """The cluster holds the columns of the flagship and the I = 512 iterate
    in shared memory, and those of I = 1024, q = 308 in global memory; past
    the rows its panels can be factored in, the wrapper raises."""
    lib = tsk._lib()
    assert lib.tnml_rangefinder_resident(256, 136) == 1
    assert lib.tnml_rangefinder_resident(512, 264) == 1
    assert lib.tnml_rangefinder_resident(1024, 308) == 0
    rows = lib.tnml_rangefinder_max_rows()
    with pytest.raises(ValueError, match="rows"):
        tsk.rangefinder_split(torch.zeros((rows + 1, 16), device=cuda), 4)


@pytest.mark.cuda
def test_the_dispatch_row_limit_is_the_kernels_on_card(cuda):
    assert tsvd._RANGEFINDER_KERNEL_MAX_I == tsk._lib().tnml_rangefinder_max_rows()


@pytest.mark.cuda
def test_rangefinder_splits_above_the_kernel_rows_on_card(cuda):
    """``svd_method="rangefinder"`` at I = 2049, one row past K6's, returns
    a split on the card (``_rangefinder_split``), held to K1's limits against
    a float64 exact split: the projector 1e-3, ``Q R`` 1e-4 of max|B| and
    the isometry 1e-4."""
    I, J, rank = 2049, 2560, 32
    b = torch.as_tensor(_gapped(I, J, rank, seed=9)).to(cuda)
    before = tsk.rangefinder_split.launches
    q, r = tsvd.truncated_svd_split(b, rank, "rangefinder", split_mode="canonical")
    torch.cuda.synchronize()
    assert tsk.rangefinder_split.launches == before  # not K6
    assert q.shape == (I, rank) and r.shape == (rank, J) and q.device.type == "cuda"
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    b64 = b.double()
    u = torch.linalg.svd(b64, full_matrices=False)[0][:, :rank]
    q64 = q.double()
    assert float((q64 @ q64.T - u @ u.T).abs().max()) <= CARD_PROJ_TOL
    bmax = float(b64.abs().max())
    assert float((q64 @ r.double() - u @ (u.T @ b64)).abs().max()) <= CARD_REC_TOL * bmax
    eye = torch.eye(rank, dtype=torch.float64, device=cuda)
    assert float((q64.T @ q64 - eye).abs().max()) <= CARD_ISO_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "global_panel", "ragged_q", "global_columns"])
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
