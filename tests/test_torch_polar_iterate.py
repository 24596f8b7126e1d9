"""K1, the polar split's subspace iteration: its plain version against the
JAX package's Pallas kernel (interpret mode on the CPU), ``hybrid_polar_split``
against the JAX one, and the CUDA kernel against the plain version on a card.

JAX is imported inside the fixtures and tests, so that the tests marked
``cuda`` run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_polar_iterate.py``.

Tolerance: 1e-5 on the projector ``Q Q^T`` (and on ``Q R`` relative to
max|B|) in float32. The two sides run the same ~60 dependent float32 products
in different summation orders. How far float32 rounding moves the subspace
grows with the spread of the kept spectrum: over half a decade, with a gap of
10 below it (the test matrices here), each float32 version stays within
~9e-6 of a float64 run of the same algorithm; over two decades both drift to
~1e-4 of it, equally. ``hybrid_polar_split`` is held against a float64 run
of the same algorithm (``F64_TOL``; its test says why).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import polar_split as tps

TOL = 1e-5


@pytest.fixture
def jps():
    from tensornetworkforml_tpu.ops.kernels import polar_split

    return polar_split


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the polar kernel has no CPU mode")
    return torch.device("cuda")


def _gapped(I, J, rank, seed, dead_rows=0):
    """A matrix with a kept spectrum over half a decade and a gap of 10 below it."""
    r = np.random.default_rng(seed)
    k = min(I, J)
    u, _ = np.linalg.qr(r.standard_normal((I, k)))
    v, _ = np.linalg.qr(r.standard_normal((J, k)))
    s = np.ones(k)
    s[:rank] = np.logspace(0, -0.5, rank)
    s[rank:] = s[rank - 1] * 0.1 * np.logspace(0, -2, k - rank)
    b = (u * s) @ v.T
    if dead_rows:
        b[I - dead_rows :] = 0.0
    return b.astype(np.float32)


def _sketch(b, q, seed):
    om = np.random.default_rng(seed).standard_normal((b.shape[1], q)).astype(np.float32)
    return (b @ om).astype(np.float32), (b @ b.T).astype(np.float32)


def _proj_err(qa, qb):
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    return np.abs(qa @ qa.T - qb @ qb.T).max()


@pytest.mark.parametrize("I,q", [(16, 8), (40, 12), (64, 32)])
@pytest.mark.parametrize("given_n2", [False, True])
def test_plain_version_matches_pallas(I, q, given_n2, jps):
    import jax.numpy as jnp

    b = _gapped(I, 5 * I, q, seed=I)
    y, g = _sketch(b, q, seed=1)
    n2 = np.array([[float((b.astype(np.float64) ** 2).sum())]], np.float32)
    want = jps.polar_iterate_pallas(
        jnp.asarray(y), jnp.asarray(g), jnp.asarray(n2) if given_n2 else None,
        interpret=True,
    )
    got = tps.polar_iterate_reference(
        torch.as_tensor(y), torch.as_tensor(g), torch.as_tensor(n2) if given_n2 else None
    )
    assert got.shape == (I, q) and got.dtype == torch.float32
    assert _proj_err(got, want) < TOL
    # the wrapper takes the plain version on CPU tensors, and counts no launch
    launches = tps.polar_iterate.launches
    via_wrapper = tps.polar_iterate(
        torch.as_tensor(y), torch.as_tensor(g), torch.as_tensor(n2) if given_n2 else None
    )
    assert tps.polar_iterate.launches == launches
    assert torch.equal(via_wrapper, got)


def test_dead_columns_are_exactly_zero(jps):
    """A zero column of the sketch stays an exactly-zero column of Q."""
    import jax.numpy as jnp

    b = _gapped(32, 160, 16, seed=2)
    y, g = _sketch(b, 16, seed=3)
    y[:, [3, 10]] = 0.0
    got = tps.polar_iterate_reference(torch.as_tensor(y), torch.as_tensor(g))
    want = np.asarray(jps.polar_iterate_pallas(jnp.asarray(y), jnp.asarray(g), interpret=True))
    assert float(got[:, [3, 10]].abs().max()) == 0.0 == np.abs(want[:, [3, 10]]).max()
    assert _proj_err(got, want) < TOL


def test_nan_column_does_not_leak():
    b = _gapped(16, 64, 8, seed=4)
    y, g = _sketch(b, 8, seed=5)
    y[:, 2] = np.nan
    q = tps.polar_iterate_reference(torch.as_tensor(y), torch.as_tensor(g))
    assert not torch.isnan(q).any() and float(q.abs().max()) == 0.0  # NaN max: all dead


# hybrid_polar_split against a float64 run of the same algorithm: each
# package's float32 split to F64_TOL, the two packages to PAIR_TOL (below)
F64_TOL = 2e-5
PAIR_TOL = 2 * F64_TOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dead_rows", [0, 16])
def test_hybrid_polar_split_matches_jax(dtype, dead_rows, jps, jax_omega):
    """Same Omega -> same subspace: projector, reconstruction and isometry;
    dead_tol follows the input dtype in both packages, and both run the
    split in float32 whatever the input dtype.

    Each package's ``Q`` and ``Q R`` are held against a float64 run of the
    same algorithm (the sketch and the Gram formed in float64 from the same
    Omega, ``polar_iterate_reference`` in float64 at the same dead_tol) to
    F64_TOL = 2e-5 on the projector and on ``Q R`` relative to max|B|.
    Measured here (AMD EPYC, torch 2.13 CPU, jax 0.9) at dead_rows=0: the
    port 6.4e-6 on the projector and 1.03e-5 on ``Q R``, the JAX package
    4.6e-6 and 7.0e-6; over seeds 1-8 of the same draw up to 1.7e-5 and
    1.8e-5; at dead_rows=16, 3e-7 for both. The ~9e-6 of the module
    docstring is one machine's draw from that spread. The two packages are
    then held to each other at PAIR_TOL = 2 F64_TOL, the triangle
    inequality's bound from the two float64 holds (measured 7.3e-6 and
    1.12e-5 at dead_rows=0: one float32 split against another at 1e-5 sat
    inside the two packages' combined rounding)."""
    import jax.numpy as jnp

    I, J, rank = 32, 192, 16
    b = _gapped(I, J, rank, seed=6, dead_rows=dead_rows).astype(dtype)
    jq, jr = jps.hybrid_polar_split(jnp.asarray(b), rank, interpret=True)
    tq, tr = tps.hybrid_polar_split(torch.as_tensor(b), rank)
    assert tq.dtype == getattr(torch, dtype) and tq.shape == (I, rank) and tr.shape == (rank, J)
    b64 = torch.as_tensor(b, dtype=torch.float64)
    om = tsvd.rangefinder_omega(J, rank, torch.float64)
    q64 = tps.polar_iterate_reference(b64 @ om, b64 @ b64.T,
                                      dead_tol=1e-6 if dtype == "float32" else 1e-12)
    qr64 = (q64 @ (q64.T @ b64)).numpy()

    def rec_err(q, r):
        qr = np.asarray(q, np.float64) @ np.asarray(r, np.float64)
        return np.abs(qr - qr64).max() / np.abs(b).max()

    for q, r in ((tq.double().numpy(), tr.double().numpy()), (jq, jr)):
        assert _proj_err(q, q64) < F64_TOL
        assert rec_err(q, r) < F64_TOL
    assert _proj_err(tq, jq) < PAIR_TOL
    rec = np.abs((tq @ tr).double().numpy() - np.asarray(jq, np.float64) @ np.asarray(jr))
    assert rec.max() / np.abs(b).max() < PAIR_TOL
    norms = torch.linalg.vector_norm(tq.double(), dim=0)
    live = norms > 0.5
    iso = tq.double()[:, live].T @ tq.double()[:, live] - torch.eye(int(live.sum()),
                                                                    dtype=torch.float64)
    assert float(iso.abs().max()) < 1e-4
    if dead_rows:
        assert float(tq[I - dead_rows :].abs().max()) == 0.0


def test_polar_method_dispatches_to_the_hybrid_split(jax_omega):
    b = torch.as_tensor(_gapped(16, 96, 8, seed=7))
    q1, r1 = tsvd.truncated_svd_split(b, 8, "polar", split_mode="canonical")
    q2, r2 = tps.hybrid_polar_split(b, 8)
    assert torch.equal(q1, q2) and torch.equal(r1, r2)
    q3, _ = tps.hybrid_polar_split(b[:4], 8)  # rank above I: dead slots padded
    assert q3.shape == (4, 8) and float(q3[:, 4:].abs().max()) == 0.0


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    y, g = torch.zeros((4, 2)), torch.eye(4)
    with pytest.raises(ValueError, match="CUDA"):
        tps.polar_iterate(y.to("meta"), g.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tps.polar_iterate(y, g.to("meta"))


# On the card: ragged shapes, the flagship (I = 256, q = 128), q = 200 (13 of
# the cluster form's 16 CTAs own live columns, the last one 8 of its 16), the
# hybrid step at M = 256 (I = 512, q = 256: the cluster form's largest
# output tile), a ragged I that is not a multiple of 4 (g read without
# float4s) and the hybrid split at M = 384 (I = 768, q = 384: the streaming
# form).
CUDA_CASES = [(16, 8), (40, 24), (256, 128), (320, 200), (512, 256), (301, 77), (768, 384)]
# the two main-path shapes: the flagship and the hybrid step at M = 256
MAIN_SHAPES = [(256, 128), (512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("I,q", CUDA_CASES)
@pytest.mark.parametrize("given_n2", [False, True])
def test_kernel_matches_plain_on_card(I, q, given_n2, cuda):
    b = _gapped(I, 5 * I, q, seed=I)
    y, g = _sketch(b, q, seed=1)
    yt, gt = torch.as_tensor(y, device=cuda), torch.as_tensor(g, device=cuda)
    n2 = torch.as_tensor([[float((b.astype(np.float64) ** 2).sum())]], device=cuda)
    n2 = n2.float() if given_n2 else None
    launches = tps.polar_iterate.launches
    got = tps.polar_iterate(yt, gt, n2)
    torch.cuda.synchronize()
    assert tps.polar_iterate.launches == launches + 1
    # against a float64 run of the same algorithm: the kernel must be as close
    # to it as the float32 plain version (which runs cuBLAS products in yet
    # another order) is, within a factor of 2, and within TOL
    want32 = tps.polar_iterate_reference(yt, gt, n2)
    want64 = tps.polar_iterate_reference(yt.double(), gt.double(),
                                         None if n2 is None else n2.double())
    assert got.shape == (I, q) and torch.isfinite(got).all()
    err, err_plain = _proj_err(got.cpu(), want64.cpu()), _proj_err(want32.cpu(), want64.cpu())
    assert err <= max(2 * err_plain, TOL), (err, err_plain)
    yt[:, 1] = 0.0
    dead = tps.polar_iterate(yt, gt, n2)
    assert float(dead[:, 1].abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    y = torch.zeros((8, 4), device=cuda)
    g = torch.eye(8, device=cuda)
    with pytest.raises(TypeError):
        tps.polar_iterate(y.double(), g.double())
    with pytest.raises(ValueError):
        tps.polar_iterate(y, g[:4])  # g not (I, I)
    with pytest.raises(ValueError):
        tps.polar_iterate(torch.zeros((4, 8), device=cuda).T, g)  # not contiguous
    with pytest.raises(ValueError):
        tps.polar_iterate(y, g.cpu())  # mixed devices


def _card_inputs(I, q, cuda, seed=None, dead_rows=0):
    b = _gapped(I, 5 * I, q, seed=I if seed is None else seed, dead_rows=dead_rows)
    y, g = _sketch(b, q, seed=1)
    return torch.as_tensor(y, device=cuda), torch.as_tensor(g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("I,q", MAIN_SHAPES)
def test_kernel_repeats_are_bit_identical(I, q, cuda):
    """Every cross-CTA sum runs in one fixed order: two launches on the same
    inputs give the same bits."""
    yt, gt = _card_inputs(I, q, cuda)
    first = tps.polar_iterate(yt, gt)
    second = tps.polar_iterate(yt, gt)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("I,q", MAIN_SHAPES)
@pytest.mark.parametrize("what", ["nan_column", "zero_y"])
def test_kernel_nan_column_and_zero_y(I, q, what, cuda):
    """A NaN column makes the largest column norm NaN, so every column is dead
    and Q is exactly zero; an all-zero y gives an all-zero Q. Both finite, as
    the plain version gives them."""
    yt, gt = _card_inputs(I, q, cuda)
    if what == "nan_column":
        yt[:, q // 3] = float("nan")
    else:
        yt.zero_()
    got = tps.polar_iterate(yt, gt)
    torch.cuda.synchronize()
    want = tps.polar_iterate_reference(yt, gt)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    assert float(got.abs().max()) == 0.0 == float(want.abs().max())


@pytest.mark.cuda
def test_kernel_ragged_with_dead_columns_on_card(cuda):
    """A ragged shape (I not a multiple of 4, q = 77 spread over 10 CTAs, the
    last with 5 live of its 8 columns) whose B has dead rows and whose sketch
    has three zero columns: those stay exactly zero, and the rest is as close
    to a float64 run as the float32 plain version is."""
    I, q = 301, 77
    yt, gt = _card_inputs(I, q, cuda, seed=9, dead_rows=24)
    dead = [3, 40, q - 1]
    yt[:, dead] = 0.0
    got = tps.polar_iterate(yt, gt)
    torch.cuda.synchronize()
    want32 = tps.polar_iterate_reference(yt, gt)
    want64 = tps.polar_iterate_reference(yt.double(), gt.double())
    assert got.shape == (I, q) and torch.isfinite(got).all()
    assert float(got[:, dead].abs().max()) == 0.0
    assert float(got[I - 24 :].abs().max()) == 0.0
    err, err_plain = _proj_err(got.cpu(), want64.cpu()), _proj_err(want32.cpu(), want64.cpu())
    assert err <= max(2 * err_plain, TOL), (err, err_plain)
