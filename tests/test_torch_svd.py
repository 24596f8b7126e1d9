"""The port's splits (``ops/svd.py``) against the JAX package's, on the CPU.

Splits are compared through gauge-invariant quantities: the reconstruction
``left @ right`` and, for the canonical gauge, the projector ``U U^T``.
The cholqr split sketches with the JAX package's Omega (the two packages'
generators differ), handed to the port by monkeypatching
``rangefinder_omega``.

Tolerances: float64 1e-9 (both run LAPACK-grade float64 factorisations of
the same matrix); the Polar Express coefficients 1e-12 (the same host NumPy
computation).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import polar_split as tps

TOL64 = 1e-9


@pytest.fixture
def jsvd():
    from tensornetworkforml_tpu.ops import svd

    return svd


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


def _bmat(I, J, seed, rank_deficient=False):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((I, J))
    if rank_deficient:
        b[I // 2 :] = 0.0  # dead rows: padded bond slots
    return b


def _close(a, b, tol=TOL64):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("split_mode", ["shared", "canonical"])
@pytest.mark.parametrize("cap", ["none", "keep", "adaptive"])
def test_svd_split_matches_jax(split_mode, cap, jsvd):
    import jax.numpy as jnp

    b = _bmat(16, 48, seed=3) * np.logspace(0, -3, 16)[:, None]  # a decaying spectrum
    kw = {"none": {}, "keep": {"keep": 5}, "adaptive": {"adaptive_tol": 1e-2}}[cap]
    jl, jr = jsvd.truncated_svd_split(jnp.asarray(b), 8, "svd", split_mode=split_mode, **kw)
    tl, tr = tsvd.truncated_svd_split(torch.as_tensor(b), 8, "svd", split_mode=split_mode,
                                      **kw)
    assert tl.shape == (16, 8) and tr.shape == (8, 48)
    _close(tl @ tr, np.asarray(jl) @ np.asarray(jr))
    if split_mode == "canonical":
        _close(tl @ tl.T, np.asarray(jl) @ np.asarray(jl).T)
    live = int((tr.abs().sum(dim=1) > 0).sum())
    assert live == int((np.abs(np.asarray(jr)).sum(axis=1) > 0).sum())
    assert live == {"none": 8, "keep": 5}.get(cap, live) and 0 < live


def test_ops_exports_truncated_svd_split_as_the_jax_package_does():
    """``truncated_svd_split`` is public in ``ops`` (``__all__`` and the name),
    as in the JAX package, and is the split above: its reconstruction matches
    the JAX package's export on the same matrix."""
    import jax.numpy as jnp

    import tensornetworkforml_torch.ops as tops
    import tensornetworkforml_tpu.ops as jops
    from tensornetworkforml_torch.ops import truncated_svd_split

    assert "truncated_svd_split" in tops.__all__ and "truncated_svd_split" in jops.__all__
    assert truncated_svd_split is tsvd.truncated_svd_split
    b = _bmat(12, 30, seed=5)
    jl, jr = jops.truncated_svd_split(jnp.asarray(b), 6, "svd")
    tl, tr = truncated_svd_split(torch.as_tensor(b), 6, "svd")
    _close(tl @ tr, np.asarray(jl) @ np.asarray(jr))


def test_adaptive_mask_matches_jax(jsvd):
    import jax.numpy as jnp

    s = np.array([5.0, 3.0, 1.0, 0.1, 0.01, 0.0])
    for tol in (1e-1, 1e-3, 1e-6):
        want = np.asarray(jsvd._adaptive_energy_mask(jnp.asarray(s), tol))
        got = tsvd._adaptive_energy_mask(torch.as_tensor(s), tol).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank_deficient", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cholqr_split_matches_jax(rank_deficient, dtype, jsvd, jax_omega):
    import jax.numpy as jnp

    b = _bmat(16, 80, seed=5, rank_deficient=rank_deficient)
    jq, jr = jsvd.truncated_svd_split(jnp.asarray(b, dtype=dtype), 8, "cholqr",
                                      split_mode="canonical")
    tq, tr = tsvd.truncated_svd_split(torch.as_tensor(b).to(getattr(torch, dtype)), 8,
                                      "cholqr", split_mode="canonical")
    jq, jr = np.asarray(jq, np.float64), np.asarray(jr, np.float64)
    tol = TOL64 if dtype == "float64" else 1e-4
    _close(tq.double() @ tq.double().T, jq @ jq.T, tol)
    _close(tq.double() @ tr.double(), jq @ jr, tol)
    if rank_deficient:  # dead rows stay exactly dead
        assert float(tq[8:].abs().max()) == 0.0


def test_cholqr_helpers_match_jax(jsvd):
    for dtype, jdt in ((torch.float32, "float32"), (torch.float64, "float64")):
        import jax.numpy as jnp

        for q in (8, 128, 512):
            assert tsvd._cholqr_eps(dtype, q) == jsvd._cholqr_eps(getattr(jnp, jdt), q)


def test_split_rejections_name_their_reasons():
    b = torch.as_tensor(_bmat(8, 24, seed=1))
    for method in ("cholqr", "polar"):
        with pytest.raises(ValueError, match="canonical"):
            tsvd.truncated_svd_split(b, 4, method, split_mode="shared")
        with pytest.raises(ValueError, match="reference"):
            tsvd.truncated_svd_split(b, 4, method, keep=2, split_mode="canonical")
    with pytest.raises(ValueError, match="spectrum"):
        tsvd.truncated_svd_split(b, 4, "polar", split_mode="canonical", adaptive_tol=0.1)
    with pytest.raises(ValueError, match="unknown"):
        tsvd.truncated_svd_split(b, 4, "qr")


@pytest.mark.parametrize("method", ["gram", "cholsvd", "rangefinder", "rangefinder_pallas"])
def test_remaining_methods_split_like_the_exact_svd(method):
    """The four methods that raised until they were ported give an isometric
    left factor and the exact SVD's truncation on a matrix whose spectrum
    drops by 1e4 after the rank (float64; the rangefinder methods capture
    the subspace to ~(1e-4)^(2 n_iter))."""
    rng = np.random.default_rng(1)
    u = np.linalg.qr(rng.standard_normal((8, 8)))[0]
    v = np.linalg.qr(rng.standard_normal((24, 8)))[0]
    b = torch.as_tensor((u * [3.0, 2.0, 1.5, 1.0, 1e-4, 1e-4, 1e-5, 1e-5]) @ v.T)
    q, r = tsvd.truncated_svd_split(b, 4, method, split_mode="canonical")
    us, rs = tsvd.truncated_svd_split(b, 4, "svd", split_mode="canonical")
    assert q.shape == (8, 4) and r.shape == (4, 24) and q.dtype == torch.float64
    _close(q.T @ q, np.eye(4), 1e-6 if method == "rangefinder_pallas" else TOL64)
    _close(q @ r, us @ rs, 1e-6)


def test_omega_is_cached_and_fixed_by_its_seed():
    a = tsvd.rangefinder_omega(40, 6, torch.float32, "cpu")
    assert a is tsvd.rangefinder_omega(40, 6, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0x52464E44)
    assert torch.equal(a, torch.randn((40, 6), generator=g))
    assert tsvd.rangefinder_omega(40, 6, torch.float64, "cpu").dtype == torch.float64


@pytest.mark.parametrize("schedule", ["loop", "final", "gramfree"])
def test_polar_express_schedule_matches_jax(schedule):
    from tensornetworkforml_tpu.ops.kernels import polar_split as jps

    args = {"loop": jps._PE_LOOP, "final": jps._PE_FINAL, "gramfree": (1e-8, 1e-7)}[schedule]
    assert tps._PE_LOOP == jps._PE_LOOP and tps._PE_FINAL == jps._PE_FINAL
    want = np.asarray(jps._pe_schedule(*args))
    got = np.asarray(tps._pe_schedule(*args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if schedule != "gramfree":  # the pass counts the kernel runs at the defaults
        assert len(got) == {"loop": 5, "final": 14}[schedule]
