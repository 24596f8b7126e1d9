"""The rangefinder, gram and cholsvd splits of ``ops/svd.py``, the rangefinder
sweep and the host data helpers of ``data/loader.py``, against the JAX
package on the CPU.

* The splits in float64, with the JAX package's Omega handed to the port,
  compared by ``Q R`` (or ``left @ right``), the projector ``Q Q^T`` and the
  isometry: 1e-9 (both run LAPACK-grade float64 factorisations of the same
  matrices).
* One two-site step with ``svd_method="rangefinder"`` at I = M*D = 128, where
  the JAX package on its chip runs the Pallas kernel K6: JAX runs it here in
  interpret mode, the port its plain version. Float32; the step's
  gauge-invariant outputs agree to 1e-4 of their largest entry (the splits
  agree to ~3e-6, and the step's products add float32 rounding).
* Whole rangefinder sweeps by quality, as every float32 sweep: a right and a
  left sweep land within 2e-2 of max|f| of the JAX package's on the batch and
  on fresh inputs (a 1e-6 difference grows ~100x along a sweep).
"""

import functools

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import sweep as tsw
from tests.test_torch_sweep import _both_sweeps, _invariants, _models, _port, _step_inputs

TOL64 = 1e-9
STEP_TOL = 1e-4
QUALITY_TOL = 2e-2


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
def jax_k6(monkeypatch):
    """Make the JAX package split as it does on its chip: K6 from I = 128
    rows, here in interpret mode. The jitted sweep caches what it traced, so
    the caches are cleared before and after."""
    import jax

    from tensornetworkforml_tpu.ops import svd as jsvd
    from tensornetworkforml_tpu.ops.kernels import split_kernel as jsk

    monkeypatch.setattr(jsvd, "_pallas_split_applicable",
                        lambda bmat, keep, split_mode: split_mode == "canonical"
                        and keep is None and bmat.shape[0] >= 128)
    monkeypatch.setattr(jsk, "rangefinder_split_pallas",
                        functools.partial(jsk.rangefinder_split_pallas, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _gapped(I, J, rank, seed=0, scale=1.0, gap=0.05):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((I, I)))[0]
    V = np.linalg.qr(rng.standard_normal((J, I)))[0]
    s = np.concatenate([np.geomspace(1.0, 0.1, rank),
                        np.geomspace(0.1 * gap, 0.01 * gap, I - rank)])
    return scale * (U * s) @ V.T


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), np.abs(a - b).max()


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.float64)


# ---- the splits in float64 -------------------------------------------------

@pytest.mark.parametrize("case", ["gapped", "scaled_1e10", "scaled_1e-8", "rank_deficient"])
def test_xla_rangefinder_matches_jax(case, jax_omega):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_split

    scale = {"scaled_1e10": 1e10, "scaled_1e-8": 1e-8}.get(case, 1.0)
    b = _gapped(64, 640, 32, scale=scale)
    if case == "rank_deficient":
        b[40:] = 0.0
    jq, jr = (np.asarray(a) for a in _rangefinder_split(jnp.asarray(b), 32))
    q, r = (_np(a) for a in tsvd._rangefinder_split(torch.as_tensor(b), 32))
    _close(q @ r, jq @ jr, TOL64)
    _close(q @ q.T, jq @ jq.T, TOL64)
    _close(q.T @ q, np.eye(32), TOL64)
    assert q.shape == (64, 32) and r.shape == (32, 640)


def test_xla_rangefinder_without_oversampling_room_matches_jax(jax_omega):
    """rank + oversample > I: no Rayleigh-Ritz step, q = I columns."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_split

    b = _gapped(20, 200, 12)
    jq, jr = (np.asarray(a) for a in _rangefinder_split(jnp.asarray(b), 20, n_power=1))
    q, r = (_np(a) for a in tsvd._rangefinder_split(torch.as_tensor(b), 20, n_power=1))
    _close(q @ r, jq @ jr, TOL64)
    _close(q @ q.T, jq @ jq.T, TOL64)


GRAM_CASES = {
    "shared": dict(split_mode="shared"),
    "canonical": dict(split_mode="canonical"),
    "shared_keep": dict(split_mode="shared", keep=5),
    "canonical_keep": dict(split_mode="canonical", keep=5),
    "shared_tall": dict(split_mode="shared", tall=True),
}
CHOLSVD_CASES = {
    "shared": dict(split_mode="shared"),
    "canonical": dict(split_mode="canonical"),
    "canonical_keep": dict(split_mode="canonical", keep=5),
    "shared_adaptive": dict(split_mode="shared", adaptive_tol=1e-3),
    "canonical_adaptive": dict(split_mode="canonical", adaptive_tol=1e-3),
}


def _split_both(method, case_kw, seed):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import truncated_svd_split as jsplit

    kw = dict(case_kw)
    tall = kw.pop("tall", False)
    b = _gapped(16, 120, 8, seed=seed, gap=0.3)
    b[12:] = 0.0  # padded bond slots
    if tall:
        b = b.T.copy()
    keep = kw.pop("keep", None)
    jl, jr = jsplit(jnp.asarray(b), 8, method, keep=None if keep is None else jnp.asarray(keep),
                    **kw)
    tl, tr = tsvd.truncated_svd_split(torch.as_tensor(b), 8, method, keep=keep, **kw)
    return b, (np.asarray(jl), np.asarray(jr)), (_np(tl), _np(tr)), kw["split_mode"]


@pytest.mark.parametrize("case", sorted(GRAM_CASES))
def test_gram_split_matches_jax(case):
    b, (jl, jr), (tl, tr), mode = _split_both("gram", GRAM_CASES[case], seed=len(case))
    _close(tl @ tr, jl @ jr, TOL64)
    if mode == "canonical":
        _close(tl @ tl.T, jl @ jl.T, TOL64)
    assert tl.shape == jl.shape and tr.shape == jr.shape


@pytest.mark.parametrize("case", sorted(CHOLSVD_CASES))
def test_cholsvd_split_matches_jax(case):
    # the jitter (1e-13 of max diag(B B^T)) moves both the same way
    b, (jl, jr), (tl, tr), mode = _split_both("cholsvd", CHOLSVD_CASES[case], seed=len(case))
    _close(tl @ tr, jl @ jr, TOL64)
    if mode == "canonical":
        _close(tl @ tl.T, jl @ jl.T, TOL64)
    live = np.abs(tr).sum(axis=1) > 0
    assert (live == (np.abs(jr).sum(axis=1) > 0)).all()
    assert np.abs(tl[:, ~live]).max(initial=0.0) == 0.0  # no weight past the kept rank


def test_gram_and_cholsvd_reject_what_jax_rejects():
    tall = torch.as_tensor(_gapped(16, 120, 8).T.copy())
    with pytest.raises(ValueError, match="wide"):
        tsvd.truncated_svd_split(tall, 4, "gram", split_mode="canonical")
    with pytest.raises(ValueError, match="wide"):
        tsvd.truncated_svd_split(tall, 4, "cholsvd")
    with pytest.raises(ValueError, match="spectrum"):
        tsvd.truncated_svd_split(tall.T, 4, "gram", adaptive_tol=0.1)


# ---- a step and a sweep through K6's plain version (I = 128) -----------------

RF = dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
          svd_method="rangefinder")


def test_rangefinder_step_at_the_kernel_shape_matches_jax(jax_omega, jax_k6):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import sweep as jsw

    inp = {k: v.astype(np.float32) for k, v in _step_inputs(M=64, L=2, B=8, seed=5).items()}
    calls = []
    real = tsw._svd.truncated_svd_split

    def spy(bmat, *a, **k):
        calls.append(bmat.shape)
        return real(bmat, *a, **k)

    jout = jsw.two_site_update(*[jnp.asarray(v) for v in inp.values()], 0.05, 1e-3,
                               jnp.asarray(64), 0.2, jsw.SweepConfig(**RF))
    tsw.truncated_svd_split, saved = spy, tsw.truncated_svd_split
    try:
        tout = tsw.two_site_update(*[torch.as_tensor(v) for v in inp.values()],
                                   torch.tensor(0.05), torch.tensor(1e-3), 64, 0.2,
                                   tsw.SweepConfig(**RF))
    finally:
        tsw.truncated_svd_split = saved
    assert calls == [(128, 2 * 2 * 64)]
    want, got = _invariants(jout), _invariants(tout)
    for k in want:
        _close(got[k], want[k], STEP_TOL)


def test_rangefinder_sweeps_match_jax_by_quality(jax_omega, jax_k6):
    from tests.test_torch_sweep import _jax_forward

    j, t, x, y = _models(N=8, M=64, L=2, B=16, dtype="float32", seed=3)
    fresh = np.random.default_rng(8).random((16, 8))
    for _ in range(2):  # a right sweep, then a left one from where JAX's ended
        jres, tres = _both_sweeps(j, t, x, y, RF)
        assert tres[0].l_pos == jres[0].l_pos
        _close(tres[2], jres[2], QUALITY_TOL)
        got = mps_forward(tres[0], psi_embed(torch.as_tensor(fresh, dtype=torch.float32)))
        _close(got, _jax_forward(jres[0], fresh), QUALITY_TOL)
        sites = tres[0].sites  # the canonical gauge: isometric left factors
        n_live = sites.shape[0] - 1
        for n in (range(n_live) if tres[0].l_pos == 7 else range(1, 8)):
            a = sites[n].reshape(-1, 64) if tres[0].l_pos == 7 else sites[n].reshape(64, -1).T
            assert float(torch.linalg.matrix_norm(a, ord=2)) <= 1 + 1e-4
        j = jres[0]
        t = _port(j)


# ---- train_model through the port's prepare_dataset ----------------------------

@pytest.mark.parametrize("method", ["rangefinder", "rangefinder_pallas"])
def test_rangefinder_training_equals_svd_quality(method):
    """Canonical training on the diagonals task with the rangefinder split
    (the sketch-QR-eigh path at this I = 16, or K6's plain version) reaches
    the exact SVD's validation accuracy, as in the JAX package's test."""
    from tensornetworkforml_torch.data.diagonals import create_dataset
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.train.trainer import train_model

    data, labels = create_dataset(400, 6, sigma=0.5, seed=0)
    accs = {}
    for m in ("svd", method):
        train_loader, val_loader, _ = prepare_dataset(
            data.reshape(len(data), -1), labels, 0.8, 0.2, train_batch_size=32,
            val_batch_size=64, test_batch_size=64, embed=False, seed=0,
        )
        x_cal, _ = next(train_loader.batches())
        mps = product_init(torch.Generator().manual_seed(0), N=36, M=8, L=2, act_fn="linear",
                           loss_fn="MSE", dtype=torch.float64, calibration_x=x_cal,
                           device="cpu")
        _, val_acc, _ = train_model(
            mps, train_loader, val_loader, lr=0.1, n_epochs=2, weight_dec=1e-5,
            L2_flag=False, split_mode="canonical", svd_method=m, verbose=False,
        )
        accs[m] = val_acc[-1]
    assert accs[method] >= 0.95
    assert abs(accs[method] - accs["svd"]) <= 0.05


# ---- data/loader.py -------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_psi_embed_host_matches_jax(dtype):
    from tensornetworkforml_torch.data.loader import psi_embed_host
    from tensornetworkforml_tpu.data.loader import psi_embed_host as jpsi

    x = np.random.default_rng(0).random((5, 7)).astype(dtype)
    got, want = psi_embed_host(x), jpsi(x)
    assert got.shape == (5, 7, 2) and got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if dtype == np.float32 else 1e-15)


@pytest.mark.parametrize("embed,even", [(False, True), (True, False), (False, False)])
def test_prepare_dataset_matches_jax(embed, even):
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_tpu.data.loader import prepare_dataset as jprep

    rng = np.random.default_rng(1)
    data, labels = rng.random((230, 4, 4)), rng.integers(0, 3, 230)
    args = (data, labels, 0.8, 0.25, 16, 8, 32)
    got = prepare_dataset(*args, embed=embed, seed=4, even_train_batches=even)
    want = jprep(*args, embed=embed, seed=4, even_train_batches=even)
    for tl, jl in zip(got, want):
        assert len(tl) == len(jl)
        for _ in range(2):  # two epochs: the shuffles follow the same seeds
            for (tx, ty), (jx, jy) in zip(tl.batches(), jl.batches()):
                np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-15)
                assert np.array_equal(ty, jy)
    assert len(got[0]) % 2 == 0 or not even
