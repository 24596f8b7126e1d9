"""The port's one-site trainer (``train/onesite.py``) against the JAX
package's, on the CPU in float64, with the same inputs made from a seed with
numpy and the JAX model carried across by ``boundary_from_numpy``.

The QR that moves the center fixes column signs by LAPACK's convention in
both packages, but the sweep is compared only through gauge-invariant
quantities: the swept model's scores on fresh inputs, the output projection
``w`` (updated from the full-chain environment, which no gauge moves) and
the per-step metrics. Tolerance 1e-9 of the largest score (a 12-site sweep
of float64 QRs and products in another order; ~1e-13 expected).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.boundary import boundary_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import onesite as tos
from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy

N, M, L, B = 12, 5, 3, 32
TOL = 1e-9


class Batches:
    """A loader of fixed numpy batches, the same for both packages."""

    def __init__(self, x, y, size):
        self.x, self.y, self.size = x, y, size

    def batches(self):
        for lo in range(0, len(self.x), self.size):
            yield self.x[lo:lo + self.size], self.y[lo:lo + self.size]


def _data(n=B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, N)), rng.integers(0, L, n)


def _jax_model(seed=0, noise=0.1):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_product_init

    return boundary_product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, noise=noise,
                                 dtype=jnp.float64, calibration_x=_data()[0])


def _carry(j):
    return boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), act_fn=j.act_fn,
                               loss_fn=j.loss_fn, T=j.T, device="cpu")


def _phi_y1h(x, y):
    phi = psi_embed(torch.as_tensor(x))
    y1h = torch.zeros((L, len(y)), dtype=torch.float64)
    y1h[torch.as_tensor(y), torch.arange(len(y))] = 1.0
    return phi, y1h


def _assert_same(t, j, x_fresh):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_forward as j_fwd
    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi

    want = np.asarray(j_fwd(j, j_psi(jnp.asarray(x_fresh))))
    got = boundary_forward(t, psi_embed(torch.as_tensor(x_fresh))).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale, np.abs(got - want).max() / scale
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=0, atol=TOL * np.abs(j.w).max())


@pytest.mark.parametrize("left_dir", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("renorm", [False, True], ids=["plain", "renorm"])
@pytest.mark.parametrize("act_fn,loss_fn", [("linear", "MSE"), ("softmax", "cross_entropy")])
def test_sweep_matches_jax(left_dir, renorm, act_fn, loss_fn):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi
    from tensornetworkforml_tpu.train.onesite import OneSiteConfig as JCfg
    from tensornetworkforml_tpu.train.onesite import onesite_sweep as j_sweep

    j = _jax_model(seed=1).replace(act_fn=act_fn, loss_fn=loss_fn)
    t = _carry(j)
    x, y = _data(seed=2)
    phi, y1h = _phi_y1h(x, y)
    jcfg = JCfg(act_fn=act_fn, loss_fn=loss_fn, renorm=renorm)
    tcfg = tos.OneSiteConfig(act_fn=act_fn, loss_fn=loss_fn, renorm=renorm)
    lr = 0.1 if loss_fn == "MSE" else 0.01
    j2, jm = j_sweep(j, j_psi(jnp.asarray(x)), jnp.asarray(y1h.numpy()), lr, 1e-4, left_dir, jcfg)
    t2, tm = tos.onesite_sweep(t, phi, y1h, lr, 1e-4, left_dir, tcfg)
    _assert_same(t2, j2, _data(seed=3)[0])
    for k in ("accuracy", "MAE"):
        assert tm[k].shape == (N,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=0, atol=TOL)
    # the swept sites are scaled isometries, as in the JAX package
    s = t2.sites.numpy()
    for n in (range(1, N) if left_dir else range(N - 1)):
        A = s[n].reshape(M, -1) if left_dir else s[n].reshape(-1, M)
        P = A @ A.T if left_dir else A.T @ A
        g2 = np.trace(P) / M
        np.testing.assert_allclose(P, g2 * np.eye(M), atol=1e-10 * g2)


def test_a_sweep_at_zero_rate_only_regauges():
    t = _carry(_jax_model(seed=4))
    x, y = _data(seed=5)
    phi, y1h = _phi_y1h(x, y)
    cfg = tos.OneSiteConfig(update_w=False)
    want = boundary_forward(t, phi)
    for left_dir in (False, True):
        t2, _ = tos.onesite_sweep(t, phi, y1h, 0.0, 0.0, left_dir, cfg)
        assert float((boundary_forward(t2, phi) - want).abs().max()) <= TOL * float(
            want.abs().max())


def test_reduced_precision_raises_naming_item_9():
    """Reduced precision is ported (``utils/precision.py``): on the CPU
    ``"bfloat16"`` gives the float32 sweep bit for bit, and a name outside
    the table raises."""
    t = _carry(_jax_model())
    phi, y1h = _phi_y1h(*_data())
    got, _ = tos.onesite_sweep(t, phi, y1h, 0.1, 0.0, False,
                               tos.OneSiteConfig(matmul_precision="bfloat16"))
    want, _ = tos.onesite_sweep(t, phi, y1h, 0.1, 0.0, False, tos.OneSiteConfig())
    assert torch.equal(got.sites, want.sites) and torch.equal(got.w, want.w)
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tos.onesite_sweep(t, phi, y1h, 0.1, 0.0, False,
                          tos.OneSiteConfig(matmul_precision="bf16"))


def _train_both(j, n_epochs, **kw):
    from tensornetworkforml_tpu.train.onesite import train_boundary_model as j_train

    x, y = _data(96, seed=6)
    xv, yv = _data(48, seed=7)
    tr, va = Batches(x, y, 32), Batches(xv, yv, 24)
    jm, jval = j_train(j, tr, va, lr=0.1, n_epochs=n_epochs, **kw)
    tm, tval = tos.train_boundary_model(_carry(j), tr, va, lr=0.1, n_epochs=n_epochs, **kw)
    return (tm, tval), (jm, jval)


def test_train_boundary_model_two_epochs_matches_jax():
    (tm, tval), (jm, jval) = _train_both(_jax_model(seed=8), 2, lr_sweep_decay=0.9)
    assert len(tval) == 2
    # the same counts of right answers; the JAX package averages them in
    # float32, so its means carry float32 rounding
    np.testing.assert_allclose(tval, jval, rtol=0, atol=1e-6)
    _assert_same(tm, jm, _data(seed=9)[0])


def test_resume_equals_an_uninterrupted_run(tmp_path):
    t0 = _carry(_jax_model(seed=10))
    x, y = _data(96, seed=11)
    tr, va = Batches(x, y, 32), Batches(*_data(24, seed=12), 24)
    kw = dict(lr=0.1, lr_sweep_decay=0.9, weight_dec=1e-4)
    full, full_val = tos.train_boundary_model(t0, tr, va, n_epochs=3, **kw)
    ck = str(tmp_path / "ck.npz")
    _, first = tos.train_boundary_model(t0, tr, va, n_epochs=2, checkpoint_path=ck, **kw)
    resumed, rest = tos.train_boundary_model(t0, tr, va, n_epochs=3, checkpoint_path=ck,
                                             resume=True, **kw)
    assert first + rest == full_val and len(rest) == 1
    # an odd number of sweeps per epoch: the resumed run must keep the
    # direction and the decay's sweep counter
    assert torch.equal(resumed.sites, full.sites) and torch.equal(resumed.w, full.w)
