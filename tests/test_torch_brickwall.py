"""The port's brick-wall trainer (``train/brickwall.py``) against the JAX
package's, on the CPU in float64, with the same inputs made from a seed with
numpy, the JAX model carried across by ``boundary_from_numpy`` and the JAX
package's sketch matrix Omega handed to the port.

The pair splits (batched CholQR or the rangefinder) return an isometry whose
basis inside the kept subspace is a gauge, so layers are compared through
gauge-invariant quantities: the model's scores after the layer on the batch
and on fresh inputs, each pair's re-merged two-site tensor, ``w`` and the
metrics. Tolerance 1e-8 of the largest value (float64 subspace iterations
in another order of summation; ~1e-12 expected).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.boundary import boundary_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import brickwall as tbw
from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy

N, M, L, B = 9, 4, 3, 16  # odd N: the even layer rests site 8, the odd one site 0
TOL = 1e-8


@pytest.fixture(autouse=True)
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


class Batches:
    def __init__(self, x, y, size):
        self.x, self.y, self.size = x, y, size

    def batches(self):
        for lo in range(0, len(self.x), self.size):
            yield self.x[lo:lo + self.size], self.y[lo:lo + self.size]


def _data(n=B, seed=0, n_sites=N):
    rng = np.random.default_rng(seed)
    return rng.random((n, n_sites)), rng.integers(0, L, n)


def _jax_model(seed=0, n_sites=N, m=M, noise=0.2):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_product_init

    return boundary_product_init(jax.random.PRNGKey(seed), N=n_sites, M=m, L=L, noise=noise,
                                 dtype=jnp.float64)


def _carry(j):
    return boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), act_fn=j.act_fn,
                               loss_fn=j.loss_fn, T=j.T, device="cpu")


def _y1h(y):
    return np.eye(L)[y].T


def _scores(sites, w, x):
    from tensornetworkforml_torch.models.boundary import boundary_forward_arrays

    return boundary_forward_arrays(torch.as_tensor(np.array(sites)),
                                   torch.as_tensor(np.array(w)),
                                   psi_embed(torch.as_tensor(x))).numpy()


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= TOL * scale, (what, np.abs(got - want).max() / scale)


def _same_function(t_sites, t_w, j_sites, j_w, xs):
    for x in xs:
        _close(_scores(t_sites, t_w, x), _scores(j_sites, j_w, x), "scores")


VARIANTS = {
    "plain": dict(),
    "line_search": dict(line_search=True),
    "line_search_floor": dict(line_search=True, line_search_relax=1.5),
    "growth_cap": dict(growth_cap=1e-3),
    "no_renorm": dict(renorm=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("split_method", ["cholqr", "rangefinder"])
@pytest.mark.parametrize("parity", [0, 1], ids=["even", "odd"])
def test_brick_layer_matches_jax(parity, split_method, variant):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train.brickwall import BrickConfig as JCfg
    from tensornetworkforml_tpu.train.brickwall import _brick_layer as j_layer

    j = _jax_model(seed=parity)
    x, y = _data(seed=2)
    kw = dict(split_method=split_method, **VARIANTS[variant])
    lr = 0.3 if variant == "growth_cap" else 0.05
    target, wd = _y1h(y), 1e-4
    if variant == "line_search_floor":
        # targets beyond the current output and a decay that beats the
        # gradient: the linearized descent test fails (num <= 0)
        target, wd = 3.0 * _scores(j.sites, j.w, x), 50.0
    phi_t = np.asarray(psi_embed(torch.as_tensor(x)).transpose(0, 1))
    j_sites, jm = j_layer(j.sites, j.w, jnp.asarray(phi_t), jnp.asarray(target), lr, wd,
                          parity, JCfg(**kw), j.T)
    t = _carry(j)
    t_sites, tm = tbw._brick_layer(t.sites, t.w, torch.as_tensor(phi_t),
                                   torch.as_tensor(target), lr, wd, parity,
                                   tbw.BrickConfig(**kw), t.T)
    _same_function(t_sites, t.w, j_sites, j.w, (x, _data(seed=3)[0]))
    js, ts = np.asarray(j_sites), t_sites.numpy()
    K = (N - parity) // 2
    for k in range(K):  # each pair's re-merged two-site tensor
        a = parity + 2 * k
        _close(np.einsum("aim,mjc->aijc", ts[a], ts[a + 1]),
               np.einsum("aim,mjc->aijc", js[a], js[a + 1]), f"pair {k}")
    rest = [n for n in range(N) if not parity <= n < parity + 2 * K]
    np.testing.assert_array_equal(ts[rest], js[rest])  # resting sites untouched
    for k in ("accuracy", "MAE", "gamma"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, atol=1e-15)
    if variant == "line_search_floor":  # the num <= 0 regime takes the floored step
        assert float(tm["gamma"]) == pytest.approx(0.05 * lr)


@pytest.mark.parametrize("split_method", ["cholqr", "rangefinder"])
def test_brick_sweep_matches_jax(split_method):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi
    from tensornetworkforml_tpu.train.brickwall import BrickConfig as JCfg
    from tensornetworkforml_tpu.train.brickwall import brick_sweep as j_sweep

    j = _jax_model(seed=4)
    x, y = _data(seed=5)
    j2, jm = j_sweep(j, j_psi(jnp.asarray(x)), jnp.asarray(_y1h(y)), 0.05, 1e-4,
                     JCfg(split_method=split_method))
    t2, tm = tbw.brick_sweep(_carry(j), psi_embed(torch.as_tensor(x)),
                             torch.as_tensor(_y1h(y)), 0.05, 1e-4,
                             tbw.BrickConfig(split_method=split_method))
    _close(t2.w.numpy(), np.asarray(j2.w), "w")
    _same_function(t2.sites, t2.w, j2.sites, j2.w, (x, _data(seed=6)[0]))
    np.testing.assert_allclose(float(tm["MAE"]), float(jm["MAE"]), rtol=TOL)


def test_brick_epoch_matches_the_per_batch_loop_and_jax():
    from tensornetworkforml_tpu.train.brickwall import brick_epoch as j_epoch

    nb = 3
    rng = np.random.default_rng(7)
    x_ep, y_ep = rng.random((nb, B, N)), rng.integers(0, L, (nb, B))
    j = _jax_model(seed=8)
    t = _carry(j)
    fused, metrics = tbw.brick_epoch(t, x_ep, y_ep, 0.05, 1e-4)
    assert metrics["accuracy"].shape == (nb,) and metrics["gamma"].shape == (nb,)
    looped = t
    cfg = tbw.BrickConfig(act_fn=t.act_fn, loss_fn=t.loss_fn)
    for i in range(nb):
        looped, _ = tbw.brick_sweep(looped, psi_embed(torch.as_tensor(x_ep[i])),
                                    torch.as_tensor(_y1h(y_ep[i])), 0.05, 1e-4, cfg)
    np.testing.assert_allclose(fused.sites.numpy(), looped.sites.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(fused.w.numpy(), looped.w.numpy(), rtol=1e-12, atol=1e-14)
    jf, jm = j_epoch(j, x_ep, y_ep, 0.05, 1e-4)
    _same_function(fused.sites, fused.w, jf.sites, jf.w, (x_ep[0], _data(seed=9)[0]))
    np.testing.assert_allclose(metrics["MAE"].numpy(), np.asarray(jm["MAE"]), rtol=TOL)


@pytest.mark.parametrize("decay", [1.0, 0.8], ids=["epoch_path", "per_batch_path"])
def test_train_brickwall_with_bond_growth_matches_jax(decay):
    from tensornetworkforml_tpu.train.brickwall import train_brickwall as j_train

    x, y = _data(64, seed=10)
    tr, va = Batches(x, y, 16), Batches(*_data(32, seed=11), 16)
    j = _jax_model(seed=12)
    kw = dict(lr=0.05, n_epochs=2, weight_dec=1e-4, lr_sweep_decay=decay,
              bond_schedule={1: M + 2})
    jm, jval = j_train(j, tr, va, **kw)
    tm, tval = tbw.train_brickwall(_carry(j), tr, va, **kw)
    assert tm.M == M + 2 and len(tval) == 2
    np.testing.assert_allclose(tval, jval, rtol=0, atol=1e-6)  # JAX means in float32
    _close(tm.w.numpy(), np.asarray(jm.w), "w")
    _same_function(tm.sites, tm.w, jm.sites, jm.w, (x, _data(seed=13)[0]))
    assert float(tm.sites[:, M:].abs().max()) > 0  # the new bond slots are live


def test_resume_equals_an_uninterrupted_run(tmp_path):
    x, y = _data(48, seed=14)
    tr, va = Batches(x, y, 16), Batches(*_data(16, seed=15), 16)
    t0 = _carry(_jax_model(seed=16))
    kw = dict(lr=0.05, weight_dec=1e-4, lr_sweep_decay=0.9)
    straight, full_val = tbw.train_brickwall(t0, tr, va, n_epochs=2, **kw)
    ck = str(tmp_path / "bw.npz")
    _, first = tbw.train_brickwall(t0, tr, va, n_epochs=1, checkpoint_path=ck, **kw)
    resumed, rest = tbw.train_brickwall(t0, tr, va, n_epochs=2, checkpoint_path=ck,
                                        resume=True, **kw)
    assert first + rest == full_val
    assert torch.equal(resumed.sites, straight.sites) and torch.equal(resumed.w, straight.w)


def test_mesh_forms_raise_naming_item_11():
    """The mesh forms are ported (item 11): in a world of one on the CPU the
    sharded epoch and the sharded step give the single-device results, and
    the functions of the JAX package's mesh forms over one device."""
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel.mesh import make_mesh
    from tensornetworkforml_tpu.parallel.mesh import make_mesh as j_make_mesh
    from tensornetworkforml_tpu.train.brickwall import BrickConfig as JB
    from tensornetworkforml_tpu.train.brickwall import brick_epoch as j_epoch
    from tensornetworkforml_tpu.train.brickwall import make_sharded_brick_step as j_step

    j = _jax_model()
    t = _carry(j)
    x, y = _data()
    cfg = tbw.BrickConfig(act_fn=t.act_fn, loss_fn=t.loss_fn)
    phi, y1h = psi_embed(torch.as_tensor(x)), torch.as_tensor(_y1h(y))
    mesh = make_mesh(device="cpu")
    try:
        epoch, _ = tbw.brick_epoch(t, x[None], y[None], 0.05, 1e-4, mesh=mesh)
        sites, w, _ = tbw.make_sharded_brick_step(mesh, t.T, cfg)(t.sites, t.w, phi, y1h, 0.05,
                                                                  1e-4)
    finally:
        dist.destroy_process_group()
    want, _ = tbw.brick_epoch(t, x[None], y[None], 0.05, 1e-4)
    assert torch.equal(epoch.sites, want.sites) and torch.equal(epoch.w, want.w)
    one, _ = tbw.brick_sweep(t, phi, y1h, 0.05, 1e-4, cfg)
    assert torch.equal(sites, one.sites) and torch.equal(w, one.w)
    j_mesh = j_make_mesh(shape=(1, 1), devices=jax.devices()[:1])
    fresh = (x, _data(seed=9)[0])
    jf, _ = j_epoch(j, x[None], y[None], 0.05, 1e-4, mesh=j_mesh)
    _same_function(epoch.sites, epoch.w, jf.sites, jf.w, fresh)
    js, jw, _ = j_step(j_mesh, j.T, JB(act_fn=j.act_fn, loss_fn=j.loss_fn))(
        j.sites, j.w, jnp.asarray(phi.numpy()), jnp.asarray(_y1h(y)), jnp.float64(0.05),
        jnp.float64(1e-4))
    _same_function(sites, w, js, jw, fresh)


def test_unknown_split_and_reduced_precision_raise():
    t = _carry(_jax_model())
    x, y = _data()
    args = (t, psi_embed(torch.as_tensor(x)), torch.as_tensor(_y1h(y)), 0.05, 1e-4)
    with pytest.raises(ValueError, match="split_method"):
        tbw.brick_sweep(*args, tbw.BrickConfig(split_method="svd"))
    with pytest.raises(NotImplementedError, match="item 9"):
        tbw.brick_sweep(*args, tbw.BrickConfig(matmul_precision="bfloat16"))


def test_brick_sweep_reaches_new_slots_after_growth():
    from tensornetworkforml_torch.models.boundary import grow_boundary_bond

    t = grow_boundary_bond(_carry(_jax_model(seed=17, n_sites=10)), 7)
    x, y = _data(seed=18, n_sites=10)
    before = boundary_forward(t, psi_embed(torch.as_tensor(x)))
    out, _ = tbw.brick_sweep(t, psi_embed(torch.as_tensor(x)), torch.as_tensor(_y1h(y)),
                             0.05, 1e-5)
    assert torch.isfinite(out.sites).all() and float(out.sites[:, M:].abs().max()) > 0
    assert not torch.equal(boundary_forward(out, psi_embed(torch.as_tensor(x))), before)
