"""The port's autodiff trainers (``train/autodiff.py``), the ring
(``models/ring.py``), the probe init (``models/probe_init.py``) and the
ensemble (``models/ensemble.py``) against the JAX package's, on the CPU in
float64, with the JAX models carried across by ``mps_from_numpy``,
``boundary_from_numpy`` and ``ensemble_from_numpy``.

Tolerances: optimiser steps against optax 1e-10 of the largest parameter
and of the loss (the same float64 gradients summed in another order; Adam's
first step divides each gradient by its own size, which keeps relative
rounding relative); forwards 1e-12 of the largest score; ``to_direct_sum``
bit for bit; ``probe_init``'s argmax exactly the probe's.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models import ensemble as tens
from tensornetworkforml_torch.models import probe_init as tprobe
from tensornetworkforml_torch.models import ring as tring
from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import autodiff as tad
from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy, mps_from_numpy

N, M, L, B = 8, 4, 3, 16
STEP_TOL = 1e-10
FWD_TOL = 1e-12


def _data(n=B, seed=0, n_sites=N, n_classes=L):
    rng = np.random.default_rng(seed)
    return rng.random((n, n_sites)), rng.integers(0, n_classes, n)


def _carry(j, **kw):
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu", **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _jax_mps(seed=0):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    return product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, noise=0.1, act_fn="softmax",
                        loss_fn="cross_entropy", T=0.5, dtype=jnp.float64)


def _run_steps(jax_trainer, port_trainer, n_steps, seed=1):
    """``n_steps`` steps of both trainers on the same batches; the losses."""
    losses = []
    for i in range(n_steps):
        x, y = _data(seed=seed + i)
        losses.append((port_trainer.step(x, y)[0], jax_trainer.step(x, y)[0]))
    return np.array(losses)


@pytest.mark.parametrize("steps,weight_decay", [(1, 0.0), (5, 1e-3)])
@pytest.mark.parametrize("loss", ["softmax_xent", "mse"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_autodiff_steps_match_optax(optimizer, loss, steps, weight_decay):
    from tensornetworkforml_tpu.train.autodiff import AutodiffConfig as JCfg
    from tensornetworkforml_tpu.train.autodiff import AutodiffTrainer as JTrainer

    kw = dict(loss=loss, optimizer=optimizer, weight_decay=weight_decay,
              learning_rate=1e-2 if optimizer == "adam" else 5e-2)
    j = _jax_mps()
    jt = JTrainer(j, JCfg(**kw))
    tt = tad.AutodiffTrainer(_carry(j), tad.AutodiffConfig(**kw))
    losses = _run_steps(jt, tt, steps)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=STEP_TOL)
    for got, want in ((tt.mps.sites, jt.mps.sites), (tt.mps.label_site, jt.mps.label_site)):
        assert _rel(got, want) <= STEP_TOL
    # the trainer steps leaves of its own
    assert tt.params[0].requires_grad and tt.params[0].is_leaf


def test_boundary_autodiff_trainer_matches_optax():
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_product_init
    from tensornetworkforml_tpu.train.autodiff import AutodiffConfig as JCfg
    from tensornetworkforml_tpu.train.autodiff import BoundaryAutodiffTrainer as JTrainer

    j = boundary_product_init(jax.random.PRNGKey(2), N=N, M=M, L=L, noise=0.1,
                              dtype=jnp.float64)
    cfg = dict(learning_rate=1e-2, weight_decay=1e-4)
    jt = JTrainer(j, JCfg(**cfg))
    t = boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), device="cpu")
    tt = tad.BoundaryAutodiffTrainer(t, tad.AutodiffConfig(**cfg))
    losses = _run_steps(jt, tt, 3, seed=5)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=STEP_TOL)
    assert _rel(tt.model.sites, jt.model.sites) <= STEP_TOL
    assert _rel(tt.model.w, jt.model.w) <= STEP_TOL
    assert torch.equal(t.sites, torch.as_tensor(np.array(j.sites)))  # its input untouched


def test_fit_matches_jax():
    from tensornetworkforml_tpu.train.autodiff import AutodiffConfig as JCfg
    from tensornetworkforml_tpu.train.autodiff import AutodiffTrainer as JTrainer

    class Batches:
        def batches(self):
            for s in range(3):
                yield _data(seed=20 + s)

    j = _jax_mps(seed=3)
    jh = JTrainer(j, JCfg(learning_rate=3e-3)).fit(Batches(), 2)
    th = tad.AutodiffTrainer(_carry(j), tad.AutodiffConfig(learning_rate=3e-3)).fit(
        Batches(), 2)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_TOL)
        np.testing.assert_allclose(a["accuracy"], b["accuracy"], atol=1e-6)


def test_unknown_loss_and_optimizer_raise():
    t = _carry(_jax_mps())
    with pytest.raises(ValueError, match="optimizer"):
        tad.AutodiffTrainer(t, tad.AutodiffConfig(optimizer="lbfgs"))
    with pytest.raises(ValueError, match="loss"):
        tad.AutodiffTrainer(t, tad.AutodiffConfig(loss="hinge")).step(*_data())


# ---- the ring ---------------------------------------------------------------

def _jax_ring(seed=4):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.ring import ring_product_init

    return ring_product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, noise=0.2,
                             dtype=jnp.float64)


@pytest.mark.parametrize("l_pos", [0, 3])
def test_ring_forward_matches_jax(l_pos):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.ring import ring_forward as j_ring
    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi

    j = _jax_ring().replace(l_pos=l_pos)
    x = _data(seed=6)[0]
    want = np.asarray(j_ring(j, j_psi(jnp.asarray(x))))
    got = tring.ring_forward(_carry(j), psi_embed(torch.as_tensor(x))).numpy()
    assert got.shape == (L, B) and _rel(got, want) <= FWD_TOL


def test_ring_trainer_matches_jax_and_init_is_seeded():
    from tensornetworkforml_tpu.models.ring import ring_trainer as j_ring_trainer
    from tensornetworkforml_tpu.train.autodiff import AutodiffConfig as JCfg

    j = _jax_ring(seed=7)
    jt = j_ring_trainer(j, JCfg(learning_rate=1e-2))
    tt = tring.ring_trainer(_carry(j), tad.AutodiffConfig(learning_rate=1e-2))
    losses = _run_steps(jt, tt, 2, seed=8)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=STEP_TOL)
    assert _rel(tt.mps.sites, jt.mps.sites) <= STEP_TOL
    a, b = (tring.ring_product_init(torch.Generator().manual_seed(1), N=N, M=M, L=L,
                                    device="cpu") for _ in range(2))
    assert torch.equal(a.sites, b.sites) and float(a.sites[0].abs().max()) == 0.0
    f = tring.ring_forward(a, psi_embed(torch.rand((B, N), generator=torch.Generator())))
    assert torch.isfinite(f).all() and 0.05 < float(f.abs().mean()) < 20


# ---- the probe init ---------------------------------------------------------

def _toy_task(n=256, n_sites=12, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, n_sites))
    phi = np.stack([np.sin(np.pi / 2 * x), np.cos(np.pi / 2 * x)], axis=-1)
    pt = phi / phi.sum(-1, keepdims=True)
    y = np.einsum("lnd,bnd->lb", rng.standard_normal((n_classes, n_sites, 2)), pt).argmax(0)
    return x, y


def test_probe_init_is_the_jax_probe_and_its_argmax_is_exact():
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.probe_init import fit_linear_probe as j_fit
    from tensornetworkforml_tpu.models.probe_init import probe_init as j_probe_init

    x, y = _toy_task()
    x_tr, y_tr, x_te = x[:192], y[:192], x[192:]
    W, acc = tprobe.fit_linear_probe(x_tr, y_tr, 4)
    jW, jacc = j_fit(x_tr, y_tr, 4)
    assert acc == jacc and _rel(W, jW) <= 1e-10
    mps, train_acc = tprobe.probe_init(x_tr, y_tr, M=7, L=4, dtype=torch.float64,
                                       device="cpu")
    jmps, _ = j_probe_init(x_tr, y_tr, M=7, L=4, dtype=jnp.float64)
    assert mps.l_pos == mps.N - 1 == jmps.l_pos and train_acc == acc
    assert _rel(mps.sites, jmps.sites) <= 1e-10 and _rel(mps.label_site, jmps.label_site) <= 1e-10
    f = mps_forward(mps, psi_embed(torch.as_tensor(x_te))).numpy()
    s_probe = tprobe.probe_scores(W, x_te)
    np.testing.assert_array_equal(f.argmax(0), s_probe.argmax(0))
    with pytest.raises(ValueError, match="M >= L"):
        tprobe.probe_init(x_tr, y_tr, M=4, L=4, device="cpu")


# ---- the ensemble -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ensemble():
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.ensemble import ensemble_init

    x = _data(7, seed=9, n_sites=9)[0]
    ens = ensemble_init(jax.random.PRNGKey(0), N=9, m=3, L=4, calibration_x=x,
                        dtype=jnp.float64)
    return ens.replace(head_a=jnp.asarray([1.0, -0.5, 2.0, 0.25], jnp.float64)), x


def _carry_ensemble(j):
    return tens.ensemble_from_numpy(np.asarray(j.sites), np.asarray(j.label_site),
                                    np.asarray(j.head_a), np.asarray(j.head_b), l_pos=j.l_pos,
                                    device="cpu")


@pytest.mark.parametrize("l_pos", [0, 4])
def test_ensemble_forward_matches_jax(jax_ensemble, l_pos):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.ensemble import ensemble_forward as j_fwd
    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi

    j, x = jax_ensemble
    j = j.replace(l_pos=l_pos, head_b=j.head_b + 0.5)
    t = _carry_ensemble(j)
    want = np.asarray(j_fwd(j, j_psi(jnp.asarray(x))))
    got = tens.ensemble_forward(t, psi_embed(torch.as_tensor(x))).numpy()
    assert got.shape == (4, len(x)) and _rel(got, want) <= FWD_TOL
    y = torch.as_tensor(got.argmax(0))
    assert float(tens.ensemble_accuracy(t, psi_embed(torch.as_tensor(x)), y)) == 1.0


def test_to_direct_sum_is_jax_bit_for_bit_and_exact(jax_ensemble):
    from tensornetworkforml_tpu.models.ensemble import to_direct_sum as j_direct_sum

    j, x = jax_ensemble
    t = _carry_ensemble(j)
    mono, jmono = tens.to_direct_sum(t), j_direct_sum(j)
    assert mono.M == t.L * t.m and mono.l_pos == 0
    np.testing.assert_array_equal(mono.sites.numpy(), np.asarray(jmono.sites))
    np.testing.assert_array_equal(mono.label_site.numpy(), np.asarray(jmono.label_site))
    phi = psi_embed(torch.as_tensor(x))
    f_ens = tens.ensemble_forward(t, phi).numpy()
    assert _rel(mps_forward(mono, phi).numpy(), f_ens) <= 1e-10


def test_to_direct_sum_refuses_a_bias_and_a_moved_label(jax_ensemble):
    t = _carry_ensemble(jax_ensemble[0])
    biased = t.replace(head_b=t.head_b.clone().index_fill_(0, torch.tensor([1]), 0.5))
    with pytest.raises(ValueError, match="head_b"):
        tens.to_direct_sum(biased)
    with pytest.raises(ValueError, match="l_pos"):
        tens.to_direct_sum(t.replace(l_pos=2))


def test_gradients_reach_every_ensemble_leaf(jax_ensemble):
    t = _carry_ensemble(jax_ensemble[0])
    leaves = {k: getattr(t, k).clone().requires_grad_(True)
              for k in ("sites", "label_site", "head_a", "head_b")}
    ens = t.replace(**leaves)
    phi = psi_embed(torch.as_tensor(jax_ensemble[1]))
    f = tens.ensemble_forward(ens, phi)
    y = torch.zeros(phi.shape[0], dtype=torch.long)
    torch.nn.functional.cross_entropy(f.T, y).backward()
    for name, leaf in leaves.items():
        assert torch.isfinite(leaf.grad).all() and float(leaf.grad.abs().max()) > 0, name


def test_ensemble_init_draws_its_chains_from_one_generator():
    x = _data(32, seed=10, n_sites=9)[0]
    a, b = (tens.ensemble_init(torch.Generator().manual_seed(5), N=9, m=3, L=4,
                               calibration_x=x, device="cpu") for _ in range(2))
    assert a.sites.shape == (4, 9, 3, 2, 3) and a.label_site.shape == (4, 3, 2, 1, 3)
    assert torch.equal(a.sites, b.sites) and not torch.equal(a.sites[0], a.sites[1])
    assert torch.equal(a.head_a, torch.ones(4)) and float(a.head_b.abs().max()) == 0.0
    f = tens.ensemble_forward(a, psi_embed(torch.as_tensor(x, dtype=torch.float32)))
    assert torch.isfinite(f).all() and 0.1 < float(f.abs().max()) < 10
