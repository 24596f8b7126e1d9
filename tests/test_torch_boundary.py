"""The boundary-label family of the port (``models/boundary.py``, its
``.npz`` checkpoints and ``Predictor``'s boundary branch) against the JAX
package's, on the CPU, with the JAX model's arrays carried across by
``boundary_from_numpy``.

Tolerances, relative to the largest score: 1e-12 for float64 forwards (one
chain scan summed in another order), 1e-5 for the float32 ``Predictor``
(rtol of a 20-site float32 chain, ~1e-7 expected). Growth and checkpoints
are exact.

JAX is imported inside the helpers, so that the tests marked ``cuda`` (a
brick sweep, a one-site sweep and the boundary ``Predictor`` on the card,
each against its CPU run) run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_boundary.py``.
"""

import json

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models import boundary as tb
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.utils import checkpoint as tck

N, M, D, L, B = 12, 5, 2, 3, 9
F64_TOL = 1e-12
F32_TOL = 1e-5
CARD_TOL = 1e-4  # float32 on the card against float32 on the CPU, of max|f|


def _jax_model(seed=0, dtype="float64"):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_product_init

    return boundary_product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, noise=0.2,
                                 act_fn="sigmoid", loss_fn="MSE", T=0.5,
                                 dtype=getattr(jnp, dtype))


def _carry(j, dtype=None, device="cpu"):
    return tck.boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), act_fn=j.act_fn,
                                   loss_fn=j.loss_fn, T=j.T, dtype=dtype, device=device)


def _x(n=B, seed=1):
    return np.random.default_rng(seed).random((n, N))


def _jax_scores(j, x):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_forward
    from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi

    return np.asarray(boundary_forward(j, j_psi(jnp.asarray(x, dtype=j.dtype))))


def _port_scores(t, x):
    return tb.boundary_forward(t, psi_embed(torch.as_tensor(x))).numpy()


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_forward_matches_jax():
    j = _jax_model()
    t = _carry(j)
    assert (t.N, t.M, t.D, t.L, t.dtype) == (N, M, D, L, torch.float64)
    _close(_port_scores(t, _x()), _jax_scores(j, _x()), F64_TOL)
    _close(t(psi_embed(torch.as_tensor(_x()))).numpy(), _jax_scores(j, _x()), F64_TOL)


def test_product_init_calibration_matches_jax():
    """Without noise the sites are the calibrated near-identity, drawn alike;
    with noise the port draws from its generator: shapes, scale and the
    generator's reproducibility."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_product_init

    x = _x(32)
    j = boundary_product_init(jax.random.PRNGKey(0), N=N, M=M, L=L, noise=0.0,
                              dtype=jnp.float64, calibration_x=x)
    t = tb.boundary_product_init(torch.Generator().manual_seed(0), N=N, M=M, L=L, noise=0.0,
                                 dtype=torch.float64, calibration_x=x, device="cpu")
    np.testing.assert_allclose(t.sites.numpy(), np.asarray(j.sites), rtol=1e-14)
    a = tb.boundary_product_init(torch.Generator().manual_seed(4), N=N, M=M, L=L, device="cpu")
    b = tb.boundary_product_init(torch.Generator().manual_seed(4), N=N, M=M, L=L, device="cpu")
    assert torch.equal(a.sites, b.sites) and torch.equal(a.w, b.w)
    assert a.w.shape == (M, L) and a.dtype == torch.float32
    assert 0.0 < float(a.w.abs().max()) < 10 * (0.01 + 1.0 / M)


def test_grow_bond_is_jax_growth_and_preserves_the_function():
    from tensornetworkforml_tpu.models.boundary import grow_boundary_bond

    j = _jax_model(seed=2)
    t = _carry(j)
    jg, tg = grow_boundary_bond(j, M + 3), tb.grow_boundary_bond(t, M + 3)
    assert tg.M == M + 3 and tb.grow_boundary_bond(t, M) is t
    np.testing.assert_array_equal(tg.sites.numpy(), np.asarray(jg.sites))
    np.testing.assert_array_equal(tg.w.numpy(), np.asarray(jg.w))
    _close(_port_scores(tg, _x()), _port_scores(t, _x()), F64_TOL)
    with pytest.raises(ValueError, match="shrink"):
        tb.grow_boundary_bond(t, M - 1)


def test_jax_boundary_checkpoints_load_in_the_port(tmp_path):
    from tensornetworkforml_tpu.utils import checkpoint as jck

    j = _jax_model(seed=3)
    path = str(tmp_path / "b.npz")
    jck.save_boundary_checkpoint(j, path)
    for t in (tck.load_boundary_checkpoint(path, device="cpu"),
              tck.load_any_checkpoint(path, device="cpu")):
        assert isinstance(t, tb.BoundaryMPS)
        assert (t.act_fn, t.loss_fn, t.T) == (j.act_fn, j.loss_fn, j.T)
        np.testing.assert_array_equal(t.sites.numpy(), np.asarray(j.sites))
        np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
    assert tck.load_any_checkpoint(path, dtype=torch.float32, device="cpu").dtype == torch.float32
    state = str(tmp_path / "state.npz")
    jck.save_boundary_training_state(state, j, epoch=3, sweep_idx=17, left=True)
    t, epoch, sweep_idx, left = tck.load_boundary_training_state(state, device="cpu")
    assert (epoch, sweep_idx, left) == (3, 17, True)
    np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))


def test_port_boundary_checkpoints_load_in_jax(tmp_path):
    from tensornetworkforml_tpu.models.boundary import BoundaryMPS as JaxBoundary
    from tensornetworkforml_tpu.utils import checkpoint as jck

    t = _carry(_jax_model(seed=4))
    path = str(tmp_path / "b.npz")
    tck.save_boundary_checkpoint(t, path)
    j = jck.load_any_checkpoint(path)
    assert isinstance(j, JaxBoundary)
    np.testing.assert_array_equal(np.asarray(j.sites), t.sites.numpy())
    _close(_jax_scores(j, _x()), _port_scores(t, _x()), F64_TOL)
    state = str(tmp_path / "state.npz")
    tck.save_boundary_training_state(state, t, epoch=2, sweep_idx=9, left=False)
    j, epoch, sweep_idx, left = jck.load_boundary_training_state(state)
    assert (epoch, sweep_idx, left) == (2, 9, False)
    # the same keys and the same meta bytes as the JAX package writes
    jck.save_boundary_training_state(str(tmp_path / "jstate.npz"), j, 2, 9, False)
    with np.load(state) as a, np.load(str(tmp_path / "jstate.npz")) as b:
        assert a.files == b.files
        assert json.loads(bytes(a["meta"])) == json.loads(bytes(b["meta"]))
        assert bytes(a["meta"]) == bytes(b["meta"])


@pytest.mark.parametrize("activation", [False, True])
def test_predictor_serves_the_boundary_family_like_jax(tmp_path, activation):
    from tensornetworkforml_tpu.models.serving import Predictor as JaxPredictor
    from tensornetworkforml_tpu.utils import checkpoint as jck

    j = _jax_model(seed=5, dtype="float32")
    path = str(tmp_path / "b.npz")
    jck.save_boundary_checkpoint(j, path)
    x = _x(23).astype(np.float32)
    want = JaxPredictor(j, batch_size=8, activation=activation).scores(x)
    for pred in (Predictor(_carry(j), batch_size=8, activation=activation, device="cpu"),
                 Predictor.from_checkpoint(path, batch_size=8, activation=activation,
                                           device="cpu")):
        assert not pred.use_kernel and not pred.use_pallas
        got = pred.scores(x)
        assert got.shape == (23, L)
        _close(got, want, F32_TOL)
        np.testing.assert_array_equal(pred.predict(x), got.argmax(axis=1))


@pytest.mark.parametrize("flag", ["use_kernel", "use_pallas"])
def test_predictor_refuses_the_kernel_for_the_boundary_family(flag):
    t = _carry(_jax_model())
    with pytest.raises(ValueError, match="boundary"):
        Predictor(t, device="cpu", **{flag: True})
    assert not Predictor(t, device="cpu", **{flag: False}).use_kernel


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    t = _carry(_jax_model())
    tck.save_boundary_checkpoint(t, str(tmp_path / "b.npz"))
    for call in (lambda: tb.boundary_product_init(torch.Generator(), N=N, M=M),
                 lambda: tck.load_boundary_checkpoint(str(tmp_path / "b.npz")),
                 lambda: Predictor(t)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---- on the card: each against its CPU run ----------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_model(n=24, m=16, seed=0):
    return tb.boundary_product_init(torch.Generator().manual_seed(seed), N=n, M=m, L=10,
                                    noise=0.05, device="cpu")


def _card_batch(model, b=64, seed=1):
    from tensornetworkforml_torch.train.sweep import one_hot_labels

    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, model.N), generator=g)
    y = torch.randint(0, model.L, (b,), generator=g)
    return psi_embed(x), one_hot_labels(y, model.L, torch.float32)


def _on(model, device):
    return model.replace(sites=model.sites.to(device), w=model.w.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("split_method", ["cholqr", "rangefinder"])
def test_brick_sweep_on_card_matches_cpu(split_method):
    _needs_card()
    from tensornetworkforml_torch.train.brickwall import BrickConfig, brick_sweep

    model = _card_model()
    phi, y1h = _card_batch(model)
    cfg = BrickConfig(split_method=split_method)
    cpu, _ = brick_sweep(model, phi, y1h, 0.01, 1e-5, cfg)
    card, metrics = brick_sweep(_on(model, "cuda"), phi.cuda(), y1h.cuda(), 0.01, 1e-5, cfg)
    assert card.device.type == "cuda" and torch.isfinite(card.sites).all()
    want = tb.boundary_forward(cpu, phi)
    got = tb.boundary_forward(card, phi.cuda()).cpu()
    assert float((got - want).abs().max()) <= CARD_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("left_dir", [False, True])
def test_onesite_sweep_on_card_matches_cpu(left_dir):
    _needs_card()
    from tensornetworkforml_torch.train.onesite import OneSiteConfig, onesite_sweep

    model = _card_model()
    phi, y1h = _card_batch(model)
    cfg = OneSiteConfig(renorm=True)
    cpu, _ = onesite_sweep(model, phi, y1h, 0.05, 1e-5, left_dir, cfg)
    card, _ = onesite_sweep(_on(model, "cuda"), phi.cuda(), y1h.cuda(), 0.05, 1e-5, left_dir,
                            cfg)
    assert card.device.type == "cuda"
    want = tb.boundary_forward(cpu, phi)
    got = tb.boundary_forward(card, phi.cuda()).cpu()
    assert float((got - want).abs().max()) <= CARD_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_boundary_predictor_on_card_matches_cpu(tmp_path):
    _needs_card()
    model = _card_model()
    path = str(tmp_path / "b.npz")
    tck.save_boundary_checkpoint(model, path)
    x = np.random.default_rng(2).random((300, model.N)).astype(np.float32)
    card = Predictor.from_checkpoint(path)  # the default device: the card
    assert card.device.type == "cuda" and not card.use_kernel
    want = Predictor(model, device="cpu").scores(x)
    got = card.scores(x)
    assert np.abs(got - want).max() <= CARD_TOL * np.abs(want).max()
