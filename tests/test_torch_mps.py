"""The PyTorch port's MPS model against the JAX package, in float64 on CPU.

Deterministic functions are held at rtol 1e-12 (atol 1e-12 * max|expected|).
Random inits cannot share bits across the two libraries, so ``product_init``
is compared exactly at ``noise=0`` and by its statistics with noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkforml_tpu.models import mps as jm
from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi
from tensornetworkforml_torch.models import mps as tm
from tensornetworkforml_torch.ops.embedding import psi_embed as t_psi
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

N, M, D, L, B = 9, 5, 2, 3, 6


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max()
    )


def _pair(l_pos: int = 0, act_fn="linear", loss_fn="MSE", seed: int = 0):
    """The same random float64 model in both packages."""
    rng = np.random.default_rng(seed)
    sites = rng.standard_normal((N, M, D, M)) * 0.5
    label = rng.standard_normal((M, D, L, M)) * 0.5
    j = jm.MPS(sites=jnp.asarray(sites), label_site=jnp.asarray(label),
               l_pos=l_pos, act_fn=act_fn, loss_fn=loss_fn, T=0.3)
    t = mps_from_numpy(sites, label, l_pos=l_pos, act_fn=act_fn,
                       loss_fn=loss_fn, T=0.3)
    return j, t


def _pixels(seed: int = 1, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).random((n, N))


@pytest.mark.parametrize("l_pos", [0, N // 2, N - 1])
def test_mps_forward_matches_jax(l_pos):
    j, t = _pair(l_pos)
    x = _pixels()
    want = jm.mps_forward(j, j_psi(jnp.asarray(x)))
    got = tm.mps_forward(t, t_psi(torch.as_tensor(x)))
    assert got.shape == (L, B)
    _close(got.numpy(), want)
    _close(t(t_psi(torch.as_tensor(x))).numpy(), want)  # nn.Module call


@pytest.mark.parametrize("act_fn", jm.ACT_FNS)
@pytest.mark.parametrize("loss_fn", jm.LOSS_FNS)
def test_act_fn_and_loss_derivative_match_jax(act_fn, loss_fn):
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((L, B))
    y = np.eye(L)[rng.integers(0, L, B)].T  # (L, B) one-hot
    f_j = jm.apply_act_fn(jnp.asarray(scores), act_fn, 0.3)
    f_t = tm.apply_act_fn(torch.as_tensor(scores), act_fn, 0.3)
    _close(f_t.numpy(), f_j)
    _close(
        tm.loss_derivative(f_t, torch.as_tensor(y), loss_fn, act_fn, 0.3).numpy(),
        jm.loss_derivative(f_j, jnp.asarray(y), loss_fn, act_fn, 0.3),
    )


def test_unknown_activation_and_loss_raise():
    s = torch.zeros((L, B))
    with pytest.raises(ValueError):
        tm.apply_act_fn(s, "relu", 0.1)
    with pytest.raises(ValueError):
        tm.loss_derivative(s, s, "hinge", "linear", 0.1)


def test_accuracy_and_predict_match_jax():
    j, t = _pair()
    x = _pixels(n=40)
    y = np.random.default_rng(3).integers(0, L, 40)
    scores = jm.mps_forward(j, j_psi(jnp.asarray(x)))
    got = tm.accuracy_from_scores(torch.as_tensor(np.array(scores)), torch.as_tensor(y))
    want = float(jm.accuracy_from_scores(scores, jnp.asarray(y)))
    assert float(got) == pytest.approx(want, rel=1e-12)
    np.testing.assert_array_equal(
        tm.predict(t, torch.as_tensor(x)).numpy(),
        np.asarray(jm.predict(j, jnp.asarray(x))),
    )


def test_grow_bond_matches_jax_and_keeps_function():
    j, t = _pair(l_pos=3)
    jg, tg = jm.grow_bond(j, 8), tm.grow_bond(t, 8)
    np.testing.assert_array_equal(tg.sites.numpy(), np.asarray(jg.sites))
    np.testing.assert_array_equal(tg.label_site.numpy(), np.asarray(jg.label_site))
    assert tg.l_pos == 3 and tg.M == 8
    phi = t_psi(torch.as_tensor(_pixels()))
    _close(tm.mps_forward(tg, phi).numpy(), tm.mps_forward(t, phi).numpy())
    assert tm.grow_bond(t, M) is t
    with pytest.raises(ValueError):
        tm.grow_bond(t, M - 1)


def test_calibrate_matches_jax():
    j, t = _pair()
    x = _pixels()
    jc = jm.calibrate(j, j_psi(jnp.asarray(x)))
    tc = tm.calibrate(t, t_psi(torch.as_tensor(x)))
    _close(tc.sites.numpy(), jc.sites)
    _close(tc.label_site.numpy(), jc.label_site)
    f = tm.mps_forward(tc, t_psi(torch.as_tensor(x)))
    assert abs(float(f.abs().max()) - 1.0) < 1e-10


def _product_pair(calibration_x, N_=N, M_=M):
    kw = dict(N=N_, M=M_, D=D, L=L, noise=0.0, act_fn="linear", loss_fn="MSE",
              calibration_x=calibration_x)
    j = jm.product_init(jax.random.PRNGKey(0), dtype=jnp.float64, **kw)
    t = tm.product_init(torch.Generator().manual_seed(0), dtype=torch.float64,
                        device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("rescaled", [False, True])
def test_product_init_noise_free_matches_jax(rescaled):
    """Exact at noise=0, with and without the output-scale guard firing."""
    n = 24
    rng = np.random.default_rng(4)
    if rescaled:
        # half the samples all-dark, half at x=0.5: the bright half gains
        # ~1.17 per site over the data mean, so max|f0| ~ 1.17^24 > 10
        x = np.concatenate([np.zeros((8, n)), np.full((8, n), 0.5)])
    else:
        x = rng.random((16, n)) * 0.1 + 0.45
    j, t = _product_pair(x, N_=n)
    _close(t.sites.numpy(), j.sites)
    _close(t.label_site.numpy(), j.label_site)
    f = tm.mps_forward(t, t_psi(torch.as_tensor(x))).abs().max()
    if rescaled:
        assert abs(float(f) - 1.0) < 1e-10
    else:
        assert 0.1 <= float(f) <= 10.0 and not np.isclose(float(f), 1.0)


def test_product_init_statistics():
    noise, n, m = 0.05, 12, 8
    g = torch.Generator().manual_seed(5)
    mps = tm.product_init(g, N=n, M=m, D=D, L=L, noise=noise, dtype=torch.float64,
                          device="cpu")
    base = np.pi / 4  # 1 / (4 / pi): no calibration data
    sites, label = mps.sites.numpy(), mps.label_site.numpy()
    eye = np.broadcast_to(np.eye(m)[:, None, :], (m, D, m))
    dev = sites[1 : n - 1] - base * eye
    assert abs(dev.mean()) < 0.2 * noise / 3
    assert abs(dev.std() / noise - 1.0) < 0.1
    assert not sites[0].any()  # the label's slot
    assert not sites[n - 1, :, :, 1:].any()  # right edge: only column 0 live
    assert abs(sites[n - 1, :, :, 0].mean() - base / m) < noise
    assert not label[1:].any()  # label at site 0: only row 0 live
    label_dev = label[0] - base * (np.arange(m) == 0)
    assert abs(label_dev.std() / noise - 1.0) < 0.25
    f = tm.mps_forward(mps, t_psi(torch.rand((16, n), generator=g, dtype=torch.float64)))
    assert 0.1 <= float(f.abs().max()) <= 10.0


def test_product_init_canonicalize_sets_the_output_scale():
    """``canonicalize=True`` raised until ``models/canonical.py`` was ported;
    it now gives right-isometric sites and max|f| = ``target_abs_f`` on the
    calibration batch (tests/test_torch_canonical.py holds it against JAX)."""
    x = np.random.default_rng(4).random((8, 4))
    mps = tm.product_init(torch.Generator().manual_seed(0), N=4, M=2, canonicalize=True,
                          calibration_x=x, target_abs_f=2.0, dtype=torch.float64,
                          device="cpu")
    f = tm.mps_forward(mps, t_psi(torch.as_tensor(x)))
    assert abs(float(f.abs().max()) - 2.0) <= 1e-12
    for a in mps.sites[1:].reshape(3, 2, -1):
        p = a @ a.T
        assert torch.allclose(p @ p, p, atol=1e-12)


def test_product_init_is_fixed_by_the_seed():
    """Draws happen on the generator's device, whatever ``device`` is; with
    no ``device`` the model goes to the card, and without a card that
    raises instead of falling back to the CPU."""
    a = tm.product_init(torch.Generator().manual_seed(7), N=5, M=3, L=2, device="cpu")
    if torch.cuda.is_available():
        b = tm.product_init(torch.Generator().manual_seed(7), N=5, M=3, L=2)
        assert b.device.type == "cuda"
        b = b.replace(sites=b.sites.cpu(), label_site=b.label_site.cpu())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.product_init(torch.Generator().manual_seed(7), N=5, M=3, L=2)
        b = tm.product_init(torch.Generator().manual_seed(7), N=5, M=3, L=2,
                            device=torch.device("cpu"))
    assert torch.equal(a.sites, b.sites) and torch.equal(a.label_site, b.label_site)


def test_mps_init_statistics_and_calibration():
    g = torch.Generator().manual_seed(6)
    raw = tm.mps_init(g, N=N, M=M, D=D, L=L, dtype=torch.float64, device="cpu")
    assert raw.l_pos == 0 and raw.act_fn == "linear"
    s, lab = raw.sites.numpy(), raw.label_site.numpy()
    assert not s[0].any() and not s[N - 1, :, :, 1:].any() and not lab[1:].any()
    mid = s[1 : N - 1]
    assert mid.min() >= 0.0 and mid.max() < 1.0 and abs(mid.mean() - 0.5) < 0.05
    phi = t_psi(torch.rand((16, N), generator=g, dtype=torch.float64))
    cal = tm.mps_init(g, N=N, M=M, D=D, L=L, normalize=True, calibration_phi=phi,
                      dtype=torch.float64, device="cpu")
    assert abs(float(tm.mps_forward(cal, phi).abs().max()) - 1.0) < 1e-10
    with pytest.raises(ValueError):
        tm.mps_init(g, N=N, M=M, act_fn="tanh")


@pytest.mark.parametrize("l_pos", [0, N // 2, N - 1])
def test_ragged_site_list_matches_jax(l_pos):
    j, t = _pair(l_pos)
    got, want = tm.ragged_site_list(t), jm.ragged_site_list(j)
    assert len(got) == len(want) == N
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, np.asarray(w_))


def test_mps_module_fields_and_replace():
    _, t = _pair(l_pos=2)
    assert (t.N, t.M, t.D, t.L) == (N, M, D, L)
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    assert set(dict(t.named_buffers())) == {"sites", "label_site"}
    u = t.replace(l_pos=0, act_fn="softmax")
    assert (t.l_pos, t.act_fn) == (2, "linear") and (u.l_pos, u.act_fn) == (0, "softmax")
    assert u.sites is t.sites and u.T == t.T
    with pytest.raises(ValueError):
        tm.mps_forward(t, torch.zeros((B, N + 1, D), dtype=torch.float64))
