"""The canonical gauge (``models/canonical.py``) and
``product_init(canonicalize=True)`` against the JAX package, in float64 on
the CPU.

The padded chain's boundary sites make the carried ``L`` factors rank
deficient, and the QR then completes the bond basis from rounding noise in
both packages: the gauge-fixed arrays agree only where they are determined.
So the two packages are compared by the network function on fresh inputs,
1e-10 of its largest value (float64 contractions in another order), with
every right (left) isometry checked to 1e-10; where the inputs are full rank
(``product_init`` at zero noise) the arrays themselves are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkforml_tpu.models import canonical as jc
from tensornetworkforml_tpu.models import mps as jm
from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi
from tensornetworkforml_torch.models import canonical as tc
from tensornetworkforml_torch.models import mps as tm
from tensornetworkforml_torch.ops.embedding import psi_embed as t_psi
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

N, M, D, L = 10, 5, 2, 3
TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _pair(l_pos, seed=0):
    """The same random float64 model in both packages, with the padded zero
    structure of a chain whose label sits at ``l_pos`` (0 or N-1)."""
    rng = np.random.default_rng(seed)
    sites = rng.random((N, M, D, M))
    label = rng.random((M, D, L, M))
    if l_pos == 0:
        sites[N - 1, :, :, 1:] = 0.0
        label[1:] = 0.0
    else:
        sites[0, 1:] = 0.0
        label[..., 1:] = 0.0
    sites[l_pos] = 0.0
    j = jm.MPS(sites=jnp.asarray(sites), label_site=jnp.asarray(label), l_pos=l_pos,
               act_fn="linear", loss_fn="MSE", T=0.1)
    return j, mps_from_numpy(sites, label, l_pos=l_pos, act_fn="linear", loss_fn="MSE")


def _scores_both(j, t, seed=1):
    x = np.random.default_rng(seed).random((7, N))
    return (tm.mps_forward(t, t_psi(torch.as_tensor(x))).numpy(),
            np.asarray(jm.mps_forward(j, j_psi(jnp.asarray(x)))))


def _right_isometric(sites, first, last):
    for n in range(first, last):
        a = sites[n].reshape(M, -1)
        p = a @ a.T
        _close(p @ p, p)


@pytest.mark.parametrize("l_pos", [0, N - 1])
def test_canonicalize_matches_jax_and_preserves_the_function(l_pos):
    j, t = _pair(l_pos)
    before, _ = _scores_both(j, t)
    jc_m, tc_m = jc.canonicalize(j), tc.canonicalize(t)
    assert tc_m.l_pos == l_pos
    got, want = _scores_both(jc_m, tc_m)
    _close(got, want)
    _close(got, before)
    sites = tc_m.sites.numpy()
    if l_pos == 0:
        _right_isometric(sites, 1, N)
    else:  # left isometries: sum_{l,d} A[l,d,r] A[l,d,r'] is a projector
        for n in range(N - 1):
            a = sites[n].reshape(-1, M)
            p = a.T @ a
            _close(p @ p, p)


def test_canonicalizers_reject_a_label_off_their_end():
    _, t = _pair(0)
    with pytest.raises(ValueError, match="site N-1"):
        tc.left_canonicalize(t)
    with pytest.raises(ValueError, match="site 0"):
        tc.right_canonicalize(t.replace(l_pos=N - 1))
    with pytest.raises(ValueError, match="chain end"):
        tc.canonicalize(t.replace(l_pos=3))


def test_renormalized_gauge_fix_and_normalize_label_match_jax():
    j, t = _pair(0, seed=2)
    js, jl = jc._right_canonicalize_arrays(j.sites, j.label_site, renormalize=True)
    ts, tl = tc._right_canonicalize_arrays(t.sites, t.label_site, renormalize=True)
    _right_isometric(ts.numpy(), 1, N)
    jn = jc.normalize_label(j.replace(sites=js, label_site=jl), 2.5)
    tn = tc.normalize_label(t.replace(sites=ts, label_site=tl), 2.5)
    _close(*_scores_both(jn, tn))
    assert abs(float(torch.linalg.norm(tn.label_site)) - 2.5) <= 1e-12


def test_canonical_init_matches_jax_on_the_same_draw():
    """The two packages draw different random bits, so the JAX draw is
    handed over: the port's gauge fix and label scaling on JAX's
    ``mps_init`` arrays give JAX's ``canonical_init``."""
    key = jax.random.PRNGKey(4)
    want = jc.canonical_init(key, N=N, M=M, L=L, dtype=jnp.float64, target_norm=1.5)
    raw = jm.mps_init(key, N=N, M=M, L=L, normalize=False, act_fn="softmax",
                      loss_fn="cross_entropy", dtype=jnp.float64)
    t = mps_from_numpy(np.asarray(raw.sites), np.asarray(raw.label_site))
    ts, tl = tc._right_canonicalize_arrays(t.sites, t.label_site, renormalize=True)
    got = tc.normalize_label(t.replace(sites=ts, label_site=tl), 1.5)
    _right_isometric(got.sites.numpy(), 1, N)
    _close(*_scores_both(want, got))


def test_canonical_init_is_right_canonical_with_the_target_norm():
    mps = tc.canonical_init(torch.Generator().manual_seed(0), N=N, M=M, L=L,
                            dtype=torch.float64, target_norm=0.7, device="cpu")
    assert mps.l_pos == 0 and mps.act_fn == "softmax" and mps.device.type == "cpu"
    _right_isometric(mps.sites.numpy(), 1, N)
    assert abs(float(torch.linalg.norm(mps.label_site)) - 0.7) <= 1e-12
    x = torch.as_tensor(np.random.default_rng(3).random((32, N)))
    assert float(tm.mps_forward(mps, t_psi(x)).abs().max()) <= 0.7 + 1e-9


def test_product_init_canonicalize_matches_jax_at_zero_noise():
    """With zero noise the two packages' inits are the same arrays."""
    x = np.random.default_rng(5).random((16, N))
    kw = dict(N=N, M=M, L=L, noise=0.0, act_fn="linear", loss_fn="MSE", calibration_x=x,
              canonicalize=True, target_abs_f=0.8)
    want = jm.product_init(jax.random.PRNGKey(0), dtype=jnp.float64, **kw)
    got = tm.product_init(torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu",
                          **kw)
    _close(got.sites.numpy(), np.asarray(want.sites))
    _close(got.label_site.numpy(), np.asarray(want.label_site))
    f = tm.mps_forward(got, t_psi(torch.as_tensor(x)))
    assert abs(float(f.abs().max()) - 0.8) <= 1e-12
    _right_isometric(got.sites.numpy(), 1, N)


def test_product_init_canonicalize_with_noise_and_no_calibration_batch():
    mps = tm.product_init(torch.Generator().manual_seed(1), N=N, M=M, L=L, canonicalize=True,
                          dtype=torch.float64, device="cpu")
    _right_isometric(mps.sites.numpy(), 1, N)
    assert torch.isfinite(mps.label_site).all()
