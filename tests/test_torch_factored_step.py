"""The factored large-bond step (``train/factored_step.py``) against the JAX
package's, and against the port's own materialising step, on the CPU.

* Single steps against JAX in float64 with the same Omega, on random
  full-rank inputs, with the JAX package's iterate handed to the port: the
  factored algebra (clip, Gram, sketch, R, f_new, renormalisation, metrics)
  agrees to reassociation error. Tolerance 1e-9 on the iterate's inputs and
  on gauge-invariant outputs (the re-merged pair, f_new, the new left
  environment closed with the new label core, the metrics), as the port's
  other float64 step tests. The iterate is handed over because the JAX
  package's runs its Newton-Schulz products with float32 results even on
  float64 input (``_dot``'s ``preferred_element_type``), and the port's in
  float64; the two meet only at float32 level.
* The iterate itself against the JAX package's in float32, by the projector
  ``Q Q^T``: 1e-5, as K1's tests (the same ~20 dependent products in
  another summation order, on a gapped spectrum).
* Single steps against the port's ``factored_update="off"`` step in float32,
  at the first step of a chain: the same split contract computed from the
  factors instead of from B_new. Tolerance 2e-5, and 1e-4 on the left
  environment's Gram, what the JAX package holds its own two routes to
  (``tests/test_factored_step.py``).
* ``train_model`` through the factored route against the JAX package's in
  float32, one epoch of two sweeps (right, then left): 2e-4 on the MAE
  series and one sample in 16 on the per-step accuracy, what
  ``tests/test_torch_trainer.py`` holds the polar trainings to (float32
  rounding that the sweep amplifies 2-5x per sweep); 2e-3 on the function,
  what that file holds four polar sweeps to: the first steps of a
  product-state chain sketch a rank-2 matrix into 8 columns, and the
  directions the iteration makes out of rounding there differ between any
  two summation orders (measured 7.6e-4 after the two sweeps).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    chain_scores,
    right_env_stack_fused,
)
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import factored_step as tfs
from tensornetworkforml_torch.train import sweep as tsw
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

TOL64 = 1e-9
TOL32, ENV_TOL32 = 2e-5, 1e-4
TRAIN_TOL, TRAIN_F_TOL = 2e-4, 2e-3
N, M, L, B = 10, 8, 3, 16


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


def _cfg(factored="on", **kw):
    return dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                svd_method="polar", factored_update=factored, **kw)


def _jax_model(x, dtype, seed=1):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    return product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, act_fn="linear",
                        loss_fn="MSE", dtype=getattr(jnp, dtype), calibration_x=x)


def _port(j):
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")


def _step_args(mps, x, y, dtype):
    """The inputs of the first step of a right sweep, from the port's own
    contractions: ``(label_site, A2, x1, x2, l_env, r_env, y_onehot, f)``."""
    phi_t = psi_embed(torch.as_tensor(x, dtype=dtype)).transpose(0, 1)
    e0 = boundary_vector(M, dtype)
    r_envs = right_env_stack_fused(mps.sites, phi_t, e0)
    l_env = e0.expand(B, M)
    f0 = chain_scores(l_env, mps.label_site, phi_t[0], r_envs[1])
    y1h = torch.as_tensor(np.eye(L)[y].T.copy(), dtype=dtype)
    return mps.label_site, mps.sites[1], phi_t[0], phi_t[1], l_env, r_envs[2], y1h, f0


def _random_step_args(seed=0):
    """Random full-rank step inputs in float64, with the carried output
    ``f`` equal to the chain's (``Lmat . B_t . rp``)."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    pix = rng.random((B, 2))
    phi = torch.as_tensor(np.stack([np.sin(np.pi * pix / 2), np.cos(np.pi * pix / 2)], -1))
    lab, A2, l_env, r_env = t(M, 2, L, M) / M, t(M, 2, M) / M, t(B, M), t(B, M)
    f = torch.einsum("ba,bi,aiok,kjc,bj,bc->ob", l_env, phi[:, 0], lab, A2, phi[:, 1], r_env)
    y1h = torch.as_tensor(np.eye(L)[rng.integers(0, L, B)].T.copy())
    return lab, A2, phi[:, 0], phi[:, 1], l_env, r_env, y1h, f


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N))
    y = rng.integers(0, L, B)
    j = _jax_model(x, dtype)
    return j, _port(j), x, y


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.float64)


def _invariants(A, lab, l_env, f_new, metrics):
    A, lab, l_env = _np(A), _np(lab), _np(l_env)
    return {
        "pair": np.einsum("adr,rjoc->adjoc", A, lab),
        "f_new": _np(f_new),
        "env_label": np.einsum("bm,mjoc->bjoc", l_env, lab),
        **{k: _np(v) for k, v in metrics.items()},
    }


def _close(got, want, tol, what):
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err)


STEP_OPTIONS = {
    "plain": {},
    "renorm_envs": {"renorm_envs": True},
    "normalized": {"update_mode": "normalized"},
    "growth_cap": {"growth_cap": 0.005},
    "no_step_metrics": {"step_metrics": False},
}


@pytest.mark.parametrize("option", sorted(STEP_OPTIONS))
def test_factored_step_matches_jax_float64(option, jax_omega, monkeypatch):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import factored_step as jfs
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JC

    seen = {}
    real = jfs._iterate_xla

    def spy(y0, g, n2, dead_tol, **kw):
        q = real(y0, g, n2, dead_tol, **kw)
        seen["inputs"], seen["q"] = [_np(v) for v in (y0, g, n2)], _np(q)
        return q

    def handed(y0, g, n2, dead_tol):
        for name, got, want in zip(("y0", "gram", "n2"), (y0, g, n2), seen["inputs"]):
            _close(_np(got), want, TOL64, name)
        assert dead_tol == 1e-12 and y0.dtype == torch.float64
        return torch.as_tensor(seen["q"])

    monkeypatch.setattr(jfs, "_iterate_xla", spy)
    monkeypatch.setattr(tfs, "_iterate", handed)
    args = _random_step_args(seed=len(option))
    kw = _cfg(**STEP_OPTIONS[option])
    jout = jfs.two_site_update_factored(*[jnp.asarray(_np(a)) for a in args],
                                       jnp.asarray(0.05), jnp.asarray(1e-4), 0.1, JC(**kw))
    tout = tfs.two_site_update_factored(*args, torch.tensor(0.05, dtype=torch.float64),
                                        torch.tensor(1e-4, dtype=torch.float64), 0.1,
                                        tsw.SweepConfig(**kw))
    assert all(o.dtype == torch.float64 for o in tout[:4])
    assert tout[0].shape == (M, 2, M) and tout[1].shape == (M, 2, L, M)
    want, got = _invariants(*jout), _invariants(*tout)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], TOL64, k)
    if option == "no_step_metrics":
        assert all(float(v) == 0.0 for v in tout[4].values())


@pytest.mark.parametrize("option", sorted(STEP_OPTIONS))
def test_factored_step_matches_the_materialising_step_float32(option):
    """The port's two routes through ``two_site_update``, same Omega."""
    _, t, x, y = _inputs("float32", seed=3)
    lab, A2, x1, x2, l_env, r_env, y1h, f0 = _step_args(t, x, y, torch.float32)
    outs = {}
    for mode in ("off", "on"):
        A, lab_new, env, E2, f_new, met = tsw.two_site_update(
            lab, A2, x1, x2, l_env, r_env, torch.eye(M), torch.zeros((M, M)), y1h, f0,
            torch.tensor(0.05), torch.tensor(1e-4), M, t.T,
            tsw.SweepConfig(**_cfg(mode, **STEP_OPTIONS[option])))
        if mode == "on":
            assert torch.equal(E2, torch.eye(M))  # the factored step keeps E2
        outs[mode] = (_np(A), _np(lab_new), _np(env), _np(f_new), met)
    (A1, lab1, env1, f1, m1), (A0, lab0, env0, f0_, m0) = outs["on"], outs["off"]
    pair = lambda A, lab: np.einsum("adr,rjoc->adjoc", A, lab)  # noqa: E731
    _close(pair(A1, lab1), pair(A0, lab0), TOL32, "pair")
    _close(f1, f0_, TOL32, "f_new")
    _close(env1 @ env1.T, env0 @ env0.T, ENV_TOL32, "l_env Gram")
    for k in m0:
        _close(_np(m1[k]), _np(m0[k]), TOL32, k)


def _gapped(I, J, rank, seed):
    """A matrix with a kept spectrum over half a decade and a gap of 10 below it."""
    r = np.random.default_rng(seed)
    k = min(I, J)
    u, _ = np.linalg.qr(r.standard_normal((I, k)))
    v, _ = np.linalg.qr(r.standard_normal((J, k)))
    s = np.ones(k)
    s[:rank] = np.logspace(0, -0.5, rank)
    s[rank:] = s[rank - 1] * 0.1 * np.logspace(0, -2, k - rank)
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.parametrize("I,J,q", [(40, 120, 16), (576, 640, 512)])
def test_iterate_matches_jax(I, J, q):
    """Below q = 512 the standard schedules, from q = 512 the shortened ones."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import factored_step as jfs

    b = _gapped(I, J, q, seed=q)
    om = np.random.default_rng(1).standard_normal((J, q)).astype(np.float32)
    y0, g = b @ om, b @ b.T
    n2 = np.float32(np.trace(g))
    want = np.asarray(jfs._iterate_xla(jnp.asarray(y0), jnp.asarray(g), jnp.asarray(n2), 1e-6),
                      np.float64)
    got = tfs._iterate(torch.as_tensor(y0), torch.as_tensor(g), torch.as_tensor(n2),
                       1e-6).double().numpy()
    assert got.shape == (I, q)
    assert np.abs(got @ got.T - want @ want.T).max() < 1e-5


def test_iterate_uses_the_shortened_schedules_from_q_512():
    from tensornetworkforml_torch.ops.kernels import polar_split as tps

    seen = []
    real = tps._pe_schedule

    def spy(*a):
        seen.append(a)
        return real(*a)

    for q, want in ((511, [tps._PE_LOOP, tps._PE_FINAL]),
                    (512, [tfs._PE_LOOP_F, tfs._PE_FINAL_F])):
        seen.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfs, "_pe_schedule", spy)
            y = torch.zeros((q, q))
            q_out = tfs._iterate(y, torch.zeros((q, q)), torch.tensor(1.0), 1e-6, n_power=0)
        assert seen == want and float(q_out.abs().max()) == 0.0  # all columns dead
    assert len(real(*tfs._PE_LOOP_F)) == 4 and len(real(*tfs._PE_FINAL_F)) == 12


def test_auto_takes_the_factored_step_above_md_512(monkeypatch):
    """``two_site_update`` hands the step to the factored update at M*D > 512
    under ``"auto"`` (and at any size under ``"on"``), and materialises B_new
    otherwise."""
    class Factored(Exception):
        pass

    class Split(Exception):
        pass

    def factored(*a):
        raise Factored

    def split(*a, **k):
        raise Split

    monkeypatch.setattr(tsw, "two_site_update_factored", factored)
    monkeypatch.setattr(tsw, "truncated_svd_split", split)
    for m, mode, route in ((257, "auto", Factored), (256, "auto", Split), (4, "on", Factored),
                           (257, "off", Split)):
        lab = torch.zeros((m, 2, 2, m))
        A2 = torch.zeros((m, 2, m))
        x = torch.zeros((2, 2))
        env = torch.zeros((2, m))
        with pytest.raises(route):
            tsw.two_site_update(lab, A2, x, x, env, env, torch.zeros((m, m)),
                                torch.zeros((m, m)), torch.zeros((2, 2)), torch.zeros((2, 2)),
                                0.05, 1e-4, m, 0.1, tsw.SweepConfig(**_cfg(mode)))


@pytest.mark.parametrize("kw", [dict(svd_method="cholqr"), dict(L2_flag=True),
                                dict(rank_mode="reference", split_mode="canonical")])
def test_factored_on_rejects_what_it_does_not_implement(kw):
    _, t, x, y = _inputs("float32")
    cfg = tsw.SweepConfig(**{**_cfg("on"), **kw})
    assert not tfs.factored_supported(cfg, M, 2)
    with pytest.raises(ValueError, match="factored_update='on'"):
        tsw.sweep_once(t, psi_embed(torch.as_tensor(x, dtype=torch.float32)),
                       torch.as_tensor(np.eye(L, dtype=np.float32)[y].T.copy()), 0.05, 1e-4,
                       cfg)


def test_train_model_through_the_factored_route_matches_jax(jax_omega, monkeypatch):
    """One epoch of two batches (a right and a left sweep), float32."""
    from tensornetworkforml_torch.data import loader as tld
    from tensornetworkforml_torch.models.mps import mps_forward
    from tensornetworkforml_torch.train import trainer as ttr
    from tensornetworkforml_tpu.data import loader as jld
    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train.trainer import train_model as jtrain
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.random((48, N)).astype(np.float32)
    y = np.clip((x.mean(axis=1) - 0.35) / 0.1, 0, L - 1).astype(np.int64)
    j = _jax_model(x, "float32")
    calls = []
    real = tsw.two_site_update_factored
    monkeypatch.setattr(tsw, "two_site_update_factored",
                        lambda *a: calls.append(1) or real(*a))

    def loaders(pkg):
        ds = pkg.NumpyDataset(x, y)
        return (pkg.ArrayLoader(ds, B, indices=np.arange(2 * B), shuffle=True, drop_last=True,
                                seed=3),
                pkg.ArrayLoader(ds, B, indices=np.arange(2 * B, 3 * B), drop_last=True))

    kw = dict(lr=0.05, n_epochs=1, weight_dec=1e-4, L2_flag=False, svd_method="polar",
              split_mode="canonical", verbose=False, factored_update="on")
    jm, jval, jhist = jtrain(j, *loaders(jld), **kw)
    tm, tval, thist = ttr.train_model(_port(j), *loaders(tld), **kw)
    assert len(calls) == 2 * (N - 1)
    assert tval == [float(v) for v in jval] and tm.l_pos == jm.l_pos == 0
    jhist = np.asarray(jhist)
    assert thist.shape == jhist.shape == (1, 2, 2 * (N - 1))
    np.testing.assert_allclose(thist[:, 0], jhist[:, 0], rtol=0, atol=1 / B + 1e-6)
    np.testing.assert_allclose(thist[:, 1], jhist[:, 1], rtol=0, atol=TRAIN_TOL)
    fresh = np.random.default_rng(11).random((8, N)).astype(np.float32)
    want = np.asarray(jfw(jm, jpsi(jnp.asarray(fresh))))
    got = mps_forward(tm, psi_embed(torch.as_tensor(fresh))).numpy()
    _close(got, want, TRAIN_F_TOL, "function on fresh inputs")


def test_carried_output_drifts_as_in_jax(jax_omega):
    """The factored update carries f across each truncating split instead of
    recomputing it, so after a sweep its f_final is not the swept model's
    output on the batch. The JAX package's does the same, by the same
    amount; the materialising route's f_final is the model's output."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train import sweep as jsw

    from tensornetworkforml_torch.models.mps import mps_forward

    _, t, x, y = _inputs("float32", seed=4)
    j = _jax_model(x, "float32")
    y1h = np.eye(L, dtype=np.float32)[y].T.copy()
    drift = {}
    for mode in ("on", "off"):
        kw = _cfg(mode)
        jm, _, jff, _ = jsw.sweep_once(j, jpsi(jnp.asarray(x, jnp.float32)), jnp.asarray(y1h),
                                       0.05, 1e-4, jsw.SweepConfig(**kw))
        phi = psi_embed(torch.as_tensor(x, dtype=torch.float32))
        tm, _, tff, _ = tsw.sweep_once(t, phi, torch.as_tensor(y1h), 0.05, 1e-4,
                                       tsw.SweepConfig(**kw))
        jout = np.asarray(jfw(jm, jpsi(jnp.asarray(x, jnp.float32))), np.float64)
        tout = _np(mps_forward(tm, phi))
        drift[mode] = (np.abs(_np(jff) - jout).max() / np.abs(jout).max(),
                       np.abs(_np(tff) - tout).max() / np.abs(tout).max())
    (j_on, t_on), (j_off, t_off) = drift["on"], drift["off"]
    assert max(j_off, t_off) < 1e-4  # the materialising route carries the model's output
    assert min(j_on, t_on) > 10 * max(j_off, t_off)
    assert abs(j_on - t_on) <= TRAIN_TOL
