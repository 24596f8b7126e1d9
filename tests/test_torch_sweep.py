"""The port's two-site sweep (``train/sweep.py``) against the JAX package's,
on the CPU, with the same inputs made from a seed with numpy.

* Single steps (``two_site_update``) in float64 with the exact ``svd`` split,
  compared through gauge-invariant quantities (the split's factors are
  defined up to a sign per bond direction): f_new, the re-merged pair, the
  new left environment closed with the new label core, the L2 transfer
  product closed with it, and the metrics. Tolerance 1e-9.
* Whole sweeps with ``svd`` in float64: tolerance 1e-8 (rounding compounds
  over the steps).
* Whole sweeps with the ``polar`` split in float32, on both engines, with
  the JAX package's Omega handed to the port: tolerance 2e-4, what
  ``tests/test_hybrid_engine.py`` holds the JAX package's two engines to
  (a 1e-6 difference grows to ~1e-4 over a sweep).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train import sweep as tsw
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

SWEEP_TOL = 2e-4


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max())


# ---- single steps --------------------------------------------------------

STEP_CASES = {
    "shared_L2": dict(L2_flag=True, split_mode="shared"),
    "canonical_decay": dict(L2_flag=False, split_mode="canonical"),
    "canonical_L2_normalized": dict(L2_flag=True, split_mode="canonical",
                                    update_mode="normalized"),
    "growth_cap": dict(L2_flag=False, split_mode="shared", growth_cap=1e-3),
    "renorm_envs": dict(L2_flag=False, split_mode="canonical", renorm_envs=True),
    "reference_rank": dict(L2_flag=True, split_mode="shared", rank_mode="reference"),
    "softmax_full_ce": dict(act_fn="softmax", loss_fn="full_cross_ent", L2_flag=True),
    "sigmoid_ce": dict(act_fn="sigmoid", loss_fn="cross_entropy", L2_flag=False,
                       split_mode="canonical"),
}


def _step_inputs(M=4, D=2, L=3, B=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 2))
    phi = np.stack([np.sin(np.pi * x / 2), np.cos(np.pi * x / 2)], axis=-1)  # (B, 2, D)
    e = rng.standard_normal((M, M))
    return dict(
        label_site=rng.standard_normal((M, D, L, M)) / M,
        A2=rng.standard_normal((M, D, M)) / M,
        x1=phi[:, 0], x2=phi[:, 1],
        l_env=rng.standard_normal((B, M)),
        r_env=rng.standard_normal((B, M)),
        E2=e @ e.T / M,
        r2_step=np.eye(M) + 0.1 * rng.standard_normal((M, M)),
        y_onehot=np.eye(L)[rng.integers(0, L, B)].T.copy(),
        f=0.5 + 0.3 * rng.standard_normal((L, B)),
    )


def _invariants(out):
    """Gauge-invariant summary of two_site_update's outputs (any package)."""
    A, lab, l_env, E2, f_new, m = [_np(o) if not isinstance(o, dict) else o for o in out]
    return {
        "f_new": f_new,
        "pair": np.einsum("aim,mjoc->aijoc", A, lab),
        "env_label": np.einsum("bm,mjoc->bjoc", l_env, lab),
        "E2_label": np.einsum("mn,mjoc,njoc->", E2, lab, lab),
        **{k: _np(v) for k, v in m.items()},
    }


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_site_update_matches_jax(case):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import sweep as jsw

    kw = dict(act_fn="linear", loss_fn="MSE", svd_method="svd")
    kw.update(STEP_CASES[case])
    inp = _step_inputs(seed=len(case))
    rank = 3
    jout = jsw.two_site_update(*[jnp.asarray(v) for v in inp.values()], 0.05, 1e-3,
                               jnp.asarray(rank), 0.2, jsw.SweepConfig(**kw))
    tout = tsw.two_site_update(*[torch.as_tensor(v) for v in inp.values()],
                               torch.tensor(0.05, dtype=torch.float64),
                               torch.tensor(1e-3, dtype=torch.float64), rank, 0.2,
                               tsw.SweepConfig(**kw))
    want, got = _invariants(jout), _invariants(tout)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-9, k)


# ---- whole sweeps, exact split -------------------------------------------

SVD_SWEEPS = {
    "shared_L2": dict(L2_flag=True, split_mode="shared"),
    "canonical_spread": dict(L2_flag=False, split_mode="canonical", renorm_envs=True,
                             norm_spread=True),
    "reference_rank": dict(L2_flag=True, split_mode="shared", rank_mode="reference"),
}


def _models(N, M, L, B, dtype, seed=1):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    rng = np.random.default_rng(seed)
    x = rng.random((B, N))
    j = product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, act_fn="linear",
                     loss_fn="MSE", dtype=getattr(jnp, dtype), calibration_x=x)
    y = rng.integers(0, L, B)
    return j, _port(j), x, y


def _port(j):
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")


def _both_sweeps(j, t, x, y, kw, lr=0.05, wd=1e-4):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train import sweep as jsw

    L = j.L
    y1h = np.eye(L)[y].T
    dt = np.asarray(j.sites).dtype
    jres = jsw.sweep_once(j, jpsi(jnp.asarray(x, dtype=dt)), jnp.asarray(y1h, dtype=dt),
                          lr, wd, jsw.SweepConfig(**kw))
    tres = tsw.sweep_once(t, psi_embed(torch.as_tensor(x, dtype=t.dtype)),
                          torch.as_tensor(y1h), lr, wd, tsw.SweepConfig(**kw))
    return jres, tres


def _assert_sweeps_close(jres, tres, x_fresh, tol, series=("accuracy", "MAE", "mean_abs_B",
                                                            "mean_abs_deltaB", "mean_abs_f")):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    (jm, jf0, jff, jmet), (tm, tf0, tff, tmet) = jres, tres
    assert tm.l_pos == jm.l_pos
    _close(tf0, jf0, tol, "f_first")
    _close(tff, jff, tol, "f_final")
    dt = np.asarray(jm.sites).dtype
    want = jfw(jm, jpsi(jnp.asarray(x_fresh, dtype=dt)))
    got = mps_forward(tm, psi_embed(torch.as_tensor(x_fresh, dtype=tm.dtype)))
    _close(got, want, tol, "function on fresh inputs")
    for k in series:
        _close(tmet[k], jmet[k], tol, k)


@pytest.mark.parametrize("case", sorted(SVD_SWEEPS))
def test_svd_sweeps_right_and_left_match_jax(case):
    kw = dict(act_fn="linear", loss_fn="MSE", svd_method="svd", **SVD_SWEEPS[case])
    j, t, x, y = _models(N=8, M=4, L=3, B=12, dtype="float64")
    fresh = np.random.default_rng(9).random((6, 8))
    jres, tres = _both_sweeps(j, t, x, y, kw)
    _assert_sweeps_close(jres, tres, fresh, 1e-8)
    if case == "reference_rank":
        assert tres[3]["bond_profile"] == jres[3]["bond_profile"]
    # the left sweep, from the JAX model the right sweep left at l_pos = N-1
    jres2, tres2 = _both_sweeps(jres[0], _port(jres[0]), x[::-1].copy(), y[::-1].copy(), kw)
    assert tres2[0].l_pos == 0
    _assert_sweeps_close(jres2, tres2, fresh, 1e-8)


# ---- whole sweeps, polar split (K1) and the hybrid engine (K2 + K1) ------

def _polar(engine, **kw):
    return {**dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                   svd_method="polar", engine=engine), **kw}


@pytest.mark.parametrize("engine", ["xla", "hybrid"])
def test_polar_sweeps_right_and_left_match_jax(engine, jax_omega):
    j, t, x, y = _models(N=10, M=8, L=3, B=16, dtype="float32")
    fresh = np.random.default_rng(7).random((8, 10))
    jres, tres = _both_sweeps(j, t, x, y, _polar(engine))
    _assert_sweeps_close(jres, tres, fresh, SWEEP_TOL)
    jres2, tres2 = _both_sweeps(jres[0], _port(jres[0]), x, y, _polar(engine))
    _assert_sweeps_close(jres2, tres2, fresh, SWEEP_TOL)


@pytest.mark.parametrize("kw", [dict(growth_cap=0.01), dict(renorm_envs=True)])
def test_hybrid_engine_matches_the_xla_engine(kw, jax_omega):
    """Same Omega, same subspace iteration: the port's two engines agree."""
    _, t, x, y = _models(N=10, M=8, L=3, B=16, dtype="float32")
    phi = psi_embed(torch.as_tensor(x, dtype=torch.float32))
    y1h = torch.as_tensor(np.eye(3, dtype=np.float32)[y].T.copy())
    out_x = tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, tsw.SweepConfig(**_polar("xla", **kw)))
    out_h = tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, tsw.SweepConfig(**_polar("hybrid", **kw)))
    for a, b in zip(out_h[1:3], out_x[1:3]):
        _close(a, b, SWEEP_TOL)
    fresh = psi_embed(torch.as_tensor(np.random.default_rng(3).random((8, 10)),
                                      dtype=torch.float32))
    _close(mps_forward(out_h[0], fresh), mps_forward(out_x[0], fresh), SWEEP_TOL)
    for k in ("accuracy", "MAE", "mean_abs_B", "mean_abs_deltaB", "mean_abs_f"):
        _close(out_h[3][k], out_x[3][k], SWEEP_TOL, k)
    sites = out_h[0].sites  # canonical gauge: no left-factor column above unit norm
    assert kw.get("renorm_envs") or float(torch.linalg.vector_norm(sites.reshape(10, -1, 8), dim=1).max()) <= 1 + 1e-4


@pytest.mark.parametrize("M", [192, 256])
def test_hybrid_engine_runs_above_the_tpu_cap(M):
    """The hybrid engine at M*D = 384 and 512, above the JAX package's
    ``M*D <= 256`` cap (a VMEM limit of the TPU), against the port's xla
    polar sweep and its fused sweep on the same model, batch and Omega. The
    JAX package raises at these bonds, so no JAX comparison exists here."""
    from tensornetworkforml_torch.models.mps import product_init

    N, L, B = 5, 3, 8
    rng = np.random.default_rng(M)
    x = torch.as_tensor(rng.random((B, N)), dtype=torch.float32)
    y1h = torch.as_tensor(np.eye(L, dtype=np.float32)[rng.integers(0, L, B)].T.copy())
    t = product_init(torch.Generator().manual_seed(M), N=N, M=M, L=L, act_fn="linear",
                     loss_fn="MSE", calibration_x=x.numpy(), device="cpu")
    phi = psi_embed(x)
    out = {e: tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, tsw.SweepConfig(**_polar(e)))
           for e in ("hybrid", "xla", "fused")}
    fresh = psi_embed(torch.as_tensor(rng.random((8, N)), dtype=torch.float32))
    got = out["hybrid"]
    assert all(bool(torch.isfinite(a).all()) for a in (got[1], got[2], got[0].sites))
    for other in ("xla", "fused"):
        want = out[other]
        for a, b, what in zip(got[1:3], want[1:3], ("f_first", "f_final")):
            _close(a, b, SWEEP_TOL, f"{what} vs {other}")
        _close(mps_forward(got[0], fresh), mps_forward(want[0], fresh), SWEEP_TOL,
               f"fresh scores vs {other}")
    for k in ("accuracy", "MAE", "mean_abs_B", "mean_abs_deltaB", "mean_abs_f"):
        _close(got[3][k], out["xla"][3][k], SWEEP_TOL, k)


def test_train_batch_matches_jax(jax_omega):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import sweep as jsw

    j, t, x, y = _models(N=10, M=8, L=3, B=16, dtype="float32", seed=4)
    jm, jacc, _ = jsw.train_batch(j, jnp.asarray(x), jnp.asarray(y), 0.05, 1e-4,
                                  jsw.SweepConfig(**_polar("xla")))
    tm, tacc, tmet = tsw.train_batch(t, x, y, 0.05, 1e-4, tsw.SweepConfig(**_polar("xla")))
    assert float(tacc) == float(jacc) and tm.l_pos == jm.l_pos == 9
    assert tmet["accuracy"].shape == (9,)
    fresh = np.random.default_rng(2).random((8, 10))
    _close(mps_forward(tm, psi_embed(torch.as_tensor(fresh, dtype=torch.float32))),
           np.asarray(_jax_forward(jm, fresh)), SWEEP_TOL)


def _jax_forward(j, x):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    return jfw(j, jpsi(jnp.asarray(x, dtype=np.asarray(j.sites).dtype)))


def test_step_metrics_off_gives_zeros():
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float64")
    cfg = tsw.SweepConfig(act_fn="linear", loss_fn="MSE", svd_method="svd",
                          step_metrics=False)
    _, _, _, met = tsw.sweep_once(t, psi_embed(torch.as_tensor(x)),
                                  torch.as_tensor(np.eye(2)[y].T), 0.05, 0.0, cfg)
    assert met["accuracy"].shape == (5,) and float(met["accuracy"].abs().max()) == 0.0


# ---- what is not ported, and the hybrid engine's own limits ---------------

@pytest.mark.parametrize("kw,error,match", [
    # dist_split is ported: without its mesh it refuses as the JAX package does
    (dict(dist_split="cholqr"), ValueError, "dist_mesh"),
    # every name of utils/precision.py is ported; a name outside it raises, as
    # the JAX package's knob does
    (dict(matmul_precision="tf32"), ValueError, "unknown matmul precision"),
])
def test_unported_configurations_raise_naming_their_item(kw, error, match):
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float32")
    cfg = tsw.SweepConfig(**{**_polar("xla"), **kw})
    with pytest.raises(error, match=match):
        tsw.sweep_once(t, psi_embed(torch.as_tensor(x, dtype=torch.float32)),
                       torch.as_tensor(np.eye(2, dtype=np.float32)[y].T), 0.05, 0.0, cfg)


def test_fused_engine_rejects_l2_naming_the_engine():
    """engine="fused" (K7) is ported; like the JAX package's, it rejects the
    exact L2 term with a ValueError that names the engine."""
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float32")
    cfg = tsw.SweepConfig(**{**_polar("fused"), "L2_flag": True})
    with pytest.raises(ValueError, match="engine='fused' requires"):
        tsw.sweep_once(t, psi_embed(torch.as_tensor(x, dtype=torch.float32)),
                       torch.as_tensor(np.eye(2, dtype=np.float32)[y].T), 0.05, 0.0, cfg)


@pytest.mark.parametrize("kw", [
    dict(svd_method="rangefinder", split_mode="canonical"),
    dict(svd_method="gram", split_mode="shared"),
])
def test_rangefinder_and_gram_sweeps_match_jax(kw, jax_omega):
    """The two configurations that raised until their splits were ported:
    a right and a left sweep in float64 (the rangefinder below K6's 128 rows,
    with the JAX package's Omega) against the JAX package's."""
    kw = dict(act_fn="linear", loss_fn="MSE", L2_flag=False, **kw)
    j, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float64")
    fresh = np.random.default_rng(9).random((6, 6))
    jres, tres = _both_sweeps(j, t, x, y, kw)
    _assert_sweeps_close(jres, tres, fresh, 1e-8)
    jres2, tres2 = _both_sweeps(jres[0], _port(jres[0]), x, y, kw)
    _assert_sweeps_close(jres2, tres2, fresh, 1e-8)


def test_factored_route_follows_the_jax_rule():
    from tensornetworkforml_tpu.train.factored_step import factored_supported

    for kw in (_polar("xla"), _polar("xla", L2_flag=True),
               dict(_polar("xla"), svd_method="cholqr"), _polar("xla", factored_update="off")):
        cfg = tsw.SweepConfig(**kw)
        for M, D in ((8, 2), (256, 2), (257, 2)):
            want = cfg.factored_update != "off" and factored_supported(cfg, M, D) and (
                cfg.factored_update == "on" or M * D > 512)
            assert tsw._factored_route(cfg, M, D) == want
    with pytest.raises(ValueError, match="factored_update='on'"):
        tsw._factored_route(tsw.SweepConfig(factored_update="on"), 8, 2)


def test_hybrid_engine_checks_its_configuration():
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float32")
    phi = psi_embed(torch.as_tensor(x, dtype=torch.float32))
    y1h = torch.as_tensor(np.eye(2, dtype=np.float32)[y].T)
    with pytest.raises(ValueError, match="hybrid"):
        tsw.sweep_once(t, phi, y1h, 0.05, 0.0, tsw.SweepConfig(**_polar("hybrid",
                                                                          L2_flag=True)))
    # no bond cap: M*D = 384 runs (the JAX package raises above 256)
    rng = np.random.default_rng(0)
    big = mps_from_numpy((np.eye(192)[None, :, None, :] + 1e-2 * rng.standard_normal(
        (4, 192, 2, 192))).astype(np.float32), (np.eye(192)[:, None, None, :] + 1e-2 *
        rng.standard_normal((192, 2, 2, 192))).astype(np.float32), device="cpu")
    out = tsw.sweep_once(big, phi[:, :4], y1h, 0.05, 0.0, tsw.SweepConfig(**_polar("hybrid")))
    assert all(bool(torch.isfinite(a).all()) for a in (out[0].sites, out[1], out[2]))


def test_mirror_is_an_involution_and_the_label_must_sit_at_an_end():
    s = torch.arange(2 * 3 * 2 * 3, dtype=torch.float64).reshape(2, 3, 2, 3)
    assert torch.equal(tsw._mirror_sites(tsw._mirror_sites(s)), s)
    lab = torch.arange(3 * 2 * 4 * 3, dtype=torch.float64).reshape(3, 2, 4, 3)
    assert torch.equal(tsw._mirror_label(tsw._mirror_label(lab)), lab)
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float64")
    with pytest.raises(ValueError, match="chain end"):
        tsw.sweep_once(t.replace(l_pos=2), psi_embed(torch.as_tensor(x)),
                       torch.as_tensor(np.eye(2)[y].T), 0.05, 0.0)
