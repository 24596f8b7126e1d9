"""K7, the fused engine's whole two-site step, and ``engine="fused"``: the
plain version against the JAX package's ``two_site_step_pallas`` (interpret
mode on the CPU) with the JAX package's Omega, the label layouts, fused sweeps
against the JAX package's fused sweeps, and the CUDA kernel against the plain
version on a card.

JAX is imported inside the fixtures and tests, so that the tests marked
``cuda`` run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_step_kernel.py``.

Tolerances:
* single steps in float32, each output relative to its largest entry:
  ``f_new`` and the metrics 1e-5 (sums of a few thousand float32 products in
  another order, as K2's tests); ``a_left``, ``lab_new``, ``lenv_new`` and
  ``a_left . lab_new`` (= Q R per label) 1e-4: the split's ~19 Newton-Schulz
  passes amplify the reductions' rounding (measured up to 3e-5, at the looped
  shape L=10, M=64, B=512);
* whole sweeps in float32: 2e-4 on ``f_final``, on the swept model's outputs
  for fresh inputs and on the metric series, what the JAX package holds its
  fused engine to against its xla engine; the accuracy series exactly. They
  run on the inputs of the JAX package's own fused-engine tests
  (``tests/test_split_kernel.py``), where the two packages agree to ~3e-5:
  the sweep amplifies float32 rounding chaotically, and over six other draws
  the two packages' sweeps part by 1e-5 to 5e-4 on either engine (xla
  included), as the JAX package's two engines part by up to 4e-5. On the
  JAX weight-decay test's own draw (seed 3, decay 0.3) the port's fused sweep
  ends 3.7e-4 from the JAX package's, so the 2e-4 parity test runs on the
  seed-0 draw, and on seed 3 each package's float32 sweep is held against a
  float64 run of the port's fused sweep (the plain version, float64 carry)
  instead: 1e-3 on ``f_final`` and on fresh outputs. Over 16 further draws
  (seeds 4-11, decay 0.3 and 1e-5) both packages ended 6e-6 to 8e-4 from
  float64, on average equally far; on seed 3 the port is 3.6e-4 from it and
  the JAX package 1.7e-5. There, at step 1, float64 finds 7 live columns and
  the port's float32 8: a column whose true norm lies below ``dead_tol``
  keeps its rounding and is kept (``tests/torch_fused_spread.py``);
* on the card, the kernel against the plain version on the same inputs:
  ``f_new`` and the metrics 1e-5 of their max (K2's limit); Q against Q'
  (``a_left`` over the renormalisation factor) by K1's limits, the projector
  1e-3 and the isometry of the live columns 1e-4; ``a_left . lab_new`` 1e-4
  of max|B_new|; ``lenv_new`` against ``left @ a_left`` from the kernel's own
  ``a_left``, 1e-5 of its max; the renormalisation factor, which cancels from
  those, on its own: ``gg`` (the largest column norm of ``a_left``) 1e-5
  relative to the plain one's, and the row norms of ``lenv_new``
  (``gg |Q^T left[b]|``, free of Q's gauge) 1e-4 of their max, as ``Q R``
  (float32 against float64 on the CPU at these shapes: <= 5e-7 and <= 5e-6,
  ``tests/torch_fused_spread.py``);
  one fused sweep against the same sweep with the
  plain version: 2e-2 of max|f| on ``f_final`` (``chip_smoke.py``'s
  ``SWEEP_TOL``: per-step float32 differences grow along the sweep).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import step_kernel as tsk
from tensornetworkforml_torch.train import sweep as tsw
from tests.test_torch_sweep import _assert_sweeps_close, _both_sweeps, _models, _port

STEP_TOL, SPLIT_TOL = 1e-5, 1e-4
SWEEP_TOL = 2e-4
WITNESS_TOL = 1e-3
CARD_PROJ_TOL, CARD_ISO_TOL, CARD_SWEEP_TOL = 1e-3, 1e-4, 2e-2
NAMES = ("a_left", "lab_new", "lenv_new", "f_new", "metrics")


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
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(L, M, D, B, seed):
    """One step's kernel-layout inputs: embedded pixels for x1, x2."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    px = rng.random((B, 2))
    phi = np.stack([np.sin(np.pi * px / 2), np.cos(np.pi * px / 2)], axis=-1).astype(f32)
    return dict(
        lab=(rng.standard_normal((L, M * D, M)) / np.sqrt(M)).astype(f32),
        a2=(rng.standard_normal((M, D, M)) / np.sqrt(M)).astype(f32),
        x1=phi[:, 0].copy(), x2=phi[:, 1].copy(),
        lenv=rng.standard_normal((B, M)).astype(f32),
        renv=rng.standard_normal((B, M)).astype(f32),
        y1h=np.eye(L, dtype=f32)[rng.integers(0, L, B)].T.copy(),
        f=(0.3 * rng.standard_normal((L, B))).astype(f32),
    )


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _qr(a_left, lab_new):
    """``a_left . lab_new`` per label: the updated two-site block Q R."""
    return np.einsum("im,omj->oij", _np(a_left), _np(lab_new))


# name: ((L, M, B), options); lr 0.5 makes the L1 clip fire and the cap bite
STEP_CASES = {
    "base": ((3, 8, 16), {}),
    "growth_cap": ((3, 8, 16), dict(growth_cap=1e-3)),
    "renorm_envs": ((3, 8, 16), dict(renorm_envs=True)),
    "softmax_ce": ((3, 8, 16), dict(act_fn="softmax", loss_fn="cross_entropy", T=0.5)),
    # L*I*max(B, JC)*4 > 2 MB: the Pallas body's looped form
    "looped_cap_renorm": ((10, 64, 512), dict(growth_cap=1e-3, renorm_envs=True)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_plain_version_matches_pallas(case, jax_omega):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.step_kernel import two_site_step_pallas

    (L, M, B), kw = STEP_CASES[case]
    inp = _inputs(L, M, 2, B, seed=M + B)
    want = two_site_step_pallas(*[jnp.asarray(v) for v in inp.values()], 0.5, 1e-3,
                                interpret=True, **kw)
    args = [torch.as_tensor(v) for v in inp.values()]
    launches = tsk.two_site_step.launches
    got = tsk.two_site_step(*args, 0.5, 1e-3, **kw)
    assert tsk.two_site_step.launches == launches  # CPU: the plain version
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        tol = STEP_TOL if name in ("f_new", "metrics") else SPLIT_TOL
        assert _rel(g, w) < tol, (name, _rel(g, w))
    assert _rel(_qr(got[0], got[1]), _qr(want[0], want[1])) < SPLIT_TOL
    assert float(got[4][0, 3]) > float(got[4][0, 2])  # the clip fired
    if "growth_cap" in kw:  # and the cap bites: without it f_new moves
        free = tsk.two_site_step(*args, 0.5, 1e-3, **{**kw, "growth_cap": 0.0})
        assert _rel(free[3], got[3]) > 1e-3


def test_accuracy_is_the_one_hot_max_rule():
    """acc counts a sample when its target's activation ties the maximum, as
    the Pallas kernel does, rather than taking argmax's first index."""
    inp = _inputs(3, 2, 2, 4, seed=1)
    inp["f"] = np.array([[1, 0, 2, 0], [1, 1, 0, 0], [0, 1, 2, 0]], np.float32)
    inp["y1h"] = np.eye(3, dtype=np.float32)[[1, 2, 2, 0]].T.copy()
    out = tsk.two_site_step_reference(*[torch.as_tensor(v) for v in inp.values()], 0.1, 0.0)
    assert float(out[4][0, 0]) == 1.0


def test_layouts_match_jax_and_round_trip():
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels import step_kernel as jsk

    M, D, L = 6, 2, 4
    lab = np.random.default_rng(0).standard_normal((M, D, L, M))
    to_k = tsk.label_to_kernel_layout(torch.as_tensor(lab))
    assert np.array_equal(_np(to_k), np.asarray(jsk.label_to_kernel_layout(jnp.asarray(lab))))
    back = tsk.label_from_kernel_layout(to_k.reshape(L, M, D * M))
    assert torch.equal(back, torch.as_tensor(lab))
    new = np.random.default_rng(1).standard_normal((L, M, D * M))
    assert np.array_equal(_np(tsk.label_from_kernel_layout(torch.as_tensor(new))),
                          np.asarray(jsk.label_from_kernel_layout(jnp.asarray(new))))


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    args = [torch.as_tensor(v).to("meta") for v in _inputs(2, 2, 2, 4, seed=0).values()]
    with pytest.raises(ValueError, match="CUDA"):
        tsk.two_site_step(*args, 0.1, 0.0)


# ---- engine="fused" --------------------------------------------------------

def _fused(**kw):
    return {**dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                   svd_method="polar", engine="fused"), **kw}


def _jax_test_inputs(seed):
    """The model and data of the JAX package's fused-engine tests
    (``tests/test_split_kernel.py``): N=12, M=8, L=3, B=16, float32, from
    ``default_rng(seed)`` and ``PRNGKey(0)``; then fresh inputs."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    rng = np.random.default_rng(seed)
    N, M, L, B = 12, 8, 3, 16
    j = product_init(jax.random.PRNGKey(0), N=N, M=M, L=L, act_fn="linear", loss_fn="MSE",
                     dtype=jnp.float32, calibration_x=rng.random((B, N)))
    x = rng.random((B, N)).astype(np.float32)
    y = rng.integers(0, L, B)
    return j, _port(j), x, y, rng.random((8, N))


@pytest.mark.parametrize("kw", [{}, dict(growth_cap=1e-3, renorm_envs=True)])
def test_fused_sweeps_right_and_left_match_jax(kw, jax_omega):
    """The port's fused sweep against the JAX package's (interpret mode), a
    right sweep and then a left one."""
    j, t, x, y, fresh = _jax_test_inputs(0)
    series = ("accuracy", "MAE", "mean_abs_B", "mean_abs_deltaB", "mean_abs_f")
    for _ in range(2):
        jres, tres = _both_sweeps(j, t, x, y, _fused(**kw), lr=0.1, wd=1e-5)
        _assert_sweeps_close(jres, tres, fresh, SWEEP_TOL, series)
        assert torch.equal(tres[3]["accuracy"], torch.as_tensor(np.array(jres[3]["accuracy"])))
        assert tres[2].dtype == torch.float32
        j, t = jres[0], _port(jres[0])


def test_fused_engine_matches_the_xla_polar_engine(jax_omega):
    """Same Omega and schedules: the port's fused sweep reproduces its xla
    polar sweep (the JAX package's test_fused_step_engine_matches_xla_polar_path)."""
    _, t, x, y, fresh = _jax_test_inputs(0)
    phi = psi_embed(torch.as_tensor(x))
    y1h = torch.as_tensor(np.eye(3, dtype=np.float32)[y].T.copy())
    mx, f0x, ffx, metx = tsw.sweep_once(t, phi, y1h, 0.1, 1e-5,
                                        tsw.SweepConfig(**_fused(engine="xla")))
    mf, f0f, fff, metf = tsw.sweep_once(t, phi, y1h, 0.1, 1e-5, tsw.SweepConfig(**_fused()))
    assert _rel(f0f, f0x) < 1e-6 and np.abs(_np(fff) - _np(ffx)).max() < SWEEP_TOL
    assert torch.equal(metf["accuracy"], metx["accuracy"])
    fresh = psi_embed(torch.as_tensor(fresh, dtype=torch.float32))
    assert np.abs(_np(mps_forward(mf, fresh)) - _np(mps_forward(mx, fresh))).max() < SWEEP_TOL


def test_fused_engine_applies_weight_decay(jax_omega):
    """At a large decay (0.3) the port's fused sweep matches the JAX
    package's, records sum|dB| after the decay and before the clip, and
    differs from the same sweep without decay."""
    j, t, x, y, fresh = _jax_test_inputs(0)
    jres, tres = _both_sweeps(j, t, x, y, _fused(), lr=0.1, wd=0.3)
    _assert_sweeps_close(jres, tres, fresh, SWEEP_TOL, ("accuracy", "MAE"))
    np.testing.assert_allclose(_np(tres[3]["mean_abs_deltaB"]),
                               np.asarray(jres[3]["mean_abs_deltaB"]), rtol=1e-3)
    _, tres0 = _both_sweeps(j, t, x, y, _fused(), lr=0.1, wd=0.0)
    assert np.abs(_np(tres[2]) - _np(tres0[2])).max() > 1e-3


def _fused_sweep_float64(j, x, y, wd, monkeypatch):
    """The port's fused sweep of the JAX model ``j`` run in float64: the plain
    version of the step on a float64 carry."""
    from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

    carry = tsw._f32_carry
    monkeypatch.setattr(tsw, "_f32_carry", lambda *a: tuple(t.double() for t in carry(*a)))
    t64 = mps_from_numpy(np.asarray(j.sites, np.float64), np.asarray(j.label_site, np.float64),
                         l_pos=j.l_pos, act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")
    y1h = torch.as_tensor(np.eye(j.L)[y].T)
    out = tsw.sweep_once(t64, psi_embed(torch.as_tensor(x, dtype=torch.float64)), y1h, 0.1, wd,
                         tsw.SweepConfig(**_fused()))
    monkeypatch.setattr(tsw, "_f32_carry", carry)
    assert out[2].dtype == torch.float64
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fused_weight_decay_sweep_tracks_float64_on_the_jax_draw(package, jax_omega,
                                                                 monkeypatch):
    """On the JAX package's own weight-decay draw (seed 3, decay 0.3), each
    package's float32 fused sweep against a float64 run of the same sweep:
    ``f_final`` and the swept model's outputs on fresh inputs."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    j, t, x, y, fresh = _jax_test_inputs(3)
    jres, tres = _both_sweeps(j, t, x, y, _fused(), lr=0.1, wd=0.3)
    w = _fused_sweep_float64(j, x, y, 0.3, monkeypatch)
    want = _np(mps_forward(w[0], psi_embed(torch.as_tensor(fresh, dtype=torch.float64))))
    if package == "port":
        f_final = _np(tres[2])
        got = _np(mps_forward(tres[0], psi_embed(torch.as_tensor(fresh, dtype=torch.float32))))
    else:
        f_final = _np(jres[2])
        got = _np(jfw(jres[0], jpsi(jnp.asarray(fresh, dtype=jnp.float32))))
    assert np.abs(f_final - _np(w[2])).max() < WITNESS_TOL
    assert np.abs(got - want).max() < WITNESS_TOL


def test_fused_engine_trains():
    """train_batch with engine="fused" learns the diagonals task, as the JAX
    package's test_fused_step_engine_trains_and_rejects_bad_configs."""
    from tensornetworkforml_torch.data.diagonals import create_dataset
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.mps import product_init

    data, labels = create_dataset(256, linear_dim=4, sigma=0.5, seed=0)
    tl, _, _ = prepare_dataset(data, labels, 1.0, 0.0, 64, 64, 64, embed=False, seed=1)
    x_cal, _ = next(tl.batches())
    mps = product_init(torch.Generator().manual_seed(0), N=16, M=8, L=2, act_fn="linear",
                       loss_fn="MSE", calibration_x=x_cal, device="cpu")
    cfg = tsw.SweepConfig(**_fused())
    accs = []
    for _ in range(3):
        for xb, yb in tl.batches():
            mps, acc, _ = tsw.train_batch(mps, xb, yb, 0.1, 1e-5, cfg)
            accs.append(float(acc))
    assert accs[-1] >= 0.95, accs
    assert bool(torch.isfinite(mps.sites).all())


@pytest.mark.parametrize("kw", [dict(L2_flag=True), dict(split_mode="shared"),
                                dict(rank_mode="adaptive"), dict(update_mode="normalized")])
def test_fused_engine_rejects_what_jax_rejects(kw):
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float32")
    with pytest.raises(ValueError, match="fused"):
        tsw.train_batch(t, x, y, 0.1, 1e-5, tsw.SweepConfig(**_fused(**kw)))


def test_fused_engine_ignores_what_jax_ignores():
    """The JAX package's fused branch reads neither svd_method, nor
    factored_update, nor dist_split: a sweep runs whatever they say."""
    _, t, x, y = _models(N=6, M=4, L=2, B=8, dtype="float32")
    base = tsw.train_batch(t, x, y, 0.1, 1e-5, tsw.SweepConfig(**_fused()))
    other = tsw.train_batch(t, x, y, 0.1, 1e-5, tsw.SweepConfig(**_fused(
        svd_method="svd", factored_update="on", dist_split="cholqr")))
    assert torch.equal(base[0].sites, other[0].sites)


def _per_step_fused_sweep(sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec, T,
                          cfg):
    """The fused sweep as a loop of per-step K7 calls with the mean |f| taken
    between steps, as the sweep ran before its steps were issued in one call."""
    N, M, D, _ = sites.shape
    L = label_site.shape[2]
    dtype, dev = sites.dtype, sites.device
    lab, a2s, x, y1h, r32, l_env, f, lr32, wd32 = tsw._f32_carry(
        sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec)
    A_lefts, metr_rows, mean_abs_f = [], [], []
    for step in range(N - 1):
        a_left, lab_new, l_env, f_new, metr = tsk.two_site_step(
            lab, a2s[step], x[step], x[step + 1], l_env, r32[step + 2], y1h, f, lr32, wd32,
            act_fn=cfg.act_fn, loss_fn=cfg.loss_fn, T=T, renorm_envs=cfg.renorm_envs,
            growth_cap=cfg.growth_cap,
        )
        mean_abs_f.append(f.abs().mean())
        lab, f = lab_new.reshape(L, M * D, M), f_new
        A_lefts.append(a_left.reshape(M, D, M).to(dtype))
        metr_rows.append(metr)
    metr = torch.cat(metr_rows).to(dtype)
    zeros = torch.zeros((N - 1,), dtype=dtype, device=dev)
    metrics = {"accuracy": metr[:, 0], "MAE": metr[:, 1], "sum_abs_B": metr[:, 2],
               "sum_abs_deltaB": metr[:, 3], "mean_abs_f": torch.stack(mean_abs_f),
               "L2_loss": zeros, "sum_abs_L2_grad": zeros}
    label_final = tsk.label_from_kernel_layout(lab.reshape(L, M, D * M)).to(dtype)
    return torch.stack(A_lefts), label_final, f, metrics


@pytest.mark.parametrize("kw", [{}, dict(growth_cap=1e-3, renorm_envs=True)])
def test_fused_sweep_on_cpu_is_the_per_step_loop(kw, monkeypatch):
    """On CPU tensors the fused sweep, issued through ``two_site_sweep``, gives
    the per-step loop's outputs bit for bit (N=10, M=8): the new sites, the
    label core, f_first, f_final and every metric series."""
    _, t, x, y = _models(N=10, M=8, L=3, B=16, dtype="float32")
    phi = psi_embed(torch.as_tensor(x, dtype=torch.float32))
    y1h = torch.as_tensor(np.eye(3, dtype=np.float32)[y].T.copy())
    cfg = tsw.SweepConfig(**_fused(**kw))
    got = tsw.sweep_once(t, phi, y1h, 0.1, 1e-5, cfg)
    monkeypatch.setattr(tsw, "_fused_sweep", _per_step_fused_sweep)
    want = tsw.sweep_once(t, phi, y1h, 0.1, 1e-5, cfg)
    assert torch.equal(got[0].sites, want[0].sites)
    assert torch.equal(got[0].label_site, want[0].label_site)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert got[3][k].dtype == want[3][k].dtype and torch.equal(got[3][k], want[3][k]), k


# ---- the kernel on a card --------------------------------------------------

# (L, M, B, options): the flagship step, ragged shapes, K1's streaming form at
# M = 256 (I = 512), the growth cap and renorm_envs
CARD_CASES = [
    (10, 128, 256, {}),
    (10, 128, 256, dict(growth_cap=1e-3, renorm_envs=True)),
    (3, 48, 100, dict(act_fn="softmax", loss_fn="cross_entropy", T=0.5)),
    (3, 5, 37, dict(renorm_envs=True)),
    (10, 256, 64, dict(growth_cap=1e-3)),
]


def _card_agreement(args, got, want, kw):
    """The card limits of the module docstring; returns the failures."""
    bad = []
    for name in ("f_new", "metrics"):
        i = NAMES.index(name)
        if _rel(got[i], want[i]) > STEP_TOL:
            bad.append((name, _rel(got[i], want[i])))
    lab, a2, x1, _, lenv = args[:5]
    B, I = x1.shape[0], lab.shape[1]
    left = (lenv[:, :, None] * x1[:, None, :]).reshape(B, I)
    if _rel(got[2], left @ got[0]) > STEP_TOL:
        bad.append(("lenv_new vs left @ a_left", _rel(got[2], left @ got[0])))
    q, qp = _np(got[0]), _np(want[0])
    gg, gg_p = np.linalg.norm(q, axis=0).max(), np.linalg.norm(qp, axis=0).max()
    if abs(gg / gg_p - 1) > STEP_TOL:  # 1 without renorm_envs
        bad.append(("gg", gg, gg_p))
    rows = [np.linalg.norm(_np(o[2]), axis=1) for o in (got, want)]
    if _rel(*rows) > SPLIT_TOL:
        bad.append(("|lenv_new[b]|", _rel(*rows)))
    q, qp = q / gg, qp / gg_p  # back to the isometry: a_left = gg Q
    proj = np.abs(q @ q.T - qp @ qp.T).max()
    live = np.linalg.norm(q, axis=0) > 0.5
    iso = np.abs(q[:, live].T @ q[:, live] - np.eye(int(live.sum()))).max()
    if proj > CARD_PROJ_TOL or iso > CARD_ISO_TOL:
        bad.append(("Q", proj, iso))
    if _rel(_qr(got[0], got[1]), _qr(want[0], want[1])) > SPLIT_TOL:
        bad.append(("Q R", _rel(_qr(got[0], got[1]), _qr(want[0], want[1]))))
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("L,M,B,kw", CARD_CASES)
def test_kernel_matches_plain_on_card(L, M, B, kw, cuda):
    args = [torch.as_tensor(v, device=cuda) for v in _inputs(L, M, 2, B, seed=M + B).values()]
    lr, wd = torch.full((1,), 0.5, device=cuda), torch.full((1,), 1e-3, device=cuda)
    launches = tsk.two_site_step.launches
    got = tsk.two_site_step(*args, lr, wd, **kw)
    torch.cuda.synchronize()
    assert tsk.two_site_step.launches == launches + 1
    want = tsk.two_site_step_reference(*args, lr, wd, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
    assert _card_agreement(args, got, want, kw) == []
    again = tsk.two_site_step(*args, lr, wd, **kw)  # no atomics: the same bits
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sweep_on_card_matches_its_plain_version(cuda, monkeypatch):
    from tensornetworkforml_torch.models.mps import product_init

    rng = np.random.default_rng(0)
    N, M, L, B = 24, 32, 10, 64
    x = torch.as_tensor(rng.random((B, N)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(rng.integers(0, L, B), device=cuda)
    mps = product_init(torch.Generator().manual_seed(0), N=N, M=M, L=L, act_fn="linear",
                       loss_fn="MSE", calibration_x=x.cpu().numpy())
    cfg = tsw.SweepConfig(**_fused())
    launches = tsk.two_site_step.launches
    kern = tsw.train_batch(mps, x, y, 0.05, 1e-5, cfg)
    assert tsk.two_site_step.launches == launches + N - 1
    monkeypatch.setattr(tsw, "two_site_sweep", tsk.two_site_sweep_reference)
    plain = tsw.train_batch(mps, x, y, 0.05, 1e-5, cfg)
    fresh = psi_embed(torch.as_tensor(rng.random((B, N)), dtype=torch.float32, device=cuda))
    got, want = mps_forward(kern[0], fresh), mps_forward(plain[0], fresh)
    assert _rel(got, want) < CARD_SWEEP_TOL


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = [torch.as_tensor(v, device=cuda) for v in _inputs(2, 4, 2, 8, seed=0).values()]
    with pytest.raises(TypeError):
        tsk.two_site_step(*[a.double() for a in args], 0.1, 0.0)
    bad = list(args)
    bad[1] = args[1][:, :, :2]  # a2 of the wrong width
    with pytest.raises(ValueError):
        tsk.two_site_step(*bad, 0.1, 0.0)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        tsk.two_site_step(*bad, 0.1, 0.0)


# (N, M, L, B, options): the flagship sweep and a ragged one, each with and
# without the growth cap and renorm_envs
SWEEP_CASES = [
    (196, 128, 10, 256, {}),
    (196, 128, 10, 256, dict(growth_cap=1e-3, renorm_envs=True)),
    (24, 48, 10, 100, {}),
    (24, 48, 10, 100, dict(growth_cap=1e-3, renorm_envs=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,L,B,kw", SWEEP_CASES)
def test_sweep_entry_matches_the_per_step_loop_on_card(N, M, L, B, kw, cuda, monkeypatch):
    """The sweep entry (all N - 1 steps issued from C) against the loop of
    per-step K7 calls in the same build, on the inputs a fused sweep gives it:
    every a_left, the final label core, f_final and the metrics bit for bit;
    mean|f|, which the entry takes from K2's stats row (another summation
    order than torch's mean), to 1e-5 relative. The sweep adds N - 1 to K7's
    launch count."""
    from tensornetworkforml_torch.models.mps import product_init

    rng = np.random.default_rng(N + M)
    x = torch.as_tensor(rng.random((B, N)), dtype=torch.float32, device=cuda)
    y = torch.as_tensor(rng.integers(0, L, B), device=cuda)
    mps = product_init(torch.Generator().manual_seed(0), N=N, M=M, L=L, act_fn="linear",
                       loss_fn="MSE", calibration_x=x.cpu().numpy())
    seen = {}

    def spy(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return tsk.two_site_sweep(*args, **kwargs)

    monkeypatch.setattr(tsw, "two_site_sweep", spy)
    launches = tsk.two_site_step.launches
    tsw.train_batch(mps, x, y, 0.05, 1e-5, tsw.SweepConfig(**_fused(**kw)))
    assert tsk.two_site_step.launches == launches + N - 1
    args, kwargs = seen["args"], seen["kwargs"]
    launches = tsk.two_site_step.launches
    got = tsk.two_site_sweep(*args, **kwargs)
    torch.cuda.synchronize()
    assert tsk.two_site_step.launches == launches + N - 1
    want = tsk.two_site_sweep_reference(*args, step=tsk.two_site_step, **kwargs)
    for name, g, w in zip(("a_lefts", "lab_final", "f_final", "metrics"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    assert bool(torch.isfinite(got[0]).all())
    assert _rel(got[4], want[4]) < 1e-5
