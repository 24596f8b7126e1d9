"""The port's epoch, trainer and loaders against the JAX package's, on the CPU.

* Loaders and the stall rule are host NumPy in both packages: equal exactly.
* ``fused_epoch`` and ``train_model`` with the exact ``svd`` split in
  float64 at N=10, M=8: accuracies equal, every series and the final
  model's function on fresh inputs within 1e-8.
* The same with the ``polar`` split in float32, with the JAX package's Omega
  handed to the port: accuracies equal; the difference starts at float32
  rounding (~5e-7 in the first sweep's MAE series) and grows 2-5x per
  sweep (measured at lr 0.05: 3e-5 after two sweeps, 1e-4 and 1e-3 in the
  MAE series and the function after four). So one epoch of two sweeps is
  held to 2e-4 on the MAE series, and ``train_model``'s four sweeps to 2e-3
  on the function and 5e-4 on the MAE series. The per-step accuracy series
  may differ by one sample where a score sits at a near-tie: 1/B. The
  function after one float32 epoch is held against a float64 run of the
  same epoch instead (``EPOCH_F64_TOL``; ``test_fused_epoch_matches_jax``
  says why).
"""

import ast
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.data import loader as tld
from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import polar_split as tps
from tensornetworkforml_torch.train import epoch as tep
from tensornetworkforml_torch.train import trainer as ttr
from tensornetworkforml_torch.train.sweep import SweepConfig
from tensornetworkforml_torch.utils.checkpoint import load_training_state, mps_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # polar, one epoch of two sweeps
TOL_4 = (2e-3, 5e-4)  # polar, four sweeps: the function, the MAE series
TOL64 = 1e-8  # svd in float64
EPOCH_F64_TOL = 2e-3  # polar: a float32 epoch's function against a float64 run of it
N, M, L = 10, 8, 3


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


def _data(n, seed=0):
    """A learnable toy task: the label is the bin of the mean pixel."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, N)).astype(np.float32)
    y = np.clip((x.mean(axis=1) - 0.35) / 0.1, 0, L - 1).astype(np.int64)
    return x, y


def _jax_model(x, seed=1, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    return product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, act_fn="linear",
                        loss_fn="MSE", dtype=getattr(jnp, dtype), calibration_x=x)


def _port(j):
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")


def _fresh_close(tm, jm, tol=TOL, seed=11):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    x = np.random.default_rng(seed).random((8, N)).astype(np.asarray(jm.sites).dtype)
    want = np.asarray(jfw(jm, jpsi(jnp.asarray(x))), np.float64)
    got = mps_forward(tm, psi_embed(torch.as_tensor(x))).double().numpy()
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _fresh_x(seed=11):
    return np.random.default_rng(seed).random((8, N))


def _fresh_f(tm, dtype=torch.float32):
    x = torch.as_tensor(_fresh_x(), dtype=dtype)
    return mps_forward(tm, psi_embed(x)).double().numpy()


def _fresh_jax_f(jm):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    return np.asarray(jfw(jm, jpsi(jnp.asarray(_fresh_x().astype(np.float32)))), np.float64)


def _split_float64(bmat, rank):
    """hybrid_polar_split run in float64: the sketch (the same Omega), the
    Gram, the plain subspace iteration at the float32 dead_tol, and R."""
    b = bmat.double()
    om = tsvd.rangefinder_omega(b.shape[1], min(rank, b.shape[0]), torch.float64)
    q = tps.polar_iterate_reference(b @ om, b @ b.T, dead_tol=1e-6)
    return tps._canonical_factors(q, rank, b, torch.float64)


def _float64_epoch(t, xe, ye):
    """The port's polar fused epoch on a float64 copy of model and batches,
    with the polar split in float64 too."""
    t64 = t.replace(sites=t.sites.double(), label_site=t.label_site.double())
    with mock.patch.object(tps, "hybrid_polar_split", _split_float64):
        return tep.fused_epoch(t64, xe.astype(np.float64), ye, 0.05, 1e-4,
                               SweepConfig(**_cfg("polar")))[0]


def _loaders(pkg, x, y, B=16, seed=3, n_batches=4):
    ds = pkg.NumpyDataset(x, y)
    n_train = n_batches * B
    train = pkg.ArrayLoader(ds, B, indices=np.arange(n_train), shuffle=True, drop_last=True,
                            seed=seed)
    val = pkg.ArrayLoader(ds, B, indices=np.arange(n_train, n_train + B), drop_last=True)
    return train, val


def test_loaders_match_jax():
    from tensornetworkforml_tpu.data import loader as jld

    x, y = _data(100)
    for kw in (dict(), dict(shuffle=True, seed=5), dict(drop_last=True, seed=2, shuffle=True),
               dict(indices=np.arange(10, 90))):
        a, b = jld.ArrayLoader(jld.NumpyDataset(x, y), 16, **kw), \
            tld.ArrayLoader(tld.NumpyDataset(x, y), 16, **kw)
        assert len(a) == len(b)
        for _ in range(2):  # two epochs: the shuffle stream continues alike
            for (xa, ya), (xb, yb) in zip(a.batches(), b.batches(), strict=True):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
        pa, pb = next(iter(a)), next(iter(b))
        assert len(pa) == len(pb) and all(np.array_equal(u[0], v[0]) for u, v in zip(pa, pb))
        for even in (False, True):
            wa, wb = jld.with_batch_size(a, 7, even), tld.with_batch_size(b, 7, even)
            assert len(wa) == len(wb)
            for (xa, _), (xb, _) in zip(wa.batches(), wb.batches(), strict=True):
                np.testing.assert_array_equal(xa, xb)
    for bs in (1, 2, 64, 127, 128, 129, 256, 340, 1024, 4096):
        assert tld.warmup_batch_size(bs) == jld.warmup_batch_size(bs)


def test_stall_rule_matches_jax():
    from tensornetworkforml_tpu.train.trainer import stall_detected as jstall

    series = [[], [0.5], [0.5, 0.5, 0.5], [0.5, 0.6, 0.7], [0.9, 0.9, 0.902],
              [0.8, 0.85, 0.9, 0.95], [0.5, 0.51, 0.52, 0.53], [0.2, 0.9, 0.2, 0.2]]
    for s in series:
        for kw in (dict(), dict(warmup_epochs=1), dict(patience=1, min_delta=0.0),
                   dict(n_epochs=6), dict(n_epochs=40, threshold=0.6)):
            assert ttr.stall_detected(s, **kw) == jstall(s, **kw), (s, kw)


def _cfg(split):
    return dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                svd_method=split)


@pytest.mark.parametrize("split,dtype,n_batches,tol", [
    ("svd", "float64", 4, TOL64), ("polar", "float32", 2, TOL)])
def test_fused_epoch_matches_jax(split, dtype, n_batches, tol, jax_omega):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train import epoch as jep
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JC

    x, y = _data(16 * n_batches)
    x = x.astype(dtype)
    j = _jax_model(x, dtype=dtype)
    xe, ye = x.reshape(n_batches, 16, N), y.reshape(n_batches, 16)
    jm, jacc, jmet = jep.fused_epoch(j, jnp.asarray(xe), jnp.asarray(ye), 0.05, 1e-4,
                                     JC(**_cfg(split)))
    tm, tacc, tmet = tep.fused_epoch(_port(j), xe, ye, 0.05, 1e-4, SweepConfig(**_cfg(split)))
    assert tm.l_pos == jm.l_pos == 0
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for k, atol in (("accuracy", 1 / 16 + 1e-6 if split == "polar" else tol), ("MAE", tol)):
        assert tmet[k].shape == np.asarray(jmet[k]).shape == (n_batches, N - 1)
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]), rtol=0, atol=atol)
    if split != "polar":
        _fresh_close(tm, jm, tol)
        return
    # Both packages run the polar split in float32 whatever the model's dtype.
    # At the first step of each sweep the two-site matrix is rank-deficient:
    # float64 keeps 7 and 5 live columns there, float32 (both packages) 8,
    # the extra ones rounding directions whose exact norm lies below
    # dead_tol = 1e-6 of the largest. So two float32 runs of this epoch part
    # by rounding: the port's against itself with the label core x (1 + 3e-7)
    # by 1.6e-4 of max|f| on this draw (6e-5 to 1.6e-3 over data seeds 0-5),
    # port against JAX by 3.5e-4 (5e-5 to 2.5e-3), while the float64 run moves
    # by 1.5e-7 under the same rescale. Each package's function is held
    # against that float64 run instead: measured 8.4e-4 (port) and 4.8e-4
    # (JAX) of max|f| on this draw, 7e-5 to 1.8e-3 over seeds 0-5; both here
    # and on the card (chip_smoke.py) the float64 run is the stable reference.
    want = _fresh_f(_float64_epoch(_port(j), xe, ye), torch.float64)
    scale = max(1.0, float(np.abs(want).max()))
    for got in (_fresh_f(tm), _fresh_jax_f(jm)):
        assert np.abs(got - want).max() <= EPOCH_F64_TOL * scale


def test_fused_epoch_checks_its_arguments():
    x, y = _data(32)
    t = _port(_jax_model(x))
    with pytest.raises(ValueError, match="even"):
        tep.fused_epoch(t, x[:16].reshape(1, 16, N), y[:16].reshape(1, 16), 0.1, 0.0)
    with pytest.raises(ValueError, match="site 0"):
        tep.fused_epoch(t.replace(l_pos=N - 1), x.reshape(2, 16, N), y.reshape(2, 16), 0.1, 0.0)
    # mesh epochs are ported (item 11): a world of one on the CPU gives the
    # unsharded epoch
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    try:
        got, accs, met = tep.fused_epoch(t, x.reshape(2, 16, N), y.reshape(2, 16), 0.1, 0.0,
                                         mesh=mesh)
    finally:
        dist.destroy_process_group()
    want, w_accs, w_met = tep.fused_epoch(t, x.reshape(2, 16, N), y.reshape(2, 16), 0.1, 0.0)
    assert torch.equal(got.sites, want.sites) and torch.equal(got.label_site, want.label_site)
    assert torch.equal(accs, w_accs) and torch.allclose(met["MAE"], w_met["MAE"], rtol=1e-12)


@pytest.mark.parametrize("split,dtype,n_batches,tols", [
    ("svd", "float64", 4, (TOL64, TOL64)), ("polar", "float32", 2, TOL_4)])
def test_train_model_matches_jax(split, dtype, n_batches, tols, jax_omega):
    """Two epochs: the lr schedule, the fused epoch, validation, var_hist."""
    from tensornetworkforml_tpu.data import loader as jld
    from tensornetworkforml_tpu.train.trainer import train_model as jtrain

    x, y = _data(96)
    x = x.astype(dtype)
    j = _jax_model(x, dtype=dtype)
    kw = dict(lr=lambda e: 0.05 / (1 + e), n_epochs=2, weight_dec=1e-4, L2_flag=False,
              svd_method=split, split_mode="canonical", verbose=False)
    jm, jval, jhist = jtrain(j, *_loaders(jld, x, y, n_batches=n_batches), **kw)
    tm, tval, thist = ttr.train_model(_port(j), *_loaders(tld, x, y, n_batches=n_batches),
                                      **kw)
    assert tval == [float(v) for v in jval]
    jhist = np.asarray(jhist)
    assert thist.shape == jhist.shape == (2, 2, n_batches * (N - 1))
    acc_tol = 1 / 16 + 1e-6 if split == "polar" else tols[1]
    np.testing.assert_allclose(thist[:, 0], jhist[:, 0], rtol=0, atol=acc_tol)
    np.testing.assert_allclose(thist[:, 1], jhist[:, 1], rtol=0, atol=tols[1])
    _fresh_close(tm, jm, tols[0])


def test_evaluate_accuracy_matches_jax():
    from tensornetworkforml_tpu.data import loader as jld
    from tensornetworkforml_tpu.train.trainer import evaluate_accuracy as jeval

    x, y = _data(80)
    j = _jax_model(x)
    assert ttr.evaluate_accuracy(_port(j), _loaders(tld, x, y)[0]) == pytest.approx(
        jeval(j, _loaders(jld, x, y)[0]), abs=1e-6)


def test_checkpoint_resume_continues_at_the_saved_epoch(tmp_path):
    x, y = _data(96)
    t = _port(_jax_model(x)).replace()
    path = str(tmp_path / "state.npz")
    kw = dict(lr=0.05, weight_dec=1e-4, L2_flag=False, svd_method="svd",
              split_mode="canonical", verbose=False, checkpoint_path=path)
    m1, val1, _ = ttr.train_model(t, *_loaders(tld, x, y), n_epochs=1, **kw)
    saved, epoch = load_training_state(path, m1)
    assert epoch == 1 and torch.equal(saved.sites, m1.sites)
    m2, val2, hist2 = ttr.train_model(t, *_loaders(tld, x, y), n_epochs=3, resume=True, **kw)
    assert len(val2) == 2 and hist2.shape[0] == 2  # epochs 1 and 2 only
    assert load_training_state(path, m2)[1] == 3


def test_restarts_warmup_and_bond_schedule_run_on_the_port():
    x, y = _data(128)
    t = _port(_jax_model(x)).replace()
    calls = []

    def reinit(attempt):
        calls.append(attempt)
        return t

    kw = dict(lr=0.05, weight_dec=1e-4, L2_flag=False, svd_method="svd",
              split_mode="canonical", verbose=False)
    # a stall rule that always fires: every attempt but the last is aborted
    _, val, _ = ttr.train_model(t, *_loaders(tld, x, y), n_epochs=3, restarts=1,
                                reinit_fn=reinit, stall_patience=1, stall_min_delta=1.0,
                                stall_threshold=1.01, **kw)
    assert calls == [1] and len(val) >= 1
    with pytest.raises(ValueError, match="reinit_fn"):
        ttr.train_model(t, *_loaders(tld, x, y), n_epochs=1, restarts=1, **kw)
    grown, _, hist = ttr.train_model(t, *_loaders(tld, x, y), n_epochs=2, warmup_epochs=1,
                                     bond_schedule={1: 10}, **kw)
    assert grown.M == 10 and hist.dtype == object and len(hist) == 2
    trainer = ttr.Trainer(lr=0.05, weight_dec=1e-4, L2_flag=False, svd_method="svd",
                          split_mode="canonical", verbose=False)
    assert len(trainer.fit(t, *_loaders(tld, x, y), n_epochs=1)[1]) == 1


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_the_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tensornetworkforml_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = [m for m in _imported_names(path)
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "tensornetworkforml_tpu")]
        assert not bad, (path, bad)
    code = (
        "import sys, pkgutil, importlib, tensornetworkforml_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tensornetworkforml_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
