"""The reduced-precision modes on the CPU: ``utils/precision.py`` and every
entry that takes ``matmul_precision``, against the ``"float32"`` result and
the JAX package's knob.

On the card the names of the table in ``utils/precision.py`` pick IEEE
float32 or TF32 for cuBLAS's float32 products; on the CPU every name gives
the ``"float32"`` result bit for bit, as the JAX package's knob is a no-op
on the CPU (``tests/test_advice_fixes.py``). So:

* each name, on each sweep engine, gives the ``"float32"`` sweep's bits, and
  matches the JAX package's ``sweep_once`` under the same name within
  ``tests/test_torch_sweep.py``'s polar-sweep tolerance (2e-4); an unknown
  name raises ``ValueError`` in both packages;
* the scope sets and restores the CUDA switch, also on an exception, and
  leaves the CPU's settings alone; the splits re-enter IEEE float32 inside a
  reduced scope (a spy reads the switch inside them);
* ``train_model``, ``Trainer``, ``fused_epoch``, the off-path trainers and
  ``ShardedTrainer`` (in a gloo world of two ranks, ``tests/torch_worlds.py``)
  take every name with the ``"float32"`` bits;
* a numpy emulation of K4a and K4b's one-pass TF32 form stays within
  ``ONE_PASS_TOL`` of float64 on an ill-scaled B (each product rounds its
  operands to TF32's 10-bit mantissa: ~3e-4 of the output's max measured at
  three shapes, against 2^-11 = 4.9e-4 a rounding), and reads above the
  3xTF32 form's ``CARD_TOL``.

JAX is imported inside the tests; the gloo ranks never import it.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import product_init
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import polar_split as tps
from tensornetworkforml_torch.train import sweep as tsw
from tensornetworkforml_torch.utils.precision import FULL, REDUCED, matmul_precision
from tests.torch_worlds import World, case_result

MODULE = "tests.test_torch_precision"
NAMES = FULL + REDUCED
SWEEP_TOL = 2e-4  # tests/test_torch_sweep.py: polar sweeps in float32, port against JAX
CARD_TOL = 1e-4  # tests/test_torch_gramfree.py: the 3xTF32 form against float64
ONE_PASS_TOL = 1e-3  # the one-pass form against float64: about two TF32 roundings


def _switch():
    return torch.backends.cuda.matmul.allow_tf32


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if hasattr(a, "sites"):
        return _same((a.sites, a.label_site if hasattr(a, "label_site") else a.w),
                     (b.sites, b.label_site if hasattr(b, "label_site") else b.w))
    return a == b


def _model(N=8, M=4, L=3, B=12, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N)).astype(np.float32)
    y = rng.integers(0, L, B)
    t = product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, act_fn="linear",
                     loss_fn="MSE", calibration_x=x, device="cpu")
    return t, psi_embed(torch.as_tensor(x)), torch.as_tensor(np.eye(L, dtype=np.float32)[y].T)


def _cfg(engine, name):
    return tsw.SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False,
                           split_mode="canonical", svd_method="polar", engine=engine,
                           matmul_precision=name)


# ---- sweeps -------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("engine", ["xla", "hybrid", "fused"])
def test_every_name_gives_the_float32_bits_on_the_cpu(engine, name):
    t, phi, y1h = _model()
    want = tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, _cfg(engine, "float32"))
    got = tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, _cfg(engine, name))
    assert _same(got, want)
    assert not _switch()


@pytest.mark.parametrize("name", NAMES)
def test_each_name_matches_the_jax_sweep_under_that_name(name, monkeypatch):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init as jinit
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega
    from tensornetworkforml_tpu.train import sweep as jsw
    from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)
    rng = np.random.default_rng(1)
    x, y = rng.random((16, 10)), rng.integers(0, 3, 16)
    j = jinit(jax.random.PRNGKey(1), N=10, M=8, L=3, act_fn="linear", loss_fn="MSE",
              dtype=jnp.float32, calibration_x=x)
    t = mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                       act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")
    y1h = np.eye(3, dtype=np.float32)[y].T
    kw = dict(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
              svd_method="polar", matmul_precision=name)
    jm, jf0, jff, _ = jsw.sweep_once(j, jpsi(jnp.asarray(x, jnp.float32)), jnp.asarray(y1h),
                                     0.05, 1e-4, jsw.SweepConfig(**kw))
    tm, tf0, tff, _ = tsw.sweep_once(t, psi_embed(torch.as_tensor(x, dtype=torch.float32)),
                                     torch.as_tensor(y1h), 0.05, 1e-4, tsw.SweepConfig(**kw))
    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_torch.models.mps import mps_forward

    fresh = np.random.default_rng(7).random((8, 10))
    jfresh = jfw(jm, jpsi(jnp.asarray(fresh, jnp.float32)))
    tfresh = mps_forward(tm, psi_embed(torch.as_tensor(fresh, dtype=torch.float32)))
    for got, want in ((tf0, jf0), (tff, jff), (tfresh, jfresh)):
        want = np.asarray(want, np.float64)
        assert np.abs(got.double().numpy() - want).max() <= SWEEP_TOL * max(1.0, np.abs(want).max())


def test_an_unknown_name_raises_in_both_packages():
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init as jinit
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train import sweep as jsw

    t, phi, y1h = _model()
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tsw.sweep_once(t, phi, y1h, 0.05, 1e-4, _cfg("xla", "tf32"))
    assert not _switch()
    x = np.random.default_rng(0).random((8, 6))
    j = jinit(jax.random.PRNGKey(0), N=6, M=4, L=2, act_fn="linear", loss_fn="MSE",
              dtype=jnp.float32, calibration_x=x)
    with pytest.raises(ValueError):
        jsw.sweep_once(j, jpsi(jnp.asarray(x, jnp.float32)), jnp.ones((2, 8), jnp.float32),
                       0.05, 1e-4, jsw.SweepConfig(act_fn="linear", loss_fn="MSE",
                                                   matmul_precision="tf32"))


# ---- the scope ------------------------------------------------------------------

def _cpu_settings():
    mk = torch.backends.mkldnn
    return (getattr(mk, "fp32_precision", None),
            getattr(getattr(mk, "matmul", None), "fp32_precision", None),
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("name", NAMES)
def test_the_scope_sets_and_restores_the_cuda_switch(name):
    before = _cpu_settings()
    assert not _switch()
    with matmul_precision(name):
        assert _switch() == (name in REDUCED)
        assert _cpu_settings() == before
        with matmul_precision("float32"):
            assert not _switch()
        assert _switch() == (name in REDUCED)
    assert not _switch()
    with pytest.raises(KeyError):
        with matmul_precision(name):
            raise KeyError("inside")
    assert not _switch() and _cpu_settings() == before


def test_the_scope_leaves_cpu_products_alone():
    r = np.random.default_rng(3)
    a, b = (torch.as_tensor(r.standard_normal((96, 80)), dtype=torch.float32) for _ in range(2))
    want = a @ b.T
    with matmul_precision("bfloat16"):
        got = a @ b.T
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown matmul precision"):
        with matmul_precision("TF32"):
            pass
    assert not _switch()


def _seen(monkeypatch, module, name):
    """Spy on ``module.name``: the CUDA switch at each call."""
    real, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        seen.append(_switch())
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("method,spied", [
    ("polar", (tsvd, "rangefinder_omega")),
    ("cholqr", (tsvd, "rangefinder_omega")),
    ("rangefinder", (tsvd, "rangefinder_omega")),
    ("gram", (torch.linalg, "eigh")),
    ("cholsvd", (torch.linalg, "cholesky_ex")),
    ("svd", (torch.linalg, "svd")),
])
def test_splits_run_with_the_switch_off_inside_a_reduced_scope(method, spied, monkeypatch):
    b = torch.as_tensor(np.random.default_rng(2).standard_normal((16, 48)), dtype=torch.float32)
    seen = _seen(monkeypatch, *spied)
    with matmul_precision("tensorfloat32"):
        q, r = tsvd.truncated_svd_split(b, 4, method, split_mode="canonical")
        assert _switch()
    assert seen and not any(seen)
    assert q.shape == (16, 4) and torch.isfinite(r).all()


def test_gramfree_split_scopes_its_parts(monkeypatch):
    """Inside a reduced scope the gram-free split's Newton-Schulz passes run
    with the switch off; with reduced ``precision`` and ``ns_prec`` it calls
    the one-pass wrappers, and its passes still see the switch off."""
    b = torch.as_tensor(np.random.default_rng(4).standard_normal((24, 96)), dtype=torch.float32)
    seen = _seen(monkeypatch, tps, "_polar_ns_greedy")
    one = {n: _seen(monkeypatch, tps, n) for n in ("gramfree_sketch_tf32", "gramfree_gmul_tf32")}
    with matmul_precision("tensorfloat32"):
        want = tps.gramfree_split(b, 6)
    assert seen == [False, False] and not any(one.values())
    seen.clear()
    got = tps.gramfree_split(b, 6, precision="tensorfloat32", ns_prec="high")
    assert seen == [False, False] and all(v == [False] for v in one.values())
    assert _same(got, want)  # the CPU: every name gives the float32 result


# ---- the entries that take the name ---------------------------------------------

def _loaders(N=8, B=8, n_batches=4, L=3, seed=0):
    from tensornetworkforml_torch.data.loader import ArrayLoader, NumpyDataset

    rng = np.random.default_rng(seed)
    x = rng.random((n_batches * B, N)).astype(np.float32)
    ds = NumpyDataset(x, rng.integers(0, L, n_batches * B))
    return ArrayLoader(ds, batch_size=B), ArrayLoader(ds, batch_size=B)


@pytest.mark.parametrize("name", ["float32", "tensorfloat32", "bfloat16"])
def test_train_model_matmul_precision_kwarg(name):
    """The port of ``tests/test_advice_fixes.py``'s knob test: ``train_model``
    and ``Trainer`` take the name and give the same result, and every name
    the ``"float32"`` bits on the CPU."""
    from tensornetworkforml_torch.models.mps import mps_init
    from tensornetworkforml_torch.train.trainer import Trainer, train_model

    mps = mps_init(torch.Generator().manual_seed(0), N=8, M=4, L=3, act_fn="softmax",
                   loss_fn="cross_entropy", device="cpu")
    runs = {}
    for n in {"float32", name}:
        tl, vl = _loaders()
        runs[n] = train_model(mps, tl, vl, lr=0.05, n_epochs=1, matmul_precision=n,
                              verbose=False)
    m, val_acc, _ = runs[name]
    assert len(val_acc) == 1 and np.isfinite(val_acc[0])
    tl, vl = _loaders()
    m2, val_acc2, _ = Trainer(lr=0.05, matmul_precision=name, verbose=False).fit(mps, tl, vl, 1)
    assert val_acc2 == pytest.approx(val_acc)
    assert _same(m, runs["float32"][0]) and _same(m2, m)


def test_matmul_precision_knob_compiles():
    """The port of ``tests/test_canonical.py``'s knob test: a canonical sweep
    with ``matmul_precision="float32"`` stays finite."""
    from tensornetworkforml_torch.models.canonical import canonical_init

    mps = canonical_init(torch.Generator().manual_seed(0), N=10, M=4, L=2, act_fn="linear",
                         loss_fn="MSE", device="cpu")
    rng = np.random.default_rng(0)
    phi = psi_embed(torch.as_tensor(rng.random((8, 10)), dtype=torch.float32))
    y = torch.as_tensor(np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)].T)
    cfg = tsw.SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False,
                          split_mode="canonical", matmul_precision="float32")
    mps2, *_ = tsw.sweep_once(mps, phi, y, 0.05, 1e-5, cfg)
    assert bool(torch.isfinite(mps2.sites).all())


@pytest.mark.parametrize("name", REDUCED)
def test_fused_epoch_takes_every_name(name):
    from tensornetworkforml_torch.train.epoch import fused_epoch

    t, _, _ = _model()
    rng = np.random.default_rng(5)
    x, y = rng.random((2, 12, 8)).astype(np.float32), rng.integers(0, 3, (2, 12))
    out = fused_epoch(t, x, y, 0.05, 1e-4, _cfg("xla", name))
    assert _same(out, fused_epoch(t, x, y, 0.05, 1e-4, _cfg("xla", "float32")))


@pytest.mark.parametrize("name", REDUCED)
def test_off_path_trainers_take_every_name(name):
    from tensornetworkforml_torch.models.boundary import boundary_product_init
    from tensornetworkforml_torch.train import brickwall as tbw
    from tensornetworkforml_torch.train import onesite as tos

    rng = np.random.default_rng(6)
    x = rng.random((16, 8)).astype(np.float32)
    b = boundary_product_init(torch.Generator().manual_seed(6), N=8, M=4, L=3,
                              calibration_x=x, device="cpu")
    phi = psi_embed(torch.as_tensor(x))
    y1h = torch.as_tensor(np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)].T)
    for split in ("cholqr", "rangefinder"):
        got = tbw.brick_sweep(b, phi, y1h, 0.05, 1e-4,
                              tbw.BrickConfig(split_method=split, matmul_precision=name))
        want = tbw.brick_sweep(b, phi, y1h, 0.05, 1e-4, tbw.BrickConfig(split_method=split))
        assert _same(got, want)
    got = tbw.brick_epoch(b, x[None], rng.integers(0, 3, (1, 16)), 0.05, 1e-4,
                          tbw.BrickConfig(matmul_precision=name))
    assert torch.isfinite(got[0].sites).all()
    for left in (False, True):
        got = tos.onesite_sweep(b, phi, y1h, 0.05, 1e-4, left,
                                tos.OneSiteConfig(matmul_precision=name))
        assert _same(got, tos.onesite_sweep(b, phi, y1h, 0.05, 1e-4, left, tos.OneSiteConfig()))
    assert not _switch()
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tbw.brick_sweep(b, phi, y1h, 0.05, 1e-4, tbw.BrickConfig(matmul_precision="f32"))
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tos.onesite_sweep(b, phi, y1h, 0.05, 1e-4, False,
                          tos.OneSiteConfig(matmul_precision="f32"))


# ---- ShardedTrainer in a gloo world of two ranks --------------------------------

def case_sharded(p):
    """One ShardedTrainer step under each name (the port of
    ``tests/test_advice_fixes.py``'s sharded knob test)."""
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.parallel.mesh import make_mesh

    import torch.distributed as dist

    mesh = make_mesh(shape=(dist.get_world_size(), 1), device="cpu")
    rng = np.random.default_rng(0)
    x, y = rng.random((8, 6)), rng.integers(0, 2, 8)
    out = {}
    for name in NAMES:
        mps = product_init(torch.Generator().manual_seed(0), N=6, M=4, L=2, act_fn="softmax",
                           loss_fn="full_cross_ent", calibration_x=x, device="cpu")
        cfg = tsw.SweepConfig(act_fn="softmax", loss_fn="full_cross_ent",
                              matmul_precision=name)
        tr = ShardedTrainer(mesh, mps, lr=0.01, weight_dec=1e-3, cfg=cfg)
        out[name] = dict(acc=tr.step(x, y), sites=tr.mps.sites.numpy(),
                         label=tr.mps.label_site.numpy())
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, MODULE, ["sharded"], {}, tmp_path_factory.mktemp("precision")).start()
    yield w
    try:
        w.results()
    except RuntimeError:
        pass


def test_sharded_step_matmul_precision_traces(world):
    for rank in (0, 1):
        res = case_result(world, "sharded", rank)
        want = res["float32"]
        for name in NAMES:
            got = res[name]
            assert np.isfinite(got["acc"]) and got["acc"] == want["acc"]
            assert np.array_equal(got["sites"], want["sites"])
            assert np.array_equal(got["label"], want["label"])


# ---- the one-pass form, emulated ---------------------------------------------------

def _tf32(x):
    """float32 -> tf32 by round-to-nearest (ties away), as ``cvt.rna.tf32.f32``."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _ill_scaled(I, J, q, seed):
    """``tests/test_torch_gramfree.py``'s B: row scales over 1e-3 to 1e3."""
    r = np.random.default_rng(seed)
    scale = np.logspace(-3, 3, I)[r.permutation(I)]
    b = (r.standard_normal((I, J)) / np.sqrt(J) * scale[:, None]).astype(np.float32)
    om = r.standard_normal((J, q)).astype(np.float32)
    y1 = np.linalg.qr(r.standard_normal((I, q)))[0].astype(np.float32)
    return b, om, y1


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", [(64, 384, 32), (256, 2560, 128)])
def test_one_pass_tf32_holds_its_bound_against_float64(shape):
    """K4a and K4b's one-pass form emulated: each operand rounded to TF32, the
    products exact in float64 (a TF32 product fits float32's mantissa), ``t``
    stored as float32 between K4b's halves. Within ONE_PASS_TOL of float64,
    and above CARD_TOL, which the 3xTF32 form meets."""
    b, om, y1 = _ill_scaled(*shape, seed=shape[2])
    b64 = b.astype(np.float64)
    bt = _tf32(b).astype(np.float64)
    y0 = bt @ _tf32(om)
    t = (bt.T @ _tf32(y1)).astype(np.float32)
    z = bt @ _tf32(t)
    for got, want in ((y0, b64 @ om), (z, b64 @ (b64.T @ y1))):
        assert CARD_TOL < _rel(got, want) < ONE_PASS_TOL
