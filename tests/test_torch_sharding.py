"""The port's ``parallel/`` against the JAX package's, on the CPU, in worlds of
2 and 4 ranks.

The JAX package runs here, in the pytest process, on ``tests/conftest.py``'s
virtual CPU devices (``make_mesh(shape=..., devices=jax.devices()[:n])``, its
Pallas kernels in interpret mode). The port runs in spawned gloo worlds of 2
and 4 ranks (``tests/torch_worlds.py``), started once for this file: each
rank runs every ``case_*`` function below, the same on every rank, on inputs
made here from seeds with numpy and handed over as numpy arrays: the data,
the JAX package's sketch matrices, and the initial models (the JAX test's
own model where its draws are reused, else the port's inits, which the JAX
package then takes as arrays). The ranks hand their results back and never
import JAX.

Tolerances are the JAX package's own in ``tests/test_sharding.py``: the
data-parallel step and epoch at rtol 1e-6, atol 1e-8 in float64, through
gauge-invariant scores on fresh inputs; the distributed cholqr split at rtol
1e-9 on its raw factors; the distributed polar split at rtol 1e-4 (float32
plain versions of K5 and K1, another summation order).

The tests marked ``cuda`` run a world of one on the card (NCCL over a
``HashStore``) and compare with the single-device port; they import JAX only
inside fixtures, so ``--noconftest`` runs them on a machine without it.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy
from tests.torch_worlds import World, case_result

MODULE = "tests.test_torch_sharding"
LR, WD = 0.01, 1.0  # the JAX tests' DP step
TOL = dict(rtol=1e-6, atol=1e-8)

# ---- the inputs, made in the parent ----------------------------------------


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_mps(seed=0, N=16, M=6, L=2, rng=None):
    """``tests/test_sharding.py::_make_mps``: calibrated ``mps_init``, float64
    (its calibration batch from ``rng``, the JAX test's shared generator)."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_init
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    rng = _rng(100 + seed) if rng is None else rng
    phi_cal = jpsi(jnp.asarray(rng.random((16, N))))
    return mps_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, normalize=True,
                    calibration_phi=phi_cal, act_fn="softmax", loss_fn="full_cross_ent",
                    dtype=jnp.float64)


def _mps_init(seed, N, M, L=2):
    """The port's calibrated ``mps_init`` (float64, softmax): a model both
    packages then take as numpy arrays."""
    from tensornetworkforml_torch.models.mps import mps_init

    phi_cal = psi_embed(torch.as_tensor(_rng(100 + seed).random((16, N))))
    return mps_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, normalize=True,
                    calibration_phi=phi_cal, act_fn="softmax", loss_fn="full_cross_ent",
                    dtype=torch.float64, device="cpu")


def _product(seed, N, M, L, dtype, x_cal):
    from tensornetworkforml_torch.models.mps import product_init

    return product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, act_fn="linear",
                        loss_fn="MSE", dtype=getattr(torch, dtype), calibration_x=x_cal,
                        device="cpu")


def _arrays(j) -> dict:
    """A model of either package as numpy arrays and its settings."""
    return dict(sites=np.asarray(j.sites), label=np.asarray(j.label_site), l_pos=j.l_pos,
                act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T)


def _boundary_init(seed, N, M, L, noise):
    from tensornetworkforml_torch.models.boundary import boundary_product_init

    return boundary_product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L,
                                 dtype=torch.float64, noise=noise, device="cpu")


def _boundary_arrays(b) -> dict:
    return dict(sites=b.sites.numpy(), w=b.w.numpy(), act_fn=b.act_fn, loss_fn=b.loss_fn,
                T=b.T)


# (J, q) of every sketch the cases draw, handed to the ranks as JAX draws
OMEGA_SHAPES = [(24, 12), (32, 16), (384, 32), (128, 16), (512, 32), (32, 8), (128, 32),
                (2048, 512), (8, 4), (30, 5)]


def _payload() -> dict:
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    p = {"omegas": {s: np.asarray(_rangefinder_omega(*s, jnp.float32)) for s in OMEGA_SHAPES}}
    # the draws of tests/test_sharding.py::test_dp_training_step_matches_single_device,
    # in its order from its generator
    r = _rng(5)
    model = _arrays(_jax_mps(0, N=16, M=6, rng=r))
    p["dp"] = dict(model=model, x=r.random((32, 16)), y=r.integers(0, 2, 32),
                   x2=r.random((32, 16)), y2=r.integers(0, 2, 32), probe=r.random((8, 16)))
    r = _rng(2)
    p["bonds"] = dict(model=_arrays(_mps_init(1, N=12, M=8)), x=r.random((16, 12)),
                      y=r.integers(0, 2, 16), probe=r.random((8, 12)))
    r = _rng(3)
    p["forward"] = dict(model=_arrays(_mps_init(2, N=10, M=6)), x=r.random((24, 10)))
    r = _rng(4)
    x_cal = r.random((16, 12))
    p["custom"] = dict(model=_arrays(_product(3, 12, 6, 2, "float32", x_cal)),
                       x=r.random((16, 12)), y=r.integers(0, 2, 16), probe=r.random((8, 12)))
    r = _rng(5)
    xe = r.random((4, 32, 16))
    p["epoch"] = dict(model=_arrays(_product(0, 16, 5, 3, "float64", xe[0])), x=xe,
                      y=r.integers(0, 3, (4, 32)), probe=r.random((8, 16)))
    r = _rng(6)
    p["rangefinder"] = dict(model=_arrays(_jax_mps(4, N=16, M=6)), x=r.random((32, 16)),
                            y=r.integers(0, 2, 32), probe=r.random((8, 16)))
    r = _rng(7)
    p["cholqr"] = dict(bmat=r.standard_normal((64, 384)),
                       lowrank=r.standard_normal((32, 5)) @ r.standard_normal((5, 128)))
    p["polar"] = dict(bmat=_rng(8).standard_normal((64, 512)).astype(np.float32))
    r = _rng(9)
    p["dist"] = dict(model=_arrays(_mps_init(5, N=12, M=8)), x=r.random((16, 12)),
                     y=r.integers(0, 2, 16), probe=r.random((8, 12)))
    r = _rng(10)
    x_cal = r.random((16, 8))
    p["dist_polar"] = dict(model=_arrays(_product(1, 8, 32, 2, "float32", x_cal)),
                           x=r.random((16, 8)), y=r.integers(0, 2, 16), x2=r.random((16, 8)),
                           y2=r.integers(0, 2, 16), probe=r.random((8, 8)))
    r = _rng(11)
    p["m512"] = dict(x_cal=r.random((16, 6)), x=r.random((16, 6)), y=r.integers(0, 2, 16))
    r = _rng(12)
    p["serve"] = dict(model=_arrays(_mps_init(6, N=10, M=6)), x=r.random((40, 10)))
    r = _rng(13)
    p["brick"] = dict(model=_boundary_arrays(_boundary_init(4, 12, 4, 3, 0.2)),
                      x=r.random((32, 12)), y=r.integers(0, 3, 32), probe=r.random((8, 12)))
    r = _rng(14)
    p["brick_epoch"] = dict(model=_boundary_arrays(_boundary_init(8, 10, 4, 3, 0.1)),
                            x=r.random((2, 16, 10)), y=r.integers(0, 3, (2, 16)),
                            probe=r.random((8, 10)))
    return p


W2_CASES = ["world", "dp_step", "cholqr_split_1x2", "diag_predictor"]
W4_CASES = ["world", "helpers", "dp_step", "bonds", "bonds_rangefinder", "forward", "custom",
            "epoch", "gather_routes", "renorm", "rangefinder", "cholqr_split_1x4",
            "cholqr_split_2x2", "cholqr_rank_deficient", "polar_split", "indivisible",
            "dist_trainer", "dist_trainer_m512", "dist_trainer_polar", "predictor",
            "predictor_boundary", "brick_step", "brick_epoch"]


@pytest.fixture(scope="module")
def payload():
    return _payload()


@pytest.fixture(scope="module")
def worlds(payload, tmp_path_factory):
    """The worlds of 2 and 4 ranks, started together."""
    tmp = tmp_path_factory.mktemp("worlds")
    started = {n: World(n, MODULE, cases, payload, tmp).start()
               for n, cases in ((2, W2_CASES), (4, W4_CASES))}
    yield started
    for w in started.values():  # stop the ranks of a world no test read
        try:
            w.results()
        except RuntimeError:
            pass


# ---- the ranks' side: each case runs on every rank ------------------------


def _mps(d, dtype=None):
    return mps_from_numpy(d["sites"], d["label"], l_pos=d["l_pos"], act_fn=d["act_fn"],
                          loss_fn=d["loss_fn"], T=d["T"], device="cpu", dtype=dtype)


def _mesh(shape):
    from tensornetworkforml_torch.parallel.mesh import make_mesh

    return make_mesh(shape=shape, device="cpu")


def _coords(mesh):
    from tensornetworkforml_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)


def _fwd(mps, x):
    return mps_forward(mps, psi_embed(torch.as_tensor(x).to(mps.dtype))).numpy()


def _single_sweep(mps, x, y, lr, wd, cfg):
    """``sweep_once`` with the batch embedded on the model's device, as the
    mesh step embeds it."""
    from tensornetworkforml_torch.train.sweep import one_hot_labels, sweep_once

    x = torch.as_tensor(x).to(dtype=mps.dtype, device=mps.device)
    y = torch.as_tensor(y).to(mps.device)
    return sweep_once(mps, psi_embed(x), one_hot_labels(y, mps.L, mps.dtype), lr, wd, cfg)[0]


def _cfg(mps, **kw):
    from tensornetworkforml_torch.train.sweep import SweepConfig

    return SweepConfig(act_fn=mps.act_fn, loss_fn=mps.loss_fn, **kw)


def case_world(p):
    import torch.distributed as dist

    return dict(rank=dist.get_rank(), size=dist.get_world_size())


def case_helpers(p):
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.parallel.mesh import (
        make_mesh,
        replicate_params,
        shard_batch,
    )
    import torch.distributed as dist

    mesh = make_mesh(device="cpu")
    try:
        make_mesh(shape=(3, 5), device="cpu")
        raised = False
    except ValueError:
        raised = True
    a = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    a_s, b_s = shard_batch(mesh, a, np.arange(16))
    # every rank draws its own model; replicate_params hands out rank 0's
    mine = product_init(torch.Generator().manual_seed(dist.get_rank()), N=6, M=3, L=2,
                        device="cpu")
    rep = replicate_params(mesh, mine)
    return dict(shape=tuple(mesh.shape), raised=raised, a=a_s.numpy(), b=b_s.numpy(),
                sites=rep.sites.numpy(), label=rep.label_site.numpy())


def _dp_two_steps(p, shape):
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["dp"]
    mps = _mps(d["model"])
    tr = ShardedTrainer(_mesh(shape), mps, lr=LR, weight_dec=WD)
    acc = tr.step(d["x"], d["y"])
    out = dict(acc=acc, sites=tr.mps.sites.numpy(), fwd1=_fwd(tr.mps, d["probe"]),
               l_pos=tr.mps.l_pos)
    tr.step(d["x2"], d["y2"])
    out.update(fwd2=_fwd(tr.mps, d["probe"]), l_pos2=tr.mps.l_pos)
    ref = _single_sweep(mps, d["x"], d["y"], LR, WD, _cfg(mps))
    ref2 = _single_sweep(ref, d["x2"], d["y2"], LR, WD, _cfg(mps))
    out.update(ref_fwd1=_fwd(ref, d["probe"]), ref_fwd2=_fwd(ref2, d["probe"]))
    return out


def case_dp_step(p):
    import torch.distributed as dist

    return _dp_two_steps(p, (dist.get_world_size(), 1))


def _bond_sharded(p, cfg_kw):
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["bonds"]
    mps = _mps(d["model"])
    mesh = _mesh((2, 2))
    cfg = _cfg(mps, **cfg_kw)
    tr = ShardedTrainer(mesh, mps, lr=LR, weight_dec=1e-3, shard_bonds=True, cfg=cfg)
    tr.step(d["x"], d["y"])
    full = tr.mps
    ref = _single_sweep(mps, d["x"], d["y"], LR, 1e-3, cfg)
    return dict(local=tr.local_sites.numpy(), sites=full.sites.numpy(),
                ref_sites=ref.sites.numpy(), fwd=_fwd(full, d["probe"]),
                ref_fwd=_fwd(ref, d["probe"]), coords=_coords(mesh))


def case_bonds(p):
    return _bond_sharded(p, {})


def case_bonds_rangefinder(p):
    return _bond_sharded(p, dict(L2_flag=False, split_mode="canonical",
                                 svd_method="rangefinder"))


def case_forward(p):
    from tensornetworkforml_torch.parallel.mesh import (
        DataShards,
        replicate_params,
        shard_batch,
    )

    d = p["forward"]
    mesh = _mesh((4, 1))
    mps = replicate_params(mesh, _mps(d["model"]))
    phi = psi_embed(shard_batch(mesh, d["x"]))
    return dict(scores=DataShards(mesh).gather(mps_forward(mps, phi), dim=1).numpy())


def case_custom(p):
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["custom"]
    mps = _mps(d["model"])
    cfg = _cfg(mps, L2_flag=False, split_mode="canonical")
    tr = ShardedTrainer(_mesh((4, 1)), mps, lr=0.05, weight_dec=1e-5, cfg=cfg)
    acc = tr.step(d["x"], d["y"])
    return dict(acc=acc, finite=bool(torch.isfinite(tr.mps.sites).all()),
                fwd=_fwd(tr.mps, d["probe"]))


def _epochs(p, cfg_kw, dtype=None):
    from tensornetworkforml_torch.train.epoch import fused_epoch

    d = p["epoch"]
    mps = _mps(d["model"], dtype=dtype)
    cfg = _cfg(mps, L2_flag=False, split_mode="canonical", **cfg_kw)
    m_dp, acc_dp, met_dp = fused_epoch(mps, d["x"], d["y"], 0.05, 1e-5, cfg, mesh=_mesh((4, 1)))
    m_1, acc_1, met_1 = fused_epoch(mps, d["x"], d["y"], 0.05, 1e-5, cfg)
    return dict(acc=acc_dp.numpy(), mae=met_dp["MAE"].numpy(), fwd=_fwd(m_dp, d["probe"]),
                ref_acc=acc_1.numpy(), ref_mae=met_1["MAE"].numpy(),
                ref_fwd=_fwd(m_1, d["probe"]), sites=m_dp.sites.numpy(),
                ref_sites=m_1.sites.numpy())


def case_epoch(p):
    return _epochs(p, {})


GATHER_ROUTES = {"hybrid": dict(engine="hybrid"), "fused": dict(engine="fused"),
                 "factored": dict(factored_update="on")}


def case_gather_routes(p):
    """The routes with no per-step gradient to sum gather the batch."""
    return {name: _epochs(p, dict(svd_method="polar", **kw), dtype=torch.float32)
            for name, kw in GATHER_ROUTES.items()}


def case_renorm(p):
    return _epochs(p, dict(renorm_envs=True, growth_cap=1e-3))


def case_rangefinder(p):
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["rangefinder"]
    mps = _mps(d["model"])
    cfg = _cfg(mps, L2_flag=False, split_mode="canonical", svd_method="rangefinder")
    tr = ShardedTrainer(_mesh((4, 1)), mps, lr=LR, weight_dec=1e-3, cfg=cfg)
    tr.step(d["x"], d["y"])
    return dict(fwd=_fwd(tr.mps, d["probe"]))


def _cholqr_split(p, shape):
    from tensornetworkforml_torch.parallel.dist_split import distributed_cholqr_split

    mesh = _mesh(shape)
    q, r = distributed_cholqr_split(torch.as_tensor(p["cholqr"]["bmat"]), 32, mesh)
    return dict(q=q.numpy(), r=r.numpy(), coords=_coords(mesh))


def case_cholqr_split_1x2(p):
    return _cholqr_split(p, (1, 2))


def case_cholqr_split_1x4(p):
    return _cholqr_split(p, (1, 4))


def case_cholqr_split_2x2(p):
    return _cholqr_split(p, (2, 2))


def case_cholqr_rank_deficient(p):
    from tensornetworkforml_torch.parallel.dist_split import distributed_cholqr_split

    mesh = _mesh((1, 4))
    q, r = distributed_cholqr_split(torch.as_tensor(p["cholqr"]["lowrank"]), 16, mesh)
    return dict(q=q.numpy(), r=r.numpy(), coords=_coords(mesh))


def case_polar_split(p):
    from tensornetworkforml_torch.ops.kernels.polar_split import (
        polar_split_reference,
        polar_split_two_stage,
    )
    from tensornetworkforml_torch.parallel.dist_split import distributed_polar_split

    mesh = _mesh((1, 4))
    bmat = torch.as_tensor(p["polar"]["bmat"])
    q, r = distributed_polar_split(bmat, 32, mesh)
    q1, r1 = polar_split_two_stage(bmat, 32)
    q0, r0 = polar_split_reference(bmat, 32)
    return dict(q=q.numpy(), r=r.numpy(), q1=q1.numpy(), r1=r1.numpy(), q0=q0.numpy(),
                r0=r0.numpy(), coords=_coords(mesh))


def case_indivisible(p):
    from tensornetworkforml_torch.parallel.dist_split import (
        distributed_cholqr_split,
        distributed_polar_split,
    )

    mesh = _mesh((1, 4))
    msgs = []
    for fn in (distributed_cholqr_split, distributed_polar_split):
        try:
            fn(torch.ones((8, 6)), 4, mesh)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return dict(msgs=msgs)


def case_dist_trainer(p):
    """``ShardedTrainer(dist_split="cholqr")`` on a (2, 2) mesh, with a spy on
    the split the sweep looks up."""
    from tensornetworkforml_torch.parallel import dist_split as ds
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["dist"]
    mps = _mps(d["model"])
    cfg = _cfg(mps, L2_flag=False, split_mode="canonical", svd_method="cholqr")
    calls, real = [], ds.distributed_cholqr_split

    def spy(bmat, rank, mesh, *a, **k):
        q, r = real(bmat, rank, mesh, *a, **k)
        calls.append((tuple(bmat.shape), tuple(r.shape)))
        return q, r

    mesh = _mesh((2, 2))
    ds.distributed_cholqr_split = spy
    try:
        tr = ShardedTrainer(mesh, mps, lr=LR, weight_dec=1e-3, cfg=cfg, dist_split="cholqr")
        tr.step(d["x"], d["y"])
    finally:
        ds.distributed_cholqr_split = real
    ref = _single_sweep(mps, d["x"], d["y"], LR, 1e-3, cfg)
    return dict(calls=calls, cfg_split=tr.cfg.dist_split, cfg_mesh=tr.cfg.dist_mesh is mesh,
                fwd=_fwd(tr.mps, d["probe"]), ref_fwd=_fwd(ref, d["probe"]))


def case_dist_trainer_m512(p):
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.train.sweep import SweepConfig

    d = p["m512"]
    mps = product_init(torch.Generator().manual_seed(0), N=6, M=512, L=2, act_fn="linear",
                       loss_fn="MSE", calibration_x=d["x_cal"], device="cpu")
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical")
    tr = ShardedTrainer(_mesh((1, 4)), mps, lr=0.01, weight_dec=1e-5, cfg=cfg,
                        dist_split="cholqr")
    acc = tr.step(d["x"], d["y"])
    return dict(acc=acc, finite=bool(torch.isfinite(tr.mps.sites).all()
                                     and torch.isfinite(tr.mps.label_site).all()),
                l_pos=tr.mps.l_pos)


def case_dist_trainer_polar(p):
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer

    d = p["dist_polar"]
    mps = _mps(d["model"])
    cfg = _cfg(mps, L2_flag=False, split_mode="canonical")
    tr = ShardedTrainer(_mesh((1, 4)), mps, lr=0.01, weight_dec=1e-5, cfg=cfg,
                        dist_split="polar")
    tr.step(d["x"], d["y"])
    fwd1 = _fwd(tr.mps, d["probe"])
    tr.step(d["x2"], d["y2"])  # the mirrored sweep
    return dict(finite=bool(torch.isfinite(tr.mps.sites).all()), l_pos=tr.mps.l_pos,
                fwd1=fwd1, fwd=_fwd(tr.mps, d["probe"]))


def case_predictor(p):
    from tensornetworkforml_torch.models.serving import Predictor

    d = p["serve"]
    mps = _mps(d["model"], dtype=torch.float32)
    mesh = _mesh((4, 1))
    pred = Predictor(mps, batch_size=32, mesh=mesh, use_kernel=True)
    plain = Predictor(mps, batch_size=32, device="cpu")
    try:
        Predictor(mps, batch_size=30, mesh=mesh)
        refused = False
    except ValueError:
        refused = True
    x = d["x"].astype(np.float32)
    return dict(scores=pred.scores(x), plain=plain.scores(x), use_kernel=pred.use_kernel,
                refused=refused)


def case_diag_predictor(p):
    """``tests/test_serving.py::test_predictor_sharded_over_mesh`` with a
    diagonals model that each rank trains alike (the reference pickle that
    test serves is not available): served over a (2, 1) mesh."""
    import os
    import tempfile

    import torch.distributed as dist

    from tensornetworkforml_torch.cli import training_diagonals
    from tensornetworkforml_torch.data.diagonals import create_dataset
    from tensornetworkforml_torch.models.serving import Predictor
    from tensornetworkforml_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"diag{dist.get_rank()}.npz")
        training_diagonals.main(["--n_samples", "500", "--n_epochs", "2", "--seed", "0",
                                 "--out", out, "--results_dir", tmp, "--device", "cpu"])
        mps = load_checkpoint(out, dtype=torch.float32, device="cpu")
    pred = Predictor(mps, batch_size=64, mesh=_mesh((2, 1)))
    data, labels = create_dataset(128, 8, sigma=0.6, seed=6)
    x = data.reshape(128, -1)
    return dict(pred=pred.predict(x), labels=labels, scores=pred.scores(x),
                plain=Predictor(mps, batch_size=64, device="cpu").scores(x))


def case_predictor_boundary(p):
    from tensornetworkforml_torch.models.serving import Predictor
    from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy

    d = p["brick"]
    m = d["model"]
    model = boundary_from_numpy(m["sites"], m["w"], act_fn=m["act_fn"], loss_fn=m["loss_fn"],
                                T=m["T"], device="cpu")
    pred = Predictor(model, batch_size=8, mesh=_mesh((4, 1)))
    plain = Predictor(model, batch_size=8, device="cpu")
    return dict(scores=pred.scores(d["x"]), plain=plain.scores(d["x"]))


def _boundary(d):
    from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy

    m = d["model"]
    return boundary_from_numpy(m["sites"], m["w"], act_fn=m["act_fn"], loss_fn=m["loss_fn"],
                               T=m["T"], device="cpu")


def case_brick_step(p):
    from tensornetworkforml_torch.models.boundary import boundary_forward
    from tensornetworkforml_torch.train import brickwall as tbw

    d = p["brick"]
    model = _boundary(d)
    phi = psi_embed(torch.as_tensor(d["x"]))
    y1h = torch.as_tensor(np.eye(model.L)[d["y"]].T)
    cfg = tbw.BrickConfig(act_fn=model.act_fn, loss_fn=model.loss_fn)
    single, _ = tbw.brick_sweep(model, phi, y1h, 0.05, 1e-4, cfg)
    step = tbw.make_sharded_brick_step(_mesh((4, 1)), model.T, cfg)
    sites, w, metrics = step(model.sites, model.w, phi, y1h, 0.05, 1e-4)
    cfg_ls = cfg._replace(line_search=True)
    single_ls, _ = tbw.brick_sweep(model, phi, y1h, 0.05, 1e-4, cfg_ls)
    step_ls = tbw.make_sharded_brick_step(_mesh((4, 1)), model.T, cfg_ls)
    sites_ls, w_ls, _ = step_ls(model.sites, model.w, phi, y1h, 0.05, 1e-4)
    probe = psi_embed(torch.as_tensor(d["probe"]))
    return dict(sites=sites.numpy(), w=w.numpy(), ref_sites=single.sites.numpy(),
                ref_w=single.w.numpy(), acc=float(metrics["accuracy"]),
                fwd=boundary_forward(single.replace(sites=sites, w=w), probe).numpy(),
                sites_ls=sites_ls.numpy(), w_ls=w_ls.numpy(),
                ref_sites_ls=single_ls.sites.numpy(), ref_w_ls=single_ls.w.numpy())


def case_brick_epoch(p):
    from tensornetworkforml_torch.models.boundary import boundary_forward
    from tensornetworkforml_torch.train import brickwall as tbw

    d = p["brick_epoch"]
    model = _boundary(d)
    sharded, metrics = tbw.brick_epoch(model, d["x"], d["y"], 0.05, 1e-4, mesh=_mesh((4, 1)))
    single, ref_metrics = tbw.brick_epoch(model, d["x"], d["y"], 0.05, 1e-4)
    fwd = {k: boundary_forward(sharded, psi_embed(torch.as_tensor(x))).numpy()
           for k, x in (("probe", d["probe"]), ("batch", d["x"][0]))}
    return dict(sites=sharded.sites.numpy(), w=sharded.w.numpy(), ref_sites=single.sites.numpy(),
                ref_w=single.w.numpy(), acc=metrics["accuracy"].numpy(),
                ref_acc=ref_metrics["accuracy"].numpy(), mae=metrics["MAE"].numpy(),
                ref_mae=ref_metrics["MAE"].numpy(), fwd=fwd)


# ---- the parent's side: the JAX package and the comparisons ----------------


def _jax_mesh(shape):
    import jax

    from tensornetworkforml_tpu.parallel.mesh import make_mesh

    return make_mesh(shape=shape, devices=jax.devices()[: int(np.prod(shape))])


def _jax_model(d):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import MPS

    return MPS(sites=jnp.asarray(d["sites"]), label_site=jnp.asarray(d["label"]),
               l_pos=d["l_pos"], act_fn=d["act_fn"], loss_fn=d["loss_fn"], T=d["T"])


def _jax_boundary(m):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import BoundaryMPS

    return BoundaryMPS(sites=jnp.asarray(m["sites"]), w=jnp.asarray(m["w"]), act_fn=m["act_fn"],
                       loss_fn=m["loss_fn"], T=m["T"])


def _jax_fwd(m, x):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    return np.asarray(jfw(m, jpsi(jnp.asarray(x, dtype=m.sites.dtype))))


def _jax_trainer(d, shape, **kw):
    from tensornetworkforml_tpu.parallel.dp import ShardedTrainer as JST

    return JST(_jax_mesh(shape), _jax_model(d["model"]), **kw)


def test_worlds_span_their_ranks(worlds):
    for n, w in worlds.items():
        got = [case_result(w, "world", r) for r in range(n)]
        assert [g["rank"] for g in got] == list(range(n))
        assert all(g["size"] == n for g in got)


def test_mesh_helpers(worlds):
    if not torch.cuda.is_available():  # the default device is the card
        from tensornetworkforml_torch.parallel.mesh import make_mesh

        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    w = worlds[4]
    a = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    for r in range(4):
        got = case_result(w, "helpers", r)
        assert got["shape"] == (4, 1) and got["raised"]
        np.testing.assert_array_equal(got["a"], a[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["b"], np.arange(16)[4 * r:4 * r + 4])
        rank0 = case_result(w, "helpers", 0)
        np.testing.assert_array_equal(got["sites"], rank0["sites"])  # rank 0's, broadcast
        np.testing.assert_array_equal(got["label"], rank0["label"])


@pytest.mark.parametrize("n", [2, 4])
def test_dp_training_step_matches_single_device(n, worlds, payload):
    """A right and a mirrored left data-parallel sweep (the JAX test's draws
    and rates: svd in the shared gauge, exact L2) against the port's
    single-device sweeps, on scores for fresh inputs at the JAX test's
    tolerances. The raw sites are not held: the shared gauge's ``U sqrt(S)``
    puts sqrt(rounding) ~ 1e-8 into the columns of dead singular values, the
    JAX test's atol. Against the JAX package's data-parallel trainer: the
    first sweep at the same tolerances; after the second, 1e-5 of max|f|,
    since the two packages' single-device sweeps already part by 1.1e-6 of
    max|f| there (this draw amplifies each sweep's rounding ~300-fold)."""
    d = payload["dp"]
    got = case_result(worlds[n], "dp_step")
    np.testing.assert_allclose(got["fwd1"], got["ref_fwd1"], **TOL)
    np.testing.assert_allclose(got["fwd2"], got["ref_fwd2"], **TOL)
    assert got["l_pos"] == d["model"]["sites"].shape[0] - 1 and got["l_pos2"] == 0
    jt = _jax_trainer(d, (n, 1), lr=LR, weight_dec=WD)
    jacc = jt.step(d["x"], d["y"])
    assert got["acc"] == pytest.approx(jacc, abs=1e-12)
    np.testing.assert_allclose(got["fwd1"], _jax_fwd(jt.mps, d["probe"]), **TOL)
    jt.step(d["x2"], d["y2"])
    want = _jax_fwd(jt.mps, d["probe"])
    assert np.abs(got["fwd2"] - want).max() <= 1e-5 * np.abs(want).max()
    # every rank holds the same model
    for r in range(1, n):
        np.testing.assert_array_equal(case_result(worlds[n], "dp_step", r)["sites"],
                                      got["sites"])


@pytest.mark.parametrize("case,kw", [
    ("bonds", {}),
    ("bonds_rangefinder", dict(L2_flag=False, split_mode="canonical", svd_method="rangefinder")),
])
def test_hybrid_mesh_with_bond_sharding(case, kw, worlds, payload):
    """(data=2, model=2) mesh, the sites' right bond leg kept sharded between
    steps; the rangefinder case is ``test_hybrid_mesh_bond_sharded_rangefinder``.
    Each rank holds exactly its block of the swept sites; the model scores
    fresh inputs as the single-device sweep's and the JAX trainer's do."""
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg

    d = payload["bonds"]
    got = case_result(worlds[4], case)
    np.testing.assert_allclose(got["fwd"], got["ref_fwd"], **TOL)
    m = d["model"]["sites"].shape[1]
    for r in range(4):
        g = case_result(worlds[4], case, r)
        col = g["coords"][1]
        assert g["local"].shape == (d["model"]["sites"].shape[0], m, 2, m // 2)
        np.testing.assert_array_equal(g["local"], g["sites"][..., col * m // 2:(col + 1) * m // 2])
    jm = _jax_model(d["model"])
    cfg = JCfg(act_fn=jm.act_fn, loss_fn=jm.loss_fn, **kw) if kw else None
    jt = _jax_trainer(d, (2, 2), lr=LR, weight_dec=1e-3, shard_bonds=True, cfg=cfg)
    jt.step(d["x"], d["y"])
    np.testing.assert_allclose(got["fwd"], _jax_fwd(jt.mps, d["probe"]), **TOL)


def test_sharded_forward_matches(worlds, payload):
    d = payload["forward"]
    want = _jax_fwd(_jax_model(d["model"]), d["x"])
    for r in range(4):
        np.testing.assert_allclose(case_result(worlds[4], "forward", r)["scores"], want,
                                   rtol=1e-10)


def test_chain_parallel_env_stacks_match_sequential():
    import jax.numpy as jnp

    from tensornetworkforml_torch.ops import contractions as tc
    from tensornetworkforml_tpu.ops import contractions as jc

    for n in (1, 2, 9, 16):
        mats = _rng(20 + n).standard_normal((n, 4, 5, 5))
        e0 = tc.boundary_vector(5, dtype=torch.float64)
        t = torch.as_tensor(mats)
        je0 = jc.boundary_vector(5, dtype=jnp.float64)
        for par, seq, jpar in ((tc.left_env_stack_parallel, tc.left_env_stack,
                                jc.left_env_stack_parallel),
                               (tc.right_env_stack_parallel, tc.right_env_stack,
                                jc.right_env_stack_parallel)):
            got = par(t, e0).numpy()
            scale = max(1.0, np.abs(got).max())
            np.testing.assert_allclose(got, seq(t, e0).numpy(), rtol=1e-9, atol=1e-11 * scale)
            np.testing.assert_allclose(got, np.asarray(jpar(jnp.asarray(mats), je0)), rtol=1e-9,
                                       atol=1e-11 * scale)


def test_sharded_trainer_custom_cfg(worlds, payload):
    """The CLI's canonical recipe through ``ShardedTrainer(cfg=...)``,
    float32: finite, and the same batch accuracy and (to the float32 sweep's
    2e-4 of ``tests/test_torch_sweep.py``) the same model as the JAX trainer."""
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg

    d = payload["custom"]
    got = case_result(worlds[4], "custom")
    assert 0.0 <= got["acc"] <= 1.0 and got["finite"]
    cfg = JCfg(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical")
    jt = _jax_trainer(d, (4, 1), lr=0.05, weight_dec=1e-5, cfg=cfg)
    assert got["acc"] == pytest.approx(jt.step(d["x"], d["y"]), abs=1e-6)
    want = _jax_fwd(jt.mps, d["probe"])
    assert np.abs(got["fwd"] - want).max() <= 2e-4 * max(1.0, np.abs(want).max())


def _jax_epoch(d, cfg_kw, dtype=None, mesh=True):
    """The JAX package's ``fused_epoch`` on the epoch payload (linear/MSE,
    canonical, no L2), over a (4, 1) mesh unless ``mesh`` is False; returns
    its scores on the probe, batch accuracies and MAE series."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.train.epoch import fused_epoch as jepoch
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg

    jm = _jax_model(d["model"])
    if dtype is not None:
        jm = jm.replace(sites=jm.sites.astype(dtype), label_site=jm.label_site.astype(dtype))
    cfg = JCfg(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical", **cfg_kw)
    m, acc, met = jepoch(jm, d["x"], d["y"], 0.05, 1e-5, cfg,
                         mesh=_jax_mesh((4, 1)) if mesh else None)
    return _jax_fwd(m, d["probe"]), np.asarray(acc), np.asarray(met["MAE"])


def test_fused_epoch_data_parallel_matches_single_device(worlds, payload):
    """A whole data-parallel epoch == the unsharded epoch (the JAX test's
    tolerances), and == the JAX package's data-parallel epoch."""
    got = case_result(worlds[4], "epoch")
    np.testing.assert_allclose(got["acc"], got["ref_acc"], atol=1e-12)
    np.testing.assert_allclose(got["mae"], got["ref_mae"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["fwd"], got["ref_fwd"], rtol=1e-7, atol=1e-9)
    fwd, acc, mae = _jax_epoch(payload["epoch"], {})
    np.testing.assert_allclose(got["acc"], acc, atol=1e-12)
    np.testing.assert_allclose(got["mae"], mae, **TOL)
    np.testing.assert_allclose(got["fwd"], fwd, **TOL)


@pytest.mark.parametrize("route", list(GATHER_ROUTES))
def test_unpartitioned_routes_gather_the_batch(route, worlds, payload):
    """The hybrid and fused engines and the factored update have no per-step
    gradient to sum: the batch is gathered and every rank runs the unsharded
    sweep, so the epoch's model equals the single-device one exactly (CPU).

    Against the JAX package's epoch of the same route over a (4, 1) mesh
    (its kernels in interpret mode): four float32 polar sweeps, held at
    ``tests/test_torch_trainer.py``'s tolerance for two float32 runs of
    four polar sweeps, 2e-3 of max|f| on fresh inputs and 5e-4 on the MAE
    series; measured 4.0e-4 (hybrid), 9.2e-4 (fused) and 8.9e-4 (factored)
    of max|f|, and at most 3.6e-5 on the MAE. GSPMD sums the JAX run in
    another order than its own single-device run, which it leaves by 6.5e-4
    to 1.2e-3 of max|f| here."""
    import jax.numpy as jnp

    got = case_result(worlds[4], "gather_routes")[route]
    np.testing.assert_array_equal(got["sites"], got["ref_sites"])
    np.testing.assert_array_equal(got["acc"], got["ref_acc"])
    # a mean over the gathered (contiguous) targets sums in another order
    # than over the single device's transposed one-hot view: float32 rounding
    np.testing.assert_allclose(got["mae"], got["ref_mae"], rtol=1e-6)
    fwd, acc, mae = _jax_epoch(payload["epoch"], dict(svd_method="polar", **GATHER_ROUTES[route]),
                               dtype=jnp.float32)
    np.testing.assert_array_equal(got["acc"], acc)
    np.testing.assert_allclose(got["mae"], mae, rtol=0, atol=5e-4)
    assert np.abs(got["fwd"] - fwd).max() <= 2e-3 * max(1.0, np.abs(fwd).max())


def test_renorm_envs_sums_its_norms_over_the_ranks(worlds, payload):
    """``renorm_envs``' mean env norm, the second (scalar) all-reduce of a
    data-parallel step, with the growth cap: the epoch equals the unsharded
    one, and the JAX package's data-parallel epoch under the same config at
    the JAX test's tolerances."""
    got = case_result(worlds[4], "renorm")
    np.testing.assert_allclose(got["acc"], got["ref_acc"], atol=1e-12)
    np.testing.assert_allclose(got["mae"], got["ref_mae"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["fwd"], got["ref_fwd"], rtol=1e-7, atol=1e-9)
    fwd, acc, mae = _jax_epoch(payload["epoch"], dict(renorm_envs=True, growth_cap=1e-3))
    np.testing.assert_allclose(got["acc"], acc, atol=1e-12)
    np.testing.assert_allclose(got["mae"], mae, **TOL)
    np.testing.assert_allclose(got["fwd"], fwd, **TOL)


def test_dp_rangefinder_split_matches_single_device(worlds, payload):
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg

    d = payload["rangefinder"]
    jm = _jax_model(d["model"])
    cfg = JCfg(act_fn=jm.act_fn, loss_fn=jm.loss_fn, L2_flag=False, split_mode="canonical",
               svd_method="rangefinder")
    jt = _jax_trainer(d, (4, 1), lr=LR, weight_dec=1e-3, cfg=cfg)
    jt.step(d["x"], d["y"])
    np.testing.assert_allclose(case_result(worlds[4], "rangefinder")["fwd"],
                               _jax_fwd(jt.mps, d["probe"]), **TOL)


def _assemble(world, case, n_model):
    """Q from rank 0 and R from the model coordinates' blocks."""
    parts = {}
    for r in range(world.size):
        g = case_result(world, case, r)
        parts[g["coords"][1]] = g["r"]
        np.testing.assert_array_equal(g["q"], case_result(world, case, 0)["q"])
    assert sorted(parts) == list(range(n_model))
    return case_result(world, case, 0)["q"], np.concatenate([parts[c] for c in
                                                             range(n_model)], axis=1)


@pytest.mark.parametrize("n,case,n_model", [(2, "cholqr_split_1x2", 2),
                                            (4, "cholqr_split_1x4", 4),
                                            (4, "cholqr_split_2x2", 2)])
def test_distributed_cholqr_split_matches_single_device(n, case, n_model, worlds, payload):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import batched_cholqr_split

    bmat = payload["cholqr"]["bmat"]
    q_ref, r_ref = batched_cholqr_split(jnp.asarray(bmat)[None], 32)
    q, r = _assemble(worlds[n], case, n_model)
    assert case_result(worlds[n], case)["r"].shape == (32, 384 // n_model)  # column-sharded
    np.testing.assert_allclose(q, np.asarray(q_ref[0]), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(r, np.asarray(r_ref[0]), rtol=1e-9, atol=1e-11)
    assert np.abs(q.T @ q - np.eye(32)).max() < 1e-9


def test_distributed_cholqr_split_rank_deficient(worlds, payload):
    """Dead subspace directions come out contracted, the live block
    isometric, and Q R reproduces B."""
    rank, true_rank = 16, 5
    q, r = _assemble(worlds[4], "cholqr_rank_deficient", 4)
    col_norms = np.sort(np.linalg.norm(q, axis=0))
    assert (col_norms < 1e-2).sum() == rank - true_rank
    assert np.allclose(col_norms[-true_rank:], 1.0, atol=1e-8)
    np.testing.assert_allclose(q @ r, payload["cholqr"]["lowrank"], rtol=1e-8, atol=1e-9)


def test_distributed_polar_split_matches_fused_kernel(worlds, payload):
    """K5's and K1's plain versions with one all-reduce between them, against
    the port's two-stage split and ``polar_split_reference`` on one rank and
    the JAX package's all-in-one kernel (interpret mode), at the JAX test's
    tolerances."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.polar_split import polar_split_pallas

    bmat = payload["polar"]["bmat"]
    q, r = _assemble(worlds[4], "polar_split", 4)
    got = case_result(worlds[4], "polar_split")
    for k in ("1", "0"):  # the two-stage split and polar_split_reference, on one rank
        np.testing.assert_allclose(q, got["q" + k], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r, got["r" + k], rtol=1e-4, atol=1e-4)
    q_ref, r_ref = polar_split_pallas(jnp.asarray(bmat), 32, interpret=True)
    np.testing.assert_allclose(q, np.asarray(q_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r, np.asarray(r_ref), rtol=1e-4, atol=1e-4)
    assert np.abs(q.T @ q - np.eye(32)).max() < 1e-3


def test_distributed_splits_refuse_indivisible_columns(worlds):
    for msg in case_result(worlds[4], "indivisible")["msgs"]:
        assert msg is not None and "not divisible" in msg


def test_dist_split_trainer_routes_and_matches(worlds, payload):
    """``ShardedTrainer(dist_split="cholqr")`` routes every split of the
    sweep through ``parallel/dist_split.py`` with R column-sharded, and
    trains the same network as the single-device cholqr sweep."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg
    from tensornetworkforml_tpu.train.sweep import sweep_once as jsweep

    d = payload["dist"]
    got = case_result(worlds[4], "dist_trainer")
    m, N = d["model"]["sites"].shape[1], d["model"]["sites"].shape[0]
    assert got["cfg_split"] == "cholqr" and got["cfg_mesh"]
    assert len(got["calls"]) == N - 1
    assert all(c == ((2 * m, 2 * 2 * m), (m, 2 * 2 * m // 2)) for c in got["calls"])
    np.testing.assert_allclose(got["fwd"], got["ref_fwd"], **TOL)
    jm = _jax_model(d["model"])
    cfg = JCfg(act_fn=jm.act_fn, loss_fn=jm.loss_fn, L2_flag=False, split_mode="canonical",
               svd_method="cholqr")
    ref, _, _, _ = jsweep(jm, jpsi(jnp.asarray(d["x"])),
                          jnp.asarray(np.eye(2)[d["y"]].T), LR, 1e-3, cfg)
    np.testing.assert_allclose(got["fwd"], _jax_fwd(ref, d["probe"]), **TOL)


def test_dist_split_trainer_m512(worlds):
    """Bond-parallel training at M=512 on a pure model mesh: every split the
    distributed cholqr with J = 2048 columns, 512 a rank."""
    got = case_result(worlds[4], "dist_trainer_m512")
    assert 0.0 <= got["acc"] <= 1.0 and got["finite"] and got["l_pos"] == 5


def test_dist_split_trainer_polar(worlds, payload):
    """The polar form from the trainer, a right and a mirrored left sweep:
    finite with the label leg back at site 0 (the JAX test's checks); the
    first sweep's model scores fresh inputs as the JAX package's distributed
    polar trainer's does, within the float32 sweep tolerance of
    ``tests/test_torch_sweep.py`` (3.9e-5 of max|f| here). After the second
    the two float32 runs part by 2.1e-4 of max|f| (a float32 sweep amplifies
    rounding), so that one is not held between the packages."""
    from tensornetworkforml_tpu.train.sweep import SweepConfig as JCfg

    d = payload["dist_polar"]
    got = case_result(worlds[4], "dist_trainer_polar")
    assert got["finite"] and got["l_pos"] == 0
    cfg = JCfg(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical")
    jt = _jax_trainer(d, (1, 4), lr=0.01, weight_dec=1e-5, cfg=cfg, dist_split="polar")
    jt.step(d["x"], d["y"])
    want = _jax_fwd(jt.mps, d["probe"])
    assert np.abs(got["fwd1"] - want).max() <= 2e-4 * max(1.0, np.abs(want).max())


def test_dist_split_requires_canonical_and_mesh():
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.train.sweep import SweepConfig, one_hot_labels, sweep_once

    mps = product_init(torch.Generator().manual_seed(0), N=8, M=4, L=2, dtype=torch.float64,
                       device="cpu")
    phi = psi_embed(torch.as_tensor(_rng(30).random((4, 8))))
    y1h = one_hot_labels(torch.tensor([0, 1, 0, 1]), 2, torch.float64)
    with pytest.raises(ValueError, match="canonical"):
        sweep_once(mps, phi, y1h, 0.01, 1e-3, SweepConfig(
            L2_flag=False, split_mode="shared", dist_split="cholqr", dist_mesh=object()))
    with pytest.raises(ValueError, match="dist_mesh"):
        sweep_once(mps, phi, y1h, 0.01, 1e-3, SweepConfig(
            L2_flag=False, split_mode="canonical", dist_split="cholqr"))
    with pytest.raises(ValueError, match="adaptive"):
        sweep_once(mps, phi, y1h, 0.01, 1e-3, SweepConfig(
            L2_flag=False, split_mode="canonical", svd_method="svd", rank_mode="adaptive",
            dist_split="cholqr", dist_mesh=object()))
    with pytest.raises(ValueError, match="L2_flag=True"):
        ShardedTrainer(object(), mps, lr=0.01, weight_dec=1e-3, dist_split="cholqr")


def test_predictor_pallas_under_mesh_matches_xla(worlds, payload):
    """The serving kernel's path (its plain version here) under a mesh: each
    rank scores its rows, the scores are gathered; against the JAX XLA
    predictor and the port's single-device one."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.serving import Predictor as JPredictor

    d = payload["serve"]
    jm = _jax_model(d["model"])
    jm = jm.replace(sites=jm.sites.astype(jnp.float32), label_site=jm.label_site.astype(
        jnp.float32))
    want = JPredictor(jm, batch_size=32).scores(d["x"].astype(np.float32))
    for r in range(4):
        got = case_result(worlds[4], "predictor", r)
        assert got["use_kernel"] and got["refused"]
        np.testing.assert_allclose(got["scores"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["scores"], got["plain"], rtol=1e-6, atol=1e-7)


def test_predictor_sharded_over_mesh(worlds):
    """A trained diagonals model served over a (2, 1) mesh: accurate, and
    the unsharded predictor's scores."""
    for r in range(2):
        got = case_result(worlds[2], "diag_predictor", r)
        assert (got["pred"] == got["labels"]).mean() > 0.9
        np.testing.assert_allclose(got["scores"], got["plain"], rtol=1e-5, atol=1e-7)


def test_boundary_family_served_over_mesh(worlds, payload):
    """The boundary-label family served under a mesh, against the JAX
    package's predictor and the port's unsharded one."""
    from tensornetworkforml_tpu.models.serving import Predictor as JPredictor

    d = payload["brick"]
    want = JPredictor(_jax_boundary(d["model"]), batch_size=8).scores(d["x"])
    for r in range(4):
        got = case_result(worlds[4], "predictor_boundary", r)
        np.testing.assert_allclose(got["scores"], got["plain"], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["scores"], want, rtol=1e-8, atol=1e-10)


def test_sharded_brick_step_matches_single_device(worlds, payload):
    """One all-reduce a brick layer for all pair gradients (and one for the
    line search's two sums): the sharded step equals ``brick_sweep`` (the
    JAX test's 1e-9), and scores fresh inputs as the JAX step does."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_forward as jbf
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train.brickwall import BrickConfig as JB
    from tensornetworkforml_tpu.train.brickwall import make_sharded_brick_step as jstep

    d = payload["brick"]
    got = case_result(worlds[4], "brick_step")
    for k in ("", "_ls"):
        np.testing.assert_allclose(got["sites" + k], got["ref_sites" + k], rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(got["w" + k], got["ref_w" + k], rtol=1e-9, atol=1e-11)
    assert np.isfinite(got["acc"])
    jb = _jax_boundary(d["model"])
    step = jstep(_jax_mesh((4, 1)), jb.T, JB(act_fn=jb.act_fn, loss_fn=jb.loss_fn))
    phi = jpsi(jnp.asarray(d["x"]))
    s, w, _ = step(jb.sites, jb.w, phi, jnp.asarray(np.eye(3)[d["y"]].T), jnp.float64(0.05),
                   jnp.float64(1e-4))
    want = np.asarray(jbf(jb.replace(sites=s, w=w), jpsi(jnp.asarray(d["probe"]))))
    np.testing.assert_allclose(got["fwd"], want, rtol=1e-8, atol=1e-8 * np.abs(want).max())


def test_brick_epoch_mesh_matches_single_device(worlds, payload):
    """The data-parallel brick epoch equals the unsharded one (the JAX test's
    1e-9), and matches the JAX package's ``brick_epoch`` over a (4, 1) mesh:
    the same accuracies, the MAE series and the scores on the first batch and
    on fresh inputs within ``tests/test_torch_brickwall.py``'s 1e-8 of the
    largest (the pair splits' bases are a gauge, so sites are not held)."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.boundary import boundary_forward as jbf
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train.brickwall import brick_epoch as jepoch

    d = payload["brick_epoch"]
    got = case_result(worlds[4], "brick_epoch")
    np.testing.assert_allclose(got["sites"], got["ref_sites"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["w"], got["ref_w"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["acc"], got["ref_acc"], atol=1e-12)
    np.testing.assert_allclose(got["mae"], got["ref_mae"], rtol=1e-9, atol=1e-12)
    assert np.isfinite(got["acc"]).all()
    jm, jmet = jepoch(_jax_boundary(d["model"]), d["x"], d["y"], 0.05, 1e-4,
                      mesh=_jax_mesh((4, 1)))
    np.testing.assert_allclose(got["acc"], np.asarray(jmet["accuracy"]), atol=1e-12)
    np.testing.assert_allclose(got["mae"], np.asarray(jmet["MAE"]), rtol=1e-8)
    for k, x in (("probe", d["probe"]), ("batch", d["x"][0])):
        want = np.asarray(jbf(jm, jpsi(jnp.asarray(x))))
        assert np.abs(got["fwd"][k] - want).max() <= 1e-8 * np.abs(want).max(), k


# ---- on the card: a world of one (NCCL over a HashStore) ------------------


@pytest.fixture
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's world of one runs over NCCL")
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


def _card_flagship_ish(N=24, M=32, L=10, B=64, seed=0):
    from tensornetworkforml_torch.models.mps import product_init

    r = _rng(seed)
    x = r.random((B, N)).astype(np.float32)
    mps = product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, act_fn="linear",
                       loss_fn="MSE", calibration_x=x, device="cuda")
    return mps, x, r.integers(0, L, B), r.random((16, N)).astype(np.float32)


@pytest.mark.cuda
def test_card_dp_sweep_matches_sweep_once(card_mesh):
    """Two data-parallel sweeps (K1 on every step) in a world of one against
    ``sweep_once`` on the same inputs: 1e-6 of max|f| on fresh inputs."""
    from tensornetworkforml_torch.ops.kernels import polar_split
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.train.sweep import SweepConfig

    mps, x, y, probe = _card_flagship_ish()
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                      svd_method="polar")
    tr = ShardedTrainer(card_mesh, mps, lr=0.05, weight_dec=1e-5, cfg=cfg)
    before = polar_split.polar_iterate.launches
    tr.step(x, y)
    tr.step(x[::-1].copy(), y[::-1].copy())
    assert polar_split.polar_iterate.launches - before == 2 * (mps.N - 1)
    ref = _single_sweep(mps, x, y, 0.05, 1e-5, cfg)
    ref = _single_sweep(ref, x[::-1].copy(), y[::-1].copy(), 0.05, 1e-5, cfg)
    got, want = _fwd(tr.mps.cpu(), probe), _fwd(ref.cpu(), probe)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.cuda
def test_card_dist_polar_step_matches_two_stage(card_mesh):
    """The distributed polar split on one rank (K5, a one-rank all-reduce, K1)
    against ``polar_split_two_stage`` on the same matrix: the same bits."""
    from tensornetworkforml_torch.ops.kernels import polar_split
    from tensornetworkforml_torch.parallel.dist_split import distributed_polar_split

    bmat = torch.as_tensor(_rng(40).standard_normal((256, 2560)).astype(np.float32),
                           device="cuda")
    k5 = polar_split.polar_sketch_gram.launches
    q, r = distributed_polar_split(bmat, 128, card_mesh)
    assert polar_split.polar_sketch_gram.launches == k5 + 1
    q1, r1 = polar_split.polar_split_two_stage(bmat, 128)
    assert torch.equal(q, q1) and torch.equal(r, r1)


@pytest.mark.cuda
def test_card_mesh_serving_matches_plain_predictor(card_mesh):
    """Mesh serving in a world of one through K3 against the single-device
    ``Predictor``: the same bits."""
    from tensornetworkforml_torch.models.serving import Predictor
    from tensornetworkforml_torch.ops.kernels import env_scan

    mps, x, _, _ = _card_flagship_ish()
    before = env_scan.right_env_chain.launches
    got = Predictor(mps, batch_size=32, mesh=card_mesh).scores(x)
    assert env_scan.right_env_chain.launches > before
    np.testing.assert_array_equal(got, Predictor(mps, batch_size=32).scores(x))
