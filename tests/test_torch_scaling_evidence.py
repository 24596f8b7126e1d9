"""The port's data-parallel sweep issues one all-reduce a step, as the JAX
package's compiled program does.

``tests/test_scaling_evidence.py`` pins this in the JAX package's optimised
HLO (``utils/hlo.py::scan_body_collectives``): the sweep's whole per-step
communication is ONE variadic all-reduce carrying the 5-D two-site gradient
and fused scalar metrics. The port has no compiled program; its collectives
are ``torch.distributed`` calls, counted from a ``torch.profiler`` trace by
``utils/collectives.py`` (``step_collectives`` takes those inside each step's
range). Both run the JAX test's configuration: N=12, M=8, L=10, B=64 over 4
data ranks, float32, linear/MSE, the canonical ``svd`` split; the port in a
spawned gloo world of 4 ranks (``tests/torch_worlds.py``), the JAX package
here on 4 virtual CPU devices.
"""

import numpy as np
import pytest
import torch

from tests.torch_worlds import World, case_result

MODULE = "tests.test_torch_scaling_evidence"
N, M, L, B, RANKS = 12, 8, 10, 64, 4
CONFIGS = {"plain": dict(L2_flag=False), "l2": dict(L2_flag=True),
           "renorm": dict(L2_flag=False, renorm_envs=True)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(RANKS, MODULE, ["collectives"], {}, tmp_path_factory.mktemp("world")).start()
    yield w
    try:
        w.results()
    except RuntimeError:
        pass


def case_collectives(p):
    """One profiled data-parallel right sweep per configuration: every
    collective (op, elements, dtype) and those of each step."""
    from torch.profiler import ProfilerActivity, profile

    from tensornetworkforml_torch.models.mps import mps_init
    from tensornetworkforml_torch.parallel.dp import make_sharded_train_step
    from tensornetworkforml_torch.parallel.mesh import make_mesh
    from tensornetworkforml_torch.train.sweep import SweepConfig
    from tensornetworkforml_torch.utils.collectives import (
        parse_collectives,
        step_collectives,
        trace_events,
    )

    mesh = make_mesh(shape=(RANKS, 1), device="cpu")
    mps = mps_init(torch.Generator().manual_seed(0), N=N, M=M, L=L, act_fn="linear",
                   loss_fn="MSE", device="cpu")
    rng = np.random.default_rng(0)
    x, y = rng.random((B, N)).astype(np.float32), rng.integers(0, L, B)
    out = {}
    for name, kw in CONFIGS.items():
        cfg = SweepConfig(act_fn="linear", loss_fn="MSE", split_mode="canonical",
                          svd_method="svd", **kw)
        step = make_sharded_train_step(mesh, cfg, mps.T, L, False)
        args = (mps.sites, mps.label_site, x, y, torch.tensor(0.05), torch.tensor(0.0),
                [M] * (N - 1))
        step(*args)  # the groups' first use outside the window
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            step(*args)
        events = trace_events(prof)
        key = lambda c: (c["op"], c["elements"], c["dtype"])  # noqa: E731
        out[name] = dict(all=[key(c) for c in parse_collectives(events)],
                         steps=[[key(c) for c in s] for s in step_collectives(events)])
    return out


def _jax_collectives(**kw):
    """The JAX test's compiled DP step: the scan body's collectives and the
    others, as (op, element count) pairs."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_init
    from tensornetworkforml_tpu.parallel.dp import make_sharded_train_step
    from tensornetworkforml_tpu.parallel.mesh import make_mesh
    from tensornetworkforml_tpu.train.sweep import SweepConfig
    from tensornetworkforml_tpu.utils.hlo import parse_collectives, scan_body_collectives

    mesh = make_mesh(shape=(RANKS, 1), devices=jax.devices()[:RANKS])
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", split_mode="canonical",
                      svd_method="svd", **kw)
    mps = mps_init(jax.random.PRNGKey(0), N=N, M=M, L=L, act_fn="linear", loss_fn="MSE",
                   dtype=jnp.float32)
    step = make_sharded_train_step(mesh, cfg, mps.T, L, False)
    rng = np.random.default_rng(0)
    txt = step.lower(
        mps.sites, mps.label_site, jnp.asarray(rng.random((B, N)), jnp.float32),
        jnp.asarray(rng.integers(0, L, B), jnp.int32), jnp.float32(0.05), jnp.float32(0.0),
        jnp.full((N - 1,), M, dtype=jnp.int32)).compile().as_text()

    def elements(c):
        return sum(int(np.prod([int(d) for d in s.split("[")[1].rstrip("]").split(",") if d]))
                   for s in c["shapes"])

    body = scan_body_collectives(txt)
    return ([(c["op"], elements(c)) for c in body],
            [(c["op"], elements(c)) for c in parse_collectives(txt) if c not in body])


def test_dp_sweep_one_all_reduce_per_step(world):
    got = case_result(world, "collectives")["plain"]
    grad = M * 2 * L * 2 * M
    # exactly one collective in each of the N-1 steps: the all-reduce of the
    # two-site gradient (M, D, L, D, M) and the three metric sums
    assert len(got["steps"]) == N - 1
    assert all(s == [("all_reduce", grad + 3, "float")] for s in got["steps"]), got["steps"]
    in_steps = [c for s in got["steps"] for c in s]
    others = [c for c in got["all"] if c not in in_steps]
    assert len(got["all"]) == len(in_steps) + len(others)
    assert all(c[1] <= 16 for c in others), others
    # the JAX package's compiled step: one variadic all-reduce in the scan
    # body carrying the same elements, and the same scalar reductions outside
    body, jax_others = _jax_collectives(L2_flag=False)
    assert body == [("all-reduce", grad + 3)]
    assert [(op.replace("_", "-"), n) for op, n, _ in others] == jax_others


def test_dp_sweep_l2_adds_no_communication(world):
    """Exact transfer-matrix L2 is parameter-side (replicated): no
    collective is added, in either package."""
    got = case_result(world, "collectives")
    assert got["l2"]["all"] == got["plain"]["all"]
    assert _jax_collectives(L2_flag=True) == _jax_collectives(L2_flag=False)


def test_renorm_envs_adds_one_scalar_all_reduce_per_step(world):
    """``renorm_envs`` needs the batch's mean env norm after the split: a
    second all-reduce a step, of one scalar. The JAX package's program also
    runs two a step under it (the gradient alone, then the metric sums with
    the norm sum): the same count and the same elements a step."""
    got = case_result(world, "collectives")["renorm"]
    grad = M * 2 * L * 2 * M
    assert all(s == [("all_reduce", grad + 3, "float"), ("all_reduce", 1, "float")]
               for s in got["steps"]), got["steps"]
    body, _ = _jax_collectives(L2_flag=False, renorm_envs=True)
    assert len(body) == 2 and sum(n for _, n in body) == grad + 4
