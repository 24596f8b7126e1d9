"""A traffic kind that no cell uses enters as one module and runs through the
harness unedited: ``run.run_cell`` (untraced and traced), ``spans.traced``,
``readings.reading`` (the program, the control and each fault) and the
tests' shared helpers. The module exists only here: a two-parameter line
fitted by SGD in float32, held against SGD in float64, made importable as
``tnbench.toy_sgd`` for each test alone."""

import math
import sys
import types

import pytest

from tnbench import readings, run
from tnbench.tests import cells

SEED = 2 ** 32 + 3

TOY = '''
"""The general generator of a toy kind: a line ``w x + c`` fitted by SGD."""

import torch

from tnbench import gen
from tnbench.trace import Tracer, measure

STEP = "tnml::toy.step"
ENTRY = ("tnbench.toy_sgd", "sgd_step")


def sgd_step(p, x, t, lr):
    """The program: one SGD step on the mean squared error, in ``p``'s
    precision; returns the new parameters and the loss before the step."""
    with torch.profiler.record_function(STEP):
        err = p[0] * x + p[1] - t
        grad = torch.stack([2 * (err * x).mean(), 2 * err.mean()])
        return p - lr * grad, (err * err).mean()


def setup(cfg, tr, seed, device):
    g = gen.generator(seed, device)
    shape = (tr["pool"], tr["batch"])
    x = 2 * torch.rand(shape, generator=g, device=device) - 1
    t = cfg["w"] * x + cfg["c"] + 0.1 * torch.randn(shape, generator=g, device=device)
    state = {"x": x, "t": t, "p": torch.zeros(2, device=device), "checked": []}
    for i in range(tr["checked_steps"]):
        state["p"], loss = sgd_step(state["p"], x[i], t[i], tr["lr"])
        state["checked"].append((state["p"].clone(), loss))
    return state


def window(state, tr, seconds, tracer):
    def step(i):
        k = (tr["checked_steps"] + i) % tr["pool"]
        state["p"], _ = sgd_step(state["p"], state["x"][k], state["t"][k], tr["lr"])

    done, _, window_s = measure(step, seconds, tracer, tr)
    return {"steps": len(done), "window_s": window_s,
            "nonfinite": int((~torch.isfinite(state["p"])).sum())}


def free(state):
    state.pop("p", None)


def reference(state, tr, dtype=torch.float64):
    """SGD in ``dtype``, a step at a time, from the same start and batches."""
    p, out = torch.zeros(2, dtype=dtype), []
    for i in range(tr["checked_steps"]):
        x, t = state["x"][i].cpu().to(dtype), state["t"][i].cpu().to(dtype)
        err = p[0] * x + p[1] - t
        loss = (err * err).mean()
        p = p - tr["lr"] * torch.stack([2 * (err * x).mean(), 2 * err.mean()])
        out.append((p, loss))
    return out


def check(state, win, cfg, tr, device, outs=None):
    prog = state["checked"] if outs is None else outs
    items = []
    for (p, loss), (rp, rloss) in zip(prog, reference(state, tr), strict=True):
        items.append({"loss_gap": abs(float(loss) - float(rloss)) / abs(float(rloss)),
                      "param_gap": float((p.cpu().double() - rp).abs().max() / rp.abs().max())})
    items.append({"window_nonfinite": float(win["nonfinite"]) if win else 0.0})
    nums = {"loss_gap": max(it["loss_gap"] for it in items[:-1]),
            "param_gap": max(it["param_gap"] for it in items[:-1]),
            "window_nonfinite": items[-1]["window_nonfinite"]}
    return {"numbers": nums, "items": items}


def end_to_end(win, tr, setup_s):
    return {"toy_steps_per_s": {"value": win["steps"] / win["window_s"], "unit": "steps/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}


def counts(view, tr):
    return {"steps": len(view.spans), "samples": len(view.spans) * tr["batch"]}


def attempted(win):
    return win["steps"]


def small(cfg, tr):
    return dict(cfg), dict(tr)


def control(cfg, tr, seed, device, seconds):
    """The reference in bfloat16 in the program's place."""
    state = setup(cfg, tr, seed, device)
    win = window(state, tr, seconds, Tracer(False, device))
    free(state)
    return check(state, win, cfg, tr, device, outs=reference(state, tr, torch.bfloat16))


def _half_batch(step):
    def faulty(p, x, t, lr):
        h = len(x) // 2
        return step(p, torch.cat([x[:h]] * 2), torch.cat([t[:h]] * 2), lr)
    return faulty


def _unchanged(step):
    def faulty(p, *args):
        return p, step(p, *args)[1]
    return faulty


def faults(tr):
    return {"half_batch": (ENTRY, _half_batch), "unchanged": (ENTRY, _unchanged)}


def span_counts(view, cfg, tr):
    return {STEP: len(view.spans)}
'''

CELL = {"name": "toy-line", "config": "toy", "traffic": "toy-sgd", "chips": 1,
        "why": "a line fitted by SGD"}
BENCH = {
    "workloads": [CELL],
    "configs": [{"name": "toy", "source": "none", "file": "none", "reduced": [], "why": "toy"}],
    "end_to_end": [
        {"name": "toy_steps_per_s", "unit": "steps/s", "better": "higher", "bound": 0.1,
         "source": "host_clock", "workloads": ["toy-line"]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "idle_share.train", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "toy_steps_per_s", "workloads": ["toy-line"]}],
}
NUMBERS = ("loss_gap", "param_gap", "window_nonfinite")


@pytest.fixture
def loaded(monkeypatch):
    """The toy cell, its module importable as ``tnbench.toy_sgd`` while the
    test runs; limits that pass anything, to be set by the helpers."""
    module = types.ModuleType("tnbench.toy_sgd")
    exec(compile(TOY, "toy_sgd.py", "exec"), module.__dict__)
    monkeypatch.setitem(sys.modules, "tnbench.toy_sgd", module)
    return {"cell": CELL, "config": {"w": 1.5, "c": -0.25},
            "traffic": {"kind": "toy_sgd", "batch": 64, "pool": 8, "checked_steps": 3,
                        "lr": 0.1, "trace_from": 0.0, "trace_seconds": 0.1},
            "limits": {k: {"limit": math.inf} for k in NUMBERS}}


@pytest.mark.parametrize("trace", [0, 1])
def test_new_kind_runs_a_cell(loaded, trace):
    c = cells.with_sound_limits("toy-line", SEED, BENCH, loaded)
    out = run.run_cell(BENCH, "toy-line", SEED, 0.2, bool(trace), cells.CPU, 0.0, loaded=c)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(NUMBERS)
    if trace:
        assert out["device"]["window_s"] > 0 and out["metrics"] == {}  # no device here
    else:
        assert set(out["metrics"]) == {"toy_steps_per_s", "setup_s"}


def test_new_kind_spans(loaded):
    from tnbench.tests.test_tnbench_spans import rehearse

    out = rehearse(BENCH, "toy-line", loaded)
    assert out["spans"]["tnml::toy.step"] >= 1


def test_new_kind_readings(loaded):
    c = cells.with_sound_limits("toy-line", SEED, BENCH, loaded)
    drv = cells.generator(c)
    roles = ["program", "control", *sorted(drv.faults(c["traffic"]))]
    assert roles[2:] == ["half_batch", "unchanged"]
    for role in roles:
        got = readings.reading(c, SEED, cells.CPU, 0.2, role)
        assert run.judge(got, c["limits"])[0] == (role == "program"), (role, got)


def test_new_kind_faults_through_the_shared_helpers(loaded):
    c = cells.with_sound_limits("toy-line", SEED, BENCH, loaded)
    drv = cells.generator(c)
    for fault in sorted(drv.faults(c["traffic"])):
        with readings.planted(drv, c["traffic"], fault):
            out = run.run_cell(BENCH, "toy-line", SEED, 0.2, False, cells.CPU, 0.0, loaded=c)
        assert not out["correct"] and out["failed"] >= 1


def test_unknown_kind_and_missing_function_are_named(loaded, monkeypatch):
    with pytest.raises(ValueError, match=r"tnbench/no_such_kind\.py does not exist"):
        run.generator("no_such_kind")
    with pytest.raises(ValueError, match="a traffic kind names a module"):
        run.generator("../serve")
    monkeypatch.delattr(sys.modules["tnbench.toy_sgd"], "span_counts")
    with pytest.raises(ValueError, match="lacks span_counts of the protocol"):
        run.generator("toy_sgd")
