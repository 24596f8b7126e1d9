"""The check that decides ``correct`` fails what it must: a run with its timed
path broken underneath, and the control put in the program's place, come out
not correct. On the CPU, at a small size, with limits at three times what
the sound program reads at that size and seed (the cells' own limits are set
on the card, at the cells' sizes, PERF.md section 2)."""

import importlib

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.serving import Predictor
from tnbench import readings, run, serve, train
from tnbench.trace import Tracer

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
SMALL = {"N": 16, "M": 6, "image_side": 8}
SERVE_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("serve")]
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("train")]


def _has_k1(cell: str) -> bool:
    sweep = run.load_cell(BENCH, cell)["traffic"]["sweep"]
    return sweep["svd_method"] == "polar" and sweep["engine"] == "hybrid"


# each fault in the cells whose path it breaks: K1's passes only where K1 runs
TRAIN_FAULTS = [(cell, fault) for cell in TRAIN_CELLS for fault in sorted(readings.FAULTS)
                if fault != "k1_pass_cut" or _has_k1(cell)]


def _small(cell: str) -> dict:
    c = run.load_cell(BENCH, cell)
    c["config"].update(SMALL)
    if c["traffic"]["kind"] == "serve_closed_loop":
        c["traffic"].update(rows=48, batch_size=32)
    else:
        # at this size float32 and float64 part from the fourth step on
        c["traffic"].update(batch=16, fresh_rows=48, steady_steps=3)
    return c


def _generator(c: dict):
    return importlib.import_module(run.GENERATORS[c["traffic"]["kind"]])


def _with_sound_limits(cell: str) -> dict:
    """The small cell, its limits three times what the sound program reads."""
    c = _small(cell)
    out = run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)
    c["limits"] = {k: {"limit": 3 * max(v["value"], 1e-12)} for k, v in out["checks"].items()}
    assert run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)["correct"]
    return c


def _half_batch_scores(real):
    def scores(self, x):
        out = real(self, x)
        h = len(out) // 2
        out[h:] = out[:h].mean(axis=0)
        return out
    return scores


def _altered_scores(real):
    def scores(self, x):
        out = real(self, x)
        out[len(out) // 2, 3] += 0.01 * np.abs(out).max()
        return out
    return scores


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", [_half_batch_scores, _altered_scores])
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    c = _with_sound_limits(cell)
    monkeypatch.setattr(Predictor, "scores", fault(Predictor.scores))
    out = run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell, fault", TRAIN_FAULTS)
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    c = _with_sound_limits(cell)
    module, name = readings.fault_target(_generator(c), fault)
    monkeypatch.setattr(module, name, readings.FAULTS[fault][1](getattr(module, name)))
    out = run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)
    assert not out["correct"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_non_finite_window_is_not_correct(cell, monkeypatch):
    # the checked epochs sound, the window's epochs leaving a NaN in the model
    c = _with_sound_limits(cell)
    module, name = _generator(c).ENTRY
    module = importlib.import_module(module)
    real, calls = getattr(module, name), []

    def poisoned(model, *args, **kwargs):
        calls.append(1)
        out = real(model, *args, **kwargs)
        if len(calls) > c["traffic"]["checked_epochs"]:
            out[0].label_site[0, 0, 0, 0] = float("nan")
        return out
    monkeypatch.setattr(module, name, poisoned)
    out = run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)
    assert not out["correct"] and out["checks"]["window_nonfinite"]["value"] >= 1


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_control_is_not_correct(cell):
    c = _with_sound_limits(cell)
    cfg, tr = c["config"], c["traffic"]
    state = serve.setup(cfg, tr, SEED, CPU)
    win = serve.window(state, tr, 0.2, Tracer(False, CPU))
    got = serve.check(state, win, cfg, tr, CPU, outs=serve.control_outputs(state, win, CPU))
    assert not run.judge(got["numbers"], c["limits"])[0]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_control_is_not_correct(cell):
    # the CPU has no TF32 path: the reference with TF32-rounded products
    # stands in the program's place
    c = _with_sound_limits(cell)
    cfg, tr = c["config"], c["traffic"]
    state = train.setup(cfg, tr, SEED, CPU)
    got = train.check(state, None, cfg, tr, CPU, outs=train.reference_epochs(state, tr, low=True))
    assert not run.judge(got["numbers"], c["limits"])[0]
