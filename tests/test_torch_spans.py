"""The port's spans (``utils/profiling.py::span``) at the layer boundaries of
serving and training.

* Under a CPU profile, ``Predictor.scores`` of 2.5 chunks records one request
  range with one copy in, three chunks and one copy out inside it, in order.
* ``fused_epoch`` of 2 batches records one epoch, two sweeps, a prologue in
  each sweep before its first step, and N - 1 steps a sweep on the xla and
  hybrid engines (none on the fused engine, whose steps are issued from C).
* With no profiler recording, neither path enters ``record_function``.
* The gate reads false in a scheduled profiler's wait and warm-up phases and
  true in its active phase.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tensornetworkforml_torch.models.mps import mps_init
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.train.epoch import fused_epoch
from tensornetworkforml_torch.train.sweep import SweepConfig
from tensornetworkforml_torch.utils import profiling as P
from tensornetworkforml_torch.utils.collectives import STEP_RANGE, trace_events

N, M, L, B, BATCH = 6, 4, 2, 8, 4
EPS = 0.01  # microseconds: the trace's times are rounded to nanoseconds
STEPS = {"xla": N - 1, "hybrid": N - 1, "fused": 0}


def _model():
    return mps_init(torch.Generator().manual_seed(0), N=N, M=M, L=L, act_fn="linear",
                    loss_fn="MSE", dtype=torch.float32, device="cpu")


def _serve():
    x = np.random.default_rng(0).random((BATCH * 5 // 2, N)).astype(np.float32)
    return Predictor(_model(), batch_size=BATCH, device="cpu").scores(x)


def _train(engine):
    def run():
        rng = np.random.default_rng(1)
        cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                          svd_method="polar", engine=engine)
        return fused_epoch(_model(), rng.random((2, B, N)), rng.integers(0, L, (2, B)), 0.05,
                           1e-5, cfg)
    return run


PATHS = {"serve": _serve, **{f"train-{e}": _train(e) for e in STEPS}}


def _spans(run) -> dict:
    """The port's ranges recorded while ``run()`` runs under a CPU profile:
    name -> sorted ``[(start, end)]`` in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = {}
    for e in trace_events(prof):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith("tnml::"):
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _parent(child, parents) -> int:
    """The index of the range of ``parents`` that holds ``child``."""
    held = [i for i, (a, b) in enumerate(parents) if a - EPS <= child[0] and child[1] <= b + EPS]
    assert len(held) == 1, (child, parents)
    return held[0]


def test_the_step_span_is_the_collectives_step_range():
    assert P.STEP == STEP_RANGE == "tnml::two_site_step"


def test_a_request_of_two_and_a_half_chunks():
    got = _spans(_serve)
    assert {k: len(v) for k, v in got.items()} == {
        P.SERVE_REQUEST: 1, P.SERVE_COPY_IN: 1, P.SERVE_CHUNK: 3, P.SERVE_COPY_OUT: 1}
    request = got[P.SERVE_REQUEST]
    inner = got[P.SERVE_COPY_IN] + got[P.SERVE_CHUNK] + got[P.SERVE_COPY_OUT]
    assert all(_parent(s, request) == 0 for s in inner)
    # copy in, the chunks in turn, copy out: one after the other
    assert all(a[1] <= b[0] + EPS for a, b in zip(inner, inner[1:]))


@pytest.mark.parametrize("engine", sorted(STEPS))
def test_an_epoch_of_two_sweeps(engine):
    got = _spans(_train(engine))
    want = {P.EPOCH: 1, P.SWEEP: 2, P.SWEEP_PROLOGUE: 2, P.STEP: 2 * STEPS[engine]}
    assert {k: len(v) for k, v in got.items()} == {k: n for k, n in want.items() if n}
    sweeps = got[P.SWEEP]
    assert all(_parent(s, got[P.EPOCH]) == 0 for s in sweeps)
    prologues = [_parent(s, sweeps) for s in got[P.SWEEP_PROLOGUE]]
    assert prologues == [0, 1]
    steps = got.get(P.STEP, [])
    owners = [_parent(s, sweeps) for s in steps]
    assert owners == [i for i in range(2) for _ in range(STEPS[engine])]
    for i, (a, b) in enumerate(got[P.SWEEP_PROLOGUE]):
        first = [s for s, o in zip(steps, owners) if o == i][:1]
        assert all(b <= s[0] + EPS for s in first)  # the prologue ends before the first step


@pytest.mark.parametrize("recording", [False, True])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_record_function_only_while_a_profiler_records(path, recording, monkeypatch):
    real, names = torch.profiler.record_function, []

    def counted(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            PATHS[path]()
        assert names and all(n.startswith("tnml::") for n in names)
    else:
        PATHS[path]()
        assert names == []


def test_the_gate_follows_the_profilers_schedule():
    seen = []
    prof = profile(activities=[ProfilerActivity.CPU], on_trace_ready=lambda p: None,
                   schedule=schedule(wait=1, warmup=1, active=1))
    seen.append(P.recording())
    prof.start()
    for _ in range(4):  # wait, warm-up, active, done
        seen.append(P.recording())
        prof.step()
    prof.stop()
    seen.append(P.recording())
    assert seen == [False, False, False, True, False, False]
    assert P.span(P.SWEEP) is P.span(P.STEP)  # one shared no-op context while off
