"""``tnbench/spans.py``: the program's spans read from a trace's raw events.

* On hand-built traces with known spans, launches and device operations,
  the idle split and the six readings come out as counted by hand, with an
  idle gap that straddles a span's edge, a kernel launched inside a step
  that runs after the step ends (counted for the step) and one launched
  outside the steps that runs during one (not counted).
* The program's spans change nothing that ``trace.py`` and the per-layer
  metrics read: the view, every metric and the breakdown are the same with
  and without them, on a hand-built trace and on a recorded CPU trace of
  every cell.
* A CPU rehearsal of every cell: one span of each kind per request or
  sweep, the host readings present, the device readings absent.
"""

import importlib

import pytest
import torch

from tnbench import run, spans
from tnbench.trace import Tracer, breakdown, idle_pct

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"N": 16, "M": 6, "image_side": 8}
M128 = {"N": 196, "D": 2, "M": 128, "L": 10}


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _annot(name, ts, end):
    return _x(name, "user_annotation", ts, end - ts)


def _launch(corr, ts):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2.0, correlation=corr)


def _kernel(corr, a, b, name="k", cat="kernel"):
    return _x(name, cat, a, b - a, correlation=corr)


TRAIN_TRACE = [
    _annot("tnbench.iteration", 0.0, 1000.0),
    _annot(spans.EPOCH, 5.0, 960.0), _annot(spans.SWEEP, 10.0, 900.0),
    _annot(spans.PROLOGUE, 20.0, 100.0),
    _annot(spans.STEP, 100.0, 110.0), _annot(spans.STEP, 120.0, 130.0),
    _launch(1, 25.0), _kernel(1, 30.0, 60.0),
    _launch(5, 15.0), _kernel(5, 102.0, 108.0),  # launched in the sweep, runs in a step
    _launch(2, 105.0), _kernel(2, 200.0, 260.0),  # launched in a step, runs after it
    _launch(3, 125.0), _kernel(3, 260.0, 300.0),
    _launch(4, 140.0), _kernel(4, 300.0, 400.0),
    _kernel(99, 950.0, 1000.0, "Memcpy DtoH", "gpu_memcpy"),  # no call carries its id
    _x("aten::einsum", "cpu_op", 60.0, 40.0),
]
# idle: [0, 30] [60, 102] [108, 200] [400, 950], put down by hand
TRAIN_IDLE = {None: 5.0, spans.EPOCH: 5.0 + 50.0, spans.SWEEP: 10.0 + 10.0 + 70.0 + 500.0,
              spans.PROLOGUE: 10.0 + 40.0, spans.STEP: 2.0 + 2.0 + 10.0}

SERVE_TRACE = [
    _annot("tnbench.iteration", 0.0, 500.0), _annot(spans.REQUEST, 2.0, 498.0),
    _annot(spans.COPY_IN, 5.0, 105.0), _annot(spans.CHUNK, 110.0, 400.0),
    _annot(spans.COPY_OUT, 400.0, 495.0),
    _x("cudaMemcpyAsync", "cuda_runtime", 6.0, 90.0, correlation=1),
    _kernel(1, 50.0, 100.0, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
    _launch(2, 120.0), _kernel(2, 150.0, 390.0, "chain_kernel"),
    _x("cudaMemcpyAsync", "cuda_runtime", 401.0, 90.0, correlation=3),
    _kernel(3, 480.0, 490.0, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
    _x("aten::to", "cpu_op", 6.0, 95.0),
]
# idle: [0, 50] [100, 150] [390, 480] [490, 500]
SERVE_IDLE = {None: 2.0 + 2.0, spans.REQUEST: 3.0 + 5.0 + 3.0, spans.COPY_IN: 45.0 + 5.0,
              spans.CHUNK: 40.0 + 10.0, spans.COPY_OUT: 80.0 + 5.0}


def _view(events, config=None, traffic=None):
    tracer = Tracer(False, torch.device("cpu"))
    tracer._events = events
    return tracer.view(config or {}, traffic or {})


@pytest.mark.parametrize("events, want", [(TRAIN_TRACE, TRAIN_IDLE), (SERVE_TRACE, SERVE_IDLE)],
                         ids=["train", "serve"])
def test_idle_split_by_innermost_span(events, want):
    view = _view(events)
    lo, hi = view.start, view.end
    got = spans.idle_by_span(spans.idle_gaps(spans.launched(events, lo, hi), lo, hi),
                             spans.program_spans(events, lo, hi))
    assert got == pytest.approx(want)
    out = spans.report(events, view)
    assert sum(out["idle_pct"].values()) == pytest.approx(idle_pct(view))
    assert out["idle_pct"] == pytest.approx({spans.ROWS[k]: 100.0 * v / (hi - lo)
                                             for k, v in want.items()})


def test_training_readings():
    view = _view(TRAIN_TRACE)
    out = spans.report(TRAIN_TRACE, view)
    assert out["readings"] == pytest.approx({
        "copy_in_ms.serve": None, "copy_in_idle.serve": None,
        "prologue_ms.train": 0.080, "prologue_idle.train": 5.0,
        "step_host_us.train": 10.0,
        "step_device_us.train": (60.0 + 40.0) / 2,  # kernels 2 and 3; not 5
    })
    assert out["spans"] == {spans.EPOCH: 1, spans.SWEEP: 1, spans.PROLOGUE: 1, spans.STEP: 2}
    assert out["unlaunched"] == 1


def test_serving_readings():
    out = spans.report(SERVE_TRACE, _view(SERVE_TRACE))
    assert out["readings"] == pytest.approx({
        "copy_in_ms.serve": 0.100, "copy_in_idle.serve": 10.0,
        "prologue_ms.train": None, "prologue_idle.train": None,
        "step_host_us.train": None, "step_device_us.train": None,
    })


def test_no_device_no_device_readings():
    host_only = [e for e in TRAIN_TRACE if e["cat"] in ("user_annotation", "cpu_op")]
    got = spans.report(host_only, _view(host_only))
    assert got["readings"]["prologue_ms.train"] == pytest.approx(0.080)
    assert got["readings"]["step_host_us.train"] == pytest.approx(10.0)
    for name in ("copy_in_idle.serve", "prologue_idle.train", "step_device_us.train"):
        assert got["readings"][name] is None
    assert got["idle_pct"] == {}


def _without_program_spans(events):
    return [e for e in events if not str(e.get("name", "")).startswith("tnml::")]


def _same_reading(events, cell, config, traffic, counts):
    """What ``trace.py`` and every per-layer metric of ``cell`` read, with and
    without the program's spans in the trace."""
    reads = []
    for evs in (events, _without_program_spans(events)):
        view = _view(evs, config, traffic)
        view.counts = counts(view)
        reads.append({
            "view": (view.device, view.host, view.spans, view.counts),
            "metrics": {m["name"]: run.metric_reader(m["name"])(view)
                        for m in run.per_layer_for(BENCH, cell)},
            "breakdown": breakdown(view) if view.spans and view.device else None,
        })
    assert reads[0] == reads[1]
    return reads[0]


@pytest.mark.parametrize("cell, events", [("m128-serve-bulk", SERVE_TRACE),
                                          ("m128-train-polar", TRAIN_TRACE)])
def test_existing_metrics_ignore_the_program_spans_hand_built(cell, events):
    traffic = {"batch_size": 8192, "rows": 8192, "batch": 256, "batches_per_epoch": 2,
               "sweep": {"svd_method": "polar"}}
    got = _same_reading(events, cell, M128, traffic,
                        lambda v: {"requests": 1, "samples": 8192, "sweeps": 2})
    assert got["breakdown"] and any(v is not None for v in got["metrics"].values())


def _small(cell):
    c = run.load_cell(BENCH, cell)
    c["config"].update(SMALL)
    tr = c["traffic"]
    if tr["kind"] == "serve_closed_loop":
        tr.update(rows=48, batch_size=32)  # two chunks a request
    else:
        tr.update(batch=16, fresh_rows=48)
    tr["trace_from"] = 0.0
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal_of_every_cell(cell):
    torch.manual_seed(0)
    c = _small(cell)
    view, events = spans.traced(BENCH, cell, 2 ** 33 + 7, 0.3, torch.device("cpu"), loaded=c)
    drv = importlib.import_module(run.GENERATORS[c["traffic"]["kind"]])
    _same_reading(events, cell, c["config"], c["traffic"], lambda v: drv.counts(v, c["traffic"]))
    out = spans.report(events, view)
    got, n = out["readings"], len(view.spans)
    assert n >= 1 and out["idle_pct"] == {} and out["unlaunched"] == 0
    if c["traffic"]["kind"] == "serve_closed_loop":
        assert out["spans"] == {spans.REQUEST: n, spans.COPY_IN: n, spans.CHUNK: 2 * n,
                                spans.COPY_OUT: n}
        assert got["copy_in_ms.serve"] > 0 and got["copy_in_idle.serve"] is None
    else:
        sweeps = view.counts["sweeps"]
        steps = (c["config"]["N"] - 1) * sweeps
        assert out["spans"] == {spans.EPOCH: n, spans.SWEEP: sweeps, spans.PROLOGUE: sweeps,
                                spans.STEP: steps}
        assert got["prologue_ms.train"] > 0 and got["step_host_us.train"] > 0
        assert got["prologue_idle.train"] is None and got["step_device_us.train"] is None


def test_command_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spans.main(["--workload", CELLS[0], "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""
