"""The program's own spans in a traced run, and the card's idle time put
down to them.

    python3 tnbench/spans.py --workload <cell> --seeds 1,2,3 [--seconds 20]

The program records ``record_function`` ranges named ``tnml::...`` at its
layer boundaries while a profiler records (``tensornetworkforml_torch/utils/
profiling.py``; the names are frozen below, as the yardstick's work counts
are in ``roofline.py``). ``trace.Tracer.view`` keeps neither those ranges nor
the runtime call that launched each device operation, so this module reads
both from the trace's raw events: each range, and for each device operation
the host time of the CUDA API call with the same ``correlation`` id (the
library's ``cudaLaunchKernelExC`` calls as well as torch's own).

For each seed the command runs the cell's set-up and window on the card as
``run.py --trace 1`` does and prints one JSON line: the traced sub-window's
pace, its idle time split among the innermost program span open on the host
(the rest "outside" the program), the six span readings below, the spans
counted, and the cell's per-layer metrics as ``run.py`` reads them (a span
this module does not name keeps its own name in the idle split; how many of
each span a window holds is its generator's ``span_counts``). It exits
2 without a card. Read from a trace without device operations (a CPU run),
the device readings are ``None`` and the host-span readings are lengths on
the host's clock.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REQUEST, COPY_IN, CHUNK, COPY_OUT = ("tnml::serve.request", "tnml::serve.copy_in",
                                     "tnml::serve.chunk", "tnml::serve.copy_out")
EPOCH, SWEEP, PROLOGUE, STEP = ("tnml::epoch", "tnml::sweep", "tnml::sweep.prologue",
                                "tnml::two_site_step")
ROWS = {REQUEST: "request self", COPY_IN: "copy in", CHUNK: "chunk", COPY_OUT: "copy out",
        EPOCH: "epoch self", SWEEP: "sweep self", PROLOGUE: "prologue", STEP: "step",
        None: "outside"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # as trace.py keeps them


def _x(events):
    return (e for e in events if e.get("ph") == "X" and "dur" in e)


def program_spans(events, lo: float, hi: float) -> list:
    """The program's ranges ``(name, start, end)`` inside ``[lo, hi]``, by
    start."""
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in _x(events) if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("tnml::")
                  and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi)


def launched(events, lo: float, hi: float) -> list:
    """Each device operation overlapping ``[lo, hi]``, clipped to it, with the
    host time of the call that launched it: ``(name, cat, start, end,
    launch)``; ``launch`` is ``None`` where no call carries its id."""
    calls = {}
    for e in _x(events):
        cat = str(e.get("cat", ""))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            calls[e["args"]["correlation"]] = float(e["ts"])
    out = []
    for e in _x(events):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and b > lo and a < hi:
            corr = e.get("args", {}).get("correlation")
            out.append((e["name"], e["cat"], max(a, lo), min(b, hi), calls.get(corr)))
    return out


def idle_gaps(device, lo: float, hi: float) -> list:
    """The intervals of ``[lo, hi]`` in which no device operation runs."""
    gaps, end = [], lo
    for a, b in sorted((d[2], d[3]) for d in device):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def idle_by_span(gaps, spans) -> dict:
    """The idle time of ``gaps`` under each span name, each instant put down
    to the innermost span open then (the one that started last), ``None``
    where no span is open; microseconds."""
    marks = [(a, 1, i) for i, (_, a, _) in enumerate(spans)]
    marks += [(b, 0, i) for i, (_, _, b) in enumerate(spans)]
    marks += [(a, 1, -1) for a, _ in gaps] + [(b, 0, -1) for _, b in gaps]
    marks.sort()
    out, open_, idle, t = {}, set(), 0, None
    for when, starts, i in marks:
        if idle and t is not None and when > t:
            inner = max(open_, key=lambda j: (spans[j][1], -spans[j][2]), default=None)
            name = spans[inner][0] if inner is not None else None
            out[name] = out.get(name, 0.0) + when - t
        t = when
        if i < 0:
            idle += 1 if starts else -1
        elif starts:
            open_.add(i)
        else:
            open_.discard(i)
    return out


def _mean(values, scale: float = 1.0):
    return scale * sum(values) / len(values) if values else None


def readings(spans, device, lo: float, hi: float) -> dict:
    """The six span readings of the sub-window ``[lo, hi]`` (``None`` where
    the spans or the device operations a reading needs are absent)."""
    lengths = {n: [b - a for m, a, b in spans if m == n] for n in (COPY_IN, PROLOGUE, STEP)}
    idle = idle_by_span(idle_gaps(device, lo, hi), spans)
    steps = [(a, b) for n, a, b in spans if n == STEP]
    starts = [a for a, _ in steps]

    def idle_pct(name):
        return 100.0 * idle.get(name, 0.0) / (hi - lo) if device and lengths[name] else None

    def in_step(t):
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return k >= 0 and t <= steps[k][1]

    step_device = sum(d[3] - d[2] for d in device if in_step(d[4]))
    return {
        "copy_in_ms.serve": _mean(lengths[COPY_IN], 1e-3),
        "copy_in_idle.serve": idle_pct(COPY_IN),
        "prologue_ms.train": _mean(lengths[PROLOGUE], 1e-3),
        "prologue_idle.train": idle_pct(PROLOGUE),
        "step_host_us.train": _mean(lengths[STEP]),
        "step_device_us.train": step_device / len(steps) if device and steps else None,
    }


def report(events, view) -> dict:
    """One traced sub-window (``view``, ``events`` its raw trace) as the
    command prints it: the idle split adds up to ``idle_share.*``."""
    if not view.spans:
        return {}
    lo, hi = view.start, view.end
    spans = program_spans(events, lo, hi)
    device = launched(events, lo, hi)
    idle = idle_by_span(idle_gaps(device, lo, hi), spans) if device else {}
    return {
        "window_s": view.window_s,
        "pace": {k: v / view.window_s for k, v in view.counts.items() if k != "samples"},
        "idle_pct": {ROWS.get(k, k): 100.0 * v / (hi - lo) for k, v in idle.items()},
        "readings": readings(spans, device, lo, hi),
        "spans": dict(Counter(name for name, _, _ in spans)),
        "unlaunched": sum(1 for d in device if d[4] is None),
    }


def traced(bench: dict, name: str, seed: int, seconds: float, device, loaded: dict = None):
    """Set-up and a traced window of one cell, as ``run.run_cell`` runs them
    (``loaded`` as there); returns the sub-window's ``TraceView`` and the
    trace's raw events."""
    from tnbench import run
    from tnbench.trace import Tracer

    c = loaded or run.load_cell(bench, name)
    cfg, tr = c["config"], c["traffic"]
    drv = run.generator(tr["kind"])
    tracer = Tracer(True, device)
    state = drv.setup(cfg, tr, seed, device)
    drv.window(state, tr, seconds, tracer)
    drv.free(state)
    tracer.close()
    view = tracer.view(cfg, tr)
    view.counts = drv.counts(view, tr)
    return view, tracer._events or []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from tnbench import run

    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        view, events = traced(bench, args.workload, seed, args.seconds, device)
        metrics = {m["name"]: run.metric_reader(m["name"])(view)
                   for m in run.per_layer_for(bench, args.workload)}
        print(json.dumps({"workload": args.workload, "seed": seed, **report(events, view),
                          "metrics": metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
