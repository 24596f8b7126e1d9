"""The collectives a program issued, read off a ``torch.profiler`` trace.

The counterpart of the JAX package's ``utils/hlo.py``, which reads the
collectives of a compiled program off its optimised HLO. The port has no
compiled program: its collectives are ``torch.distributed`` calls, and the
profiler records each one twice, as the dispatcher's ``c10d::*`` op and as
the backend's own range (``gloo:all_reduce``, ``nccl:all_reduce``, ...).
``parse_collectives`` counts the backend's range, once per collective, with
its element count and bytes; ``step_collectives`` groups them by the ranges
a data-parallel sweep marks around each of its steps (``STEP_RANGE``), as
``scan_body_collectives`` takes those of the scan body. This is how the tests
pin the data-parallel sweep's one all-reduce a step.

Profile with ``record_shapes=True``: the ranges carry their tensors' shapes
and types only then. A profile exports its trace once: to read it twice,
pass both functions ``trace_events(prof)``.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

# the range the data-parallel sweep puts around each two-site step
STEP_RANGE = "tnml::two_site_step"

_BACKENDS = ("gloo:", "nccl:")
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4,
                "long int": 8, "bool": 1, "Float": 4, "Double": 8, "Half": 2, "BFloat16": 2,
                "Int": 4, "Long": 8, "Bool": 1}


def trace_events(prof) -> list:
    """The events of a finished ``torch.profiler.profile``, as its Chrome
    trace holds them (name, category, start, duration and the recorded
    arguments)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def _first_dims(dims):
    while dims and isinstance(dims[0], list):
        dims = dims[0]
    return dims


def parse_collectives(prof_or_events) -> list:
    """Every collective in a trace, in order of issue.

    Returns a list of ``{"op", "elements", "dtype", "bytes", "ts", "end"}``
    (``op`` as the backend names it: ``all_reduce``, ``all_gather``,
    ``broadcast``, ...; the times in microseconds). Takes a finished
    ``torch.profiler.profile`` or its ``trace_events``."""
    events = prof_or_events if isinstance(prof_or_events, list) else trace_events(prof_or_events)
    found = []
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") != "X" or not name.startswith(_BACKENDS) or str(
                ev.get("cat", "")).startswith("gpu"):
            continue
        args = ev.get("args", {})
        if "In msg nelems" in args:
            elements, dtype = int(args["In msg nelems"]), str(args.get("dtype", ""))
        else:
            dims = args.get("Input Dims") or [[]]
            elements = math.prod(int(d) for d in _first_dims(dims[0]))
            dtype = str((args.get("Input type") or [""])[0])
        found.append({
            "op": name.split(":", 1)[1],
            "elements": elements,
            "dtype": dtype,
            "bytes": elements * _DTYPE_BYTES.get(dtype, 0),
            "ts": float(ev["ts"]),
            "end": float(ev["ts"]) + float(ev.get("dur", 0.0)),
        })
    return sorted(found, key=lambda c: c["ts"])


def step_collectives(prof_or_events, step_range: str = STEP_RANGE) -> list:
    """The collectives issued inside each ``step_range`` range, one list per
    range in order (the port's ``scan_body_collectives``)."""
    events = prof_or_events if isinstance(prof_or_events, list) else trace_events(prof_or_events)
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("ph") == "X" and e.get("name") == step_range
                   and not str(e.get("cat", "")).startswith("gpu"))
    colls = parse_collectives(events)
    return [[c for c in colls if a <= c["ts"] and c["end"] <= b] for a, b in steps]
