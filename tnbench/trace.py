"""The traced run's profile: started early, recording one steady sub-window.

``Tracer`` starts ``torch.profiler`` at the beginning of set-up in its
warm-up phase (the device tracer is initialised then, not late in the
process, where it has been seen to lose device events), records only the
iterations between ``begin()`` and ``end()`` of the measured window, and
reads the exported trace into a ``TraceView``: the device's operations and
the harness's own spans (``record_function`` ranges, one per request or
epoch) in that sub-window. Per-layer metrics read the view.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import torch

SPAN = "tnbench.iteration"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceView:
    """What one traced sub-window holds. Times in microseconds of the
    profiler's clock. ``device`` holds ``(name, cat, start, end)`` of every
    device operation inside the sub-window, ``spans`` the harness's
    iteration spans ``(start, end)``."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)  # samples, sweeps, requests in the sub-window
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)

    @property
    def start(self) -> float:
        return self.spans[0][0]

    @property
    def end(self) -> float:
        return self.spans[-1][1]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6 if self.spans else 0.0

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, _, a, b in self.device]) / 1e6

    def matching(self, pattern: str) -> list:
        """The device operations whose name matches the regular expression."""
        rx = re.compile(pattern)
        return [e for e in self.device if rx.search(e[0])]


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_pct(view: TraceView):
    """The share of the sub-window in which no device operation ran, in %."""
    if not view.spans or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


class Tracer:
    """A profile over one sub-window of the measured window; inert when
    ``enabled`` is false."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self._events = None
        self._prof = None
        self.active = False
        if not enabled:
            return
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=self._export)
        self._prof.start()  # warm-up: the tracer is set up now, nothing is kept

    def _export(self, prof) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                self._events = json.load(fh).get("traceEvents", [])

    def begin(self) -> None:
        """Start recording (at an iteration boundary, the device idle)."""
        if self._prof is not None and not self.active:
            self._prof.step()
            self.active = True

    def end(self) -> None:
        """Stop recording (at an iteration boundary, the device idle)."""
        if self.active:
            self._prof.step()
            self.active = False
            self.close()

    def close(self) -> None:
        """Stop the profiler, recording or not."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def view(self, config: dict, traffic: dict) -> TraceView:
        evs = self._events or []
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                       if e.get("ph") == "X" and e.get("name") == SPAN
                       and e.get("cat") == "user_annotation")
        view = TraceView(spans=spans, config=config, traffic=traffic)
        if not spans:
            return view
        lo, hi = view.start, view.end
        for e in evs:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b <= lo or a >= hi:
                continue
            cat = str(e.get("cat", ""))
            if cat in DEVICE_CATS:
                view.device.append((e["name"], cat, max(a, lo), min(b, hi)))
            elif cat == "cpu_op" or cat.startswith("cuda_"):  # operators, CUDA API calls
                view.host.append((e["name"], a, b))
        return view


def measure(step, seconds: float, tracer: "Tracer", tr: dict):
    """The measured window: ``step(i)`` called back to back, ``i = 0, 1, ...``,
    until ``seconds`` have passed (the last call started inside the window is
    waited for and counted); the tracer records the calls from
    ``tr["trace_from"]`` of the window on for ``tr["trace_seconds"]``, each in
    a span. Returns ``(outputs, seconds a call, window seconds)``."""
    outs, lat = [], []
    t0 = now = time.perf_counter()
    t_trace = t0 + tr["trace_from"] * seconds
    traced_at = None
    while True:
        if tracer.enabled and traced_at is None and now >= t_trace:
            tracer.begin()
            traced_at = now
        span = torch.profiler.record_function(SPAN) if tracer.active else contextlib.nullcontext()
        with span:
            ts = time.perf_counter()
            outs.append(step(len(outs)))
            now = time.perf_counter()
        lat.append(now - ts)
        if tracer.active and now - traced_at >= tr["trace_seconds"]:
            tracer.end()
        if now - t0 >= seconds:
            break
    tracer.end()
    return outs, lat, now - t0


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took the most time in the sub-window, and
    its longest idle gaps, each named by the host operation that covered
    most of it."""
    by_name: dict = {}
    for name, _, a, b in view.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], view.start
    for _, _, a, b in sorted(view.device, key=lambda e: e[2]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if view.end > end:
        gaps.append((end, view.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for ga, gb in gaps:
        best, best_overlap = "host idle", 0.0
        for name, a, b in view.host:
            ov = min(b, gb) - max(a, ga)
            if ov > best_overlap:
                best, best_overlap = name, ov
        named.append([best[:160], (gb - ga) / 1e6])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": named}
