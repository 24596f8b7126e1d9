"""Profiling and tracing utilities.

The counterpart of the JAX package's ``utils/profiling.py``. The reference's
only profiling is hand-rolled ``time.time()`` harnesses in its development
notebooks (SURVEY.md section 5); this module is the same as a library:

* ``Timer``: accumulating named wall-clock scopes that wait for the card's
  work on the tensors they are given;
* ``profile_model``: the notebook's table -- per-op timings of the forward,
  a full sweep, the environment stack and the SVD split -- for any model
  configuration;
* ``device_trace``: a context manager around ``torch.profiler`` that writes a
  Chrome / Perfetto trace of the host and, on the card, the device timeline;
* ``span``: the port's own ranges in that trace, at the layer boundaries of
  serving and training (the names below), on the profiler's clock beside the
  CUDA runtime calls and the card's kernels and copies. They are recorded
  exactly while a profiler records; otherwise ``span`` returns a shared
  no-op context and costs one flag read.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from tensornetworkforml_torch.utils.collectives import STEP_RANGE

# The spans (``record_function`` ranges), outermost first. Serving:
SERVE_REQUEST = "tnml::serve.request"  # ``Predictor.scores``, the whole call
SERVE_COPY_IN = "tnml::serve.copy_in"  # numpy to tensor and the copy to the device
SERVE_CHUNK = "tnml::serve.chunk"  # one chunk: padding, embedding, K3, the label closure
SERVE_COPY_OUT = "tnml::serve.copy_out"  # waiting for the card, the copy back
# Training:
EPOCH = "tnml::epoch"  # ``fused_epoch``
SWEEP = "tnml::sweep"  # one sweep, every engine and caller
SWEEP_PROLOGUE = "tnml::sweep.prologue"  # the stale environment stack and f0
STEP = STEP_RANGE  # one two-site step (the xla and hybrid engines)

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler is recording now (false in a scheduled profiler's
    wait and warm-up phases, true in its active phase)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records; otherwise a shared ``contextlib.nullcontext()``, so the
    range is never entered and costs nothing measurable."""
    return torch.profiler.record_function(name) if recording() else _OFF


def _devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in ``tree`` (a tensor, or nested
    lists, tuples and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def _device_sync(tree) -> None:
    """Wait until the card has finished the work queued on the devices that
    hold ``tree``'s tensors (work on the CPU is done when it returns)."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named wall-clock scopes with device synchronisation."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        """Time the body; with ``sync`` (tensors, or nested lists, tuples and
        dicts of them) the scope ends only after the card's work on their
        devices has."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _device_sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'op':<28}{'count':>8}{'mean ms':>12}{'total s':>12}"]
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<28}{s['count']:>8}{s['mean_ms']:>12.3f}{s['total_s']:>12.3f}"
            )
        return "\n".join(lines)


def profile_model(
    N: int = 25,
    M: int = 20,
    L: int = 2,
    batch: int = 16,
    iters: int = 10,
    dtype=None,
    seed: int = 0,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Per-op timing table for a model configuration (the reference
    notebook's profiling harness, reproducible from the library) on
    ``device`` (``None``: the card).

    Times (device-synced, after a warm-up): the full forward, one full
    sweep, the sweep prologue's environment stack (on the path the sweep
    takes), and one SVD split at the sweep's matrix shape.
    """
    from tensornetworkforml_torch.models.mps import mps_forward, mps_init, resolve_device
    from tensornetworkforml_torch.ops.contractions import boundary_vector
    from tensornetworkforml_torch.ops.embedding import psi_embed
    from tensornetworkforml_torch.ops.svd import truncated_svd_split
    from tensornetworkforml_torch.train.sweep import (
        SweepConfig,
        _right_envs,
        one_hot_labels,
        sweep_once,
    )

    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    mps = mps_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, normalize=True,
                   act_fn="softmax", loss_fn="full_cross_ent", dtype=dtype, device=device)
    x = torch.as_tensor(rng.random((batch, N)), dtype=dtype, device=device)
    phi = psi_embed(x)
    y = one_hot_labels(torch.as_tensor(rng.integers(0, L, batch), device=device), L, dtype)
    cfg = SweepConfig(act_fn="softmax", loss_fn="full_cross_ent")
    e0 = boundary_vector(M, dtype=dtype, device=device)
    phi_t = phi.transpose(0, 1).contiguous()
    bmat = torch.as_tensor(rng.standard_normal((M * 2, L * 2 * M)), dtype=dtype, device=device)

    # warm-up: kernel builds, allocator, first-call costs
    _device_sync(mps_forward(mps, phi))
    m2, *_ = sweep_once(mps, phi, y, 0.01, 1.0, cfg)
    m3, *_ = sweep_once(m2, phi, y, 0.01, 1.0, cfg)
    _device_sync(m3.sites)
    _device_sync(_right_envs(mps.sites, phi_t, e0))
    _device_sync(truncated_svd_split(bmat, M))

    timer = Timer()
    for _ in range(iters):
        with timer.scope("forward"):
            _device_sync(mps_forward(mps, phi))
        with timer.scope("full_sweep"):
            m2, *_ = sweep_once(mps, phi, y, 0.01, 1.0, cfg)
            _device_sync(m2.sites)
        with timer.scope("env_stack"):
            _device_sync(_right_envs(mps.sites, phi_t, e0))
        with timer.scope("svd_split"):
            _device_sync(truncated_svd_split(bmat, M))
    return timer.summary()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a trace viewable in Perfetto or ``chrome://tracing``.

    Records the host and, where a card is present, its kernels
    (``torch.profiler``), and writes ``trace_<pid>_<ns>.json`` into
    ``log_dir`` on exit. Yields the profiler: its ``key_averages()`` and
    ``events()`` are there after the block, and its ``trace_path`` names
    the file written.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
            if torch.cuda.is_available():  # the block's kernels end inside the trace
                torch.cuda.synchronize()
    finally:
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
