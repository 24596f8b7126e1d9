"""The port's ``utils/profiling.py`` against the JAX package's.

* ``Timer`` fed the same scopes on the same clock gives the JAX ``Timer``'s
  counts, totals, summary and ``report()`` text.
* ``profile_model(device="cpu")`` at tiny sizes returns the JAX table's four
  keys, each timed ``iters`` times.
* ``device_trace`` writes a Chrome trace on the CPU.

JAX is imported inside the tests, so that the test marked ``cuda`` runs on a
machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_profiling.py``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.utils import Timer, device_trace, profile_model

SCOPES = [("forward", 0.0125), ("full_sweep", 1.5), ("forward", 0.0250),
          ("svd_split", 0.002), ("a_name_longer_than_the_column_is", 3.0), ("forward", 0.5)]


def _feed(timer, monkeypatch):
    """Every scope of ``SCOPES`` on a clock that advances by its duration."""
    clock = {"t": 100.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["t"])
    for name, dt in SCOPES:
        with timer.scope(name, sync=torch.zeros(2)):
            clock["t"] += dt
    monkeypatch.undo()
    return timer


def test_timer_is_the_jax_timer(monkeypatch):
    from tensornetworkforml_tpu.utils.profiling import Timer as JaxTimer

    got = _feed(Timer(), monkeypatch)
    want = _feed(JaxTimer(), monkeypatch)
    assert dict(got.counts) == dict(want.counts) == {
        "forward": 3, "full_sweep": 1, "svd_split": 1, "a_name_longer_than_the_column_is": 1}
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    lines = got.report().splitlines()
    assert lines[0] == f"{'op':<28}{'count':>8}{'mean ms':>12}{'total s':>12}"
    assert lines[1].startswith("a_name_longer_than_the_column_is")  # largest total first


def test_timer_scope_counts_a_body_that_raises():
    timer = Timer()
    with pytest.raises(ValueError):
        with timer.scope("x"):
            raise ValueError
    assert timer.counts["x"] == 1 and timer.totals["x"] >= 0.0


def test_profile_model_on_the_cpu():
    from tensornetworkforml_tpu.utils.profiling import profile_model as jax_profile

    got = profile_model(N=6, M=3, L=2, batch=4, iters=3, device="cpu")
    want = jax_profile(N=6, M=3, L=2, batch=4, iters=3)
    assert set(got) == set(want) == {"forward", "full_sweep", "env_stack", "svd_split"}
    for name, s in got.items():
        assert set(s) == set(want[name]) and s["count"] == 3
        assert s["total_s"] > 0 and s["mean_ms"] == pytest.approx(1e3 * s["total_s"] / 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_model(N=6, M=3, iters=1)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    a = torch.ones((64, 64))
    with device_trace(log_dir) as prof:
        (a @ a).sum()
    assert os.path.dirname(prof.trace_path) == log_dir
    assert os.listdir(log_dir) == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.cuda
def test_timer_waits_for_the_card_and_the_trace_holds_the_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain kernel has no CPU mode")
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.models.serving import Predictor

    mps = product_init(torch.Generator().manual_seed(0), N=196, M=128, L=10,
                       act_fn="linear", loss_fn="MSE")
    pred = Predictor(mps, batch_size=256)
    x = torch.as_tensor(np.random.default_rng(0).random((256, 196)), dtype=torch.float32,
                        device="cuda")
    pred.warmup()
    timer = Timer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with timer.scope("serve", sync=x):  # the events inside the scope: it must not read less
        start.record()
        out = pred._chunk_scores(x)
        end.record()
    assert 1e3 * timer.totals["serve"] >= start.elapsed_time(end)
    with device_trace(str(tmp_path)) as prof:
        pred._chunk_scores(x)
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert any("env" in n or "chain" in n for n in names), names
    assert torch.isfinite(out).all()
