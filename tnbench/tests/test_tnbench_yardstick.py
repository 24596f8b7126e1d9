"""The frozen yardstick: the work counts at the shapes of ``chip_smoke.py``'s
printed rows, the peaks, and shares that stay at or under 100% on a
synthetic trace whose kernels run exactly at their bound."""

import math

import pytest

from tnbench import roofline
from tnbench.run import metric_reader
from tnbench.trace import TraceView


@pytest.mark.parametrize("work, expected", [
    (roofline.chain_work(195, 128, 8192)[0], 1.05e11),
    (roofline.polar_work(256, 128, 5, 14)[0], 3.05e8),
    (roofline.presplit_work(10, 256, 128, 256, 256, 128)[0], 1.18e9),
    (roofline.presplit_work(10, 512, 256, 512, 256, 256)[0], 6.71e9),
    (roofline.rf_work(256, 2560, 136, 128)[0], 7.3e8),
])
def test_work_counts_pinned(work, expected):
    assert work == pytest.approx(expected, rel=5e-3)


def test_peaks():
    assert roofline.PEAK_FLOPS == pytest.approx(165e12)
    assert roofline.PEAK_BYTES == pytest.approx(3.35e12)
    # K3 at the bulk shape is bound by its operations: 0.634 ms
    t, which = roofline.bound(*roofline.chain_work(195, 128, 8192))
    assert which == "operations" and t == pytest.approx(6.345e-4, rel=1e-3)


M128 = {"N": 196, "D": 2, "M": 128, "L": 10}
SERVE = {"batch_size": 8192, "rows": 8192}
TRAIN = {"batch": 256, "batches_per_epoch": 2, "sweep": {"svd_method": "polar"}}
TRAIN_RF = {"batch": 256, "batches_per_epoch": 2, "sweep": {"svd_method": "rangefinder"}}


def _kernels_at_bound(names_and_work, n_calls, gap_us=0.0):
    """A timeline of ``n_calls`` calls, each launch of a call taking its share
    of the call's bound, back to back (plus ``gap_us`` of idle a call)."""
    device, t = [], 0.0
    for _ in range(n_calls):
        for name, work, parts in names_and_work:
            dur = roofline.bound(*work)[0] * 1e6 / parts
            device.append((name, "kernel", t, t + dur))
            t += dur
        t += gap_us
    return device, t


@pytest.mark.parametrize("metric, config, traffic, kernels, counts", [
    ("k3_roofline", M128, SERVE,
     [("void (anonymous namespace)::chain_kernel<Throughput>(Args, Plan)",
       roofline.chain_work(195, 128, 8192), 1)], {"requests": 4, "samples": 4 * 8192}),
    ("k1_roofline", M128, TRAIN,
     [("(anonymous namespace)::polar::polar_cluster_kernel(float const*)",
       roofline.polar_work(256, 128), 1)], {"sweeps": 2, "samples": 512}),
    ("k2_roofline", M128, TRAIN,
     [(f"(anonymous namespace)::presplit::{k}_kernel(Args)",
       roofline.presplit_work(10, 256, 128, 256, 256, 128), 6)
      for k in ("prep", "gradient", "update", "transpose", "products", "finish")],
     {"sweeps": 2, "samples": 512}),
    ("k6_roofline", M128, TRAIN_RF,
     [(f"(anonymous namespace)::{k}(Args)", roofline.rf_work(256, 2560, 136, 128), 4)
      for k in ("sketch_tile_kernel", "rf_finish_kernel", "rf_cluster_kernel", "rf_r_kernel")],
     {"sweeps": 2, "samples": 512}),
])
def test_kernel_shares_at_most_100(metric, config, traffic, kernels, counts):
    device, end = _kernels_at_bound(kernels, 5)
    view = TraceView(device=device, spans=[(0.0, end)], counts=counts, config=config,
                     traffic=traffic)
    share = metric_reader(metric)(view)
    assert share == pytest.approx(100.0, rel=1e-9)
    slower, end = _kernels_at_bound(kernels, 5, gap_us=3.0)
    view.device = [(n, c, a, a + 2 * (b - a)) for n, c, a, b in slower]
    assert metric_reader(metric)(view) == pytest.approx(50.0, rel=1e-9)


@pytest.mark.parametrize("metric, config, traffic, counts, work", [
    ("mfu.serve", M128, SERVE, {"requests": 3, "samples": 3 * 8192},
     3 * 8192 * roofline.sample_flops(196, 128, 2, 10)),
    ("mfu.train", M128, TRAIN, {"sweeps": 4, "samples": 1024},
     4 * roofline.sweep_flops(196, 128, 2, 10, 256, "polar")),
    ("mfu.train", M128, TRAIN_RF, {"sweeps": 4, "samples": 1024},
     4 * roofline.sweep_flops(196, 128, 2, 10, 256, "rangefinder")),
])
def test_mfu_at_most_100(metric, config, traffic, counts, work):
    # the shortest window the work could take at the peak reads 100%
    window_us = work / roofline.PEAK_FLOPS * 1e6
    view = TraceView(device=[("k", "kernel", 0.0, window_us)], spans=[(0.0, window_us)],
                     counts=counts, config=config, traffic=traffic)
    assert metric_reader(metric)(view) == pytest.approx(100.0, rel=1e-9)
    view.spans = [(0.0, 4 * window_us)]
    assert metric_reader(metric)(view) == pytest.approx(25.0, rel=1e-9)


@pytest.mark.parametrize("metric", ["idle_share.serve", "idle_share.train"])
def test_idle_share_between_0_and_100(metric):
    device = [("a", "kernel", 0.0, 40.0), ("b", "gpu_memcpy", 30.0, 50.0),
              ("c", "kernel", 80.0, 100.0)]
    view = TraceView(device=device, spans=[(0.0, 60.0), (60.0, 100.0)])
    assert metric_reader(metric)(view) == pytest.approx(30.0)
    view.device = [("a", "kernel", 0.0, 100.0), ("b", "kernel", 0.0, 100.0)]
    assert metric_reader(metric)(view) == pytest.approx(0.0)


def test_readers_return_nothing_without_their_kernels():
    view = TraceView(device=[("other", "kernel", 0.0, 5.0)], spans=[(0.0, 10.0)],
                     counts={"requests": 1, "samples": 8192, "sweeps": 2},
                     config=M128, traffic={**SERVE, **TRAIN})
    for name in ("k3_roofline", "k1_roofline", "k2_roofline", "k6_roofline", "h2d_ms.serve"):
        assert metric_reader(name)(view) is None
    assert not math.isnan(metric_reader("mfu.train")(view))
