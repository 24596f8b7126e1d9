"""The ring's pieces of the benchmark: its frozen reference
(``reference/ring.py``) against the port's plain reference
(``models/ring_reference.py``) and against the program at the rehearsal size,
on the CPU in float64; the ring's work counts pinned at the cell's shape;
the two readers on synthetic views whose launches run exactly at their
bound; and the cell's entries in ``BENCHMARK.json``. The shared tests drive
the cell through the harness at its rehearsal size (a run, each fault, the
control and the spans), as they drive every cell."""

import pytest
import torch

from tnbench import autodiff, gen, ring_work, roofline, run
from tnbench.reference import ring as bench_ref
from tnbench.run import metric_reader
from tnbench.trace import TraceView
from tnbench.tests import cells

F64 = torch.float64
CELL = "ring128-train-adam"
SEED = 2 ** 32 + 11
BENCH = cells.BENCH


def _small():
    """The cell at its rehearsal size: weights from the generator's copy of
    ``ring_product_init`` (the label slot filled, so that every ``l_pos``
    sees a full ring), two batches and their labels, in float64."""
    c = cells.small(CELL, BENCH)
    cfg, tr = c["config"], c["traffic"]
    g = gen.generator(SEED, torch.device("cpu"))
    cal, _ = gen.images(g, tr["calibration_rows"], cfg)
    sites, label = autodiff.ring_weights(g, cfg, cal, noise=0.2)
    sites[0] = sites[1]
    x, y = gen.images(g, 2 * tr["batch"], cfg)
    return cfg, sites.to(F64), label.to(F64), x.to(F64), y


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("l_pos", [0, 5])
def test_frozen_reference_is_the_ports_plain_reference(l_pos):
    from tensornetworkforml_torch.models import ring_reference as port_ref

    cfg, sites, label, x, y = _small()
    B = len(y) // 2
    batches = [(x[:B], y[:B]), (x[B:], y[B:])]
    assert torch.equal(bench_ref.scores(sites, label, x, l_pos, block=7),
                       port_ref.scores(sites, label, x, l_pos, block=7))
    got = bench_ref.train(sites, label, batches, l_pos, cfg["T"], 1e-2, 1e-3, block=5)
    want = port_ref.train(sites, label, batches, l_pos, cfg["T"], 1e-2, 1e-3, block=5)
    for a, b in zip(got, want):
        assert torch.equal(a["loss"], b["loss"])
        assert all(torch.equal(p, q) for p, q in zip(a["grads"], b["grads"]))
        assert torch.equal(a["sites"], b["sites"]) and torch.equal(a["label"], b["label"])


def test_frozen_reference_holds_the_program():
    from tensornetworkforml_torch.models.mps import MPS
    from tensornetworkforml_torch.models.ring import ring_forward_arrays, ring_trainer
    from tensornetworkforml_torch.ops.embedding import psi_embed
    from tensornetworkforml_torch.train.autodiff import AutodiffConfig

    cfg, sites, label, x, y = _small()
    f = ring_forward_arrays(sites, label, psi_embed(x), 0)
    assert _rel(f, bench_ref.scores(sites, label, x, 0, block=9)) <= 1e-10
    t = ring_trainer(MPS(sites, label, l_pos=0, act_fn="softmax", loss_fn="cross_entropy",
                         T=cfg["T"]), AutodiffConfig())
    loss, _ = t.step(x, y)
    want, grads = bench_ref.loss_and_grads(sites, label, x, y, 0, cfg["T"], block=9)
    assert abs(loss - float(want)) <= 1e-10 * abs(float(want))
    assert all(_rel(p.grad, g) <= 1e-9 for p, g in zip(t.params, grads))


def test_the_cell_reads_its_own_size():
    c = run.load_cell(BENCH, CELL)
    cfg, tr = c["config"], c["traffic"]
    assert (cfg["N"], cfg["M"], cfg["D"], cfg["L"]) == (196, 128, 2, 10)
    assert cfg["N"] == (cfg["image_side"] // cfg["pool"]) ** 2
    assert tr["batch"] == 256 and "batch" not in cfg["assumed"]


def test_work_counts_pinned():
    N, M, D, L, B = 196, 128, 2, 10, 256
    # the forward's 195 batched products: 195 x 256 x 2 x 128^3
    assert ring_work.product(B, M)[0] * (N - 1) == pytest.approx(2.094e11, rel=1e-3)
    assert ring_work.forward_flops(N, M, D, L, B) == pytest.approx(2.128e11, rel=1e-3)
    assert ring_work.step_flops(N, M, D, L, B) == pytest.approx(6.341e11, rel=1e-3)
    # a product reads two (256, 128, 128) float32 operands and writes one:
    # 50.3 MB, 15.0 us at 3.35 TB/s, above its 6.5 us of operations
    t, which = roofline.bound(*ring_work.product(B, M))
    assert which == "bytes" and t == pytest.approx(1.5024e-5, rel=1e-3)
    assert ring_work.step_bound_s(N, M, D, L, B) == pytest.approx(1.0774e-2, rel=1e-3)


RING = {"N": 196, "D": 2, "M": 128, "L": 10}
TRAFFIC = {"batch": 256, "steps_per_call": 2}
# kernel names from a traced window of the cell on the H100
GEMMS = {"product": "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3_warpsize2x2x1_"
                    "ffma_aligna4_alignc4_execute_kernel__5x_cublas",
         "site": "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x64x8_stage3_warpsize1x2x1_"
                 "ffma_aligna4_alignc4_execute_kernel__5x_cublas",
         "closure": "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>("
                    "cutlass_80_simt_sgemm_128x32_8x5_nn_align1::Params)"}


def _steps_at_bound(n_steps, slow=1.0, gap_us=0.0):
    """``n_steps`` steps of the ring's contractions, each launch taking
    ``slow`` times its bound, back to back, with ``gap_us`` of idle and an
    elementwise kernel (not a contraction) between steps."""
    kinds = dict(zip(("product", "site", "closure"),
                     ring_work.step_launches(196, 128, 2, 10, 256)))
    device, t = [], 0.0
    for _ in range(n_steps):
        for kind, (work, count) in kinds.items():
            dur = slow * roofline.bound(*work)[0] * 1e6
            for _ in range(count):
                device.append((GEMMS[kind], "kernel", t, t + dur))
                t += dur
        device.append(("void at::native::vectorized_elementwise_kernel<4>", "kernel", t,
                       t + 50.0))
        t += 50.0 + gap_us
    return device, t


def test_ring_gemm_share_at_most_100():
    device, end = _steps_at_bound(3)
    view = TraceView(device=device, spans=[(0.0, end)], counts={"calls": 1, "steps": 3},
                     config=RING, traffic=TRAFFIC)
    assert metric_reader("ring_gemm_roofline")(view) == pytest.approx(100.0, rel=1e-9)
    view.device, view.spans = _steps_at_bound(3, slow=2.0, gap_us=100.0)[0], [(0.0, 4 * end)]
    assert metric_reader("ring_gemm_roofline")(view) == pytest.approx(50.0, rel=1e-9)
    view.device = [e for e in view.device if "gemm" not in e[0] and "gemv" not in e[0]]
    assert metric_reader("ring_gemm_roofline")(view) is None


def test_ring_mfu_at_most_100():
    flops = 4 * ring_work.step_flops(196, 128, 2, 10, 256)
    window_us = flops / roofline.PEAK_FLOPS * 1e6
    view = TraceView(device=[("k", "kernel", 0.0, window_us)], spans=[(0.0, window_us)],
                     counts={"calls": 2, "steps": 4}, config=RING, traffic=TRAFFIC)
    assert metric_reader("mfu.ring")(view) == pytest.approx(100.0, rel=1e-9)
    view.spans = [(0.0, 4 * window_us)]
    assert metric_reader("mfu.ring")(view) == pytest.approx(25.0, rel=1e-9)
    view.counts = {}
    assert metric_reader("mfu.ring")(view) is None


def test_the_cells_entries_keep_the_rules():
    assert [m["name"] for m in run.per_layer_for(BENCH, CELL)] == [
        "idle_share.train", "mfu.ring", "ring_gemm_roofline"]
    for m in run.per_layer_for(BENCH, CELL):
        assert (run.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert {m["name"] for m in BENCH["end_to_end"] if run.reports(m, CELL)} == {
        "train_samples_per_s", "setup_s"}
