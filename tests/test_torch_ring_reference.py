"""The ring (``models/ring.py``) and its trainer (``train/autodiff.py``)
against the plain reference (``models/ring_reference.py``), on the CPU in
float64, at N=12, M=6, D=2, L=3, B=16 on seeded random weights (noise 0.2
around the ring's near-identity init, the label slot's site filled too, so
that every ``l_pos`` sees a full ring).

Tolerances: the scores 1e-10 of the largest (the two contract the ring in
different orders: 12 products of near-identity 6 x 6 matrices round at
~1e-15); the gradients 1e-9 of each tensor's largest entry (prefix and
suffix products against autograd's reverse pass); three Adam steps 1e-8
(Adam's first step divides each gradient by its own size, so relative
rounding stays relative, and grows over the steps).

Also: a step on tensors and on the same batch as numpy arrays gives the same
bits; the trainer's spans and the ring's product counter; the reference
imports only ``torch`` and ``math``.
"""

import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensornetworkforml_torch.models import ring
from tensornetworkforml_torch.models import ring_reference as ref
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.autodiff import AutodiffConfig
from tensornetworkforml_torch.utils import profiling as P
from tensornetworkforml_torch.utils.collectives import trace_events

N, M, L, B = 12, 6, 3, 16
FWD_TOL, GRAD_TOL, ADAM_TOL = 1e-10, 1e-9, 1e-8
F64 = torch.float64


def _ring(seed=0, l_pos=0):
    g = torch.Generator().manual_seed(seed)
    m = ring.ring_product_init(g, N=N, M=M, L=L, noise=0.2, dtype=F64, device="cpu")
    sites = m.sites.clone()
    sites[0] = sites[N // 2] + 0.2 * torch.randn((M, 2, M), generator=g, dtype=F64)
    return m.replace(sites=sites, l_pos=l_pos)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, N), generator=g, dtype=F64), torch.randint(0, L, (B,), generator=g)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("l_pos", range(N))
def test_ring_forward_matches_the_plain_reference(l_pos):
    m = _ring(l_pos=l_pos)
    x, _ = _batch()
    got = ring.ring_forward_arrays(m.sites, m.label_site, psi_embed(x), l_pos)
    want = ref.scores(m.sites, m.label_site, x, l_pos, block=5)
    assert got.shape == want.shape == (L, B) and _rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("l_pos, weight_decay", [(0, 0.0), (7, 1e-3)])
def test_step_zero_gradients_match_the_hand_written_ones(l_pos, weight_decay):
    m = _ring(seed=2, l_pos=l_pos)
    x, y = _batch(seed=3)
    t = ring.ring_trainer(m, AutodiffConfig(weight_decay=weight_decay))
    loss, _ = t.step(x, y)
    want_loss, (g_sites, g_label) = ref.loss_and_grads(m.sites, m.label_site, x, y, l_pos, m.T,
                                                       weight_decay, block=6)
    assert abs(loss - float(want_loss)) <= FWD_TOL * abs(float(want_loss))
    assert _rel(t.params[0].grad, g_sites) <= GRAD_TOL
    assert _rel(t.params[1].grad, g_label) <= GRAD_TOL
    # the label slot's site takes no part in the scores: only the decay moves it
    assert torch.equal(g_sites[l_pos], 2.0 * weight_decay * m.sites[l_pos])


def test_three_adam_steps_match_the_hand_written_adam():
    m = _ring(seed=4)
    batches = [_batch(seed=10 + i) for i in range(3)]
    t = ring.ring_trainer(m, AutodiffConfig(learning_rate=1e-2))
    want = ref.train(m.sites, m.label_site, batches, 0, m.T, 1e-2)
    for (x, y), w in zip(batches, want):
        loss, _ = t.step(x, y)
        assert abs(loss - float(w["loss"])) <= ADAM_TOL * abs(float(w["loss"]))
        assert _rel(t.params[0].detach(), w["sites"]) <= ADAM_TOL
        assert _rel(t.params[1].detach(), w["label"]) <= ADAM_TOL
    assert _rel(want[-1]["sites"], m.sites) > 1e-3  # the steps moved the model


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_step_on_tensors_and_on_numpy_arrays_alike(dtype):
    m = _ring(seed=5)
    m = m.replace(sites=m.sites.to(dtype), label_site=m.label_site.to(dtype))
    batches = [_batch(seed=20 + i) for i in range(2)]
    on_tensors, on_arrays = (ring.ring_trainer(m) for _ in range(2))
    for x, y in batches:
        assert on_tensors.step(x, y) == on_arrays.step(x.numpy(), y.numpy())
    for a, b in zip(on_tensors.params, on_arrays.params):
        assert a.dtype == dtype and torch.equal(a, b)


def _spans(run) -> dict:
    """The port's ranges recorded while ``run()`` runs under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = {}
    for e in trace_events(prof):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith("tnml::"):
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def test_step_spans_and_the_product_counter(monkeypatch):
    x, y = _batch()
    t = ring.ring_trainer(_ring())
    before = ring.ring_forward_arrays.products
    got = _spans(lambda: [t.step(x, y) for _ in range(2)])
    assert ring.ring_forward_arrays.products - before == 2 * (N - 1)
    inner = (P.AUTODIFF_FORWARD, P.AUTODIFF_BACKWARD, P.AUTODIFF_OPTIMIZER)
    assert {k: len(v) for k, v in got.items()} == {P.AUTODIFF_STEP: 2, **{k: 2 for k in inner}}
    eps = 0.01  # microseconds: the trace's times are rounded to nanoseconds
    for i, (a, b) in enumerate(got[P.AUTODIFF_STEP]):
        parts = [got[k][i] for k in inner]  # forward, backward, optimiser: in turn, inside
        assert all(a - eps <= s <= e <= b + eps for s, e in parts)
        assert all(p[1] <= q[0] + eps for p, q in zip(parts, parts[1:]))

    # without a profiler: no range is entered; the counter still counts
    real, names = torch.profiler.record_function, []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a, **k: names.append(name) or real(name, *a, **k))
    before = ring.ring_forward_arrays.products
    t.step(x, y)
    assert names == [] and ring.ring_forward_arrays.products - before == N - 1


def test_the_reference_imports_only_torch_and_math(monkeypatch):
    tops = set()
    for node in ast.walk(ast.parse(Path(ref.__file__).read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops == {"torch", "math"}
    # TF32 off for both backends while it computes, put back after
    seen = []
    real = ref._scores
    monkeypatch.setattr(ref, "_scores", lambda *a: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)) or real(*a))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    m = _ring()
    ref.scores(m.sites, m.label_site, _batch()[0], 0)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
