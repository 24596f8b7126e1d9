"""The general generator of autodiff training traffic (``"kind":
"autodiff"``; the protocol is in ``run.py``): the ring MPS trained by full
gradients, ``models/ring.py::ring_trainer`` -> ``train/autodiff.py::
AutodiffTrainer.step``.

Set-up makes the weights (a frozen device copy of ``ring_product_init``,
its calibration included) and a pool of ``pool_batches`` distinct batches of
``batch`` images on the device, builds one trainer and drives it through its
first ``checked_calls`` calls of the window's own call, on batches that all
differ. A call is ``steps_per_call`` optimiser steps (``AutodiffTrainer.
step`` on tensors already on the device, inside the configuration's
``matmul_precision``), cycling through the pool, and ends in
``torch.cuda.synchronize()``. The window carries the same trainer on, call
after call.

After the window the plain reference (``reference/ring.py``, float64, in
blocks of ``REF_BLOCK`` rows) runs the checked steps by itself from the same
weights and batches, and the program's outputs of those steps are held
against it: step 0's gradients, the loss of the first ``steady_steps``
steps (Adam's first updates are close to ``lr sign(g)``, which rounding can
flip where a gradient entry is near zero, so the losses are compared and not
the entries), and the scores of the model after the first checked call on
fresh images (after that, Adam's sign-like steps carry the float32 run and
the float64 reference further apart with each call, so the later calls'
scores are reported and not limited). ``window_nonfinite`` makes a
model that leaves the window with a NaN or an infinity not correct.

The control is the program's own TF32 path (``matmul_precision=
"tensorfloat32"``, which reaches every product of the ring's forward and
backward) on the card, and the reference in float32 with TF32-rounded
products in the program's place on the CPU, which has no TF32. The faults:
the optimiser's step skipped (``unchanged``), each batch's first half fed
twice (``half_batch``), the product started from ``e0 e0^T`` in place of the
identity, so that the trace loses its periodic bond (``open_chain``), and
the window's steps leaving a NaN in the model (``window_nan``).
"""

from __future__ import annotations

import functools
import math

import torch

from tnbench import gen
from tnbench.reference import ring as ref
from tnbench.trace import Tracer, measure

ENTRY = ("tensornetworkforml_torch.train.autodiff", "AutodiffTrainer.step")
MAKE_OPTIMIZER = ("tensornetworkforml_torch.train.autodiff", "make_optimizer")
FORWARD = ("tensornetworkforml_torch.models.ring", "ring_forward_arrays")
# the program's spans (tensornetworkforml_torch/utils/profiling.py), frozen here
STEP, FORWARD_SPAN, BACKWARD_SPAN, OPTIMIZER_SPAN = (
    "tnml::autodiff.step", "tnml::autodiff.forward", "tnml::autodiff.backward",
    "tnml::autodiff.optimizer")
REF_BLOCK = 256  # rows a block of the reference on the card: ~13 GB of float64 products


def ring_weights(g: torch.Generator, cfg: dict, calibration_x: torch.Tensor,
                 noise: float = 1e-2):
    """``(sites (N, M, D, M), label (M, D, L, M))`` in float32 on the
    generator's device, as ``models/ring.py::ring_product_init`` makes them
    from a calibration batch: near-identity cores scaled by ``1 / (c_n
    M^(1/N))``, ``c_n`` the batch's mean ``sum_d psi_d`` at site ``n``, so
    that the traced product is O(1), plus Gaussian noise (the sites' drawn
    first, then the label core's); the label slot ``sites[0]`` zero."""
    dev = g.device
    N, M, D, L = cfg["N"], cfg["M"], cfg["D"], cfg["L"]
    f32 = torch.float32
    x = calibration_x.to(f32)
    c = torch.clamp((torch.sin(math.pi * x / 2) + torch.cos(math.pi * x / 2)).mean(dim=0),
                    min=1e-3)
    base = 1.0 / c / (M ** (1.0 / N))
    eye = torch.eye(M, dtype=f32, device=dev)
    sites = base[:, None, None, None] * eye[:, None, :].expand(M, D, M)[None]
    sites = sites + noise * torch.randn((N, M, D, M), generator=g, dtype=f32, device=dev)
    sites[0] = 0.0
    label = base[0] * eye[:, None, None, :].expand(M, D, L, M)
    label = label + noise * torch.randn((M, D, L, M), generator=g, dtype=f32, device=dev)
    return sites.contiguous(), label.contiguous()


def _batch_index(tr: dict, step: int) -> int:
    return step % tr["pool_batches"]


def _call(state: dict, tr: dict, i: int, after_step=None) -> list:
    """Call ``i``: its ``steps_per_call`` optimiser steps; their losses."""
    from tensornetworkforml_torch.utils.precision import matmul_precision

    trainer, losses = state["trainer"], []
    with matmul_precision(state["precision"]):
        for j in range(tr["steps_per_call"]):
            k = _batch_index(tr, i * tr["steps_per_call"] + j)
            losses.append(trainer.step(state["x"][k], state["y"][k])[0])
            if after_step is not None:
                after_step(i * tr["steps_per_call"] + j)
    if state["x"].device.type == "cuda":
        torch.cuda.synchronize(state["x"].device)
    return losses


def setup(cfg: dict, tr: dict, seed: int, device, precision: str = None):
    """Weights, batches and fresh images from ``seed``; one trainer driven
    through the checked calls (which also build and warm everything the
    window runs). ``precision`` replaces the configuration's
    ``matmul_precision`` (the control)."""
    from tensornetworkforml_torch.models.mps import MPS
    from tensornetworkforml_torch.models.ring import ring_trainer
    from tensornetworkforml_torch.train.autodiff import AutodiffConfig

    if cfg["topology"] != "ring":
        raise ValueError(f"the autodiff generator trains the ring, not {cfg['topology']!r}")
    n_checked = tr["checked_calls"] * tr["steps_per_call"]
    if n_checked > tr["pool_batches"] or tr["steady_steps"] > n_checked:
        raise ValueError("the checked steps must take distinct batches and hold the steady ones")
    g = gen.generator(seed, device)
    cal_x, _ = gen.images(g, tr["calibration_rows"], cfg)
    sites, label = ring_weights(g, cfg, cal_x)
    B, P = tr["batch"], tr["pool_batches"]
    x, y = gen.images(g, P * B, cfg)
    fresh, _ = gen.images(g, tr["fresh_rows"], cfg)
    model = MPS(sites.clone(), label.clone(), l_pos=cfg["l_pos"], act_fn=cfg["act_fn"],
                loss_fn=cfg["loss_fn"], T=cfg["T"])
    state = {"weights": (sites, label), "x": x.reshape(P, B, -1), "y": y.reshape(P, B),
             "fresh": fresh, "precision": precision or cfg["matmul_precision"],
             "trainer": ring_trainer(model, AutodiffConfig(**tr["trainer"]))}
    params = state["trainer"].params
    grads = []

    def keep_step0_grads(step):
        if step == 0:
            grads.extend(p.grad.detach().clone() for p in params)

    checked = {"losses": [], "params": []}
    for i in range(tr["checked_calls"]):
        checked["losses"] += _call(state, tr, i, keep_step0_grads)
        checked["params"].append(tuple(p.detach().clone() for p in params))
    checked["grads"] = tuple(grads)
    state["checked"] = checked
    return state


def window(state: dict, tr: dict, seconds: float, tracer) -> dict:
    """Calls back to back for ``seconds`` (``trace.measure``), the trainer
    carried from one to the next, each ending in a synchronisation."""
    done, _, window_s = measure(lambda i: _call(state, tr, tr["checked_calls"] + i), seconds,
                                tracer, tr)
    nonfinite = sum(int((~torch.isfinite(p)).sum()) for p in state["trainer"].params)
    return {"calls": len(done), "window_s": window_s, "nonfinite": nonfinite}


def free(state: dict) -> None:
    state.pop("trainer", None)


def reference_steps(state: dict, cfg: dict, tr: dict, low: bool = False) -> dict:
    """The reference's checked steps, in the form of ``state["checked"]``:
    float64, or float32 with TF32-rounded products when ``low``."""
    n = tr["checked_calls"] * tr["steps_per_call"]
    batches = [(state["x"][_batch_index(tr, s)], state["y"][_batch_index(tr, s)])
               for s in range(n)]
    t = tr["trainer"]
    if t["loss"] != "softmax_xent" or t["optimizer"] != "adam":
        raise ValueError("the ring's reference trains softmax cross-entropy with Adam")
    steps = ref.train(*state["weights"], batches, cfg["l_pos"], cfg["T"], t["learning_rate"],
                      t["weight_decay"], dtype=torch.float32 if low else torch.float64,
                      block=REF_BLOCK, low=low)
    k = tr["steps_per_call"]
    return {"losses": [float(s["loss"]) for s in steps], "grads": steps[0]["grads"],
            "params": [(s["sites"], s["label"]) for s in steps[k - 1::k]]}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.to(want.dtype) - want).abs().max() / want.abs().max())


def check(state: dict, win: dict, cfg: dict, tr: dict, device, outs=None) -> dict:
    """The numbers that decide ``correct`` (those the cell's limits name),
    from the checked calls:

    * ``grad_gap``: step 0's gradients against the reference's, the widest
      gap of each tensor's entries relative to its largest entry (the larger
      of the two tensors);
    * ``first_steps_gap``: the widest relative gap of the loss of the first
      ``steady_steps`` steps (the forward before any update, then after the
      first updates);
    * ``loss_gap``: the same over every checked step (not limited);
    * ``score_gap``: the widest gap of the scores of the model after the
      first checked call on fresh images, relative to the largest change the
      reference's steps made to those scores (a model left unchanged
      reads 1);
    * ``late_score_gap``: the same after each later checked call (not
      limited: where a gradient entry is near zero, rounding flips the sign
      of Adam's first steps, and the gap grows from call to call);
    * ``window_nonfinite``: the entries of the model that are not finite
      when the window closes (``win``; none without a window).

    ``outs`` replaces the program's checked steps."""
    prog = state["checked"] if outs is None else outs
    want = reference_steps(state, cfg, tr)
    l_pos, fresh = cfg["l_pos"], state["fresh"]

    def scores(sites, label):
        return ref.scores(sites, label, fresh, l_pos, block=REF_BLOCK)

    f0 = scores(*state["weights"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"], strict=True)]
    k = tr["steps_per_call"]
    items = []
    for c, (p, r) in enumerate(zip(prog["params"], want["params"], strict=True)):
        fr = scores(*r)
        items.append({"loss_gap": max(gaps[c * k:(c + 1) * k]),
                      "score_gap": float((scores(*p) - fr).abs().max() / (fr - f0).abs().max())})
    items[0]["grad_gap"] = max(_rel(a, b) for a, b in zip(prog["grads"], want["grads"],
                                                          strict=True))
    items[0]["first_steps_gap"] = max(gaps[:tr["steady_steps"]])
    items.append({"window_nonfinite": float(win["nonfinite"]) if win else 0.0})
    nums = {"grad_gap": items[0]["grad_gap"], "first_steps_gap": items[0]["first_steps_gap"],
            "loss_gap": max(gaps),
            "score_gap": items[0]["score_gap"],
            "late_score_gap": max((it["score_gap"] for it in items[1:-1]), default=0.0),
            "window_nonfinite": items[-1]["window_nonfinite"]}
    return {"numbers": {k: (v if v == v else float("inf")) for k, v in nums.items()},
            "items": items, "profile": gaps}


def end_to_end(win: dict, tr: dict, setup_s: float) -> dict:
    samples = win["calls"] * tr["steps_per_call"] * tr["batch"]
    return {
        "train_samples_per_s": {"value": samples / win["window_s"], "unit": "samples/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def counts(view, tr: dict) -> dict:
    n = len(view.spans)
    steps = n * tr["steps_per_call"]
    return {"calls": n, "steps": steps, "samples": steps * tr["batch"]}


def attempted(win: dict) -> int:
    return win["calls"]


def small(cfg: dict, tr: dict):
    """The CPU rehearsal's size."""
    return ({**cfg, "N": 16, "M": 6, "image_side": 8},
            {**tr, "batch": 16, "fresh_rows": 48, "trace_from": 0.0})


def control(cfg: dict, tr: dict, seed: int, device, seconds: float) -> dict:
    """Set-up, a window and the check with the control in the program's
    place: the program's TF32 path on the card; the reference's checked
    steps in float32 with TF32-rounded products on the CPU, which has no
    TF32."""
    own = device.type == "cuda"
    state = setup(cfg, tr, seed, device, precision="tensorfloat32" if own else None)
    win = window(state, tr, seconds, Tracer(False, device))
    free(state)
    outs = None if own else reference_steps(state, cfg, tr, low=True)
    return check(state, win, cfg, tr, device, outs=outs)


def _unchanged(make_optimizer):
    """``make_optimizer`` whose optimiser's step does nothing."""
    def faulty(*args, **kwargs):
        opt = make_optimizer(*args, **kwargs)
        opt.step = lambda *a, **k: None
        return opt
    return faulty


def _half_batch(step):
    """``AutodiffTrainer.step`` fed each batch's first half twice."""
    def faulty(self, x, y):
        h = len(y) // 2
        return step(self, torch.cat([x[:h]] * 2), torch.cat([y[:h]] * 2))
    return faulty


def _open_chain(forward):
    """``ring_forward_arrays`` with the first site after the label cut to
    its first row: the product starts from ``e0 e0^T`` in place of the
    identity, ``f = (A ... Lab)[0, 0]``, the open chain's boundary in place
    of the trace. It carries the forward's attributes (its counter), which
    the forward updates through its module's name."""
    @functools.wraps(forward)
    def faulty(sites, label_site, phi, l_pos):
        keep = torch.ones((sites.shape[0], sites.shape[1], 1, 1), dtype=sites.dtype,
                          device=sites.device)
        keep[(l_pos + 1) % sites.shape[0], 1:] = 0.0
        return forward(sites * keep, label_site, phi, l_pos)
    return faulty


def _window_nan(checked_steps: int):
    """``AutodiffTrainer.step`` sound through the checked steps, then
    leaving a NaN in the label core."""
    def wrap(step):
        calls = []

        def faulty(self, x, y):
            out = step(self, x, y)
            calls.append(1)
            if len(calls) > checked_steps:
                with torch.no_grad():
                    self.params[1][0, 0, 0, 0] = float("nan")
            return out
        return faulty
    return wrap


def faults(tr: dict) -> dict:
    return {"unchanged": (MAKE_OPTIMIZER, _unchanged), "half_batch": (ENTRY, _half_batch),
            "open_chain": (FORWARD, _open_chain),
            "window_nan": (ENTRY, _window_nan(tr["checked_calls"] * tr["steps_per_call"]))}


def span_counts(view, cfg: dict, tr: dict) -> dict:
    """A step span a step, each holding one forward, backward and optimiser
    span."""
    steps = len(view.spans) * tr["steps_per_call"]
    return {STEP: steps, FORWARD_SPAN: steps, BACKWARD_SPAN: steps, OPTIMIZER_SPAN: steps}
