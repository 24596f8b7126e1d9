"""The general generator of training traffic (``"kind": "train"``; the
protocol is in ``run.py``).

Set-up makes the weights and a pool of ``pool_batches`` distinct batches of
``batch`` images on the device, builds one model and drives it through its
first ``checked_epochs`` epochs by the window's own call,
``fused_epoch(model, x_epoch, y_epoch, lr, weight_decay, cfg)``, on batches
that all differ. The window carries that same model on, epoch after epoch,
cycling through the pool (epoch ``e`` takes batches ``2e, 2e + 1`` modulo the
pool), each epoch ending in ``torch.cuda.synchronize()``.

After the window the plain reference runs the checked epochs by itself in
float64 from the same weights and batches, and the program's outputs of
those epochs are held against it: the MAE of every step's output (the loss
each step sees), tightly over the first steps, and the scores of the model
after each epoch on fresh images. Two numbers need no reference: how far the
program's sites after each checked epoch are from isometries (the split's
output on every step of the epoch's last sweep), and whether the model left
the window finite (``check``). The traffic's ``sweep`` names the split the
reference runs (``svd_method``, a key of ``reference.mps.SPLITS``).

The control is the program's own TF32 path (``matmul_precision=
"tensorfloat32"``) on the card, and the reference in float32 with
TF32-rounded products in the program's place where the program has no such
path: on the CPU, and in the fused engine, where the TF32 scope reaches only
the prologue's closure and none of K7's arithmetic. The
faults: each batch's first half fed twice (``half_batch``), every epoch
returning the model it was given (``unchanged``), the window's epochs
leaving a NaN in the model (``window_nan``), and, where the hybrid engine
runs the polar split through ``polar_iterate`` (K1), its final schedule cut
by two passes (``k1_pass_cut``).
"""

from __future__ import annotations

import torch

from tnbench import gen, spans
from tnbench.reference import mps as ref
from tnbench.trace import Tracer, measure

ENTRY = ("tensornetworkforml_torch.train.epoch", "fused_epoch")
POLAR_ITERATE = ("tensornetworkforml_torch.train.sweep", "polar_iterate")


def sweep_config(cfg: dict, tr: dict, precision: str = None):
    from tensornetworkforml_torch.train.sweep import SweepConfig

    return SweepConfig(act_fn=cfg["act_fn"], loss_fn=cfg["loss_fn"],
                       matmul_precision=precision or cfg["matmul_precision"], **tr["sweep"])


def _epoch_batches(state: dict, tr: dict, e: int):
    k = tr["batches_per_epoch"]
    idx = [(e * k + j) % tr["pool_batches"] for j in range(k)]
    return state["x"][idx], state["y"][idx]


def setup(cfg: dict, tr: dict, seed: int, device, precision: str = None):
    """Weights, batches and fresh images from ``seed``; one model driven
    through the checked epochs (which also build and warm every kernel the
    window runs). ``precision`` replaces the configuration's
    ``matmul_precision`` (the control)."""
    import importlib

    from tensornetworkforml_torch.models.mps import MPS

    if tr["checked_epochs"] * tr["batches_per_epoch"] > tr["pool_batches"]:
        raise ValueError("the checked epochs must take distinct batches")
    fused_epoch = getattr(importlib.import_module(ENTRY[0]), ENTRY[1])
    g = gen.generator(seed, device)
    cal_x, _ = gen.images(g, tr["calibration_rows"], cfg)
    sites, label = gen.product_weights(g, cfg, cal_x)
    B, P = tr["batch"], tr["pool_batches"]
    x, y = gen.images(g, P * B, cfg)
    fresh, _ = gen.images(g, tr["fresh_rows"], cfg)
    state = {"weights": (sites, label), "x": x.reshape(P, B, -1), "y": y.reshape(P, B),
             "fresh": fresh, "fused_epoch": fused_epoch,
             "sweep": sweep_config(cfg, tr, precision)}
    model = MPS(sites.clone(), label.clone(), l_pos=0, act_fn=cfg["act_fn"],
                loss_fn=cfg["loss_fn"])
    checked = []
    for e in range(tr["checked_epochs"]):
        xe, ye = _epoch_batches(state, tr, e)
        model, _, metrics = fused_epoch(model, xe, ye, tr["lr"], tr["weight_decay"],
                                        state["sweep"])
        checked.append({"sites": model.sites.clone(), "label": model.label_site.clone(),
                        "mae": metrics["MAE"].clone()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state["model"], state["checked"] = model, checked
    return state


def window(state: dict, tr: dict, seconds: float, tracer) -> dict:
    """Epochs back to back for ``seconds`` (``trace.measure``), the model
    carried from one to the next, each ending in a synchronisation."""
    dev = state["model"].device

    def epoch(i):
        xe, ye = _epoch_batches(state, tr, tr["checked_epochs"] + i)
        state["model"], _, _ = state["fused_epoch"](state["model"], xe, ye, tr["lr"],
                                                    tr["weight_decay"], state["sweep"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    done, _, window_s = measure(epoch, seconds, tracer, tr)
    m = state["model"]
    nonfinite = (~torch.isfinite(m.sites)).sum() + (~torch.isfinite(m.label_site)).sum()
    return {"epochs": len(done), "window_s": window_s, "nonfinite": int(nonfinite)}


def free(state: dict) -> None:
    state.pop("model", None)


def isometry_gaps(sites: torch.Tensor) -> torch.Tensor:
    """How far each non-label site ``A = sites[n] (M, D M)``, n >= 1, is from
    a partial isometry: the widest entry of ``G G - G``, ``G = A A^T``, in
    float64. After an epoch, whose last sweep runs from site N - 1 back to
    the label at site 0, each is the split's factor ``Q^T`` of one step of
    that sweep, whose Gram ``Q^T Q`` is the identity on its live columns and
    zero on the columns the split left dead."""
    a = sites[1:].to(torch.float64)
    a = a.reshape(a.shape[0], a.shape[1], -1)
    g = a @ a.transpose(1, 2)
    return (g @ g - g).abs().amax(dim=(1, 2))


def reference_epochs(state: dict, tr: dict, low: bool = False):
    """The reference's checked epochs: per epoch ``(sites, label, MAE)``,
    float64, or float32 with TF32 products when ``low``."""
    sites, label = state["weights"]
    split = state["sweep"].svd_method  # a key of reference.mps.SPLITS
    dtype = torch.float32 if low else torch.float64
    out = []
    for e in range(tr["checked_epochs"]):
        xe, ye = _epoch_batches(state, tr, e)
        sites, label, mae = ref.epoch(sites, label, xe, ye, tr["lr"], tr["weight_decay"],
                                      split, dtype=dtype, low=low)
        out.append({"sites": sites, "label": label, "mae": mae})
    return out


def check(state: dict, win: dict, cfg: dict, tr: dict, device, outs=None) -> dict:
    """The numbers that decide ``correct`` (those the cell's limits name),
    from the checked epochs:

    * ``first_steps_gap``: the widest relative gap of the MAE of the first
      sweep's first ``steady_steps`` steps (the batch output before any
      update, then after the first updates: the environment stack, the
      closure, the merge, gradient and update, the first splits and the
      environments they extend), which float32 rounding leaves steady;
    * ``mae_gap``: the widest relative gap of a step's MAE over every step
      of the checked sweeps;
    * ``score_gap``: the widest gap of the scores of the model after each
      checked epoch on fresh images, relative to the largest change the
      reference's epochs made to those scores (a model left unchanged reads
      1);
    * ``isometry_gap``: the median of the ``isometry_gaps`` of the program's
      sites after the first checked epoch (no reference; that item gives in
      ``isometry_tail`` the 3/4 and 9/10 quantiles and the widest). Where a
      two-site matrix has directions at the level of float32's rounding, the
      polar split lifts them only in part, so some sites of a sound run read
      up to 1/4: a few after the first epoch, more with each epoch as
      training narrows the model's spectrum. A split that loses its
      orthogonality on every step (passes cut, the product state left in
      place) moves the median;
    * ``window_nonfinite``: the entries of the model that are not finite
      when the window closes (``win``; none without a window).

    ``outs`` replaces the program's checked epochs."""
    prog = state["checked"] if outs is None else outs
    refs = reference_epochs(state, tr)
    fresh = state["fresh"]
    f0 = ref.scores(*state["weights"], fresh)
    items = []
    for p, r in zip(prog, refs, strict=True):
        pm, rm = p["mae"].to(torch.float64), r["mae"]
        if pm.shape != rm.shape:
            items.append({"mae_gap": float("inf"), "score_gap": float("inf")})
            continue
        fr = ref.scores(r["sites"], r["label"], fresh)
        fp = ref.scores(p["sites"], p["label"], fresh)
        items.append({"mae_gap": float(((pm - rm).abs() / rm.abs()).max()),
                      "score_gap": float((fp - fr).abs().max() / (fr - f0).abs().max()),
                      "steps": ((pm - rm).abs() / rm.abs())[0]})
    gaps = isometry_gaps(prog[0]["sites"])
    items[0]["isometry_gap"] = float(gaps.median())
    items[0]["isometry_tail"] = [float(v) for v in torch.quantile(
        gaps, torch.tensor([0.75, 0.9, 1.0], dtype=gaps.dtype, device=gaps.device))]
    k = tr["steady_steps"]
    steps = items[0].pop("steps", None)
    items[0]["first_steps_gap"] = float(steps[:k].max()) if steps is not None else float("inf")
    for it in items[1:]:
        it.pop("steps", None)
    items.append({"window_nonfinite": float(win["nonfinite"]) if win else 0.0})
    nums = {"first_steps_gap": items[0]["first_steps_gap"],
            "mae_gap": max(it["mae_gap"] for it in items[:-1]),
            "score_gap": max(it["score_gap"] for it in items[:-1]),
            "isometry_gap": items[0]["isometry_gap"],
            "window_nonfinite": items[-1]["window_nonfinite"]}
    profile = [float(v) for v in steps[:10]] + [float(steps[10:].max())] \
        if steps is not None else []
    return {"numbers": {k: (v if v == v else float("inf")) for k, v in nums.items()},
            "items": items, "profile": profile}


def end_to_end(win: dict, tr: dict, setup_s: float) -> dict:
    samples = win["epochs"] * tr["batches_per_epoch"] * tr["batch"]
    return {
        "train_samples_per_s": {"value": samples / win["window_s"], "unit": "samples/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def counts(view, tr: dict) -> dict:
    n = len(view.spans)
    return {"epochs": n, "sweeps": n * tr["batches_per_epoch"],
            "samples": n * tr["batches_per_epoch"] * tr["batch"]}


def attempted(win: dict) -> int:
    return win["epochs"]


def small(cfg: dict, tr: dict):
    """The CPU rehearsal's size; at it float32 and float64 part from the
    fourth step on."""
    return ({**cfg, "N": 16, "M": 6, "image_side": 8},
            {**tr, "batch": 16, "fresh_rows": 48, "steady_steps": 3, "trace_from": 0.0})


def control(cfg: dict, tr: dict, seed: int, device, seconds: float) -> dict:
    """Set-up, a window and the check with the control in the program's
    place: the program's TF32 path on the card; the reference's checked
    epochs in float32 with TF32-rounded products on the CPU, which has no
    TF32, and for the fused engine, whose steps (K7) the TF32 scope does not
    reach."""
    own = device.type == "cuda" and tr["sweep"]["engine"] != "fused"
    state = setup(cfg, tr, seed, device, precision="tensorfloat32" if own else None)
    win = window(state, tr, seconds, Tracer(False, device))
    free(state)
    outs = None if own else reference_epochs(state, tr, low=True)
    return check(state, win, cfg, tr, device, outs=outs)


def _half_batch(step):
    """``step`` (``fused_epoch``) fed each batch's first half twice: every
    sum over the batch is twice the sum over the half kept."""
    def faulty(model, x, y, *args, **kwargs):
        axis = y.dim() - 1  # the batch axis
        h = y.shape[axis] // 2
        x2 = torch.cat([x.narrow(axis, 0, h)] * 2, dim=axis)
        y2 = torch.cat([y.narrow(axis, 0, h)] * 2, dim=axis)
        return step(model, x2, y2, *args, **kwargs)
    return faulty


def _unchanged(step):
    """``step`` returning the model it was given."""
    def faulty(model, *args, **kwargs):
        return (model, *step(model, *args, **kwargs)[1:])
    return faulty


def _window_nan(checked_epochs: int):
    """``step`` sound through the checked epochs, then leaving a NaN in the
    model. The next call gets back the entry the NaN replaced, so every
    epoch runs on a finite model (a split on the CPU raises on a NaN) and
    the model is non-finite when the window closes."""
    def wrap(step):
        calls, replaced = [], []

        def faulty(model, *args, **kwargs):
            calls.append(1)
            if replaced:
                model.label_site[0, 0, 0, 0] = replaced.pop()
            out = step(model, *args, **kwargs)
            if len(calls) > checked_epochs:
                replaced.append(out[0].label_site[0, 0, 0, 0].item())
                out[0].label_site[0, 0, 0, 0] = float("nan")
            return out
        return faulty
    return wrap


def _k1_pass_cut(polar_iterate, cut: int = 2):
    """``polar_iterate`` with the last ``cut`` passes of its final schedule
    left out (the reference's copy of the schedule)."""
    final = ref.pe_schedule(*ref.POLAR_FINAL)[:-cut]

    def faulty(y, g, n2=None, **kwargs):
        return polar_iterate(y, g, n2, final_coeffs=final, **kwargs)
    return faulty


def faults(tr: dict) -> dict:
    out = {"half_batch": (ENTRY, _half_batch), "unchanged": (ENTRY, _unchanged),
           "window_nan": (ENTRY, _window_nan(tr["checked_epochs"]))}
    sweep = tr["sweep"]
    if sweep["svd_method"] == "polar" and sweep["engine"] == "hybrid":
        # only the hybrid engine calls K1 through this name: the fused
        # engine's K1 stage runs inside K7's C chain
        out["k1_pass_cut"] = (POLAR_ITERATE, _k1_pass_cut)
    return out


def span_counts(view, cfg: dict, tr: dict) -> dict:
    """An epoch's span and each sweep's with its prologue; a span a two-site
    step but in the fused engine, whose steps K7 issues from C."""
    n = len(view.spans)
    sweeps = n * tr["batches_per_epoch"]
    steps = 0 if tr["sweep"]["engine"] == "fused" else (cfg["N"] - 1) * sweeps
    return {spans.EPOCH: n, spans.SWEEP: sweeps, spans.PROLOGUE: sweeps, spans.STEP: steps}
