"""The general generator of training traffic (``"kind": "train_epochs"``).

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
"""

from __future__ import annotations

import torch

from tnbench import gen
from tnbench.reference import mps as ref
from tnbench.trace import measure

ENTRY = ("tensornetworkforml_torch.train.epoch", "fused_epoch")


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
