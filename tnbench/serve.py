"""The general generator of serving traffic (``"kind": "serve"``; the
protocol is in ``run.py``).

One closed-loop client sends requests of ``rows`` images back to back
through ``Predictor(batch_size=...).scores``, cycling through a pool of
``pool`` distinct requests made in set-up as host arrays. A request's latency
runs from the call to the numpy result in hand. After the window every
answer served in it is compared with the plain reference's scores of its
request, computed in float64. The control is the reference in float32 with
TF32-rounded operands in the program's place; the faults are a request's
second half of scores replaced by the mean of its first (``half_batch``) and
one score of each request altered (``altered_score``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tnbench import gen, spans
from tnbench.reference import mps as ref
from tnbench.trace import Tracer, measure

PREDICTOR_SCORES = ("tensornetworkforml_torch.models.serving", "Predictor.scores")


def setup(cfg: dict, tr: dict, seed: int, device):
    """Weights, the request pool and a warmed predictor, from ``seed``."""
    from tensornetworkforml_torch.models.mps import MPS
    from tensornetworkforml_torch.models.serving import Predictor

    g = gen.generator(seed, device)
    cal_x, _ = gen.images(g, tr["calibration_rows"], cfg)
    sites, label = gen.product_weights(g, cfg, cal_x)
    pool = [gen.images(g, tr["rows"], cfg)[0].cpu().numpy() for _ in range(tr["pool"])]
    model = MPS(sites.clone(), label.clone(), l_pos=0, act_fn=cfg["act_fn"],
                loss_fn=cfg["loss_fn"])
    pred = Predictor(model, batch_size=tr["batch_size"], device=device)
    pred.warmup()
    for req in pool:  # the request path at the served shape, once each
        pred.scores(req)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"weights": (sites, label), "pool": pool, "pred": pred}


def window(state: dict, tr: dict, seconds: float, tracer) -> dict:
    """Requests back to back for ``seconds`` (``trace.measure``)."""
    pred, pool = state["pred"], state["pool"]
    outs, lat, window_s = measure(lambda i: pred.scores(pool[i % len(pool)]), seconds, tracer, tr)
    return {"outs": outs, "lat": lat, "window_s": window_s}


def free(state: dict) -> None:
    state.pop("pred", None)


def check(state: dict, win: dict, cfg: dict, tr: dict, device, outs=None) -> dict:
    """The widest gap of a served score from the reference's, over every
    answer of the window, relative to the largest reference score of its
    request: ``{"score_gap": value}`` and the gap of each answer."""
    sites, label = state["weights"]
    pool = state["pool"]
    refs = [ref.scores(sites, label, torch.from_numpy(x).to(device)).cpu().numpy()
            for x in pool]
    outs = win["outs"] if outs is None else outs
    gaps = []
    for i, out in enumerate(outs):
        r = refs[i % len(pool)]
        if not isinstance(out, np.ndarray) or out.shape != r.shape:
            gaps.append(float("inf"))
            continue
        gap = np.abs(out.astype(np.float64) - r).max() / np.abs(r).max()
        gaps.append(float(gap) if np.isfinite(gap) else float("inf"))
    return {"numbers": {"score_gap": max(gaps) if gaps else float("inf")},
            "items": [{"score_gap": g} for g in gaps]}


def control_outputs(state: dict, win: dict, device) -> list:
    """The control put in the program's place: the reference's scores in
    float32 with every product's operands rounded to TF32, one answer for each
    answer the window served."""
    sites, label = state["weights"]
    pool = state["pool"]
    low = [ref.scores(sites, label, torch.from_numpy(x).to(device), dtype=torch.float32,
                      low=True).cpu().numpy() for x in pool]
    return [low[i % len(pool)] for i in range(len(win["outs"]))]


def end_to_end(win: dict, tr: dict, setup_s: float) -> dict:
    n = len(win["outs"])
    return {
        "serve_samples_per_s": {"value": n * tr["rows"] / win["window_s"], "unit": "samples/s"},
        "serve_p95_ms": {"value": float(np.percentile(np.asarray(win["lat"]) * 1e3, 95)),
                         "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def counts(view, tr: dict) -> dict:
    n = len(view.spans)
    return {"requests": n, "samples": n * tr["rows"]}


def attempted(win: dict) -> int:
    return len(win["outs"])


def small(cfg: dict, tr: dict):
    """The CPU rehearsal's size: two chunks a request."""
    return ({**cfg, "N": 16, "M": 6, "image_side": 8},
            {**tr, "rows": 48, "batch_size": 32, "trace_from": 0.0})


def control(cfg: dict, tr: dict, seed: int, device, seconds: float) -> dict:
    """The program's set-up and window, then the check of ``control_outputs``
    in place of the answers served."""
    state = setup(cfg, tr, seed, device)
    win = window(state, tr, seconds, Tracer(False, device))
    free(state)
    return check(state, win, cfg, tr, device, outs=control_outputs(state, win, device))


def _half_batch_scores(real):
    def scores(self, x):
        out = real(self, x)
        h = len(out) // 2
        out[h:] = out[:h].mean(axis=0)
        return out
    return scores


def _altered_scores(real):
    def scores(self, x):
        out = real(self, x)
        out[len(out) // 2, 3] += 0.01 * np.abs(out).max()
        return out
    return scores


def faults(tr: dict) -> dict:
    return {"half_batch": (PREDICTOR_SCORES, _half_batch_scores),
            "altered_score": (PREDICTOR_SCORES, _altered_scores)}


def span_counts(view, cfg: dict, tr: dict) -> dict:
    """A request's spans, and one chunk span a chunk of ``batch_size`` rows."""
    n = len(view.spans)
    chunks = math.ceil(tr["rows"] / tr["batch_size"])
    return {spans.REQUEST: n, spans.COPY_IN: n, spans.CHUNK: chunks * n, spans.COPY_OUT: n}
