"""Readings of the numbers that decide ``correct``, for setting their limits.

    python3 tnbench/readings.py --workload <cell> --seeds 1,2,3 [--control 4,5,6]
        [--fault half_batch:7,8,9] [--fault unchanged:7] [--seconds 3]

For each seed of ``--seeds`` it runs the cell's set-up and a short window
(training needs none: its checked epochs run in set-up) and prints the
numbers its check compares, one JSON line a seed. ``--control`` runs the
control on those seeds in the program's place: for serving the reference in
float32 with every product's operands rounded to TF32, for training the
program's own TF32 path (``matmul_precision="tensorfloat32"``). ``--fault
name:seeds`` plants a fault in the program: ``half_batch`` (each batch's
second half replaced by its first, so every sum over the batch is twice the
sum over the half kept), ``unchanged`` (every epoch returns the model it was
given), ``k1_pass_cut`` (the polar iteration, K1, run with the last two
passes of its final schedule cut, on the hybrid engine's every step). The
benchmark's runs never run these; they run on the card, at the cell's own
sizes, once, when the limits are set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _half_batch(step):
    """``step`` (``fused_epoch``) fed each batch's first half twice."""
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


def _k1_pass_cut(polar_iterate, cut: int = 2):
    """``polar_iterate`` with the last ``cut`` passes of its final schedule
    left out (the reference's copy of the schedule)."""
    from tnbench.reference import mps as ref

    final = ref.pe_schedule(*ref.POLAR_FINAL)[:-cut]

    def faulty(y, g, n2=None, **kwargs):
        return polar_iterate(y, g, n2, final_coeffs=final, **kwargs)
    return faulty


# name: (the (module, attribute) it wraps, None for the generator's ENTRY; wrapper)
FAULTS = {"half_batch": (None, _half_batch), "unchanged": (None, _unchanged),
          "k1_pass_cut": (("tensornetworkforml_torch.train.sweep", "polar_iterate"),
                          _k1_pass_cut)}


def fault_target(drv, fault: str):
    """The module and attribute that ``fault`` wraps in the generator
    ``drv``'s run."""
    import importlib

    target, _ = FAULTS[fault]
    module, name = target or drv.ENTRY
    return importlib.import_module(module), name


def reading(c: dict, seed: int, device, seconds: float, role: str) -> dict:
    """One seed's numbers for ``role``: ``program``, ``control`` or a fault."""
    import importlib

    from tnbench import run, serve
    from tnbench.trace import Tracer

    cfg, tr = c["config"], c["traffic"]
    t0 = time.perf_counter()
    if tr["kind"] == "serve_closed_loop":
        if role not in ("program", "control"):
            raise ValueError(f"serving has no planted fault {role!r} here")
        state = serve.setup(cfg, tr, seed, device)
        win = serve.window(state, tr, seconds, Tracer(False, device))
        serve.free(state)
        outs = serve.control_outputs(state, win, device) if role == "control" else None
        got = serve.check(state, win, cfg, tr, device, outs=outs)
    else:
        drv = importlib.import_module(run.GENERATORS[tr["kind"]])
        precision = "tensorfloat32" if role == "control" else None
        if role in FAULTS:
            module, name = fault_target(drv, role)
            real = getattr(module, name)
            setattr(module, name, FAULTS[role][1](real))
            try:
                state = drv.setup(cfg, tr, seed, device)
            finally:
                setattr(module, name, real)
        else:
            state = drv.setup(cfg, tr, seed, device, precision=precision)
        drv.free(state)
        got = drv.check(state, None, cfg, tr, device)
    return {"seed": seed, "role": role, **got["numbers"],
            "items": got["items"] if len(got["items"]) <= 8 else None,
            "profile": got.get("profile"),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from tnbench import run

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = run.load_cell(run.load_json(ROOT / "BENCHMARK.json"), args.workload)
    jobs = [(s, "program") for s in _seeds(args.seeds)]
    jobs += [(s, "control") for s in _seeds(args.control)]
    for spec in args.fault:
        name, seeds = spec.split(":")
        jobs += [(s, name) for s in _seeds(seeds)]
    for seed, role in jobs:
        got = reading(c, seed, device, args.seconds, role)
        print(json.dumps({"workload": args.workload, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
