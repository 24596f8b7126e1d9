"""Readings of the numbers that decide ``correct``, for setting their limits.

    python3 tnbench/readings.py --workload <cell> --seeds 1,2,3 [--control 4,5,6]
        [--fault half_batch:7,8,9] [--fault unchanged:7] [--seconds 3]

For each seed of ``--seeds`` it runs the cell's set-up, a window of
``--seconds`` and the check, as ``run.py`` does, and prints the numbers the
check compares, one JSON line a seed. ``--control`` runs the generator's
control on those seeds in the program's place (``control`` of the protocol
in ``run.py``). ``--fault name:seeds`` plants a fault of the generator's
list for this traffic (``faults``) for the set-up and the window: the
names are the generator's, and each generator's docstring says what its
faults break. The benchmark's runs never run these; they run on the card, at
the cell's own sizes, once, when the limits are set.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


@contextlib.contextmanager
def planted(drv, tr: dict, fault: str):
    """The generator ``drv``'s ``fault`` for the traffic ``tr`` in place
    while the block runs: the dotted attribute it names replaced by its
    wrapper of it, and put back after."""
    faults = drv.faults(tr)
    if fault not in faults:
        raise ValueError(f"no fault {fault!r} in this traffic's path; its faults: {sorted(faults)}")
    (module, attribute), wrap = faults[fault]
    owner = importlib.import_module(module)
    *path, name = attribute.split(".")
    for part in path:
        owner = getattr(owner, part)
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def reading(c: dict, seed: int, device, seconds: float, role: str) -> dict:
    """One seed's numbers for ``role``: ``program``, ``control`` or a fault."""
    from tnbench import run
    from tnbench.trace import Tracer

    cfg, tr = c["config"], c["traffic"]
    drv = run.generator(tr["kind"])
    t0 = time.perf_counter()
    if role == "control":
        got = drv.control(cfg, tr, seed, device, seconds)
    else:
        fault = planted(drv, tr, role) if role != "program" else contextlib.nullcontext()
        with fault:
            state = drv.setup(cfg, tr, seed, device)
            win = drv.window(state, tr, seconds, Tracer(False, device))
            drv.free(state)
        got = drv.check(state, win, cfg, tr, device)
    return {"seed": seed, "role": role, **got["numbers"],
            "items": got["items"] if len(got["items"]) <= 8 else None,
            "profile": got.get("profile"),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="name:seeds, the name one of the generator's faults for the traffic")
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
    known = run.generator(c["traffic"]["kind"]).faults(c["traffic"])
    jobs = [(s, "program") for s in _seeds(args.seeds)]
    jobs += [(s, "control") for s in _seeds(args.control)]
    for spec in args.fault:
        name, seeds = spec.split(":")
        if name not in known:
            print(f"readings: no fault {name!r} for {args.workload}; its faults: {sorted(known)}",
                  file=sys.stderr)
            return 2
        jobs += [(s, name) for s in _seeds(seeds)]
    for seed, role in jobs:
        got = reading(c, seed, device, args.seconds, role)
        print(json.dumps({"workload": args.workload, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
