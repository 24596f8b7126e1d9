"""What the CPU tests share: each cell at its generator's rehearsal size, the
faults its traffic can have, and limits set from the sound program's own
reading at that size. ``small`` and ``with_sound_limits`` take a ``bench``
and a ``loaded`` cell, as ``run.run_cell`` does, so that a kind that no
cell uses yet goes through the same code."""

import torch

from tnbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


def generator(c: dict):
    return run.generator(c["traffic"]["kind"])


def small(name: str, bench: dict = BENCH, loaded: dict = None) -> dict:
    """The cell ``name``, or ``loaded``, at its generator's rehearsal size."""
    c = loaded or run.load_cell(bench, name)
    cfg, tr = generator(c).small(c["config"], c["traffic"])
    return {**c, "config": cfg, "traffic": tr}


def fault_cases() -> list:
    """``(cell, fault)`` for each fault of each cell's traffic."""
    out = []
    for name in CELLS:
        c = run.load_cell(BENCH, name)
        out += [(name, fault) for fault in sorted(generator(c).faults(c["traffic"]))]
    return out


def with_sound_limits(name: str, seed: int, bench: dict = BENCH, loaded: dict = None) -> dict:
    """The small cell, each number its limits name limited to three times
    what the sound program reads at that size and seed (the cells' own
    limits are set on the card, at the cells' sizes)."""
    c = small(name, bench, loaded)
    out = run.run_cell(bench, name, seed, 0.2, False, CPU, 0.0, loaded=c)
    c["limits"] = {k: {"limit": 3 * max(v["value"], 1e-12)} for k, v in out["checks"].items()}
    assert run.run_cell(bench, name, seed, 0.2, False, CPU, 0.0, loaded=c)["correct"]
    return c
