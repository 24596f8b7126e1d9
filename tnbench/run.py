"""Run one cell of the benchmark of ``tensornetworkforml_torch`` on one card.

    python3 tnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``tnbench/configs/<config>.json``, and a traffic mix,
``tnbench/traffic/<traffic>.json``. The traffic's ``kind`` is the name of the
general generator that reads it, the module ``tnbench/<kind>.py``
(``generator``). The limits of the numbers that decide ``correct`` are
``tnbench/limits/<cell>.json``, and each per-layer metric is read by
``tnbench/metrics/<metric>.py``. Everything is found by name: a new cell,
metric or traffic kind is new files and new entries in ``BENCHMARK.json``.

A generator provides these functions, and the harness and its tests learn
nothing about a kind but through them (``cfg`` the configuration, ``tr`` the
traffic, both dicts):

* ``setup(cfg, tr, seed, device) -> state``: weights and inputs from
  ``seed``, every shape the window uses built and warmed;
* ``window(state, tr, seconds, tracer) -> win``: the measured window, its
  calls through ``trace.measure`` (which records the traced sub-window);
* ``free(state)``: drop the program's state before the reference runs;
* ``check(state, win, cfg, tr, device, outs=None) -> {"numbers": {...},
  "items": [...]}``: the numbers that the limits name, and one dict of
  numbers an answer or epoch; ``outs`` puts the control's outputs in the
  program's place;
* ``end_to_end(win, tr, setup_s) -> {metric: {"value", "unit"}}``;
* ``counts(view, tr) -> dict``: what the traced sub-window holds (the
  metric readers' ``view.counts``), from its ``tnbench.iteration`` spans;
* ``attempted(win) -> int``;
* ``small(cfg, tr) -> (cfg, tr)``: copies at the size of the CPU rehearsal
  (``tnbench/tests``), which traces from the window's first call on;
* ``control(cfg, tr, seed, device, seconds) -> dict``: ``check``'s result
  with the control in the program's place (set-up, a window of ``seconds``,
  the check), for setting the limits (``readings.py``);
* ``faults(tr) -> {name: ((module, attribute), wrap)}``: the faults that
  this traffic's path can have, each planted by replacing the dotted
  ``attribute`` of ``module`` by ``wrap`` of it (``readings.planted``);
* ``span_counts(view, cfg, tr) -> {span: count}``: how many of each of the
  program's spans (``spans.py``) one traced sub-window holds.

A run makes its weights and inputs on the card from ``--seed``, builds and
warms the cell's kernels (set-up), measures for ``--seconds``, then checks
the outputs against the plain reference (``tnbench/reference/``) and prints
one JSON line as the last line of standard output. With ``--trace 1`` it
profiles a steady sub-window of the measured window and reports the
per-layer metrics instead of the end-to-end ones. It exits non-zero, with no
result, when no card is present, and when JAX or the JAX package has been
imported.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "tnbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tensornetworkforml_tpu")
PROTOCOL = ("setup", "window", "free", "check", "end_to_end", "counts", "attempted", "small",
            "control", "faults", "span_counts")
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def generator(kind: str):
    """The generator of a traffic ``kind``: the module ``tnbench.<kind>``,
    with every function of the protocol."""
    if not isinstance(kind, str) or not NAME.match(kind):
        raise ValueError(f"a traffic kind names a module of tnbench/, not {kind!r}")
    name = f"tnbench.{kind}"
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as err:
        if err.name != name:
            raise
        raise ValueError(f"no generator for the traffic kind {kind!r}: "
                         f"tnbench/{kind}.py does not exist") from None
    missing = [f for f in PROTOCOL if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"the generator tnbench/{kind}.py lacks {', '.join(missing)} "
                         "of the protocol (tnbench/run.py)")
    return module


def load_cell(bench: dict, name: str) -> dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
    }


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell's traced run reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if reports(m, cell)}
    out = []
    for m in bench["per_layer"]:
        if ("workloads" in m and cell in m["workloads"]) or (
                "workloads" not in m and m["moves"] in e2e):
            out.append(m)
    return out


def metric_reader(name: str):
    """The ``read(view)`` function of ``tnbench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tnbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def judge(numbers: dict, limits: dict):
    """``correct`` and the compared numbers beside their limits. Every number
    that has a limit must be finite and at or under it."""
    checks, correct = {}, True
    for name, lim in limits.items():
        value = numbers.get(name, float("inf"))
        ok = math.isfinite(value) and value <= lim["limit"]
        correct = correct and ok
        checks[name] = {"value": value, "limit": lim["limit"]}
    return correct, checks


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, loaded: dict = None) -> dict:
    """Set-up, window, check and metrics of one cell on ``device``; returns
    the result line's object (``checks`` last). ``loaded`` replaces what
    ``load_cell`` would read (the tests' small configurations)."""
    import torch

    from tnbench.trace import Tracer, breakdown

    c = loaded or load_cell(bench, name)
    cfg, tr, limits = c["config"], c["traffic"], c["limits"]
    drv = generator(tr["kind"])
    tracer = Tracer(trace, device)
    state = drv.setup(cfg, tr, seed, device)
    setup_s = time.perf_counter() - t0
    win = drv.window(state, tr, seconds, tracer)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.free(state)
    if cuda:
        torch.cuda.empty_cache()
    got = drv.check(state, win, cfg, tr, device)
    correct, checks = judge(got["numbers"], limits)
    failed = sum(1 for item in got["items"]
                 if not judge(item, {k: limits[k] for k in item if k in limits})[0])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c["cell"].get("chips", 1), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": drv.attempted(win), "failed": int(failed)}
    if trace:
        view = tracer.view(cfg, tr)
        view.counts = drv.counts(view, tr)
        metrics = {}
        for m in per_layer_for(bench, name):
            value = metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        out.update(metrics=metrics, device=dev)
        if view.spans and view.device:
            out["breakdown"] = breakdown(view)
    else:
        e2e = drv.end_to_end(win, tr, setup_s)
        out.update(metrics={m["name"]: e2e[m["name"]] for m in bench["end_to_end"]
                            if reports(m, name)}, device=dev)
    tracer.close()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of anything that builds kernels: inside the checkout, at fixed paths
    cache = ROOT / "_tnbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    spec = importlib.util.find_spec("tensornetworkforml_torch")
    if spec is None or ROOT not in Path(spec.origin).resolve().parents:
        print("tnbench: the program (tensornetworkforml_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tnbench: the cell needs {chips} CUDA card(s), this machine has {n}; "
              "the benchmark runs only on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, _T0)

    bad = forbidden_modules()
    if bad:
        print(f"tnbench: modules of JAX or the JAX package were imported: {bad}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
