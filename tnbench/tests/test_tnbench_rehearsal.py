"""A dry rehearsal on the CPU: ``BENCHMARK.json`` against the benchmark's
rules, and every cell driven end to end at a small size through the files
its names lead to."""

import json
import re

import pytest
import torch

from tnbench import run
from tnbench.tests import cells

BENCH = cells.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = cells.CELLS


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (run.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    files = [w for w in BENCH["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("tnbench/") and (run.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in CELLS for w in m.get("workloads", []))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if run.reports(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.per_layer_for(BENCH, cell)
    assert layer
    for m in BENCH["per_layer"]:
        # every cell a metric lists reports the end-to-end metric it moves
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"] if run.reports(e, w)}
    for m in layer:
        assert (run.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end_on_the_cpu(cell, trace):
    torch.manual_seed(0)
    c = cells.small(cell)
    out = run.run_cell(BENCH, cell, 2 ** 33 + 5, 0.3, bool(trace), torch.device("cpu"), 0.0,
                       loaded=c)
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert out["attempted"] >= 1 and 0 <= out["failed"] <= max(out["attempted"], 3)
    assert set(out["checks"]) == set(c["limits"])
    for v in out["checks"].values():
        assert v["value"] == v["value"]  # a number, compared
    if trace:
        assert out["device"]["window_s"] > 0
        # no device on the CPU: the device readers find nothing to read
        assert set(out["metrics"]) <= {m["name"] for m in run.per_layer_for(BENCH, cell)}
    else:
        want = {m["name"] for m in BENCH["end_to_end"] if run.reports(m, cell)}
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
