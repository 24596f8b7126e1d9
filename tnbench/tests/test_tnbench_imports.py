"""What the benchmark imports, and what it does without a card.

Run in a fresh interpreter, so that nothing the test process imported
earlier counts."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

IMPORT_ALL = r"""
import importlib, importlib.util, json, pkgutil, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import tnbench.run
for sub in ("reference",):
    pkg = importlib.import_module(f"tnbench.{sub}")
    for info in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"tnbench.{sub}.{info.name}")
for mod in ("tnbench.serve", "tnbench.train", "tnbench.readings", "tnbench.gen",
            "tnbench.roofline", "tnbench.trace"):
    importlib.import_module(mod)
for path in sorted((root / "tnbench" / "metrics").glob("*.py")):
    tnbench.run.metric_reader(path.stem)
for path in sorted((root / "tnbench" / "configs").glob("*.json")):
    json.loads(path.read_text())
for path in sorted((root / "tnbench" / "traffic").glob("*.json")):
    json.loads(path.read_text())
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import tnbench.reference as pkg
for info in pkgutil.iter_modules(pkg.__path__):
    importlib.import_module(f"tnbench.reference.{info.name}")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_no_jax_anywhere():
    tops = _modules(IMPORT_ALL)
    assert not tops & {"jax", "jaxlib", "flax", "tensornetworkforml_tpu"}


def test_reference_imports_nothing_of_the_program():
    tops = _modules(REFERENCE_ONLY)
    assert "tensornetworkforml_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "tensornetworkforml_tpu"}


def test_run_without_a_card_exits_nonzero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "tnbench/run.py", "--workload", "m128-serve-bulk",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_without_the_program_exits_nonzero(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "tnbench", tmp_path / "tnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "tnbench/run.py", "--workload", "m128-serve-bulk",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
