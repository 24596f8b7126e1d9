"""The port's examples (``examples/torch/``) stay runnable on the CPU.

They mirror ``tests/test_examples.py``: each runs in-process (``runpy``)
with ``--device cpu`` and ``TNML_SMOKE=1`` (01 and 04 shrink their data and
epochs on the same code path) and prints an accuracy. 05 has no smoke size
and takes the longest: it sits in ``tests/test_torch_examples_recipe.py``,
so that ``--dist loadfile`` runs it beside these. Each runs at one torch
thread: its small products run faster so, and six test workers share the
cores.
"""

import sys

import pytest
import torch

SCRIPTS = [
    "examples/torch/01_train_diagonals_functional.py",
    "examples/torch/02_fused_epoch_and_serving.py",
    "examples/torch/03_data_parallel_mesh.py",
    "examples/torch/04_onesite_full_resolution.py",
    "examples/torch/06_brickwall_parallel_bonds.py",
]


def run_example(script, capsys, monkeypatch) -> dict:
    """Run ``script`` as ``__main__`` on the CPU at one torch thread;
    returns its globals."""
    import runpy

    monkeypatch.setenv("TNML_SMOKE", "1")
    monkeypatch.setattr(sys, "argv", [script, "--device", "cpu"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = runpy.run_path(script, run_name="__main__")
    finally:
        torch.set_num_threads(threads)
    assert "accuracy" in capsys.readouterr().out
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs(script, capsys, monkeypatch):
    out = run_example(script, capsys, monkeypatch)
    model = out.get("mps", out.get("model"))
    assert model.sites.device.type == "cpu"
