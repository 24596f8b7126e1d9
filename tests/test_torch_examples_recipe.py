"""The port's production-recipe example (``examples/torch/05_production_recipe.py``)
on the CPU: the longest example, in a file of its own so that
``--dist loadfile`` runs it beside ``tests/test_torch_examples.py``."""

from tests.test_torch_examples import run_example


def test_production_recipe_example_runs(capsys, monkeypatch):
    out = run_example("examples/torch/05_production_recipe.py", capsys, monkeypatch)
    assert out["mps"].M == 32  # the bond grew at epoch 2
    assert out["mps"].sites.device.type == "cpu"
