"""``scripts/torch_teacher_pm0.py`` against ``scripts/teacher_pm0.py`` on the
CPU, at a tiny size (N=16, M=4, 2048 training samples, 2 epochs, both
trainers, one torch thread).

The port's script is handed the JAX package's task arrays and initial models
(its ``make_task``, ``initial_boundary`` and ``initial_mps`` patched) and the
JAX package's sketch matrix for the CholQR splits, as
``tests/test_torch_cli.py`` hands its CLIs the JAX initial models. Both
scripts then train from the same start on the same batches: their
validation curves and test accuracies agree within ``ACC_TOL``, that file's
tolerance for the training CLIs from one initial model.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ACC_TOL = 0.05  # tests/test_torch_cli.py: one recipe through both packages
ARGS = ["--N", "16", "--M", "4", "--n_train", "2048", "--n_epochs", "2",
        "--trainers", "brickwall,twosite", "--seed", "1"]
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_script_from_the_jax_start_matches_the_jax_script(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_torch.ops import svd as tsvd
    from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy, mps_from_numpy
    from tensornetworkforml_tpu.data.teacher import teacher_task
    from tensornetworkforml_tpu.models.boundary import boundary_product_init
    from tensornetworkforml_tpu.models.mps import product_init
    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    port, ref = _load("torch_teacher_pm0"), _load("teacher_pm0")

    def jax_task(args, device):
        return teacher_task(n_train=args.n_train, n_test=1024, N=args.N, L=args.L,
                            teacher_m=args.teacher_m, margin=args.margin, proto_mix=0.0,
                            seed=args.seed)

    def jax_boundary(seed, N, M, L, x_cal, device):
        j = boundary_product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, act_fn="linear",
                                  loss_fn="MSE", dtype=jnp.float32, calibration_x=x_cal)
        return boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), act_fn=j.act_fn,
                                   loss_fn=j.loss_fn, T=j.T, dtype=torch.float32, device=device)

    def jax_mps(seed, N, M, L, x_cal, device):
        j = product_init(jax.random.PRNGKey(seed), N=N, M=M, L=L, act_fn="linear",
                         loss_fn="MSE", dtype=jnp.float32, calibration_x=x_cal)
        return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                              act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device=device)

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(port, "make_task", jax_task)
    monkeypatch.setattr(port, "initial_boundary", jax_boundary)
    monkeypatch.setattr(port, "initial_mps", jax_mps)
    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)
    got = port.main(ARGS + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    jax_out = tmp_path / "jax_seed1.json"  # --combine reads the seed off the name
    monkeypatch.setattr(sys, "argv", ["teacher_pm0.py", *ARGS, "--out", str(jax_out)])
    ref.main()
    with open(jax_out) as f:
        want = json.load(f)
    assert got["model_devices"] == {"brickwall": "cpu", "twosite": "cpu"}
    for name in ("brickwall", "twosite"):
        g, w = got["results"][name], want["results"][name]
        assert len(g["val_acc"]) == len(w["val_acc"]) == 2
        assert np.all(np.isfinite(g["val_acc"]))
        assert np.abs(np.subtract(g["val_acc"], w["val_acc"])).max() <= ACC_TOL, (name, g, w)
        assert abs(g["test_acc"] - w["test_acc"]) <= ACC_TOL, (name, g, w)
    combined = port.main(["--combine", str(tmp_path / "both.json"),
                          f"jax={jax_out}", f"torch={tmp_path / 'port.json'}"])
    assert combined["packages"]["jax"]["seeds"] == combined["packages"]["torch"]["seeds"] == [1]
    assert set(combined["hold"]) == {"brickwall", "twosite"}
