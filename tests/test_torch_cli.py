"""The port's command-line entry points (``cli/``) against the JAX package's,
on the CPU (``--device cpu``).

* Each of the six parsers has the JAX parser's options -- the same flags,
  dests, defaults, types, choices, nargs and constants -- plus ``--device``
  and nothing else.
* Every case of ``tests/test_cli.py`` is mirrored on the port, with the same
  arguments and thresholds. The reference ``.dat`` case becomes a check that
  the port refuses such a file naming the item that ports it.
* Models cross between the packages through the shared ``.npz`` files: a
  model trained by either ``training_diagonals`` gives the same
  ``(acc, mae)`` through both ``test_diagonals`` within 1e-6 (float32
  scores, the same data).
* ``training_mnist`` with the JAX package's initial MPS handed over
  (``initial_mps`` patched) ends within 0.05 of the JAX CLI's validation
  and test accuracy.
* ``--trainer brickwall`` and ``--trainer onesite`` with the JAX package's
  initial boundary-label model handed over (``initial_boundary`` patched,
  and the JAX package's sketch matrix for the CholQR splits) end within 0.05
  of the JAX CLI's validation and test accuracy, and save a boundary
  checkpoint.
* ``--dp`` defaults to the card and raises without one, and
  ``--trainer brickwall`` with a split other than cholqr or rangefinder
  exits, both before any data is loaded; without a card the default device
  raises.
* ``--dp --device cpu`` (a world of one over gloo) from the JAX package's
  initial MPS ends within 0.05 of the JAX CLI's ``--dp`` run (its batch
  split over 8 virtual devices).
"""

import argparse
import importlib
import os

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

CLIS = ("training_diagonals", "test_diagonals", "training_binary_MNIST",
        "test_binary_MNIST", "training_mnist", "replicate_stoudenmire")
CROSS_TOL = 1e-6  # (acc, mae) of one model through both packages' test_diagonals
ACC_TOL = 0.05  # training_mnist from the same initial MPS


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread is faster and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name):
    return importlib.import_module(f"tensornetworkforml_torch.cli.{name}")


def _jax(name):
    return importlib.import_module(f"tensornetworkforml_tpu.cli.{name}")


def _options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[tuple(a.option_strings)] = (a.dest, a.default, a.type, a.choices, a.nargs,
                                        a.const, a.required, type(a).__name__)
    return out


@pytest.mark.parametrize("name", CLIS)
def test_parser_is_the_jax_parser_plus_device(name):
    got, want = _options(_port(name).build_parser()), _options(_jax(name).build_parser())
    device = got.pop(("--device",))
    assert device == ("device", None, str, None, None, None, False, "_StoreAction")
    assert got == want


def test_training_and_test_diagonals_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    val_acc = _port("training_diagonals").main([
        "--n_samples", "1200", "--linear_dim", "5", "--sigma", "0.5",
        "--M", "6", "--n_epochs", "3", "--lr", "0.02", "--seed", "0",
        "--out", str(tmp_path / "model.npz"),
        "--results_dir", str(tmp_path / "results"), "--device", "cpu",
    ])
    assert max(val_acc) >= 0.95
    assert os.path.exists(tmp_path / "model.npz")
    try:
        import matplotlib  # noqa: F401

        assert os.path.exists(tmp_path / "results" / "diag_accuracy.png")
        assert os.path.exists(tmp_path / "results" / "diag_MAE.png")
    except ImportError:
        pass

    acc, mae = _port("test_diagonals").main([
        "--filename", str(tmp_path / "model.npz"),
        "--n_samples", "400", "--sigma", "0.5", "--seed", "1", "--device", "cpu",
    ])
    assert acc >= 0.9
    assert 0.0 <= mae <= 1.0


def test_test_diagonals_cli_refuses_reference_pickle(tmp_path):
    """The JAX CLI loads the reference's ``.dat`` pickles; the port does not
    yet, and says which item ports them."""
    (tmp_path / "trained_diag_model.dat").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 12"):
        _port("test_diagonals").main([
            "--filename", str(tmp_path / "trained_diag_model.dat"), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 12"):
        _port("test_binary_MNIST").main([
            "--filename", str(tmp_path / "trained_diag_model.dat"), "--synthetic",
            "--device", "cpu"])


@pytest.mark.parametrize("recipe,n_epochs,min_val,min_acc", [
    ("tpu", "2", 0.95, 0.9),  # test_cli.py's case and thresholds
    ("reference", "1", None, None),  # the reference recipe's arm: it runs
])
def test_training_binary_mnist_cli_synthetic(tmp_path, monkeypatch, recipe, n_epochs,
                                             min_val, min_acc):
    monkeypatch.chdir(tmp_path)
    val_acc = _port("training_binary_MNIST").main([
        "--synthetic", "--n_epochs", n_epochs, "--n_train_batch", "4", "--seed", "0",
        "--recipe", recipe, "--out", str(tmp_path / "mnist.npz"),
        "--results_dir", str(tmp_path / "results"), "--device", "cpu",
    ])
    assert os.path.exists(tmp_path / "mnist.npz") and len(val_acc) == int(n_epochs)
    acc, mae = _port("test_binary_MNIST").main([
        "--filename", str(tmp_path / "mnist.npz"), "--synthetic", "--device", "cpu"])
    assert 0.0 <= mae <= 1.0
    if min_val is not None:
        assert max(val_acc) >= min_val, f"val accuracy too low: {val_acc}"
        assert acc >= min_acc


def test_training_mnist10_cli_synthetic(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    val_acc, test_acc = _port("training_mnist").main([
        "--synthetic", "--pool", "--M", "16", "--n_epochs", "2",
        "--batch_size", "256", "--seed", "0",
        "--out", str(tmp_path / "mnist10.npz"), "--device", "cpu",
    ])
    assert os.path.exists(tmp_path / "mnist10.npz")
    assert max(val_acc) >= 0.9, f"val accuracy too low: {val_acc}"
    assert test_acc >= 0.9, f"test accuracy too low: {test_acc}"


def test_replicate_stoudenmire_runner_synthetic_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = _port("replicate_stoudenmire").main([
        "--synthetic", "--smoke", "--out", str(tmp_path / "m120.npz"), "--device", "cpu",
    ])
    assert rc == 0
    assert os.path.exists(tmp_path / "m120.npz")


def test_training_mnist10_cli_checkpoint_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_main = _port("training_mnist").main
    ck = str(tmp_path / "ck.npz")
    common = [
        "--synthetic", "--pool", "--M", "8", "--batch_size", "128",
        "--seed", "0", "--restarts", "0", "--checkpoint", ck,
        "--out", str(tmp_path / "m.npz"), "--device", "cpu",
    ]
    val1, _ = train_main(common + ["--n_epochs", "1"])
    assert len(val1) == 1 and os.path.exists(ck)
    val2, test_acc = train_main(common + ["--n_epochs", "2", "--resume"])
    assert len(val2) == 1, "resume must skip the already-trained epoch"
    assert val2[-1] >= val1[-1] - 0.05
    val3, _ = train_main(common + ["--n_epochs", "2", "--resume"])
    assert len(val3) == 0


def test_diagonals_models_cross_between_the_packages(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train = ["--n_samples", "600", "--linear_dim", "5", "--sigma", "0.5", "--M", "4",
             "--n_epochs", "2", "--lr", "0.02", "--seed", "0",
             "--results_dir", str(tmp_path / "results")]
    _jax("training_diagonals").main(train + ["--out", str(tmp_path / "jax.npz")])
    _port("training_diagonals").main(train + ["--out", str(tmp_path / "port.npz"),
                                              "--device", "cpu"])
    for who in ("jax", "port"):
        test = ["--filename", str(tmp_path / f"{who}.npz"), "--n_samples", "300",
                "--sigma", "0.5", "--seed", "2"]
        got = _port("test_diagonals").main(test + ["--device", "cpu"])
        want = _jax("test_diagonals").main(test)
        assert got[0] >= 0.9, (who, got)
        assert abs(got[0] - want[0]) <= CROSS_TOL and abs(got[1] - want[1]) <= CROSS_TOL


def test_training_mnist_from_the_jax_init_matches_the_jax_cli(tmp_path, monkeypatch):
    """test_cli.py's 10-class case through both CLIs, the port starting from
    the JAX package's initial MPS (and its restart draws)."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    tm = _port("training_mnist")
    draws = []

    def jax_init(seed, N, M, act_fn, loss_fn, x_cal, device):
        draws.append(seed)
        j = product_init(jax.random.PRNGKey(seed), N=N, M=M, L=10, act_fn=act_fn,
                         loss_fn=loss_fn, dtype=jnp.float32, calibration_x=x_cal)
        return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                              act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device=device,
                              dtype=torch.float32)

    monkeypatch.setattr(tm, "initial_mps", jax_init)
    monkeypatch.chdir(tmp_path)
    args = ["--synthetic", "--pool", "--M", "16", "--n_epochs", "2", "--batch_size", "256",
            "--seed", "0"]
    val, test = tm.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    jval, jtest = _jax("training_mnist").main(args + ["--out", str(tmp_path / "j.npz")])
    assert draws and draws[0] == 0
    assert len(val) == len(jval)
    assert abs(val[-1] - jval[-1]) <= ACC_TOL and abs(test - jtest) <= ACC_TOL


@pytest.mark.parametrize("flags,error,match", [
    (["--trainer", "brickwall", "--svd_method", "polar"], SystemExit, "cholqr or rangefinder"),
    (["--trainer", "brickwall", "--svd_method", "svd"], SystemExit, "cholqr or rangefinder"),
    (["--dp"], RuntimeError, "no CUDA device"),
])
def test_unported_flags_raise_before_loading_data(flags, error, match, tmp_path):
    # no --synthetic and no data: loading anything would raise FileNotFoundError
    with pytest.raises(error, match=match):
        _port("training_mnist").main(flags + ["--data_dir", str(tmp_path / "none")])


@pytest.mark.parametrize("trainer", ["brickwall", "onesite"])
def test_boundary_trainers_from_the_jax_init_match_the_jax_cli(trainer, tmp_path, monkeypatch):
    """``--trainer brickwall|onesite`` through both CLIs at M=8, the port
    starting from the JAX package's initial boundary-label model."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_torch.models.boundary import BoundaryMPS
    from tensornetworkforml_torch.ops import svd as tsvd
    from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy, load_any_checkpoint
    from tensornetworkforml_tpu.models.boundary import boundary_product_init
    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    tm = _port("training_mnist")
    draws = []

    def jax_init(seed, N, M, act_fn, loss_fn, x_cal, device):
        draws.append(seed)
        j = boundary_product_init(jax.random.PRNGKey(seed), N=N, M=M, L=10, act_fn=act_fn,
                                  loss_fn=loss_fn, dtype=jnp.float32, calibration_x=x_cal)
        return boundary_from_numpy(np.asarray(j.sites), np.asarray(j.w), act_fn=j.act_fn,
                                   loss_fn=j.loss_fn, T=j.T, dtype=torch.float32, device=device)

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tm, "initial_boundary", jax_init)
    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)
    monkeypatch.chdir(tmp_path)
    args = ["--synthetic", "--pool", "--M", "8", "--n_epochs", "1", "--batch_size", "256",
            "--seed", "0", "--trainer", trainer]
    val, test = tm.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    jval, jtest = _jax("training_mnist").main(args + ["--out", str(tmp_path / "j.npz")])
    assert draws == [0] and len(val) == len(jval) == 1
    assert abs(val[-1] - jval[-1]) <= ACC_TOL and abs(test - jtest) <= ACC_TOL
    assert test > 0.5, test  # both trainers learn the pooled stand-in in one epoch
    saved = load_any_checkpoint(str(tmp_path / "t.npz"), device="cpu")
    assert isinstance(saved, BoundaryMPS) and saved.M == 8


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port("training_mnist").main(["--data_dir", str(tmp_path / "none")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port("training_diagonals").main(["--n_samples", "50", "--out", str(tmp_path / "m.npz")])


def test_dp_from_the_jax_init_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--dp``: the port in a world of one on the CPU, the JAX package over
    its 8 virtual devices, from the same initial MPS and sketch matrix."""
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist

    from tensornetworkforml_torch.ops import svd as tsvd
    from tensornetworkforml_tpu.models.mps import product_init
    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    tm = _port("training_mnist")

    def jax_init(seed, N, M, act_fn, loss_fn, x_cal, device):
        j = product_init(jax.random.PRNGKey(seed), N=N, M=M, L=10, act_fn=act_fn,
                         loss_fn=loss_fn, dtype=jnp.float32, calibration_x=x_cal)
        return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                              act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device=device,
                              dtype=torch.float32)

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tm, "initial_mps", jax_init)
    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)
    monkeypatch.chdir(tmp_path)
    args = ["--synthetic", "--pool", "--M", "8", "--n_epochs", "1", "--batch_size", "128",
            "--seed", "0", "--dp"]
    val, test = tm.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    assert not dist.is_initialized()  # the CLI's own world of one is gone
    jval, jtest = _jax("training_mnist").main(args + ["--out", str(tmp_path / "j.npz")])
    assert len(val) == len(jval) == 1
    assert abs(val[-1] - jval[-1]) <= ACC_TOL and abs(test - jtest) <= ACC_TOL
    assert os.path.exists(tmp_path / "t.npz")
