"""The training CLI of both packages from the same initial MPS, on the CPU.

Runs ``cli/training_mnist.py --synthetic --pool --seed 0 --svd_method polar
--n_epochs 1 --batch_size 128 --restarts 0`` at the bond dimensions given
(default 64: the CLI's M >= 64 recipe, with renorm_envs, growth cap and lr
0.02) through the JAX package's CLI and through the port's with the JAX
package's initial MPS handed over (``initial_mps`` patched), and prints both
validation and test accuracies, wall times, and the mean MAE of every tenth
batch (``train_model``'s var_hist). Run from the root of the
repository: ``JAX_PLATFORMS=cpu python -m tests.torch_cli_parity [M ...]``.
"""

import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU, float64 enabled)
from tensornetworkforml_torch.cli import training_mnist as tcli
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy


def jax_initial_mps(seed, N, M, act_fn, loss_fn, x_cal, device):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    j = product_init(jax.random.PRNGKey(seed), N=N, M=M, L=10, act_fn=act_fn, loss_fn=loss_fn,
                     dtype=jnp.float32, calibration_x=x_cal)
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device=device,
                          dtype=torch.float32)


def keeping_history(module, hist):
    """Patch ``module.train_model`` to keep each run's var_hist in ``hist``."""
    real = module.train_model

    def keep(*args, **kwargs):
        result = real(*args, **kwargs)
        hist.append(np.asarray(result[2], dtype=np.float64))
        return result

    return mock.patch.object(module, "train_model", keep)


def every_tenth_mae(var_hist, steps):
    mae = var_hist[0, 1].reshape(-1, steps).mean(axis=1)
    return " ".join(f"{v:.3g}" for v in mae[::10])


def main(bonds):
    from tensornetworkforml_torch.train import trainer as ttr
    from tensornetworkforml_tpu.cli import training_mnist as jcli
    from tensornetworkforml_tpu.train import trainer as jtr

    tcli.initial_mps = jax_initial_mps
    hist = []
    with tempfile.TemporaryDirectory() as tmp, keeping_history(jtr, hist), \
            keeping_history(ttr, hist):
        for m in bonds:
            args = ["--synthetic", "--pool", "--seed", "0", "--svd_method", "polar",
                    "--n_epochs", "1", "--batch_size", "128", "--restarts", "0", "--M", str(m),
                    "--out", f"{tmp}/model.npz"]
            t0 = time.perf_counter()
            jval, jtest = jcli.main(args)
            t1 = time.perf_counter()
            tval, ttest = tcli.main(args + ["--device", "cpu"])
            t2 = time.perf_counter()
            print(f"\nM={m}: JAX val {jval[-1]:.6f} test {jtest:.6f} ({t1 - t0:.1f} s); "
                  f"port val {tval[-1]:.6f} test {ttest:.6f} ({t2 - t1:.1f} s)")
            print(f"M={m}: mean MAE of batches 0, 10, 20, ...: JAX "
                  f"{every_tenth_mae(hist[-2], 195)}; port {every_tenth_mae(hist[-1], 195)}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64])
