"""How the training CLI's recipe trains at the flagship, on a machine with one
CUDA card; run from the root of the repository:

    python3 scripts/torch_cli_probe.py

runs ``cli/training_mnist.py --synthetic --pool --n_epochs 1 --batch_size 128
--restarts 0`` five times on the card and prints, for each, the validation
and test accuracy, the accuracy at each batch's first step and each batch's
mean MAE (train_model's var_hist):
  1. --M 128 --svd_method polar (K1 on every step; chip_smoke.py's [cli] run);
  2. the same with K1's plain PyTorch version in its place;
  3. --M 128 with the CLI's default split, cholqr (no kernel);
  4. --M 64 --svd_method polar (tests/torch_cli_parity.py runs it on the CPU
     in both packages);
  5. --M 128 --svd_method polar --renorm_envs off.
"""

import os
import sys
import tempfile
import time
from unittest import mock

import torch

from tensornetworkforml_torch.cli import training_mnist
from tensornetworkforml_torch.ops.kernels import polar_split
from tensornetworkforml_torch.train import sweep as sweep_mod
from tensornetworkforml_torch.train import trainer as trainer_mod

RUNS = (
    ("M128 polar kernel", ["--M", "128", "--svd_method", "polar"], False),
    ("M128 polar plain K1", ["--M", "128", "--svd_method", "polar"], True),
    ("M128 cholqr", ["--M", "128"], False),
    ("M64 polar kernel", ["--M", "64", "--svd_method", "polar"], False),
    ("M128 polar kernel renorm off", ["--M", "128", "--svd_method", "polar",
                                      "--renorm_envs", "off"], False),
)


def run(tag, extra, plain, out):
    hist = {}
    real = trainer_mod.train_model

    def keep(*args, **kwargs):
        result = real(*args, **kwargs)
        hist["var"] = result[2]
        return result

    patches = [mock.patch.object(trainer_mod, "train_model", keep)]
    if plain:
        patches += [mock.patch.object(mod, "polar_iterate", polar_split.polar_iterate_reference)
                    for mod in (polar_split, sweep_mod)]
    argv = ["--synthetic", "--pool", "--n_epochs", "1", "--batch_size", "128", "--restarts", "0",
            "--out", out] + extra
    t0 = time.perf_counter()
    for p in patches:
        p.start()
    try:
        val, test = training_mnist.main(argv)
    finally:
        for p in patches:
            p.stop()
    steps = hist["var"][0]  # (2, batches * 195): accuracy, MAE
    n = steps.shape[1] // 195
    print(f"\n### {tag}: val {val} test {test:.4f} in {time.perf_counter() - t0:.1f} s")
    print(f"### {tag} per-batch first-step acc: "
          + " ".join(f"{a:.2f}" for a in steps[0].reshape(n, 195)[:, 0]))
    print(f"### {tag} per-batch MAE: "
          + " ".join(f"{a:.3g}" for a in steps[1].reshape(n, 195).mean(1)))
    sys.stdout.flush()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra, plain in RUNS:
            run(tag, extra, plain, os.path.join(tmp, "model.npz"))


if __name__ == "__main__":
    main()
