"""Train the MPS classifier on pooled 14x14 binary (0 vs 1) MNIST.

Reference-compatible CLI (the flags of the reference
``training_binary_MNIST.py:36-48``, plus ``--device``):

    python -m tensornetworkforml_torch.cli.training_binary_MNIST \
        --data_dir datasets [--M 8 ...]

MNIST is read from local IDX files (no download is attempted;
``--synthetic`` substitutes a deterministic stand-in). Trains on the CUDA
card unless given ``--device cpu``.

Two recipes:

* ``--recipe tpu`` (default; the JAX package's name for it): near-identity
  product init + canonical-gauge sweeps + linear activation + MSE loss --
  the configuration that learns at chain length 196 in float32.
  Defaults: M=8, lr=0.05.
* ``--recipe reference``: the reference's configuration (random init +
  output calibration, shared-sqrt(S) split, softmax + full cross-entropy,
  M=3, lr=0.001). The reference's own published run of this recipe sits at
  chance accuracy (~0.505, its report section VI); it is kept for parity.

Unlike the reference, pixels are normalised to [0, 1] before the psi
embedding -- the reference embeds raw 0..255 values, which aliases the
sin/cos feature map.
"""

from __future__ import annotations

import argparse

import numpy as np

from tensornetworkforml_torch.cli.common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train an MPS classifier on 0-vs-1 MNIST (pooled 14x14)"
    )
    # flag names and defaults match the reference CLI
    # (training_binary_MNIST.py:36-48)
    p.add_argument("--data_dir", type=str, default="datasets",
                   help="folder holding the MNIST IDX files")
    p.add_argument("--n_train_batch", type=int, default=10,
                   help="how many mini-batches the training split is cut into")
    p.add_argument("--M", type=int, default=None,
                   help="MPS bond dimension (default: 8 tpu recipe, 3 reference)")
    p.add_argument("--n_epochs", type=int, default=3,
                   help="training epochs (full passes over the data)")
    p.add_argument("--lr", type=float, default=None,
                   help="gradient-step size (default: 0.05 tpu recipe, "
                        "0.001 reference)")
    p.add_argument("--L2_decay", type=float, default=None,
                   help="weight-decay coefficient (default: 1e-5 tpu recipe, "
                        "1e-56 reference)")
    p.add_argument("--act_fn", type=str, default=None)
    p.add_argument("--loss_fn", type=str, default=None)
    p.add_argument("--recipe", type=str, default="tpu",
                   choices=["tpu", "reference"])
    p.add_argument("--out", type=str, default="trained_MNIST_model.npz")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="Use the synthetic MNIST stand-in (no dataset files)")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    product_recipe = args.recipe == "tpu"
    M = args.M if args.M is not None else (8 if product_recipe else 3)
    lr = args.lr if args.lr is not None else (0.05 if product_recipe else 0.001)
    wd = args.L2_decay if args.L2_decay is not None else (
        1e-5 if product_recipe else 1e-56
    )
    act_fn = args.act_fn or ("linear" if product_recipe else "softmax")
    loss_fn = args.loss_fn or ("MSE" if product_recipe else "full_cross_ent")

    import torch

    from tensornetworkforml_torch.cli.common import load_binary_mnist, save_training_plots
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.mps import product_init, resolve_device
    from tensornetworkforml_torch.models.network import Network
    from tensornetworkforml_torch.train.trainer import train_model

    device = resolve_device(args.device)
    data01, labels01 = load_binary_mnist(args.data_dir, args.synthetic)

    train_batch = int(len(data01) * 0.8 / args.n_train_batch)
    train_loader, val_loader, test_loader = prepare_dataset(
        data01, labels01, 1, 0.2,
        train_batch_size=train_batch, val_batch_size=128,
        test_batch_size=128, embed=False, seed=args.seed,
    )

    seed = args.seed if args.seed is not None else 0
    x_cal, _ = next(train_loader.batches())
    if product_recipe:
        net = Network.__new__(Network)
        net.mps = product_init(
            torch.Generator().manual_seed(seed), N=data01[0].size, M=M, L=2,
            act_fn=act_fn, loss_fn=loss_fn, dtype=torch.float32,
            calibration_x=x_cal[:256], device=device,
        )
        net.mps, val_acc, var_hist = train_model(
            net.mps, train_loader, val_loader, lr=lr, n_epochs=args.n_epochs,
            weight_dec=wd, L2_flag=False, split_mode="canonical",
        )
    else:
        net = Network(
            N=data01[0].size, M=M, L=2,
            calibration_X=np.stack(
                [np.sin(np.pi * x_cal[:16] / 2), np.cos(np.pi * x_cal[:16] / 2)],
                axis=-1,
            ),
            normalize=True, act_fn=act_fn, loss_fn=loss_fn, seed=seed, device=device,
        )
        val_acc, var_hist = net.train(
            train_loader, val_loader, lr=lr, n_epochs=args.n_epochs, weight_dec=wd,
        )

    net.save(args.out)
    print(f"\nModel saved to {args.out}")
    save_training_plots(var_hist, val_acc, args.n_epochs, args.results_dir, "MNIST")
    return val_acc


if __name__ == "__main__":
    main()
