"""Train the MPS classifier on the noisy-diagonals dataset.

Reference-compatible CLI (the flags and defaults of the reference
``training_diagonals.py:31-46``, plus ``--device``):

    python -m tensornetworkforml_torch.cli.training_diagonals [--M 10 ...]

Trains on the CUDA card (``--device cpu`` for the CPU), saves
``trained_diag_model.npz`` and accuracy/MAE plots under ``results/``.
"""

from __future__ import annotations

import argparse

import numpy as np

from tensornetworkforml_torch.cli.common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train an MPS classifier on the noisy-diagonals task"
    )
    # flag names and defaults match the reference CLI
    # (training_diagonals.py:31-46)
    p.add_argument("--n_samples", type=int, default=5000,
                   help="how many images to synthesize in total")
    p.add_argument("--linear_dim", type=int, default=8,
                   help="image side length (images are square)")
    p.add_argument("--sigma", type=float, default=0.7,
                   help="uniform-noise amplitude mixed into each image")
    p.add_argument("--n_train_batch", type=int, default=1,
                   help="how many mini-batches the training split is cut into")
    p.add_argument("--M", type=int, default=10,
                   help="MPS bond dimension (virtual-leg width)")
    p.add_argument("--n_epochs", type=int, default=5,
                   help="training epochs (full passes over the data)")
    p.add_argument("--lr", type=float, default=0.01,
                   help="gradient-step size for the two-site updates")
    p.add_argument("--L2_decay", type=float, default=1,
                   help="coefficient of the exact-L2 regularizer")
    p.add_argument("--act_fn", type=str, default="softmax",
                   help="output activation: linear, sigmoid or softmax")
    p.add_argument("--loss_fn", type=str, default="full_cross_ent",
                   help="training loss: MSE, cross_entropy or full_cross_ent")
    p.add_argument("--out", type=str, default="trained_diag_model.npz",
                   help="Output checkpoint path")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--split_mode", type=str, default="shared",
                   choices=["shared", "canonical"],
                   help="SVD split gauge ('canonical' = stable DMRG mode)")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tensornetworkforml_torch.cli.common import save_training_plots
    from tensornetworkforml_torch.data.diagonals import create_dataset
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.mps import resolve_device
    from tensornetworkforml_torch.models.network import Network

    device = resolve_device(args.device)
    train_batch = int(args.n_samples * 0.8 / args.n_train_batch)
    data, label = create_dataset(args.n_samples, args.linear_dim, args.sigma,
                                 seed=args.seed)
    train_loader, val_loader, test_loader = prepare_dataset(
        data, label, 1, 0.2,
        train_batch_size=train_batch, val_batch_size=128,
        test_batch_size=128, embed=False, seed=args.seed,
    )

    x_cal, _ = next(train_loader.batches())
    net = Network(
        N=args.linear_dim**2,
        M=args.M,
        L=2,
        calibration_X=np.stack(
            [np.sin(np.pi * x_cal[:16] / 2), np.cos(np.pi * x_cal[:16] / 2)],
            axis=-1,
        ),
        normalize=True,
        act_fn=args.act_fn,
        loss_fn=args.loss_fn,
        seed=args.seed,
        device=device,
    )

    val_acc, var_hist = net.train(
        train_loader, val_loader, lr=args.lr, n_epochs=args.n_epochs,
        weight_dec=args.L2_decay,
    )

    net.save(args.out)
    print(f"\nModel saved to {args.out}")
    save_training_plots(var_hist, val_acc, args.n_epochs, args.results_dir, "diag")
    return val_acc


if __name__ == "__main__":
    main()
