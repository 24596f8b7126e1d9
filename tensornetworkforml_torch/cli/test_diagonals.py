"""Evaluate a trained diagonals model (reference ``test_diagonals.py``).

    python -m tensornetworkforml_torch.cli.test_diagonals \
        --filename trained_diag_model.npz

Reads the ``.npz`` checkpoints both packages write and the reference's
``.dat`` pickles (e.g. ``--filename trained_diag_model.dat``). Runs on the CUDA card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from tensornetworkforml_torch.cli.common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a trained MPS model on fresh diagonals data"
    )
    p.add_argument("--filename", type=str, default="trained_diag_model.npz",
                   help="Filename of the trained network (.npz, or a reference .dat)")
    p.add_argument("--n_samples", type=int, default=1000,
                   help="how many test images to synthesize")
    p.add_argument("--sigma", type=float, default=0.6,
                   help="uniform-noise amplitude mixed into each image")
    p.add_argument("--seed", type=int, default=None)
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tensornetworkforml_torch.cli.common import evaluate_loader
    from tensornetworkforml_torch.data.diagonals import create_dataset
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.network import Network

    net = Network.load(args.filename, device=args.device)

    linear_dim = int(np.sqrt(net.N))
    data, label = create_dataset(args.n_samples, linear_dim, args.sigma,
                                 seed=args.seed)
    _, _, test_loader = prepare_dataset(
        data, label, 0, 0, train_batch_size=1, val_batch_size=1,
        test_batch_size=128, embed=False,
    )

    acc, mae = evaluate_loader(net, test_loader)
    print("\tAccuracy:            ", acc)
    print("\tMean Absolute Error: ", mae)
    return acc, mae


if __name__ == "__main__":
    main()
