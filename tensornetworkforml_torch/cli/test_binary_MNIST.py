"""Evaluate a trained binary-MNIST model (reference ``test_binary_MNIST.py``).

    python -m tensornetworkforml_torch.cli.test_binary_MNIST \
        --filename trained_MNIST_model.npz --data_dir datasets

Reads the ``.npz`` checkpoints both packages write and the reference's
``.dat`` pickles (e.g. ``--filename trained_MNIST_model.dat``). Runs on the CUDA card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

from tensornetworkforml_torch.cli.common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a trained MPS model on 0-vs-1 MNIST"
    )
    p.add_argument("--filename", type=str, default="trained_MNIST_model.npz",
                   help="Filename of the trained network (.npz, or a reference .dat)")
    p.add_argument("--data_dir", type=str, default="datasets",
                   help="folder holding the MNIST IDX files")
    p.add_argument("--synthetic", action="store_true",
                   help="Use the synthetic MNIST stand-in (no dataset files)")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tensornetworkforml_torch.cli.common import evaluate_loader, load_binary_mnist
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.network import Network

    net = Network.load(args.filename, device=args.device)
    data01, labels01 = load_binary_mnist(args.data_dir, args.synthetic)
    _, _, test_loader = prepare_dataset(
        data01, labels01, 0, 0, train_batch_size=1, val_batch_size=1,
        test_batch_size=128, embed=False,
    )

    acc, mae = evaluate_loader(net, test_loader)
    print("\tAccuracy:            ", acc)
    print("\tMean Absolute Error: ", mae)
    return acc, mae


if __name__ == "__main__":
    main()
