"""Shared helpers for the command-line entry points."""

from __future__ import annotations

import os

import numpy as np

def add_device_flag(p) -> None:
    """The one flag the port's CLIs add to the JAX package's: ``--device``."""
    p.add_argument("--device", type=str, default=None,
                   help="device to run on, e.g. cuda or cpu (default: the CUDA card; "
                        "without one the run stops, it does not fall back to the CPU)")


def save_training_plots(
    var_hist: np.ndarray,
    val_acc,
    n_epochs: int,
    out_dir: str,
    prefix: str,
) -> None:
    """Accuracy and MAE curves, as the reference's result plots
    (``training_diagonals.py:75-96``). Skipped without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plots")
        return

    os.makedirs(out_dir, exist_ok=True)
    steps_per_epoch = var_hist.shape[2]
    x_values = np.arange(n_epochs * steps_per_epoch) / steps_per_epoch

    plt.plot(x_values, var_hist[:, 0].reshape(-1), label="Train acc")
    plt.plot(np.arange(1, n_epochs + 1), val_acc, "ro", label="Validation acc")
    plt.title("Accuracies of the network")
    plt.ylabel("Accuracy")
    plt.xlabel("Epoch")
    plt.legend()
    plt.savefig(os.path.join(out_dir, f"{prefix}_accuracy.png"))
    plt.close()

    plt.plot(x_values, var_hist[:, 1].reshape(-1), label="MAE")
    plt.title("Mean Absolute Error")
    plt.ylabel("| f(x) - y |")
    plt.xlabel("Epoch")
    plt.legend()
    plt.savefig(os.path.join(out_dir, f"{prefix}_MAE.png"))
    plt.close()
    print(f"\nPlots are stored in the '{out_dir}' folder\n")


def evaluate_loader(net, loader):
    """Per-batch accuracy and MAE over a loader, averaged, as the reference
    test scripts compute them (``test_diagonals.py:60-79``)."""
    accs, maes = [], []
    for x, y in loader.batches():
        f = net.apply_act_func(net.forward(x))
        accs.append(net.accuracy(x, y, f))
        y_onehot = np.zeros((net.L, len(y)))
        y_onehot[np.asarray(y), np.arange(len(y))] = 1.0
        maes.append(float(np.abs(y_onehot - f.elem.cpu().numpy()).mean()))
    return float(np.mean(accs)), float(np.mean(maes))


def load_binary_mnist(data_dir: str, synthetic: bool = False):
    """Pooled 14x14 binary-MNIST arrays (digits 0 and 1) in [0, 1], the
    reference recipe (``training_binary_MNIST.py:54-65``)."""
    from tensornetworkforml_torch.data.mnist import (
        get_MNIST_dataset,
        max_pool_2x2,
        synthetic_mnist,
    )

    if synthetic:
        tr_x, tr_y, te_x, te_y = synthetic_mnist()
    else:
        tr_x, tr_y, te_x, te_y = get_MNIST_dataset(data_root_dir=data_dir)
    data = np.concatenate([tr_x, te_x])
    labels = np.concatenate([tr_y, te_y])
    data = max_pool_2x2(data)
    mask = (labels == 0) | (labels == 1)
    # pixel values to [0, 1] for the psi embedding
    return data[mask] / 255.0, labels[mask]
