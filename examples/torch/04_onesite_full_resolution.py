"""One-site (SVD-free) training at FULL 28x28 resolution (N=784), on the card.

The long-chain recipe: boundary-label MPS + scaled-isometry QR center moves
+ per-sweep lr decay (``train/onesite.py``), on the synthetic MNIST
stand-in.

Run: python examples/torch/04_onesite_full_resolution.py [--device cpu]
(set TNML_SMOKE=1 for the CI-sized run -- same N=784 code path, fewer
samples/epochs)
"""

import argparse
import os

import numpy as np
import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.loader import prepare_dataset
from tensornetworkforml_torch.data.mnist import synthetic_mnist
from tensornetworkforml_torch.models.boundary import boundary_product_init
from tensornetworkforml_torch.models.mps import resolve_device
from tensornetworkforml_torch.train.onesite import train_boundary_model

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

SMOKE = bool(os.environ.get("TNML_SMOKE"))
n_train, n_test = (256, 64) if SMOKE else (2048, 256)
M = 8 if SMOKE else 16
n_epochs = 1 if SMOKE else 2

tr_x, tr_y, te_x, te_y = synthetic_mnist(n_train, n_test)
data = np.concatenate([tr_x, te_x]) / 255.0
labels = np.concatenate([tr_y, te_y])
train_loader, val_loader, _ = prepare_dataset(
    data, labels, 1.0, 0.15, 128, 128, 128, embed=False, seed=0
)

x_cal, _ = next(train_loader.batches())
model = boundary_product_init(
    torch.Generator().manual_seed(0), N=784, M=M, L=10,
    act_fn="linear", loss_fn="MSE", dtype=torch.float32,
    calibration_x=x_cal, device=device,
)

model, val_acc = train_boundary_model(
    model, train_loader, val_loader, lr=0.05, n_epochs=n_epochs,
    weight_dec=1e-5, lr_sweep_decay=0.3 ** (1 / 15), verbose=True,
)
print("validation accuracy per epoch:", [round(v, 4) for v in val_acc])
