"""Minimal functional-API training on the noisy-diagonals task, on the card.

Run: python examples/torch/01_train_diagonals_functional.py [--device cpu]
(set TNML_SMOKE=1 for the CI-sized run -- same code path, smaller data)
"""

import argparse
import os

import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.diagonals import create_dataset
from tensornetworkforml_torch.data.loader import prepare_dataset
from tensornetworkforml_torch.models.mps import mps_init, resolve_device
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.trainer import train_model

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

SMOKE = bool(os.environ.get("TNML_SMOKE"))
n_samples = 320 if SMOKE else 4000
batch = 128 if SMOKE else 3200
n_epochs = 2 if SMOKE else 5

data, labels = create_dataset(n_samples, linear_dim=8, sigma=0.7, seed=0)
train_loader, val_loader, _ = prepare_dataset(
    data, labels, 1.0, 0.2, batch, 128, 128, embed=False, seed=1
)

x_cal, _ = next(train_loader.batches())
mps = mps_init(
    torch.Generator().manual_seed(0),
    N=64, M=10, L=2,
    normalize=True,
    calibration_phi=psi_embed(torch.as_tensor(x_cal[:16], dtype=torch.float32, device=device)),
    act_fn="softmax", loss_fn="full_cross_ent",
    device=device,
)

mps, val_acc, var_hist = train_model(
    mps, train_loader, val_loader, lr=0.01, n_epochs=n_epochs, weight_dec=1.0
)
print("validation accuracy per epoch:", [round(v, 4) for v in val_acc])
