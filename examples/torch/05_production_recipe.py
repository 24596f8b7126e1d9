"""The production training recipe: rangefinder split + half-batch warmup +
bond growth, on the pooled 10-class task, on the card.

* ``svd_method="rangefinder"``: the subspace split. Its whole-split kernel
  (K6) serves splits of at least ``ops/svd.py::_RANGEFINDER_KERNEL_MIN_I``
  rows; here the bond grows from M=16 to 32, so a split has I = M*D <= 64
  rows and every split runs the plain rangefinder, never K6;
* ``warmup_epochs=1``: one half-batch epoch escapes the init-dependent
  attractors that large clean batches settle into;
* ``bond_schedule``: start small, grow M mid-training (16 -> 32 at epoch 2).

Run: python examples/torch/05_production_recipe.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.loader import prepare_dataset
from tensornetworkforml_torch.data.mnist import max_pool_2x2, synthetic_mnist
from tensornetworkforml_torch.models.mps import product_init, resolve_device
from tensornetworkforml_torch.train.trainer import evaluate_accuracy, train_model

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

tr_x, tr_y, te_x, te_y = synthetic_mnist()
data = max_pool_2x2(np.concatenate([tr_x, te_x]) / 255.0)
labels = np.concatenate([tr_y, te_y])
train_perc = len(tr_x) / len(data)

train_loader, val_loader, test_loader = prepare_dataset(
    data, labels, train_perc, 0.1, train_batch_size=256,
    val_batch_size=256, test_batch_size=256, embed=False, seed=0,
    even_train_batches=True,   # keep every epoch on the fused path
)
x_cal, _ = next(train_loader.batches())

mps = product_init(torch.Generator().manual_seed(0), N=data[0].size, M=16, L=10,
                   act_fn="linear", loss_fn="MSE",
                   calibration_x=x_cal[:256], device=device)

mps, val_acc, _ = train_model(
    mps, train_loader, val_loader,
    lr=0.2, n_epochs=4, weight_dec=1e-5,
    L2_flag=False, split_mode="canonical",
    svd_method="rangefinder",
    warmup_epochs=1,            # half-batch first epoch
    bond_schedule={2: 32},      # grow M 16 -> 32 at epoch 2
    verbose=True,
)
print("val per epoch:", [f"{v:.4f}" for v in val_acc])
print(f"test accuracy: {evaluate_accuracy(mps, test_loader):.4f}  "
      f"(final M = {mps.M})")
