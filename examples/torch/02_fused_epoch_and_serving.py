"""Whole-epoch fused training (one call per epoch) + serving through the
fused chain kernel (K3) on the card.

After an even number of sweeps the label is back at site 0, so the
``Predictor`` serves through K3 on the card (``use_kernel``); on the CPU it
runs the kernel's plain version.

Run: python examples/torch/02_fused_epoch_and_serving.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.diagonals import create_dataset
from tensornetworkforml_torch.models.mps import product_init, resolve_device
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.train.epoch import fused_epoch
from tensornetworkforml_torch.train.sweep import SweepConfig

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

N_SAMPLES, DIM, BATCH = 4096, 6, 256
data, labels = create_dataset(N_SAMPLES, DIM, sigma=0.6, seed=0)
nb = N_SAMPLES // BATCH
x = data.reshape(N_SAMPLES, -1).astype(np.float32).reshape(nb, BATCH, DIM * DIM)
y = labels.astype(np.int32).reshape(nb, BATCH)

mps = product_init(
    torch.Generator().manual_seed(0), N=DIM * DIM, M=8, L=2,
    act_fn="linear", loss_fn="MSE", calibration_x=x[0], device=device,
)
cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False,
                  split_mode="canonical")
for epoch in range(3):
    mps, accs, _ = fused_epoch(mps, x, y, lr=0.05, weight_dec=1e-5, cfg=cfg)
    print(f"epoch {epoch}: batch accuracies {accs.cpu().numpy().round(3)}")

pred = Predictor(mps, batch_size=BATCH, device=device)
pred.warmup()
print(f"serving on {pred.device} (l_pos {mps.l_pos}, kernel {pred.use_kernel})")
test_x, test_y = create_dataset(1000, DIM, sigma=0.6, seed=7)
acc = (pred.predict(test_x.reshape(1000, -1)) == test_y).mean()
print("test accuracy:", acc)
