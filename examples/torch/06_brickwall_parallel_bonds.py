"""Brick-wall parallel-bond training (``train/brickwall.py``), on the card.

A sweep-equivalent update of every bond runs as TWO batched layers (even
pairs, then odd pairs) instead of N-1 dependent steps: merges, gradients,
clips and truncated splits for all K = N/2 pairs run as batched products
and Cholesky factorisations (``ops/svd.py::batched_cholqr_split``). The
K simultaneous clipped lr-relative pair updates are block-Jacobi (no
Gauss-Seidel self-correction), so keep lr*K <~ 0.25, i.e. lr ~ 0.5/N.

Run: python examples/torch/06_brickwall_parallel_bonds.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.loader import prepare_dataset
from tensornetworkforml_torch.data.mnist import max_pool_2x2, synthetic_mnist
from tensornetworkforml_torch.models.boundary import boundary_forward, boundary_product_init
from tensornetworkforml_torch.models.mps import resolve_device
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.brickwall import train_brickwall

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

tr_x, tr_y, te_x, te_y = synthetic_mnist()
data = max_pool_2x2(np.concatenate([tr_x, te_x]) / 255.0)
labels = np.concatenate([tr_y, te_y])
train_perc = len(tr_x) / len(data)

train_loader, val_loader, test_loader = prepare_dataset(
    data, labels, train_perc, 0.1, train_batch_size=128,
    val_batch_size=256, test_batch_size=256, embed=False, seed=0,
    even_train_batches=True,
)

N = data[0].size
x_cal, _ = next(train_loader.batches())
model = boundary_product_init(
    torch.Generator().manual_seed(0), N=N, M=16, L=10, act_fn="linear", loss_fn="MSE",
    dtype=torch.float32, calibration_x=x_cal[:256], device=device,
)

# lr*K <~ 0.25: N=196 -> K=98 pairs -> lr ~ 0.5/N
model, val_acc = train_brickwall(
    model, train_loader, val_loader, lr=min(0.02, 0.5 / N), n_epochs=2,
    weight_dec=1e-5, verbose=True,
)

accs = []
for x_t, y_t in test_loader.batches():
    x_t = torch.as_tensor(x_t, dtype=torch.float32, device=device)
    scores = boundary_forward(model, psi_embed(x_t))
    accs.append(float((scores.argmax(0).cpu() == torch.as_tensor(y_t)).float().mean()))
print(f"test accuracy: {float(np.mean(accs)):.4f}")
assert val_acc[-1] > 0.9
