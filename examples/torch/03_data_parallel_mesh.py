"""Data-parallel training over a device mesh (``parallel/dp.py``).

Run plainly, ``make_mesh()`` opens a world of one itself: NCCL on the card,
gloo with ``--device cpu``. Under ``torchrun --nproc_per_node k`` it spans
torchrun's k ranks (one card each), and each step's batch is split over
them; rank 0 prints.

Run: python examples/torch/03_data_parallel_mesh.py [--device cpu]
     torchrun --nproc_per_node 4 examples/torch/03_data_parallel_mesh.py
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.data.diagonals import create_dataset
from tensornetworkforml_torch.models.mps import product_init, resolve_device
from tensornetworkforml_torch.parallel.dp import ShardedTrainer
from tensornetworkforml_torch.parallel.mesh import make_mesh

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_device_flag(parser)
device = resolve_device(parser.parse_args().device)

owns_world = not dist.is_initialized()
mesh = make_mesh(device=device)  # all ranks on the 'data' axis
lead = dist.get_rank() == 0
if lead:
    print("mesh:", mesh)

data, labels = create_dataset(4096, 6, sigma=0.6, seed=0)
x = data.reshape(4096, -1).astype(np.float32)
mps = product_init(torch.Generator().manual_seed(0), N=36, M=8, L=2,
                   act_fn="linear", loss_fn="MSE", calibration_x=x[:256], device=device)

trainer = ShardedTrainer(mesh, mps, lr=0.05, weight_dec=1e-5, L2_flag=False)
for step in range(8):
    lo = (step * 512) % 4096
    acc = trainer.step(x[lo : lo + 512], labels[lo : lo + 512])
    if lead:
        print(f"step {step}: pre-sweep accuracy {acc:.3f}")
mps = trainer.mps
if owns_world:
    dist.destroy_process_group()
