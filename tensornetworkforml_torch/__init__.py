"""TensorNetworkForML in PyTorch: the MPS classifier on an NVIDIA H100.

The PyTorch / CUDA counterpart of ``tensornetworkforml_tpu``, which stays the
reference it is tested against. The layout mirrors that package (``ops/``,
``ops/kernels/``, ``models/``, ``utils/``, ``data/``, ``parallel/``) and so do the function
names. Kernels written by hand for Hopper live in ``csrc/`` and are built
with ``nvcc`` at first use (``ops/kernels/_build.py``); on CPU tensors each
kernel's wrapper runs its plain PyTorch version.

Ported so far: serving and training -- embedding, contractions, every split
method, the ``MPS`` model with its canonical gauge, ``.npz`` checkpoints, the
data layer (MNIST and CIFAR-10 readers with their checksums, the native host
library, the loaders and the teacher task), ``Predictor`` with its chain
kernel, the two-site sweep, epoch and ``train_model`` with the
polar-iteration, pre-split, streaming-reduction and rangefinder kernels, the
named-axis ``Tensor`` with the reference-compatible ``Network`` facade, the
command-line tools (``cli/``), and the off-path trainers: the boundary-label
family with its one-site and brick-wall trainers, the autodiff trainers with
the ring topology, the linear-probe init and the ensemble of chains, and
``parallel/`` (meshes over ``torch.distributed``: data-parallel and
bond-distributed sweeps, mesh epochs and serving). The entry points run on
the card unless given ``device="cpu"`` (``--device cpu`` for the tools).
ROADMAP.md lists what is not ported yet.
"""

__version__ = "0.1.0"

from tensornetworkforml_torch.tensor import Tensor, contract, partial_trace
from tensornetworkforml_torch.models.mps import MPS, mps_forward, mps_init
from tensornetworkforml_torch.models.network import Network
from tensornetworkforml_torch.models.serving import Predictor

__all__ = ["Tensor", "contract", "partial_trace", "MPS", "mps_forward", "mps_init",
           "Network", "Predictor", "__version__"]
