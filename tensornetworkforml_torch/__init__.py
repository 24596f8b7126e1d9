"""TensorNetworkForML in PyTorch: the MPS classifier on an NVIDIA H100.

The PyTorch / CUDA counterpart of ``tensornetworkforml_tpu``, which stays the
reference it is tested against. The layout mirrors that package (``ops/``,
``ops/kernels/``, ``models/``, ``utils/``, ``data/``) and so do the function
names. Kernels written by hand for Hopper live in ``csrc/`` and are built
with ``nvcc`` at first use (``ops/kernels/_build.py``); on CPU tensors each
kernel's wrapper runs its plain PyTorch version.

Ported so far: serving and training -- embedding, contractions, every split
method, the ``MPS`` model with its canonical gauge, ``.npz`` checkpoints, the
data helpers and loaders, ``Predictor`` with its chain kernel, and the
two-site sweep, epoch and ``train_model`` with the polar-iteration,
pre-split, streaming-reduction and rangefinder kernels. The entry
points run on the card unless given ``device="cpu"``. ROADMAP.md lists what
is not ported yet.
"""

__version__ = "0.1.0"

from tensornetworkforml_torch.models.mps import MPS, mps_forward, mps_init
from tensornetworkforml_torch.models.serving import Predictor

__all__ = ["MPS", "mps_forward", "mps_init", "Predictor", "__version__"]
