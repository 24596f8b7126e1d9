"""Production batch inference: fixed-batch predictor.

Raw pixels in, class scores and labels out, with the psi embedding on the
device. Requests of any size are cut into chunks of ``batch_size``; the last
chunk is padded with zero rows on the device, so every launch sees the same
batch shape. Both model families are served: the traveling-label ``MPS``
and the boundary-label ``BoundaryMPS`` (the one-site and brick-wall
trainers' family). With a mesh (``parallel/mesh.py``) every rank scores its
rows of each chunk (by its ``data`` coordinate) and the scores are
all-gathered, so every rank returns all of them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tensornetworkforml_torch.models.boundary import BoundaryMPS, boundary_forward_arrays
from tensornetworkforml_torch.models.mps import MPS, apply_act_fn, mps_forward, resolve_device
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels.env_scan import forward_scores
from tensornetworkforml_torch.utils.profiling import (
    SERVE_CHUNK,
    SERVE_COPY_IN,
    SERVE_COPY_OUT,
    SERVE_REQUEST,
    span,
)


class Predictor:
    """Fixed-batch predictor for an ``MPS`` or a ``BoundaryMPS`` on one device.

    The model is served on ``device``; ``None`` is the card
    (``resolve_device``), and a machine without one passes ``"cpu"``.
    ``use_kernel`` selects the fused embed + chain kernel
    (``ops/kernels/env_scan.py``); for an ``MPS`` it is on by default exactly
    when the device is a CUDA device, D == 2 and the label leg sits at site 0.
    Otherwise the plain forward (``mps_forward``) serves. A ``BoundaryMPS``
    is served by the plain ``boundary_forward_arrays``: there is no kernel
    for that family, and ``use_kernel=True`` raises ``ValueError``, as the
    JAX package's ``use_pallas=True`` does. ``use_pallas`` is the JAX
    package's name for ``use_kernel``, as argument and attribute, with the
    same meaning; passing both with different values raises ``ValueError``.

    With a ``mesh``, every rank builds the predictor and calls it with the
    same requests: the model is rank 0's (a broadcast), on the mesh's device
    (``device`` is then ignored), each rank scores its ``batch_size / d``
    rows of each chunk through the same forward (K3 on the card), and one
    all-gather a chunk gives every rank all the scores. ``batch_size`` must
    divide over the ``data`` axis.
    """

    def __init__(
        self,
        mps: MPS,
        batch_size: int = 256,
        mesh=None,
        activation: bool = False,
        use_kernel: Optional[bool] = None,
        device=None,
        use_pallas: Optional[bool] = None,
    ):
        if use_pallas is not None:
            if use_kernel is not None and bool(use_kernel) != bool(use_pallas):
                raise ValueError(
                    f"use_kernel={use_kernel} and use_pallas={use_pallas} disagree; "
                    "use_pallas is the JAX package's name for use_kernel"
                )
            use_kernel = use_pallas
        self.batch_size = int(batch_size)
        self.activation = activation
        self._is_boundary = isinstance(mps, BoundaryMPS)
        self._dp = None
        if mesh is not None:
            from tensornetworkforml_torch.parallel.mesh import DataShards, mesh_device, replicated

            self._dp = DataShards(mesh)
            if self.batch_size % self._dp.size:
                raise ValueError(f"batch_size {self.batch_size} does not divide over the mesh's "
                                 f"data axis of {self._dp.size} ranks")
            self.device = mesh_device(mesh)
            to_device = replicated(mesh).local
        else:
            self.device = resolve_device(device)
            to_device = lambda t: t.to(self.device)  # noqa: E731
        if self._is_boundary:
            if use_kernel:
                raise ValueError(
                    "use_kernel=True (use_pallas=True) is not supported for the "
                    "boundary-label family (the fused kernel serves the traveling-"
                    "label MPS only); omit it or pass use_kernel=False"
                )
            self.mps = mps.replace(sites=to_device(mps.sites), w=to_device(mps.w))
            self.use_kernel = False
            return
        self.mps = mps.replace(sites=to_device(mps.sites), label_site=to_device(mps.label_site))
        if use_kernel is None:
            use_kernel = (
                self.device.type == "cuda" and self.mps.D == 2 and self.mps.l_pos == 0
            )
        self.use_kernel = bool(use_kernel)

    @property
    def use_pallas(self) -> bool:
        """The JAX package's name for ``use_kernel``."""
        return self.use_kernel

    @classmethod
    def from_checkpoint(cls, path: str, device=None, **kwargs) -> "Predictor":
        """Serve a checkpoint (float32) on ``device`` (``None``: the card): an
        ``.npz`` of either family, or a reference ``.dat`` pickle."""
        from tensornetworkforml_torch.utils.checkpoint import (
            load_any_checkpoint,
            mps_from_reference_pickle,
        )

        device = resolve_device(device)
        if path.endswith(".dat"):
            mps = mps_from_reference_pickle(path, dtype=torch.float32, device=device)
        else:
            mps = load_any_checkpoint(path, dtype=torch.float32, device=device)
        return cls(mps, device=device, **kwargs)

    def warmup(self) -> None:
        """Build the kernel and run one batch before serving traffic."""
        x = torch.zeros((self.batch_size, self.mps.N), dtype=self.mps.dtype,
                        device=self.device)
        self._chunk_scores(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _chunk_scores(self, x: torch.Tensor) -> torch.Tensor:
        if self._dp is not None:
            return self._dp.gather(self._rows_scores(self._dp.rows(x)), dim=1)
        return self._rows_scores(x)

    def _rows_scores(self, x: torch.Tensor) -> torch.Tensor:
        if self._is_boundary:
            f = boundary_forward_arrays(self.mps.sites, self.mps.w, psi_embed(x))
        elif self.use_kernel:
            f = forward_scores(self.mps, x)
        else:
            f = mps_forward(self.mps, psi_embed(x))
        if self.activation:
            f = apply_act_fn(f, self.mps.act_fn, self.mps.T)
        return f

    def scores(self, x_raw) -> np.ndarray:
        """Class scores ``(n, L)`` for raw pixels ``(n, N)`` (any n)."""
        with span(SERVE_REQUEST):
            with span(SERVE_COPY_IN):
                x = torch.as_tensor(x_raw, dtype=torch.float32)
                x = x.reshape(len(x), -1).to(device=self.device, dtype=self.mps.dtype)
            outs = []
            for lo in range(0, len(x), self.batch_size):
                with span(SERVE_CHUNK):
                    chunk = x[lo : lo + self.batch_size]
                    n = len(chunk)
                    if n < self.batch_size:
                        chunk = F.pad(chunk, (0, 0, 0, self.batch_size - n))
                    outs.append(self._chunk_scores(chunk)[:, :n].T)
            with span(SERVE_COPY_OUT):
                return torch.cat(outs).cpu().numpy()

    def predict(self, x_raw) -> np.ndarray:
        """Predicted labels ``(n,)``."""
        return self.scores(x_raw).argmax(axis=1)
