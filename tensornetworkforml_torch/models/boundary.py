"""Boundary-label MPS: the label leg lives on a fixed output projection.

A second classifier family beside the traveling-label MPS
(``models/mps.py``):

    f_o(x) = e0 . A_1(x_1) ... A_N(x_N) . W[:, o]

The label is a fixed ``(M, L)`` projection at the right chain end instead of
a leg that the DMRG sweep drags through the chain. Its trainers are the
one-site sweep (``train/onesite.py``: the center moves by exact QR
factorisations, no truncated split) and the brick-wall layers
(``train/brickwall.py``: every pair of a layer updated at once).

The same padded-uniform layout as the traveling-label model. ``BoundaryMPS``
is an ``nn.Module`` whose two tensors are buffers; random draws take an
explicit ``torch.Generator``, as ``models/mps.py`` does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tensornetworkforml_torch.models.mps import _normal, resolve_device
from tensornetworkforml_torch.ops.contractions import boundary_vector, left_env_final_fused


class BoundaryMPS(nn.Module):
    """Sites ``(N, M, D, M)`` + output projection ``w (M, L)``."""

    def __init__(
        self,
        sites: torch.Tensor,
        w: torch.Tensor,
        act_fn: str = "linear",
        loss_fn: str = "MSE",
        T: float = 0.1,
    ):
        super().__init__()
        self.register_buffer("sites", sites)
        self.register_buffer("w", w)
        self.act_fn = act_fn
        self.loss_fn = loss_fn
        self.T = T

    @property
    def N(self) -> int:
        return self.sites.shape[0]

    @property
    def M(self) -> int:
        return self.sites.shape[1]

    @property
    def D(self) -> int:
        return self.sites.shape[2]

    @property
    def L(self) -> int:
        return self.w.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.sites.dtype

    @property
    def device(self) -> torch.device:
        return self.sites.device

    def replace(self, **changes) -> "BoundaryMPS":
        """A new ``BoundaryMPS`` with the given fields replaced."""
        fields = dict(sites=self.sites, w=self.w, act_fn=self.act_fn,
                      loss_fn=self.loss_fn, T=self.T)
        fields.update(changes)
        return BoundaryMPS(**fields)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        return boundary_forward(self, phi)


def boundary_forward_arrays(sites: torch.Tensor, w: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Scores ``(L, B)``: the left-to-right chain scan closed by ``w``."""
    e0 = boundary_vector(sites.shape[1], dtype=sites.dtype, device=sites.device)
    left = left_env_final_fused(sites, phi.transpose(0, 1), e0)  # (B, M)
    return (left @ w).T


def boundary_forward(model: BoundaryMPS, phi: torch.Tensor) -> torch.Tensor:
    """Un-activated class scores ``(L, B)`` for embedded input ``(B, N, D)``."""
    return boundary_forward_arrays(model.sites, model.w, phi.to(model.dtype))


def grow_boundary_bond(model: BoundaryMPS, new_M: int) -> BoundaryMPS:
    """Embed the model into a larger bond dimension (zero padding; the
    function is preserved exactly). The new bond slots and the new rows of
    ``w`` start at zero; the next layer's pair splits rotate weight into
    them."""
    M = model.M
    if new_M < M:
        raise ValueError(f"cannot shrink bonds: {M} -> {new_M}")
    if new_M == M:
        return model
    N, _, D, _ = model.sites.shape
    sites = model.sites.new_zeros((N, new_M, D, new_M))
    sites[:, :M, :, :M] = model.sites
    w = model.w.new_zeros((new_M, model.L))
    w[:M, :] = model.w
    return model.replace(sites=sites, w=w)


def boundary_product_init(
    generator: torch.Generator,
    N: int,
    M: int,
    D: int = 2,
    L: int = 10,
    T: float = 0.1,
    noise: float = 1e-2,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    dtype=torch.float32,
    calibration_x=None,
    device=None,
) -> BoundaryMPS:
    """Per-site-calibrated near-identity init (see ``mps.product_init``) with
    a small random output projection. The site noise is drawn first, then
    ``w``. ``device=None`` is the card (``resolve_device``)."""
    device = resolve_device(device)
    if calibration_x is not None:
        x = torch.as_tensor(calibration_x, dtype=dtype, device=device)
        psi_sum = torch.sin(np.pi * x / 2) + torch.cos(np.pi * x / 2)
        c = torch.clamp(psi_sum.mean(dim=0), min=1e-3)
    else:
        c = torch.full((N,), 4.0 / np.pi, dtype=dtype, device=device)
    base = 1.0 / c

    eye = torch.eye(M, dtype=dtype, device=device)
    core = eye[:, None, :].expand(M, D, M)
    sites = base[:, None, None, None] * core[None]
    sites = sites + noise * _normal(generator, (N, M, D, M), dtype, device)
    # no right-edge masking: all M components of the final bond feed the
    # output projection
    w = (noise + 1.0 / M) * _normal(generator, (M, L), dtype, device)
    return BoundaryMPS(sites, w, act_fn=act_fn, loss_fn=loss_fn, T=T)


def boundary_right_envs(sites: torch.Tensor, w: torch.Tensor, phi_t: torch.Tensor) -> torch.Tensor:
    """Right environments closing on ``w``, ``(N, B, M, L)``: ``out[n]``
    contracts sites ``n+1 .. N-1`` (site-major ``phi_t (N, B, D)``) into
    ``w``; ``out[N-1]`` is ``w`` itself."""
    N, M, D, _ = sites.shape
    B = phi_t.shape[1]
    R = w.expand(B, M, w.shape[1])
    out = [R]
    for n in range(N - 1, 0, -1):
        R = right_label_step(sites[n], phi_t[n], R)
        out.append(R)
    return torch.stack(out[::-1])


def right_label_step(A: torch.Tensor, p: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``R'[b,l,o] = sum_{d,r} A[l,d,r] p[b,d] R[b,r,o]``."""
    t = torch.einsum("bd,bro->bdro", p, R)
    return torch.einsum("ldr,bdro->blo", A, t)
