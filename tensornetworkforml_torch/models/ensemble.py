"""Ensemble-of-chains MPS classifier: L independent single-output chains.

The counterpart of the JAX package's ``models/ensemble.py``. One small chain
per class plus a learned per-class affine head; the class axis is a batch
axis of the contraction, so each site's ``(B, m) @ (m, m)`` products become
one ``bmm`` over ``(L, B, m)``.

This is not extra capacity: ``to_direct_sum`` builds the equivalent
monolithic label-leg ``MPS`` with bond ``L * m`` (block-diagonal bulk sites,
boundary rows merged, the head's scale folded into the label blocks), which
every facility that takes an ``MPS`` -- serving through the chain kernel K3,
checkpoints -- takes as it is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tensornetworkforml_torch.models.mps import MPS, product_init, resolve_device
from tensornetworkforml_torch.ops.contractions import boundary_vector


class EnsembleMPS(nn.Module):
    """L independent single-output chains + per-class affine head.

    Buffers: ``sites (L, N, m, D, m)``, ``label_site (L, m, D, 1, m)``,
    ``head_a (L,)``, ``head_b (L,)``. Each chain is a label-leg MPS with one
    output (its class's score); class ``c``'s logit is
    ``head_a[c] * f_c(x) + head_b[c]``.
    """

    def __init__(self, sites, label_site, head_a, head_b, l_pos: int = 0):
        super().__init__()
        self.register_buffer("sites", sites)
        self.register_buffer("label_site", label_site)
        self.register_buffer("head_a", head_a)
        self.register_buffer("head_b", head_b)
        self.l_pos = int(l_pos)

    @property
    def L(self) -> int:
        return self.sites.shape[0]

    @property
    def N(self) -> int:
        return self.sites.shape[1]

    @property
    def m(self) -> int:
        return self.sites.shape[2]

    @property
    def D(self) -> int:
        return self.sites.shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.sites.dtype

    @property
    def device(self) -> torch.device:
        return self.sites.device

    def replace(self, **changes) -> "EnsembleMPS":
        fields = dict(sites=self.sites, label_site=self.label_site, head_a=self.head_a,
                      head_b=self.head_b, l_pos=self.l_pos)
        fields.update(changes)
        return EnsembleMPS(**fields)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        return ensemble_forward(self, phi)


def ensemble_init(
    generator: torch.Generator,
    N: int,
    m: int,
    L: int,
    noise: Optional[float] = None,
    calibration_x=None,
    dtype=torch.float32,
    device=None,
) -> EnsembleMPS:
    """L per-class chains, ``product_init(L=1)`` one after the other from one
    generator; the head starts at the identity affine map (a=1, b=0).
    ``device=None`` is the card (``resolve_device``)."""
    device = resolve_device(device)
    kw = {} if noise is None else {"noise": noise}
    chains = [
        product_init(generator, N=N, M=m, L=1, act_fn="linear", loss_fn="MSE", dtype=dtype,
                     calibration_x=calibration_x, device=device, **kw)
        for _ in range(L)
    ]
    return EnsembleMPS(
        torch.stack([c.sites for c in chains]),
        torch.stack([c.label_site for c in chains]),
        torch.ones((L,), dtype=dtype, device=device),
        torch.zeros((L,), dtype=dtype, device=device),
        l_pos=chains[0].l_pos,
    )


def ensemble_from_numpy(sites, label_site, head_a, head_b, *, l_pos: int = 0, dtype=None,
                        device=None) -> EnsembleMPS:
    """Build an ``EnsembleMPS`` from numpy parameters (e.g. ``np.asarray`` of
    the JAX package's ensemble leaves)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return EnsembleMPS(t(sites), t(label_site), t(head_a), t(head_b), l_pos=l_pos)


def ensemble_forward(ens: EnsembleMPS, phi: torch.Tensor) -> torch.Tensor:
    """Class logits ``(L, B)`` for embedded input ``phi (B, N, D)``: every
    chain's contraction at once, the class axis a batch axis of ``bmm``."""
    sites, label = ens.sites, ens.label_site[:, :, :, 0, :]  # (L, m, D, m)
    L, N, m = sites.shape[:3]
    phi = phi.to(ens.dtype)
    B = phi.shape[0]
    v0 = boundary_vector(m, dtype=sites.dtype, device=sites.device).expand(L, B, m)
    left = v0
    for n in range(ens.l_pos):
        w = torch.einsum("cbl,bd->cbld", left, phi[:, n])
        left = torch.einsum("cbld,cldr->cbr", w, sites[:, n])
    right = v0
    for n in range(N - 1, ens.l_pos, -1):
        t = torch.einsum("bd,cbr->cbdr", phi[:, n], right)
        right = torch.einsum("cldr,cbdr->cbl", sites[:, n], t)
    w = torch.einsum("cbl,bd->cbld", left, phi[:, ens.l_pos])
    f = (torch.einsum("cbld,cldr->cbr", w, label) * right).sum(-1)  # (L, B)
    return f * ens.head_a[:, None] + ens.head_b[:, None]


def ensemble_accuracy(ens: EnsembleMPS, phi: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(ensemble_forward(ens, phi), dim=0) == y).to(ens.dtype).mean()


def to_direct_sum(ens: EnsembleMPS) -> MPS:
    """The equivalent monolithic label-leg MPS with bond ``L * m``, on the
    ensemble's device.

    With the label leg at site 0 and the chain ends closed by the one-hot
    boundary ``e0``: the label site's ``e0`` row holds every class's
    first-site row in its own bond block, scaled by that class's head; the
    bulk sites ``1..N-2`` are the chains' block-diagonal embedding; the last
    site's ``e0`` column takes every chain's closing column in its own row
    block. Requires ``head_b == 0`` (a per-class constant is outside the
    exact MPS function class) and ``l_pos == 0``; raises ``ValueError``
    otherwise.
    """
    if float(ens.head_b.detach().abs().max()) != 0.0:
        raise ValueError(
            "to_direct_sum needs head_b == 0 (per-class constant bias is outside "
            "the exact MPS function class); retrain with a bias-free head or keep "
            "the ensemble form"
        )
    if ens.l_pos != 0:
        raise ValueError("to_direct_sum supports l_pos == 0 chains")
    L, N, m, D, _ = ens.sites.shape
    Mc = L * m
    sites_e = ens.sites.detach().cpu().numpy()
    label_e = ens.label_site.detach().cpu().numpy()
    head_a = ens.head_a.detach().cpu().numpy()

    sites = np.zeros((N, Mc, D, Mc), dtype=sites_e.dtype)
    # bulk: block-diagonal; sites[0] stays the unused slot (the label leg
    # sits there), the last site closes on column 0
    for c in range(L):
        sl = slice(c * m, (c + 1) * m)
        sites[1:N - 1, sl, :, sl] = sites_e[c, 1:N - 1]
        sites[N - 1, sl, :, 0] = sites_e[c, N - 1, :, :, 0]

    label_site = np.zeros((Mc, D, L, Mc), dtype=label_e.dtype)
    for c in range(L):
        label_site[0, :, c, c * m:(c + 1) * m] = head_a[c] * label_e[c, 0, :, 0, :]

    return MPS(
        torch.from_numpy(sites).to(ens.device),
        torch.from_numpy(label_site).to(ens.device),
        l_pos=0, act_fn="linear", loss_fn="cross_entropy",
    )
