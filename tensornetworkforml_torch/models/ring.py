"""Periodic (ring) MPS classifier.

The counterpart of the JAX package's ``models/ring.py``. The chain closes on
itself and the forward pass is a trace over the boundary bond,

    f_o(x) = Tr[ A_1(x_1) ... label_o(x_l) ... A_N(x_N) ],

trained by the autodiff trainer (``train/autodiff.py``): two-site sweeps
need open boundaries, gradients of the whole contraction do not.

The forward carries a full ``(B, M, M)`` matrix product through the sites
(O(N B M^3), against the open chain's O(N B M^2)); the trace's cyclic
invariance lets the product start right after the label site, so the label
contraction closes the loop in one step.
"""

from __future__ import annotations

import numpy as np
import torch

from tensornetworkforml_torch.models.mps import MPS, _normal, resolve_device


def ring_forward_arrays(sites: torch.Tensor, label_site: torch.Tensor, phi: torch.Tensor,
                        l_pos: int) -> torch.Tensor:
    """Un-activated class scores ``(L, B)`` for the ring topology.

    The open chain's layout (``sites (N, M, D, M)``, ``label_site
    (M, D, L, M)``); the slot ``sites[l_pos]`` is unused. Each call adds
    the ``N - 1`` batched ``(B, M, M)`` products it carries to
    ``ring_forward_arrays.products``.
    """
    N, M, D, _ = sites.shape
    B = phi.shape[0]
    G = torch.eye(M, dtype=sites.dtype, device=sites.device).expand(B, M, M)
    # ring order starting after the label: l_pos+1, ..., N-1, 0, ..., l_pos-1;
    # every site's matrix in one contraction, the products one by one
    shift = -(l_pos + 1)
    mats = torch.einsum("nldr,bnd->nblr", sites.roll(shift, 0)[: N - 1],
                        phi.roll(shift, 1)[:, : N - 1])
    for mat in mats.unbind(0):
        G = torch.bmm(G, mat)
    # close the loop through the label site:
    # f[o,b] = sum_{k,r} G[b,k,r] label[r,d,o,k] phi[b,l_pos,d]
    gx = torch.einsum("bkr,bd->bkrd", G, phi[:, l_pos, :])
    ring_forward_arrays.products += N - 1
    return torch.einsum("bkrd,rdok->ob", gx, label_site)


ring_forward_arrays.products = 0


def ring_forward(mps: MPS, phi: torch.Tensor) -> torch.Tensor:
    return ring_forward_arrays(mps.sites, mps.label_site, phi.to(mps.dtype), mps.l_pos)


def ring_product_init(
    generator: torch.Generator,
    N: int,
    M: int,
    D: int = 2,
    L: int = 10,
    T: float = 0.1,
    noise: float = 1e-2,
    act_fn: str = "softmax",
    loss_fn: str = "cross_entropy",
    dtype=torch.float32,
    calibration_x=None,
    device=None,
) -> MPS:
    """Near-identity init for the ring (a trace of near-identity products is
    ~M). Per-site scales carry an extra ``M^(1/N)`` so the traced output is
    O(1). The site noise is drawn first, then the label core's.
    ``device=None`` is the card (``resolve_device``)."""
    if N < 2:
        raise ValueError(f"a ring needs N >= 2 sites, got {N}")
    device = resolve_device(device)
    if calibration_x is not None:
        x = torch.as_tensor(calibration_x, dtype=dtype, device=device)
        psi_sum = torch.sin(np.pi * x / 2) + torch.cos(np.pi * x / 2)
        c = torch.clamp(psi_sum.mean(dim=0), min=1e-3)
    else:
        c = torch.full((N,), 4.0 / np.pi, dtype=dtype, device=device)
    base = 1.0 / c / (M ** (1.0 / N))

    eye = torch.eye(M, dtype=dtype, device=device)
    core = eye[:, None, :].expand(M, D, M)
    sites = base[:, None, None, None] * core[None]
    sites = sites + noise * _normal(generator, (N, M, D, M), dtype, device)
    sites[0] = 0.0  # the label slot

    label_site = base[0] * eye[:, None, None, :].expand(M, D, L, M)
    label_site = label_site + noise * _normal(generator, (M, D, L, M), dtype, device)
    return MPS(sites, label_site, l_pos=0, act_fn=act_fn, loss_fn=loss_fn, T=T)


def ring_trainer(mps: MPS, cfg=None):
    """An ``AutodiffTrainer`` wired to the ring forward."""
    from tensornetworkforml_torch.train.autodiff import AutodiffConfig, AutodiffTrainer

    return AutodiffTrainer(mps, cfg or AutodiffConfig(), forward_arrays=ring_forward_arrays)
