"""Canonical-form gauge fixing for the padded MPS.

The counterpart of the JAX package's ``models/canonical.py``:

* ``right_canonicalize``: with the label at site 0, make every other site a
  right isometry (``sum_{d,r} A[l,d,r] A[l',d,r] = P_{ll'}``, a projector);
  all of the chain's weight moves into the label core.
* ``left_canonicalize``: the mirror image, for the label at site N-1.
* ``canonical_init``: a random MPS built directly in right-canonical form.

Canonicalisation is one pass of QR decompositions over the sites, right to
left (a Python loop here, a ``lax.scan`` in JAX).
"""

from __future__ import annotations

import torch

from tensornetworkforml_torch.models.mps import MPS


def _right_canonicalize_arrays(sites: torch.Tensor, label_site: torch.Tensor,
                               renormalize: bool = False):
    """Label at site 0; returns ``(sites', label_site')`` with sites 1..N-1
    right-isometric. Right to left, each site ``A (l, d, r)`` takes the ``L``
    factor from its right, ``A <- A . L``, and is LQ-decomposed over its
    ``(d, r)`` legs through a QR of its transpose; its ``L`` moves on left.

    With ``renormalize`` the carried ``L`` is scaled to unit Frobenius norm at
    every step, so the network function changes by one overall scalar (the
    product of the site norms would overflow float32 over hundreds of
    random sites); ``canonical_init`` sets the scale afterwards.
    """
    N, M, D, _ = sites.shape
    dtype = sites.dtype
    qr_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    carry = torch.eye(M, dtype=dtype, device=sites.device)
    qs = []
    for n in range(N - 1, 0, -1):
        A = torch.einsum("ldr,rk->ldk", sites[n], carry)
        qt, r = torch.linalg.qr(A.reshape(M, D * M).to(qr_dtype).T)  # (D*M, M), (M, M)
        lfac = r.T
        if renormalize:
            lfac = lfac / torch.clamp(torch.linalg.norm(lfac), min=1e-30)
        carry = lfac.to(dtype)
        qs.append(qt.T.reshape(M, D, M).to(dtype))
    qs.reverse()
    new_sites = torch.cat([torch.zeros((1, M, D, M), dtype=dtype, device=sites.device)]
                          + [q[None] for q in qs])
    new_label = torch.einsum("ldor,rk->ldok", label_site, carry)
    return new_sites, new_label


def right_canonicalize(mps: MPS) -> MPS:
    """Gauge-fix an MPS with ``l_pos == 0`` into right-canonical form; the
    network function is preserved (only the gauge moves)."""
    if mps.l_pos != 0:
        raise ValueError("right_canonicalize expects the label at site 0")
    sites, label = _right_canonicalize_arrays(mps.sites, mps.label_site)
    return mps.replace(sites=sites, label_site=label)


def left_canonicalize(mps: MPS) -> MPS:
    """Gauge-fix an MPS with ``l_pos == N-1`` into left-canonical form (the
    right-canonical form of the mirrored chain, mirrored back)."""
    if mps.l_pos != mps.N - 1:
        raise ValueError("left_canonicalize expects the label at site N-1")
    sites_m = mps.sites.flip(0).permute(0, 3, 2, 1)
    label_m = mps.label_site.permute(3, 1, 2, 0)
    new_sites_m, new_label_m = _right_canonicalize_arrays(sites_m, label_m)
    return mps.replace(
        sites=new_sites_m.flip(0).permute(0, 3, 2, 1).contiguous(),
        label_site=new_label_m.permute(3, 1, 2, 0).contiguous(),
    )


def canonicalize(mps: MPS) -> MPS:
    """Gauge-fix toward the label position, which must be at a chain end."""
    if mps.l_pos == 0:
        return right_canonicalize(mps)
    if mps.l_pos == mps.N - 1:
        return left_canonicalize(mps)
    raise ValueError("canonicalize expects the label at a chain end")


def normalize_label(mps: MPS, target_norm: float = 1.0) -> MPS:
    """Rescale the label core to the Frobenius norm ``target_norm``; in
    canonical form this one scalar sets the output magnitude."""
    norm = torch.linalg.norm(mps.label_site)
    return mps.replace(label_site=mps.label_site * (target_norm / norm))


def canonical_init(
    generator: torch.Generator,
    N: int,
    M: int,
    D: int = 2,
    L: int = 10,
    T: float = 0.1,
    act_fn: str = "softmax",
    loss_fn: str = "cross_entropy",
    dtype=torch.float32,
    target_norm: float = 1.0,
    device=None,
) -> MPS:
    """A random MPS in right-canonical form (label at site 0): ``mps_init``
    without calibration, gauge-fixed with per-step renormalisation, and the
    label core scaled to ``target_norm``. ``device=None`` is the card."""
    from tensornetworkforml_torch.models.mps import mps_init

    mps = mps_init(generator, N=N, M=M, D=D, L=L, T=T, normalize=False, act_fn=act_fn,
                   loss_fn=loss_fn, dtype=dtype, device=device)
    sites, label = _right_canonicalize_arrays(mps.sites, mps.label_site, renormalize=True)
    return normalize_label(mps.replace(sites=sites, label_site=label), target_norm)
