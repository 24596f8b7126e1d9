"""Truncated split of the two-site tensor: ``bmat (I, J) -> (I, rank) @ (rank, J)``.

The counterpart of the JAX package's ``ops/svd.py``. Methods ported here:

  * ``"svd"``    -- ``torch.linalg.svd``, with the ``keep`` rank cap and the
    adaptive energy mask; ``"shared"`` or ``"canonical"`` gauge.
  * ``"cholqr"`` -- the matmul/Cholesky-only subspace split
    (``batched_cholqr_split``), canonical gauge only.
  * ``"polar"``  -- the polar Newton-Schulz split, canonical gauge only.
    Up to I = 768 rows it is ``ops/kernels/polar_split.py::
    hybrid_polar_split``, whose subspace iteration is the kernel K1 on a
    CUDA tensor; above, ``gramfree_split``, whose two streaming reductions
    over B are the kernels K4a and K4b. The choice goes by shape alone, on
    every device, as the JAX package's goes on its chip.

``gram``, ``cholsvd``, ``rangefinder`` and ``rangefinder_pallas`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools

import torch

_OMEGA_SEED = 0x52464E44  # the seed of the JAX package's fixed sketch matrix
# rows above which the polar split goes gram-free (the JAX package's
# threshold, kept so that both compute the same split at every I)
_GRAMFREE_MIN_I = 768


@functools.lru_cache(maxsize=None)
def rangefinder_omega(J: int, q: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Fixed Gaussian test matrix ``(J, q)``, cached per shape, dtype and device.

    Drawn in float32 from a ``torch.Generator`` seeded like the JAX
    package's key. The two packages' generators give different numbers, so
    a test that compares them hands both the same matrix.
    """
    gen = torch.Generator().manual_seed(_OMEGA_SEED)
    om = torch.randn((J, q), generator=gen, dtype=torch.float32)
    return om.to(dtype=dtype, device=device)


def _not_ported(method: str) -> NotImplementedError:
    return NotImplementedError(
        f"svd_method={method!r} is not ported yet (ROADMAP queue 1 item 3"
        + ("; its kernel K6 is in queue 2)" if method.startswith("rangefinder") else ")")
    )


def truncated_svd_split(
    bmat: torch.Tensor,
    rank: int,
    method: str = "svd",
    keep=None,
    split_mode: str = "shared",
    adaptive_tol: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``bmat (I, J)`` into ``(I, rank) @ (rank, J)``.

    ``split_mode="shared"`` gives ``(U sqrt(S), sqrt(S) V^h)``;
    ``"canonical"`` gives ``(U, S V^h)`` with an isometric left factor.
    ``keep`` (an int) zeroes singular values past the first ``keep``;
    ``adaptive_tol > 0`` zeroes the trailing directions beyond the smallest
    prefix holding ``1 - adaptive_tol`` of the energy (``svd`` only here).
    """
    if adaptive_tol > 0.0:
        if keep is not None:
            raise ValueError("adaptive_tol and keep are mutually exclusive")
        if method not in ("svd", "cholsvd"):
            raise ValueError(
                "adaptive_tol requires a spectrum-producing split method "
                "('svd' or 'cholsvd'), got " + repr(method)
            )
    if method == "svd":
        U, S, Vh = torch.linalg.svd(bmat, full_matrices=False)
        U, S, Vh = U[:, :rank], S[:rank], Vh[:rank, :]
        if keep is not None:
            S = torch.where(torch.arange(rank, device=S.device) < keep, S, 0.0)
        if adaptive_tol > 0.0:
            S = S * _adaptive_energy_mask(S, adaptive_tol)
        S = torch.clamp(S, min=0.0)
        if split_mode == "canonical":
            if keep is not None or adaptive_tol > 0.0:
                # no weight leak into bond slots past the kept rank
                U = U * (S > 0).to(bmat.dtype)[None, :]
            return U, S[:, None] * Vh
        sqrt_s = torch.sqrt(S)
        return U * sqrt_s[None, :], sqrt_s[:, None] * Vh
    if method == "cholqr":
        if split_mode != "canonical":
            raise ValueError("cholqr split requires split_mode='canonical'")
        if keep is not None:
            raise ValueError("cholqr split does not support rank_mode='reference'")
        q, r = batched_cholqr_split(bmat[None], rank)
        return q[0], r[0]
    if method == "polar":
        if split_mode != "canonical":
            raise ValueError("polar split requires split_mode='canonical'")
        if keep is not None:
            raise ValueError("polar split does not support rank_mode='reference'")
        from tensornetworkforml_torch.ops.kernels import polar_split

        # by shape alone, on every device: what the JAX package computes on
        # its chip (its CPU fallback runs the hybrid split at every I)
        if bmat.shape[0] > _GRAMFREE_MIN_I:
            return polar_split.gramfree_split(bmat, rank)
        return polar_split.hybrid_polar_split(bmat, rank)
    if method in ("gram", "cholsvd", "rangefinder", "rangefinder_pallas"):
        raise _not_ported(method)
    raise ValueError(f"unknown SVD method {method!r}")


def _adaptive_energy_mask(S: torch.Tensor, adaptive_tol: float) -> torch.Tensor:
    """Keep position i iff the energy strictly before it is still below
    ``(1 - adaptive_tol)`` of the total (energies in float32, as in JAX)."""
    e = S.to(torch.float32) ** 2
    total = e.sum()
    prev = torch.cumsum(e, 0) - e
    return (prev < (1.0 - adaptive_tol) * total).to(S.dtype)


def _cholqr_eps(dtype, q_cols: int) -> float:
    """Cholesky ridge of the cholqr splits: grows with the column count, so
    that the roundoff of the unit-diagonal Gram never makes a pivot negative."""
    if dtype == torch.float64:
        return max(1e-12, 8.0 * q_cols * 2.22e-16)
    return max(1e-5, 8.0 * q_cols * 1.19e-7)


def batched_cholqr_split(bmats: torch.Tensor, rank: int, n_power: int = 3, eps: float = None):
    """Batched canonical splits with no qr/eigh/svd: a Gaussian sketch at
    ``rank`` columns, CholQR-orthonormalised power iterations on the Gram,
    and a final CholQR2 pass. ``bmats (K, I, J)`` -> ``(Q (K, I, q),
    Q^T B (K, q, J))`` with ``q = min(rank, I)``."""
    out_dtype = bmats.dtype
    if out_dtype == torch.bfloat16:
        bmats = bmats.to(torch.float32)
    _, I, J = bmats.shape
    if eps is None:
        eps = _cholqr_eps(bmats.dtype, min(rank, I))
    bn = torch.clamp(torch.sqrt((bmats * bmats).sum(dim=(-2, -1), keepdim=True)), min=1e-30)
    bs = bmats / bn
    om = rangefinder_omega(J, min(rank, I), bmats.dtype, bmats.device)
    y = torch.einsum("kij,jq->kiq", bs, om)
    g = torch.einsum("kij,klj->kil", bs, bs)
    q = _cholqr_subspace(g, y, eps, n_power)
    r = torch.einsum("kim,kij->kmj", q, bmats)
    return q.to(out_dtype), r.to(out_dtype)


def _cholqr_subspace(g, y, eps, n_power: int):
    """Power iterations of ``g (K, I, I)`` on ``y (K, I, q)``, each iterate
    column-normalised (dead columns to exactly zero) then CholQR'd with the
    ``eps`` ridge, finished by CholQR2. Returns the isometric ``(K, I, q)``."""
    dead_tol = 1e-6 if y.dtype != torch.float64 else 1e-12
    ee = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)

    def colnorm(y):
        n = torch.linalg.vector_norm(y, dim=-2, keepdim=True)
        n_max = n.amax(dim=-1, keepdim=True)
        live = (n > dead_tol * n_max) & torch.isfinite(n)
        return torch.where(live, y / torch.clamp(n, min=1e-30), 0.0)

    def cholqr(y):
        w = torch.einsum("kiq,kip->kqp", y, y)
        scale = torch.clamp(torch.diagonal(w, dim1=-2, dim2=-1).amax(dim=-1), min=1e-30)
        # cholesky_ex: no host synchronisation to check the factorisation
        c, _ = torch.linalg.cholesky_ex(w + (eps * scale)[:, None, None] * ee)
        # X C^T = Y  ->  X = Y C^{-T}
        return torch.linalg.solve_triangular(c.mT, y, upper=True, left=False)

    for _ in range(n_power):
        y = cholqr(colnorm(y))
        y = torch.einsum("kil,klq->kiq", g, y)
    return cholqr(cholqr(colnorm(y)))
