"""Truncated split of the two-site tensor: ``bmat (I, J) -> (I, rank) @ (rank, J)``.

The counterpart of the JAX package's ``ops/svd.py``; every method is ported:

  * ``"svd"``     -- ``torch.linalg.svd``, with the ``keep`` rank cap and the
    adaptive energy mask; ``"shared"`` or ``"canonical"`` gauge.
  * ``"gram"``    -- ``eigh`` of the smaller Gram matrix (tall matrices
    recurse on the transpose in the shared gauge), with two Newton-Schulz
    steps on U in the canonical gauge.
  * ``"cholsvd"`` -- SVD of the Cholesky factor of ``B B^T`` (trace-scaled
    jitter), with ``keep`` and the adaptive energy mask.
  * ``"cholqr"``  -- the matmul/Cholesky-only subspace split
    (``batched_cholqr_split``), canonical gauge only.
  * ``"polar"``   -- the polar Newton-Schulz split, canonical gauge only.
    Up to I = 768 rows it is ``ops/kernels/polar_split.py::
    hybrid_polar_split``, whose subspace iteration is the kernel K1 on a
    CUDA tensor; above, ``gramfree_split``, whose two streaming reductions
    over B are the kernels K4a and K4b.
  * ``"rangefinder"`` -- the randomized rangefinder split, canonical gauge
    only: from I = 128 to 2048 rows ``ops/kernels/split_kernel.py::
    rangefinder_split`` (the kernel K6 on a CUDA tensor), at other I
    ``_rangefinder_split`` (sketch, QR, Rayleigh-Ritz, one polish), as the
    JAX package sends what its kernel does not take to its own.
  * ``"rangefinder_pallas"`` -- ``rangefinder_split`` at every I (on a CUDA
    tensor above 2048 rows it raises).

The polar and rangefinder choices go by shape alone, on every device, as the
JAX package's go on its chip. Its CPU fallback differs: there ``polar`` runs
the hybrid split at every I, and both rangefinder methods run
``_rangefinder_split`` at every I.
"""

from __future__ import annotations

import functools

import torch

_OMEGA_SEED = 0x52464E44  # the seed of the JAX package's fixed sketch matrix
# rows above which the polar split goes gram-free, and from which the
# rangefinder split runs K6 (the JAX package's thresholds, kept so that both
# compute the same split at every I); above _RANGEFINDER_KERNEL_MAX_I, the
# rows K6 factors its panels in (tnml_rangefinder_max_rows), it runs
# _rangefinder_split, on every device
_GRAMFREE_MIN_I = 768
_RANGEFINDER_KERNEL_MIN_I = 128
_RANGEFINDER_KERNEL_MAX_I = 2048


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
    if method == "gram":
        return _gram_split(bmat, rank, keep, split_mode)
    if method == "cholsvd":
        return _chol_svd_split(bmat, rank, keep, split_mode, adaptive_tol)
    if method in ("rangefinder", "rangefinder_pallas"):
        if split_mode != "canonical":
            raise ValueError("rangefinder split requires split_mode='canonical'")
        if keep is not None:
            raise ValueError("rangefinder split does not support rank_mode='reference'")
        from tensornetworkforml_torch.ops.kernels import split_kernel

        I = bmat.shape[0]
        if method == "rangefinder_pallas" or (
                _RANGEFINDER_KERNEL_MIN_I <= I <= _RANGEFINDER_KERNEL_MAX_I):
            return split_kernel.rangefinder_split(bmat, rank)
        return _rangefinder_split(bmat, rank, keep, split_mode)
    raise ValueError(f"unknown SVD method {method!r}")


def _adaptive_energy_mask(S: torch.Tensor, adaptive_tol: float) -> torch.Tensor:
    """Keep position i iff the energy strictly before it is still below
    ``(1 - adaptive_tol)`` of the total (energies in float32, as in JAX)."""
    e = S.to(torch.float32) ** 2
    total = e.sum()
    prev = torch.cumsum(e, 0) - e
    return (prev < (1.0 - adaptive_tol) * total).to(S.dtype)


def _colnorm(y: torch.Tensor) -> torch.Tensor:
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=0, keepdim=True), min=1e-30)


def _rangefinder_split(
    bmat: torch.Tensor, rank: int, keep=None, split_mode: str = "canonical",
    n_power: int = 0, oversample: int = 16, n_polish: int = 1,
):
    """Randomized rangefinder split ``(Q, Q^T B)``, canonical gauge only:
    ``Q (I, rank)`` is an exact isometry spanning (approximately) the top
    ``rank`` row space of B. The Frobenius-prescaled matrix is sketched with
    ``q = min(rank + oversample, I)`` Gaussian columns, orthonormalised by QR
    (``n_power`` optional power iterations), rotated onto its top ``rank``
    Ritz vectors by ``eigh`` of the projected Gram, and polished by
    ``n_polish`` QR-orthonormalised iterations on ``bs bs^T``."""
    if split_mode != "canonical":
        raise ValueError("rangefinder split requires split_mode='canonical'")
    if keep is not None:
        raise ValueError("rangefinder split does not support rank_mode='reference'")
    I, J = bmat.shape
    q_cols = min(rank + oversample, I)
    bs = bmat / torch.clamp(torch.linalg.norm(bmat), min=1e-30)
    y = bs @ rangefinder_omega(J, q_cols, bmat.dtype, bmat.device)
    y, _ = torch.linalg.qr(_colnorm(y))
    for _ in range(n_power):
        y, _ = torch.linalg.qr(_colnorm(bs @ (bs.T @ y)))
    if q_cols > rank:
        z = bs.T @ y
        _, evecs = torch.linalg.eigh(z.T @ z)  # ascending
        y = y @ evecs.flip(1)[:, :rank]
    q = y
    for _ in range(n_polish):
        q, _ = torch.linalg.qr(_colnorm(bs @ (bs.T @ q)))
    return q, q.T @ bmat


def _chol_svd_split(
    bmat: torch.Tensor, rank: int, keep=None, split_mode: str = "shared",
    adaptive_tol: float = 0.0,
):
    """Split via the SVD of the Cholesky factor ``C`` of ``B B^T + jitter``:
    ``svd(C)`` gives B's left singular vectors and values from a square
    ``(I, I)`` problem. The jitter is ``eps * max(diag(B B^T))`` with eps 1e-6
    in float32 and 1e-13 in float64; a factorisation that fails gives NaN,
    as JAX's does. Wide matrices only (``I <= J``)."""
    I, J = bmat.shape
    if I > J:
        raise ValueError(f"cholsvd split expects a wide matrix, got {I} x {J}")
    gram = bmat @ bmat.T
    gram = 0.5 * (gram + gram.T)
    eps = 1e-6 if bmat.dtype != torch.float64 else 1e-13
    scale = torch.diagonal(gram).max() + 1e-30
    eye = torch.eye(I, dtype=bmat.dtype, device=bmat.device)
    C, info = torch.linalg.cholesky_ex(gram + (eps * scale) * eye)
    C = torch.where(info == 0, C, float("nan"))
    U, S, _ = torch.linalg.svd(C, full_matrices=False)
    U, S = U[:, :rank], S[:rank]
    if keep is not None:
        S = torch.where(torch.arange(rank, device=S.device) < keep, S, 0.0)
    if adaptive_tol > 0.0:
        S = S * _adaptive_energy_mask(S, adaptive_tol)
    if split_mode == "canonical":
        svh = U.T @ bmat
        if keep is not None or adaptive_tol > 0.0:
            mask = (S > 0).to(bmat.dtype)
            svh = svh * mask[:, None]
            U = U * mask[None, :]  # no weight leak past the kept rank
        return U, svh
    sqrt_s = torch.sqrt(torch.clamp(S, min=0.0))
    inv_sqrt = torch.where(S > 0, 1.0 / torch.clamp(sqrt_s, min=1e-30), 0.0)
    return U * sqrt_s[None, :], inv_sqrt[:, None] * (U.T @ bmat)


def _gram_split(bmat: torch.Tensor, rank: int, keep=None, split_mode: str = "shared"):
    """Split via ``eigh`` of the smaller Gram matrix. A tall matrix recurses
    on its transpose (shared gauge only: the canonical gauge is left-sided).
    In the canonical gauge two Newton-Schulz steps restore U's isometry,
    which the squared spectrum costs in float32."""
    I, J = bmat.shape
    if I > J:
        if split_mode != "shared":
            raise ValueError(f"canonical gram split expects a wide matrix, got {I} x {J}")
        right, left = _gram_split(bmat.T, rank, keep, split_mode)
        return left.T, right.T
    evals, evecs = torch.linalg.eigh(bmat @ bmat.T)  # ascending
    evals = evals.flip(0)[:rank]
    U = evecs.flip(1)[:, :rank]
    if keep is not None:
        evals = torch.where(torch.arange(rank, device=evals.device) < keep, evals, 0.0)
    S = torch.sqrt(torch.clamp(evals, min=0.0))
    if split_mode == "canonical":
        for _ in range(2):
            U = 1.5 * U - 0.5 * U @ (U.T @ U)
        svh = U.T @ bmat
        if keep is not None:
            mask = (S > 0).to(bmat.dtype)
            svh = svh * mask[:, None]
            U = U * mask[None, :]
        return U, svh
    inv = torch.where(S > 0, 1.0 / torch.clamp(S, min=1e-30), 0.0)
    svh = (torch.sqrt(S) * inv)[:, None] * (U.T @ bmat)
    return U * torch.sqrt(S)[None, :], svh


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
