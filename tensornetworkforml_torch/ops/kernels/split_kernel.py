"""The rangefinder split as one kernel (K6).

``rangefinder_split`` is the canonical split of ``svd_method="rangefinder"``
from I = 128 rows, and of ``"rangefinder_pallas"`` at every I. Its
arithmetic, all in float32 whatever the input dtype:

    bs = B / (|B|_F + 1e-30)
    y  = bs Omega   (I, q),   G = bs bs^T   (I, I)      q = min(rank + oversample, I)
    repeat n_iter:  y = G hqr_orth(colnorm(y))        (hqr every `mid_orth` iterations)
    Q  = hqr_orth(colnorm(y))[:, :rank];   R = Q^T B   (the unscaled B)

``colnorm`` divides each column by ``max(|col|, 1e-30)``, with no dead-column
mask: a zero column stays zero, and ``hqr_orth`` then gives the unit vector
``e_j`` in its slot. ``hqr_orth`` is a Householder QR with one reflector per
column and Q accumulated by applying the reflectors in reverse to the
``(I, q)`` identity; a column whose reflector vector has ``|v|^2 <= 1e-30``
gets the identity reflector.

On a CUDA tensor ``rangefinder_split`` launches the hand-written kernel
``csrc/rangefinder_split.cu`` (the counterpart of the JAX package's Pallas
kernel ``rangefinder_split_pallas``): the subspace iteration runs on one
cluster of 16 CTAs as a blocked Householder QR, which re-associates the
reflectors of ``hqr_orth`` (the same function, float32 rounding apart), and
takes I up to the rows its panels can be factored in
(``tnml_rangefinder_max_rows``, 2048). On a CPU tensor it runs the plain
version ``rangefinder_split_plain``. The JAX module's ``_ns_orth`` (a
Newton-Schulz orthonormalisation) is never called there and has no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.kernels import _build
from tensornetworkforml_torch.utils.precision import full_float32

_EPS = 1e-30


def hqr_orth(y: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Householder orthonormalisation of ``y (I, q)``, ``q <= I`` -> ``Q (I, q)``.

    Plain version of the JAX package's ``_hqr_orth``: reflector j zeroes
    rows below j of column j, with ``alpha = -sign(x_j + eps) |x|`` (sign(0)
    is 0) and ``beta = 2 / |v|^2``, or ``beta = 0`` (the identity) when
    ``|v|^2 <= eps``; Q is the product of the reflectors applied to the
    ``(I, q)`` identity. Works in the dtype of ``y``.
    """
    I, q = y.shape
    if q > I:
        raise ValueError(f"hqr_orth needs q <= I, got {tuple(y.shape)}")
    a = y.clone()
    vs, bvs = [], []
    for j in range(q):
        v = a[j:, j].clone()
        # v_j = x_j - alpha with alpha = -sign(x_j + eps) |x|
        v[0] += torch.sign(v[0] + eps) * torch.sqrt(torch.dot(v, v))
        vn2 = torch.dot(v, v)
        bv = torch.where(vn2 > eps, 2.0 / torch.clamp(vn2, min=eps), 0.0) * v
        # a -= (beta v) (v^T a); columns left of j are never read again
        blk = a[j:, j + 1:]
        blk.addr_(bv, v @ blk, alpha=-1.0)
        vs.append(v)
        bvs.append(bv)
    qacc = torch.eye(I, q, dtype=y.dtype, device=y.device)
    for j in range(q - 1, -1, -1):
        blk = qacc[j:, j:]
        blk.addr_(bvs[j], vs[j] @ blk, alpha=-1.0)
    return qacc


@full_float32
def rangefinder_split_plain(
    bmat: torch.Tensor, rank: int, oversample: int = 8, n_iter: int = 6, mid_orth: int = 1,
):
    """Plain version of K6: ``bmat (I, J)`` -> ``(Q (I, rank), R = Q^T B
    (rank, J))`` in ``bmat``'s dtype, computed in float32 on ``bmat``'s
    device (the module docstring has the algorithm)."""
    I, J = bmat.shape
    q_cols = min(rank + oversample, I)
    b = bmat.to(torch.float32)
    om = _svd.rangefinder_omega(J, q_cols, torch.float32, bmat.device)
    bs = b / (torch.sqrt((b * b).sum()) + _EPS)
    y = bs @ om
    g = bs @ bs.T
    for it in range(n_iter):
        y = _svd._colnorm(y)
        if mid_orth and (it + 1) % mid_orth == 0:
            y = hqr_orth(y)
        y = g @ y
    q = hqr_orth(_svd._colnorm(y))[:, :rank]
    return q.to(bmat.dtype), (q.T @ b).to(bmat.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rangefinder_split")
    fn = lib.tnml_rangefinder_split
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # b, omega, q_out, r_out, scratch, then I, J, q, rank, n_iter,
        # mid_orth, then the stream
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.tnml_rangefinder_scratch_floats.argtypes = [i, i, i]
        lib.tnml_rangefinder_scratch_floats.restype = ctypes.c_long
        lib.tnml_rangefinder_resident.argtypes = [i, i]
        lib.tnml_rangefinder_resident.restype = ctypes.c_int
        lib.tnml_rangefinder_max_rows.argtypes = []
        lib.tnml_rangefinder_max_rows.restype = ctypes.c_int
        lib.tnml_cuda_error_string.argtypes = [i]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rangefinder_split(
    bmat: torch.Tensor, rank: int, oversample: int = 8, n_iter: int = 6, mid_orth: int = 1,
):
    """K6: the canonical rangefinder split ``bmat (I, J)`` -> ``(Q (I, rank)
    isometric, R = Q^T B (rank, J))`` in ``bmat``'s dtype, with the sketch
    ``ops.svd.rangefinder_omega(J, min(rank + oversample, I))``.

    CPU tensors run ``rangefinder_split_plain``. CUDA tensors (float32 or
    float64; the kernel computes in float32) launch the kernel; each call
    adds one to ``rangefinder_split.launches``.
    """
    if bmat.device.type == "cpu":
        return rangefinder_split_plain(bmat, rank, oversample, n_iter, mid_orth)
    if bmat.device.type != "cuda":
        raise ValueError(f"rangefinder_split takes CPU or CUDA tensors, got {bmat.device}")
    if bmat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, got {bmat.dtype}")
    if bmat.dim() != 2 or 0 in bmat.shape:
        raise ValueError(f"bmat must be a non-empty (I, J) matrix, got {tuple(bmat.shape)}")
    I, J = bmat.shape
    if not 1 <= rank <= min(I, J):
        raise ValueError(f"rank must be in [1, min(I, J)] = [1, {min(I, J)}], got {rank}")
    if n_iter < 0 or mid_orth < 0 or oversample < 0:
        raise ValueError(f"n_iter, mid_orth and oversample must be >= 0, got "
                         f"{n_iter}, {mid_orth}, {oversample}")
    lib = _lib()
    if I > lib.tnml_rangefinder_max_rows():
        raise ValueError(f"the CUDA kernel takes at most {lib.tnml_rangefinder_max_rows()} rows "
                         f"(its panels are factored in registers), got I = {I}")
    q_cols = min(rank + oversample, I)
    b32 = bmat.to(torch.float32).contiguous()
    om = _svd.rangefinder_omega(J, q_cols, torch.float32, bmat.device).contiguous()
    q = torch.empty((I, rank), dtype=torch.float32, device=bmat.device)
    r = torch.empty((rank, J), dtype=torch.float32, device=bmat.device)
    scratch = torch.empty((lib.tnml_rangefinder_scratch_floats(I, J, q_cols),),
                          dtype=torch.float32, device=bmat.device)
    with torch.cuda.device(bmat.device):
        stream = torch.cuda.current_stream(bmat.device).cuda_stream
        err = lib.tnml_rangefinder_split(
            b32.data_ptr(), om.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(),
            I, J, q_cols, rank, int(n_iter), int(mid_orth), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rangefinder_split kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    rangefinder_split.launches += 1
    return q.to(bmat.dtype), r.to(bmat.dtype)


rangefinder_split.launches = 0
