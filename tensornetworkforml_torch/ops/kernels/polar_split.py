"""The polar Newton-Schulz split and its subspace-iteration kernel (K1).

``hybrid_polar_split`` is the canonical split of ``svd_method="polar"``:
plain matrix products for the sketch ``Y0 = B Omega``, the Gram
``G = B B^T`` and ``R = Q^T B``, and one kernel, ``polar_iterate``, for the
serial subspace iteration in between:

    G <- G / n2                 (n2 = |B|_F^2, read off tr G when not given)
    repeat n_power:  y = G @ polar_ns(colnorm(y), loop schedule)
    Q = polar_ns(colnorm(y), final schedule)

``polar_ns`` is the matmul-only polar orthonormalisation with per-pass
minimax odd-quintic coefficients (the greedy Polar Express schedule,
``_pe_schedule``) after a row-sum prescale of ``Y^T Y``. Columns below
``dead_tol`` of the largest column norm become exactly zero and stay zero
through every pass.

On a CUDA tensor ``polar_iterate`` launches the hand-written kernel
``csrc/polar_iterate.cu`` (the counterpart of the JAX package's Pallas
kernel ``polar_iterate_pallas``); on a CPU tensor it runs the plain version
``polar_iterate_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.kernels import _build

# Default greedy schedules: the loop phase only conditions the iterate for
# the power step (E ~ 0.25 from l0 = 1e-3); the final phase runs on the
# G-multiplied iterate, whose spectrum is squared, down to l0 = 1e-7.
_PE_LOOP = (1e-3, 0.25)
_PE_FINAL = (1e-7, 1e-7)
_MAX_PASSES = 64  # coefficient slots of the kernel's parameter block


def _minimax_quintic(lo: float, hi: float):
    """Coefficients ``(a, b, c, E)`` of the odd quintic ``a x + b x^3 + c x^5``
    minimising ``max_{x in [lo, hi]} |f(x) - 1|`` (Lawson's iteratively
    reweighted least squares on a dense grid)."""
    x = np.linspace(lo, hi, 4001)
    A = np.stack([x, x ** 3, x ** 5], axis=1)
    w = np.ones_like(x)
    coef = np.zeros(3)
    for _ in range(400):
        sw = np.sqrt(w / w.sum())
        coef, *_ = np.linalg.lstsq(A * sw[:, None], sw, rcond=None)
        err = np.abs(A @ coef - 1.0)
        w = w * (err + 1e-30)
        w = w / w.max()
    E = float(np.abs(A @ coef - 1.0).max())
    return float(coef[0]), float(coef[1]), float(coef[2]), E


@functools.lru_cache(maxsize=None)
def _pe_schedule(l0: float, e_target: float, max_passes: int = 24):
    """Greedy per-pass minimax schedule: pass k maps its singular-value
    interval ``[lo_k, hi_k]`` onto ``[1 - E_k, 1 + E_k]``, the next pass's
    interval, until ``E_k <= e_target``. Host-side and cached."""
    coeffs = []
    lo, hi = float(l0), 1.0
    for _ in range(max_passes):
        a, b, c, E = _minimax_quintic(lo, hi)
        coeffs.append((a, b, c))
        lo, hi = 1.0 - E, 1.0 + E
        if E <= e_target:
            break
    return tuple(coeffs)


def _colnorm(y: torch.Tensor, dead_tol: float) -> torch.Tensor:
    """Unit-normalise live columns, zero dead ones exactly (a NaN column is
    dead; a NaN anywhere makes the max NaN and every column dead)."""
    n = torch.sqrt((y * y).sum(dim=0, keepdim=True))
    n_max = n.max()
    live = (n > dead_tol * n_max) & torch.isfinite(n)
    return torch.where(live, y / torch.clamp(n, min=1e-30), 0.0)


def _polar_ns_greedy(y: torch.Tensor, coeffs) -> torch.Tensor:
    """Polar orthonormalisation of ``y (I, q)``: prescale by the row-sum
    bound of ``W = Y^T Y`` (>= sigma_max^2), then ``y <- y (a + b W + c W^2)``
    per pass."""
    eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
    w = y.T @ y
    rowsum = w.abs().sum(dim=1).max()
    y = y / torch.sqrt(torch.clamp(rowsum, min=1e-30))
    for a, b, c in coeffs:
        w = y.T @ y
        p = a * eye + b * w + c * (w @ w)
        y = y @ p
    return y


def _schedules(loop_coeffs, final_coeffs):
    if loop_coeffs is None:
        loop_coeffs = _pe_schedule(*_PE_LOOP)
    if final_coeffs is None:
        final_coeffs = _pe_schedule(*_PE_FINAL)
    return tuple(loop_coeffs), tuple(final_coeffs)


def polar_iterate_reference(
    y: torch.Tensor,
    g: torch.Tensor,
    n2: torch.Tensor = None,
    n_power: int = 1,
    loop_coeffs: tuple = None,
    final_coeffs: tuple = None,
    dead_tol: float = 1e-6,
) -> torch.Tensor:
    """Plain version of K1: ``y (I, q)``, ``g (I, I)``, ``n2`` (one element
    or None) -> isometric ``Q (I, q)``; any dtype and device."""
    loop_coeffs, final_coeffs = _schedules(loop_coeffs, final_coeffs)
    bn2 = torch.diagonal(g).sum() if n2 is None else n2.reshape(())
    g = g / torch.clamp(bn2, min=1e-30)
    for _ in range(n_power):
        y = _colnorm(y, dead_tol)
        y = _polar_ns_greedy(y, loop_coeffs)
        y = g @ y
    y = _colnorm(y, dead_tol)
    return _polar_ns_greedy(y, final_coeffs)


class _Coeffs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("c", ctypes.c_float * (3 * _MAX_PASSES))]


@functools.lru_cache(maxsize=None)
def _coeff_block(coeffs: tuple) -> _Coeffs:
    if len(coeffs) > _MAX_PASSES:
        raise ValueError(f"at most {_MAX_PASSES} passes per schedule, got {len(coeffs)}")
    block = _Coeffs()
    block.n = len(coeffs)
    for k, (a, b, c) in enumerate(coeffs):
        block.c[3 * k : 3 * k + 3] = (a, b, c)
    return block


def _lib() -> ctypes.CDLL:
    lib = _build.load("polar_iterate")
    fn = lib.tnml_polar_iterate
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # y (I, q)
            ctypes.c_void_p,  # g (I, I)
            ctypes.c_void_p,  # n2 (1) or NULL: read tr(g)
            ctypes.c_void_p,  # q_out (I, q)
            ctypes.c_void_p,  # scratch
            ctypes.c_int,     # I
            ctypes.c_int,     # q
            ctypes.c_int,     # n_power
            ctypes.POINTER(_Coeffs),  # loop schedule
            ctypes.POINTER(_Coeffs),  # final schedule
            ctypes.c_float,   # dead_tol
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.tnml_polar_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tnml_polar_scratch_floats.restype = ctypes.c_long
        lib.tnml_polar_resident.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tnml_polar_resident.restype = ctypes.c_int
        lib.tnml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def polar_iterate(
    y: torch.Tensor,
    g: torch.Tensor,
    n2: torch.Tensor = None,
    n_power: int = 1,
    loop_coeffs: tuple = None,
    final_coeffs: tuple = None,
    dead_tol: float = 1e-6,
) -> torch.Tensor:
    """The subspace iteration of the polar split: ``y (I, q)``, the UNSCALED
    Gram ``g (I, I)`` and ``n2 = |B|_F^2`` (one element; None reads it off
    ``tr g``) -> isometric ``Q (I, q)``.

    CPU tensors run ``polar_iterate_reference``. CUDA tensors must be
    float32 and contiguous and launch the kernel; each launch adds one to
    ``polar_iterate.launches``.
    """
    tensors = [y, g] + ([] if n2 is None else [n2])
    if all(t.device.type == "cpu" for t in tensors):
        return polar_iterate_reference(y, g, n2, n_power, loop_coeffs, final_coeffs, dead_tol)
    if y.device.type != "cuda" or any(t.device != y.device for t in tensors):
        raise ValueError(
            "polar_iterate takes CPU tensors or CUDA tensors on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the CUDA kernel takes float32, got " + ", ".join(str(t.dtype) for t in tensors)
        )
    if y.dim() != 2 or g.dim() != 2 or g.shape != (y.shape[0], y.shape[0]):
        raise ValueError(f"y must be (I, q) and g (I, I), got {tuple(y.shape)}, {tuple(g.shape)}")
    if n2 is not None and n2.numel() != 1:
        raise ValueError(f"n2 must hold one element, got shape {tuple(n2.shape)}")
    if not (y.is_contiguous() and g.is_contiguous()):
        raise ValueError("y and g must be contiguous")
    if n_power < 0:
        raise ValueError(f"n_power must be >= 0, got {n_power}")
    loop_coeffs, final_coeffs = _schedules(loop_coeffs, final_coeffs)
    loop_block, final_block = _coeff_block(loop_coeffs), _coeff_block(final_coeffs)
    I, q = y.shape
    out = torch.empty((I, q), dtype=torch.float32, device=y.device)
    if I == 0 or q == 0:
        return out
    lib = _lib()
    scratch = torch.empty(
        (lib.tnml_polar_scratch_floats(I, q),), dtype=torch.float32, device=y.device
    )
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.tnml_polar_iterate(
            y.data_ptr(), g.data_ptr(), None if n2 is None else n2.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), I, q, int(n_power),
            ctypes.byref(loop_block), ctypes.byref(final_block),
            float(dead_tol), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"polar_iterate kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    polar_iterate.launches += 1
    return out


polar_iterate.launches = 0


def hybrid_polar_split(bmat: torch.Tensor, rank: int):
    """Canonical split ``bmat (I, J) -> (Q (I, rank) isometric, R = Q^T B)``.

    The sketch, the Gram and ``R`` are plain float32 matrix products; the
    subspace iteration is ``polar_iterate`` (K1 on a card), with ``n2`` read
    off ``tr G``. ``dead_tol`` follows the INPUT dtype (1e-12 for float64),
    as in the JAX package, though the iteration itself runs in float32.
    """
    out_dtype = bmat.dtype
    I, J = bmat.shape
    q_cols = min(rank, I)
    dead_tol = 1e-6 if bmat.dtype != torch.float64 else 1e-12
    b32 = bmat.to(torch.float32)
    om = _svd.rangefinder_omega(J, q_cols, torch.float32, bmat.device)
    y0 = b32 @ om
    g = b32 @ b32.T
    q = polar_iterate(y0, g, dead_tol=dead_tol)
    if q_cols < rank:
        q = torch.cat([q, q.new_zeros((I, rank - q_cols))], dim=1)
    r = q.T @ b32
    return q.to(out_dtype), r.to(out_dtype)
