"""The polar Newton-Schulz splits and their kernels (K1, K4a, K4b, K5, K8).

``hybrid_polar_split`` is the canonical split of ``svd_method="polar"`` up
to I = 768 rows: plain matrix products for the sketch ``Y0 = B Omega``, the
Gram ``G = B B^T`` and ``R = Q^T B``, and one kernel, ``polar_iterate``, for
the serial subspace iteration in between:

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

``gramfree_split`` is the split above I = 768: no ``(I, I)`` Gram, since
``G y = B (B^T y)``. Two streaming reductions over B's columns,
``gramfree_sketch`` (K4a: ``y0 = B Omega`` and ``n2``) and ``gramfree_gmul``
(K4b: ``z = B (B^T y1)``), with the polar orthonormalisations (or CholQR2)
as plain products in between. ``polar_split_two_stage`` is the split as
``polar_sketch_gram`` (K5: ``y``, ``G`` and ``n2`` in one pass over B)
followed by K1. The three reductions are ``csrc/polar_sketch.cu`` on a card
(all three on the tensor cores in 3xTF32, ``csrc/tc_gemm.cuh``; K5's G from
its upper triangle of tiles, mirrored, so exactly symmetric) and their
``*_reference`` plain versions on the CPU.

``polar_split`` is the all-in-one split (K8, the counterpart of the JAX
package's ``polar_split_pallas``): the sketch, the Gram and ``n2`` in one pass
over B, then ``n_power`` rounds of the iteration, as one C entry on a card
(``tnml_polar_split`` in ``csrc/polar_iterate.cu``: K5's two launches, then
K1's, chained by programmatic dependent launch, the scratch's parts on
256-byte boundaries), and ``polar_split_reference`` on the CPU;
``R = Q^T B`` is a plain float32 product. No sweep reaches it; its split is the
one inside K7 (``ops/kernels/step_kernel.py``, ``engine="fused"``).
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
# the gram-free split's final schedule: at q = 512 the row-sum prescale
# overestimates sigma_max by up to sqrt(q) ~ 23, so the deepest kept
# directions of the squared spectrum start near 4e-8
_PE_FINAL_GRAMFREE = (1e-8, 1e-7)
_MAX_PASSES = 64  # coefficient slots of the kernel's parameter block
# the split methods' products all run in float32 here, apart from K4a, K4b
# and K5, which run in 3xTF32 on the tensor cores (within about ten times
# float32's error); a reduced precision for the rest is an open numerics
# decision
_FULL_F32 = ("default", "highest")


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
        lib.tnml_polar_cluster.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tnml_polar_cluster.restype = ctypes.c_int
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


def _canonical_factors(q: torch.Tensor, rank: int, b32: torch.Tensor, out_dtype):
    """``(Q, R = Q^T B)`` in ``out_dtype``, with ``Q (I, q_cols)`` padded by
    zero columns to ``rank`` when the split had fewer rows than ``rank``."""
    if q.shape[1] < rank:
        q = torch.cat([q, q.new_zeros((q.shape[0], rank - q.shape[1]))], dim=1)
    r = q.T @ b32
    return q.to(out_dtype), r.to(out_dtype)


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
    return _canonical_factors(q, rank, b32, out_dtype)


# ---- the J-streaming reductions: K4a, K4b and K5 ----------------------------

def gramfree_sketch_reference(bmat: torch.Tensor, om: torch.Tensor):
    """Plain version of K4a: ``bmat (I, J)``, ``om (J, q)`` -> ``(y0 = B om
    (I, q), n2 = |B|_F^2 (1, 1))``; any dtype and device."""
    return bmat @ om, (bmat * bmat).sum().reshape(1, 1)


def gramfree_gmul_reference(bmat: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """Plain version of K4b: ``z = B (B^T y1)``, ``(I, q)``."""
    return bmat @ (bmat.T @ y1)


def polar_sketch_gram_reference(bmat: torch.Tensor, om: torch.Tensor):
    """Plain version of K5: ``(y = B om (I, q), G = B B^T (I, I), n2 = |B|_F^2
    (1, 1))``."""
    return bmat @ om, bmat @ bmat.T, (bmat * bmat).sum().reshape(1, 1)


def _sketch_lib() -> ctypes.CDLL:
    lib = _build.load("polar_sketch")
    if lib.tnml_gramfree_sketch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # pointers (inputs, outputs, scratch), then I, J, q, then the stream
        lib.tnml_gramfree_sketch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.tnml_sketch_gram.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.tnml_gramfree_gmul.argtypes = [p, p, p, p, i, i, i, p]
        for fn in (lib.tnml_gramfree_sketch, lib.tnml_sketch_gram, lib.tnml_gramfree_gmul):
            fn.restype = ctypes.c_int
        for fn in (lib.tnml_sketch_scratch_floats, lib.tnml_gramfree_sketch_scratch_floats,
                   lib.tnml_gmul_scratch_floats):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_long
        lib.tnml_cuda_error_string.argtypes = [i]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_card(name: str, bmat: torch.Tensor, other: torch.Tensor, rows: int) -> bool:
    """False for CPU tensors (the caller runs the plain version); True for
    what the kernel takes: CUDA float32, contiguous, ``bmat (I, J)`` and
    ``other (rows, q)``, none of I, J and q zero. Raises on anything else."""
    if bmat.device.type == "cpu" and other.device.type == "cpu":
        return False
    if bmat.device.type != "cuda" or other.device != bmat.device:
        raise ValueError(
            f"{name} takes CPU tensors or CUDA tensors on one device, got "
            f"{bmat.device}, {other.device}"
        )
    if bmat.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {bmat.dtype}, {other.dtype}")
    if bmat.dim() != 2 or other.dim() != 2 or other.shape[0] != bmat.shape[rows]:
        raise ValueError(
            f"{name}: bmat must be (I, J) and its partner ({'IJ'[rows]}, q), got "
            f"{tuple(bmat.shape)}, {tuple(other.shape)}"
        )
    if 0 in bmat.shape or other.shape[1] == 0:
        raise ValueError(f"{name}: the kernel takes no empty dimension, got "
                         f"{tuple(bmat.shape)}, {tuple(other.shape)}")
    if not (bmat.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{name}: the inputs must be contiguous")
    return True


def _run(name: str, bmat: torch.Tensor, launch) -> None:
    lib = _sketch_lib()
    if bmat.device.index == torch.cuda.current_device():
        err = launch(lib, torch.cuda.current_stream(bmat.device).cuda_stream)
    else:
        with torch.cuda.device(bmat.device):
            err = launch(lib, torch.cuda.current_stream(bmat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel failed: cudaError {err} ({lib.tnml_cuda_error_string(err).decode()})"
        )


def _scratch(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((n,), dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _scratch_floats(fn: str, I: int, J: int, q: int) -> int:
    """Scratch floats of one of ``polar_sketch.cu``'s entries at a shape."""
    return getattr(_sketch_lib(), fn)(I, J, q)


def gramfree_sketch(bmat: torch.Tensor, om: torch.Tensor):
    """K4a: ``y0 = B om (I, q)`` and ``n2 = |B|_F^2 (1, 1)`` in one pass over
    ``bmat (I, J)``. On the card every product runs on the tensor cores in
    3xTF32 (``csrc/tc_gemm.cuh``), within about ten times float32's error.

    CPU tensors run ``gramfree_sketch_reference``. CUDA tensors must be
    float32 and contiguous and launch the kernel; each launch adds one to
    ``gramfree_sketch.launches``.
    """
    if not _on_card("gramfree_sketch", bmat, om, 1):
        return gramfree_sketch_reference(bmat, om)
    (I, J), q = bmat.shape, om.shape[1]
    y0 = torch.empty((I, q), dtype=torch.float32, device=bmat.device)
    n2 = torch.empty((1, 1), dtype=torch.float32, device=bmat.device)
    scratch = _scratch(_scratch_floats("tnml_gramfree_sketch_scratch_floats", I, J, q), bmat)
    _run("gramfree_sketch", bmat, lambda lib, stream: lib.tnml_gramfree_sketch(
        bmat.data_ptr(), om.data_ptr(), y0.data_ptr(), n2.data_ptr(), scratch.data_ptr(),
        I, J, q, stream))
    gramfree_sketch.launches += 1
    return y0, n2


def gramfree_gmul(bmat: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """K4b: ``z = B (B^T y1)``, ``(I, q)``, with no ``(I, I)`` Gram.

    CPU tensors run ``gramfree_gmul_reference``. CUDA tensors must be float32
    and contiguous and launch the kernel (``t^T = y1^T B``, then ``z = B t``,
    each on the tensor cores in 3xTF32, each followed by a fixed-order sum
    where its k range is split); each call adds one to
    ``gramfree_gmul.launches``.
    """
    if not _on_card("gramfree_gmul", bmat, y1, 0):
        return gramfree_gmul_reference(bmat, y1)
    (I, J), q = bmat.shape, y1.shape[1]
    z = torch.empty((I, q), dtype=torch.float32, device=bmat.device)
    scratch = _scratch(_scratch_floats("tnml_gmul_scratch_floats", I, J, q), bmat)
    _run("gramfree_gmul", bmat, lambda lib, stream: lib.tnml_gramfree_gmul(
        bmat.data_ptr(), y1.data_ptr(), z.data_ptr(), scratch.data_ptr(), I, J, q, stream))
    gramfree_gmul.launches += 1
    return z


def polar_sketch_gram(bmat: torch.Tensor, om: torch.Tensor):
    """K5: ``y = B om (I, q)``, ``G = B B^T (I, I)`` and ``n2 = |B|_F^2
    (1, 1)`` in one pass over ``bmat (I, J)``. On the card the products run
    on the tensor cores in 3xTF32 (``csrc/tc_gemm.cuh``), within about ten
    times float32's error, and G is exactly symmetric.

    CPU tensors run ``polar_sketch_gram_reference``. CUDA tensors must be
    float32 and contiguous and launch the kernel; each launch adds one to
    ``polar_sketch_gram.launches``.
    """
    if not _on_card("polar_sketch_gram", bmat, om, 1):
        return polar_sketch_gram_reference(bmat, om)
    (I, J), q = bmat.shape, om.shape[1]
    # y, G and n2 in one allocation
    y, g, n2 = _scratch(I * q + I * I + 1, bmat).split([I * q, I * I, 1])
    y, g, n2 = y.view(I, q), g.view(I, I), n2.view(1, 1)
    scratch = _scratch(_scratch_floats("tnml_sketch_scratch_floats", I, J, q), bmat)
    _run("polar_sketch_gram", bmat, lambda lib, stream: lib.tnml_sketch_gram(
        bmat.data_ptr(), om.data_ptr(), y.data_ptr(), g.data_ptr(), n2.data_ptr(),
        scratch.data_ptr(), I, J, q, stream))
    polar_sketch_gram.launches += 1
    return y, g, n2


gramfree_sketch.launches = 0
gramfree_gmul.launches = 0
polar_sketch_gram.launches = 0


# ---- the large-bond splits -----------------------------------------------------

def _full_f32(name: str, value: str) -> None:
    if value in _FULL_F32:
        return
    if value == "high":
        raise NotImplementedError(
            f"{name}='high' (3-pass bf16 products on the TPU) is not ported: whether "
            "TF32 or 3xTF32 may stand in for it on the card is an open numerics "
            "decision (ROADMAP queue 1 item 9); 'default' and 'highest' both mean "
            "full float32 here"
        )
    raise ValueError(f"unknown {name} {value!r}; expected one of {_FULL_F32} or 'high'")


def _polish(q: torch.Tensor) -> torch.Tensor:
    """One CholQR pass at a 1e-6 floor ridge: ``Q^T Q = I + O(eps)`` here, so
    the ridge only keeps exactly-dead columns factorable."""
    eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
    c, _ = torch.linalg.cholesky_ex(q.T @ q + 1e-6 * eye)
    return torch.linalg.solve_triangular(c.mT, q, upper=True, left=False)


def gramfree_split(
    bmat: torch.Tensor,
    rank: int,
    precision: str = "default",
    orth: str = "ns",
    ns_prec: str = "highest",
):
    """Large-bond canonical split ``bmat (I, J) -> (Q (I, rank) isometric,
    R = Q^T B)`` with no ``(I, I)`` Gram: ``G y = B (B^T y)``.

        y0, n2 = B Omega, |B|_F^2                      (K4a)
        y1 = orth_first(y0 / sqrt(n2))
        z  = B (B^T y1)                                (K4b)
        Q  = orth_final(z / n2)                         (n2: overflow safety)

    ``orth="ns"`` orthonormalises by polar Newton-Schulz: ``colnorm`` then the
    loop schedule, and ``colnorm`` then the ``(1e-8, 1e-7)`` final schedule.
    ``orth="cholqr"`` uses CholQR2 with the q-scaled ridge and a 1e-6 polish
    for both. The orthonormalisations and ``R`` are plain float32 products.
    ``precision`` and ``ns_prec`` take "default" or "highest", which both mean
    full float32 here; "high" raises. ``dead_tol`` is 1e-6 and the split runs
    in float32 whatever the input dtype, as in the JAX package.
    """
    _full_f32("precision", precision)
    _full_f32("ns_prec", ns_prec)
    I, J = bmat.shape
    q_cols = min(rank, I)
    dead_tol = 1e-6
    if orth == "ns":
        loop_s, final_s = _pe_schedule(*_PE_LOOP), _pe_schedule(*_PE_FINAL_GRAMFREE)

        def orth_first(y):
            return _polar_ns_greedy(_colnorm(y, dead_tol), loop_s)

        def orth_final(z):
            return _polar_ns_greedy(_colnorm(z, dead_tol), final_s)

    elif orth == "cholqr":
        eps = _svd._cholqr_eps(torch.float32, q_cols)

        def orth_first(y):
            return _polish(_svd._cholqr_subspace(None, y[None], eps, 0)[0])

        orth_final = orth_first
    else:
        raise ValueError(f"unknown orth {orth!r}")
    out_dtype = bmat.dtype
    b32 = bmat.to(torch.float32).contiguous()
    om = _svd.rangefinder_omega(J, q_cols, torch.float32, bmat.device).contiguous()
    y0, n2 = gramfree_sketch(b32, om)
    n2 = torch.clamp(n2.reshape(()), min=1e-30)
    y1 = orth_first(y0 / torch.sqrt(n2))
    q = orth_final(gramfree_gmul(b32, y1.contiguous()) / n2)
    return _canonical_factors(q, rank, b32, out_dtype)


def polar_split_two_stage(
    bmat: torch.Tensor,
    rank: int,
    n_power: int = 1,
    loop_coeffs: tuple = None,
    final_coeffs: tuple = None,
):
    """Canonical split as two kernels: ``polar_sketch_gram`` (K5) for the
    sketch, the Gram and ``n2``, then ``polar_iterate`` (K1) with that ``n2``;
    ``R = Q^T B`` is a plain float32 product. The contract of
    ``hybrid_polar_split``; ``dead_tol`` follows the input dtype.
    """
    I, J = bmat.shape
    q_cols = min(rank, I)
    out_dtype = bmat.dtype
    dead_tol = 1e-6 if bmat.dtype != torch.float64 else 1e-12
    b32 = bmat.to(torch.float32).contiguous()
    om = _svd.rangefinder_omega(J, q_cols, torch.float32, bmat.device).contiguous()
    y, g, n2 = polar_sketch_gram(b32, om)
    q = polar_iterate(y, g, n2, n_power, loop_coeffs, final_coeffs, dead_tol)
    return _canonical_factors(q, rank, b32, out_dtype)


# ---- the all-in-one split: K8 -------------------------------------------------

def _tile_j(I: int, J: int, max_bytes: int = 2 ** 21):
    """The JAX package's J-tiling of ``polar_split_pallas``: ``(nc, tj, pad)``
    with ``nc * tj = J + pad``, chunks a multiple of 128 columns, at most 2048
    and at most ``max_bytes`` of float32 per ``(I, tj)`` block. The tiling
    itself was a Mosaic limit; here it decides only ``pad``, the extra rows
    at which Omega is drawn (of which the split uses the first J)."""
    tj_cap = min(2048, max(128, 128 * ((max_bytes // 4 // max(I, 1)) // 128)))
    nc = max(1, -(-J // tj_cap))
    tj = 128 * (-(-J // (nc * 128)))
    return nc, tj, nc * tj - J


def _split_inputs(bmat: torch.Tensor, rank: int):
    """What both versions of the split take: ``(b32, om (J, q_cols),
    q_cols, dead_tol)``, Omega drawn at the padded length of the JAX tiling
    through ``ops.svd.rangefinder_omega``."""
    I, J = bmat.shape
    q_cols = min(rank, I)
    dead_tol = 1e-6 if bmat.dtype != torch.float64 else 1e-12
    b32 = bmat.to(torch.float32)
    pad = _tile_j(I, J)[2]
    om = _svd.rangefinder_omega(J + pad, q_cols, torch.float32, bmat.device)[:J]
    return b32, om, q_cols, dead_tol


def polar_split_reference(
    bmat: torch.Tensor,
    rank: int,
    n_power: int = 1,
    loop_coeffs: tuple = None,
    final_coeffs: tuple = None,
):
    """Plain version of ``polar_split``; any device."""
    out_dtype = bmat.dtype
    b32, om, _, dead_tol = _split_inputs(bmat, rank)
    n2 = (b32 * b32).sum()
    q = polar_iterate_reference(b32 @ om, b32 @ b32.T, n2, n_power, loop_coeffs, final_coeffs,
                                dead_tol)
    return _canonical_factors(q, rank, b32, out_dtype)


def _split_lib() -> ctypes.CDLL:
    """K8's entry, which lives in K1's library (``csrc/polar_iterate.cu``)."""
    lib = _lib()
    fn = lib.tnml_polar_split
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # b, om, q_out, scratch; I, J, q, n_power; the schedules; dead_tol, stream
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.POINTER(_Coeffs),
                       ctypes.POINTER(_Coeffs), ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.tnml_polar_split_scratch_floats.argtypes = [i, i, i]
        lib.tnml_polar_split_scratch_floats.restype = ctypes.c_long
    return lib


_LAYOUT_PARTS = ("y", "G", "n2", "K5 n2 partials", "K5 y partials", "K5 G partials",
                 "K1 scratch", "floats")


def split_scratch_layout(I: int, J: int, q: int) -> dict:
    """K8's scratch layout at ``(I, J, q)`` as the library lays it out: the
    offset in floats of each part (y, G, n2, K5's partial sums of squares and
    partial tiles of y and G, K1's scratch) and the total, ``floats``."""
    fn = _split_lib().tnml_polar_split_layout
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_long * len(_LAYOUT_PARTS))()
    n = fn(I, J, q, out)
    return dict(zip(_LAYOUT_PARTS[:n], out[:n]))


def polar_split(
    bmat: torch.Tensor,
    rank: int,
    n_power: int = 1,
    loop_coeffs: tuple = None,
    final_coeffs: tuple = None,
):
    """Canonical split ``bmat (I, J) -> (Q (I, rank) isometric, R = Q^T B)``,
    the all-in-one polar split (K8):

        y, G, n2 = B Omega, B B^T, |B|_F^2        (n2 accumulated, not tr G)
        G <- G / n2;  n_power times: y = G polar_ns(colnorm(y), loop schedule)
        Q = polar_ns(colnorm(y), final schedule);  R = Q^T B

    Omega is ``ops.svd.rangefinder_omega(J + pad, q_cols)[:J]`` with ``pad``
    from the JAX package's J-tiling, ``q_cols = min(rank, I)``, and Q is padded
    with zero columns up to ``rank``. ``dead_tol`` is 1e-6 (1e-12 for float64
    input); the split runs in float32 and returns the input's dtype.

    CPU tensors run ``polar_split_reference``. CUDA tensors must be float32 and
    contiguous and launch the kernel (the sketch and Gram tiles, their
    fixed-order sum, then the iteration: three chained launches); each call
    adds one to ``polar_split.launches``.
    """
    if bmat.device.type == "cpu":
        return polar_split_reference(bmat, rank, n_power, loop_coeffs, final_coeffs)
    if bmat.device.type != "cuda":
        raise ValueError(f"polar_split takes a CPU or a CUDA tensor, got {bmat.device}")
    if bmat.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {bmat.dtype}")
    if bmat.dim() != 2 or 0 in bmat.shape or rank < 1:
        raise ValueError(f"polar_split takes a non-empty (I, J) matrix and rank >= 1, got "
                         f"{tuple(bmat.shape)}, rank {rank}")
    if not bmat.is_contiguous():
        raise ValueError("polar_split takes a contiguous matrix")
    if n_power < 0:
        raise ValueError(f"n_power must be >= 0, got {n_power}")
    loop_coeffs, final_coeffs = _schedules(loop_coeffs, final_coeffs)
    loop_block, final_block = _coeff_block(loop_coeffs), _coeff_block(final_coeffs)
    b32, om, q_cols, dead_tol = _split_inputs(bmat, rank)
    om = om.contiguous()
    I, J = bmat.shape
    q = torch.empty((I, q_cols), dtype=torch.float32, device=bmat.device)
    lib = _split_lib()
    scratch = _scratch(lib.tnml_polar_split_scratch_floats(I, J, q_cols), bmat)
    with torch.cuda.device(bmat.device):
        err = lib.tnml_polar_split(
            b32.data_ptr(), om.data_ptr(), q.data_ptr(), scratch.data_ptr(), I, J, q_cols,
            int(n_power), ctypes.byref(loop_block), ctypes.byref(final_block), float(dead_tol),
            torch.cuda.current_stream(bmat.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"polar_split kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    polar_split.launches += 1
    return _canonical_factors(q, rank, b32, bmat.dtype)


polar_split.launches = 0
