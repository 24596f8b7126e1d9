"""The plain reference of the MPS classifier: scores and two-site sweeps.

Plain torch, in any dtype (the benchmark runs it in float64), on any device.
It imports nothing of the program under test and takes nothing the program
made: the weights and inputs come from the benchmark's generator, and
whatever the program draws for itself (the fixed sketch matrix Omega) is
drawn again here.

The sweep is the reference algorithm of arXiv:1605.05775 as the port
implements it (``train/sweep.py::two_site_update``, written out again for
the configurations the benchmark runs: linear activation, MSE loss, plain
weight decay, the L1 clip, the canonical split). The splits are written out
again from the port's plain versions:

* ``polar_split``: the sketch ``Y0 = B Omega``, the Gram ``G = B B^T``, one
  power step and a final orthonormalisation by the greedy minimax
  Newton-Schulz schedule (``ops/kernels/polar_split.py``), dead columns
  (below 1e-6 of the largest norm, the float32 configuration's tolerance)
  exactly zero, then ``R = Q^T B``;
* ``rangefinder_split``: Omega at ``rank + 8`` columns, six products with the
  scaled Gram, each iterate column-normalised and orthonormalised by a
  Householder QR (LAPACK's here: the same reflectors as the port's
  ``hqr_orth``), the first ``rank`` columns kept, ``R = Q^T B``
  (``ops/kernels/split_kernel.py``).

``tf32=True`` rounds both operands of every product outside the splits to
TF32 (10 explicit mantissa bits), as cuBLAS does when TF32 is allowed: the
lower-precision control of a float32 configuration.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

OMEGA_SEED = 0x52464E44
POLAR_LOOP = (1e-3, 0.25)
POLAR_FINAL = (1e-7, 1e-7)
DEAD_TOL = 1e-6
RF_OVERSAMPLE, RF_ITERS = 8, 6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (ties away from zero
    on the dropped 13 bits), kept in float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"TF32 rounding takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _op(x: torch.Tensor, low: bool) -> torch.Tensor:
    return tf32(x) if low else x


def psi(x: torch.Tensor) -> torch.Tensor:
    h = (math.pi / 2.0) * x
    return torch.stack([torch.sin(h), torch.cos(h)], dim=-1)


def scores(sites: torch.Tensor, label: torch.Tensor, x: torch.Tensor, dtype=torch.float64,
           block: int = 8192, low: bool = False) -> torch.Tensor:
    """Class scores ``(n, L)`` of raw pixels ``x (n, N)`` for the label at site
    0, computed in ``dtype`` in blocks of ``block`` rows."""
    s, lab = sites.to(dtype), label.to(dtype)
    N, M = s.shape[0], s.shape[1]
    out = []
    for lo in range(0, x.shape[0], block):
        phi = psi(x[lo:lo + block].to(dtype))
        B = phi.shape[0]
        v = torch.zeros((B, M), dtype=dtype, device=s.device)
        v[:, 0] = 1.0
        for n in range(N - 1, 0, -1):
            w = torch.einsum("bd,br->bdr", phi[:, n], v).reshape(B, -1)
            v = _op(w, low) @ _op(s[n].reshape(M, -1), low).T
        y = torch.einsum("bd,dor->bor", phi[:, 0], lab[0])
        out.append(torch.einsum("bor,br->bo", _op(y, low), _op(v, low)))
    return torch.cat(out)


# ---- the splits ---------------------------------------------------------------

def _minimax_quintic(lo: float, hi: float):
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
    return float(coef[0]), float(coef[1]), float(coef[2]), float(np.abs(A @ coef - 1.0).max())


@functools.lru_cache(maxsize=None)
def pe_schedule(l0: float, e_target: float, max_passes: int = 24):
    """Greedy per-pass minimax quintic coefficients from ``[l0, 1]`` down to
    an error of ``e_target``."""
    coeffs, lo, hi = [], float(l0), 1.0
    for _ in range(max_passes):
        a, b, c, E = _minimax_quintic(lo, hi)
        coeffs.append((a, b, c))
        lo, hi = 1.0 - E, 1.0 + E
        if E <= e_target:
            break
    return tuple(coeffs)


@functools.lru_cache(maxsize=None)
def _omega_cpu(J: int, q: int) -> torch.Tensor:
    return torch.randn((J, q), generator=torch.Generator().manual_seed(OMEGA_SEED),
                       dtype=torch.float32)


def omega(J: int, q: int, dtype, device) -> torch.Tensor:
    """The fixed Gaussian sketch ``(J, q)``: drawn in float32 on the CPU from
    the program's fixed seed, then converted."""
    return _omega_cpu(J, q).to(dtype=dtype, device=device)


def _colnorm_dead(y, dead_tol):
    n = torch.sqrt((y * y).sum(dim=0, keepdim=True))
    live = (n > dead_tol * n.max()) & torch.isfinite(n)
    return torch.where(live, y / torch.clamp(n, min=1e-30), 0.0)


def _polar_ns(y, coeffs):
    eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
    w = y.T @ y
    y = y / torch.sqrt(torch.clamp(w.abs().sum(dim=1).max(), min=1e-30))
    for a, b, c in coeffs:
        w = y.T @ y
        y = y @ (a * eye + b * w + c * (w @ w))
    return y


def polar_split(bmat: torch.Tensor, rank: int):
    """``(Q (I, rank), R = Q^T B)`` by the polar split with one power step."""
    I, J = bmat.shape
    q_cols = min(rank, I)
    y = bmat @ omega(J, q_cols, bmat.dtype, bmat.device)
    g = bmat @ bmat.T
    g = g / torch.clamp(torch.diagonal(g).sum(), min=1e-30)
    y = g @ _polar_ns(_colnorm_dead(y, DEAD_TOL), pe_schedule(*POLAR_LOOP))
    q = _polar_ns(_colnorm_dead(y, DEAD_TOL), pe_schedule(*POLAR_FINAL))
    if q.shape[1] < rank:
        q = torch.cat([q, q.new_zeros((I, rank - q.shape[1]))], dim=1)
    return q, q.T @ bmat


def _colnorm(y):
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=0, keepdim=True), min=1e-30)


def rangefinder_split(bmat: torch.Tensor, rank: int):
    """``(Q (I, rank), R = Q^T B)`` by the rangefinder split."""
    I, J = bmat.shape
    q_cols = min(rank + RF_OVERSAMPLE, I)
    bs = bmat / (torch.sqrt((bmat * bmat).sum()) + 1e-30)
    y = bs @ omega(J, q_cols, bmat.dtype, bmat.device)
    g = bs @ bs.T
    for _ in range(RF_ITERS):
        y = g @ torch.linalg.qr(_colnorm(y))[0]
    q = torch.linalg.qr(_colnorm(y))[0][:, :rank]
    return q, q.T @ bmat


SPLITS = {"polar": polar_split, "rangefinder": rangefinder_split}


# ---- the sweep ------------------------------------------------------------------

def _right_sweep(sites, label, phi, y1h, lr, wd, split, low):
    """One right sweep; returns ``(sites', label' at N-1, MAE per step)``."""
    N, M, D, _ = sites.shape
    L = label.shape[2]
    B = phi.shape[0]
    dtype, dev = sites.dtype, sites.device
    phi_t = phi.transpose(0, 1)
    e0 = torch.zeros((M,), dtype=dtype, device=dev)
    e0[0] = 1.0
    r_envs = [None] * (N + 1)
    v = e0.expand(B, M)
    r_envs[N] = v
    for n in range(N - 1, 0, -1):
        w = torch.einsum("bd,br->bdr", phi_t[n], v).reshape(B, D * M)
        v = _op(w, low) @ _op(sites[n].reshape(M, D * M), low).T
        r_envs[n] = v
    y0 = torch.einsum("bd,dor->bor", phi_t[0], label[0])
    f = torch.einsum("bor,br->ob", _op(y0, low), _op(r_envs[1], low))
    split_fn = SPLITS[split]
    l_env, lab, lefts, maes = e0.expand(B, M), label, [], []
    for step in range(N - 1):
        a2, x1, x2, r_env = sites[step + 1], phi_t[step], phi_t[step + 1], r_envs[step + 2]
        bt = (_op(lab.reshape(M * D * L, M), low) @ _op(a2.reshape(M, D * M), low)
              ).reshape(M, D, L, D, M)
        loss_der = y1h - f
        maes.append((y1h - f).abs().mean())
        left_part = (l_env[:, :, None] * x1[:, None, :]).reshape(B, M * D)
        right_part = (x2[:, :, None] * r_env[:, None, :]).reshape(B, D * M)
        w = (loss_der.T[:, :, None] * right_part[:, None, :]).reshape(B, L * D * M)
        db = (_op(left_part, low).T @ _op(w, low)).reshape(M, D, L, D, M) - wd * bt
        s_b, s_db = bt.abs().sum(), db.abs().sum()
        db = db * torch.where(s_db > s_b, s_b / s_db, 1.0)
        bnew = (bt + lr * db).reshape(M * D, L * D * M)
        v = (_op(left_part, low) @ _op(bnew, low)).reshape(B, L, D * M)
        f = (v * right_part[:, None, :]).sum(dim=2).T
        q, r = split_fn(bnew, M)
        lefts.append(q.reshape(M, D, M))
        lab = r.reshape(M, L, D, M).permute(0, 2, 1, 3)
        l_env = _op(left_part, low) @ _op(q, low)
    new_sites = torch.cat([torch.stack(lefts), torch.zeros((1, M, D, M), dtype=dtype, device=dev)])
    return new_sites, lab, torch.stack(maes)


def _mirror_sites(s):
    return s.flip(0).permute(0, 3, 2, 1)


def _mirror_label(lab):
    return lab.permute(3, 1, 2, 0)


def epoch(sites, label, x_epoch, y_epoch, lr, wd, split, dtype=torch.float64, low=False):
    """One epoch: a right sweep on even batches, the mirrored left sweep on
    odd ones, from the label at site 0 back to site 0. ``x_epoch (nb, B, N)``
    raw pixels, ``y_epoch (nb, B)`` integer labels. Returns ``(sites, label, MAE (nb, N - 1))``, the
    MAE of each step's output before its update."""
    L = label.shape[2]
    s, lab = sites.to(dtype), label.to(dtype)
    maes = []
    for b in range(x_epoch.shape[0]):
        phi = psi(x_epoch[b].to(dtype))
        y1h = torch.nn.functional.one_hot(y_epoch[b].long(), L).T.to(dtype)
        if b % 2 == 0:
            s, lab, m = _right_sweep(s, lab, phi, y1h, lr, wd, split, low)
        else:
            ms, ml, m = _right_sweep(_mirror_sites(s), _mirror_label(lab), phi.flip(1), y1h,
                                     lr, wd, split, low)
            s, lab = _mirror_sites(ms), _mirror_label(ml)
        maes.append(m)
    return s.contiguous(), lab.contiguous(), torch.stack(maes)
