"""Linear-probe initialisation: warm-start an MPS at an additive model.

The counterpart of the JAX package's ``models/probe_init.py``. An additive
model is argmax-exactly representable by an MPS with this feature map: with
the per-site carrier ``u(x) = psi_1(x) + psi_2(x) > 0`` and the normalized
features ``pt = psi / u``, a carrier + per-class-accumulator chain of bond
dimension L+1 computes

    f_o(x) = [prod_j u(x_j)] * sum_i W[o, i] . pt_i(x_i)

The bracket is a common positive factor across classes, so argmax(f) is the
argmax of the linear probe on the ``pt`` features, exactly.

``probe_init`` fits a ridge probe on the ``pt`` features (closed-form normal
equations in float64, in numpy) and embeds it in the padded-M layout with
the label leg at the right end (``l_pos = N - 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from tensornetworkforml_torch.models.mps import MPS, resolve_device


def _psi(x_raw) -> np.ndarray:
    """The psi embedding in float64 numpy: ``(B, N)`` -> ``(B, N, 2)``."""
    half = (np.pi / 2.0) * np.asarray(x_raw, dtype=np.float64)
    return np.stack([np.sin(half), np.cos(half)], axis=-1)


def fit_linear_probe(x_raw: np.ndarray, y: np.ndarray, L: int, ridge: float = 1e-4):
    """Closed-form multiclass ridge on the carrier-normalized features.

    ``x_raw (B, N)`` raw pixels in [0, 1]; returns ``(W (L, N, D),
    train_acc)`` where scores are ``sum_i W[o, i] . pt_i``.
    """
    phi = _psi(x_raw)
    pt = phi / phi.sum(axis=-1, keepdims=True)  # sin + cos >= 1 > 0
    B, N, D = pt.shape
    X = pt.reshape(B, N * D)
    Y = np.eye(L)[np.asarray(y)]  # (B, L)
    G = X.T @ X + ridge * B * np.eye(N * D)
    W = np.linalg.solve(G, X.T @ Y)  # (N*D, L)
    acc = float(np.mean((X @ W).argmax(1) == np.asarray(y)))
    return W.T.reshape(L, N, D), acc


def probe_scores(W: np.ndarray, x_raw: np.ndarray) -> np.ndarray:
    """Linear-probe scores ``(L, B)`` on raw pixels."""
    phi = _psi(x_raw)
    pt = phi / phi.sum(axis=-1, keepdims=True)
    return np.einsum("lnd,bnd->lb", W, pt)


def probe_init(
    x_cal: np.ndarray,
    y_cal: np.ndarray,
    M: int,
    L: int,
    ridge: float = 1e-4,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    T: float = 0.1,
    dtype=torch.float32,
    device=None,
):
    """An MPS whose argmax equals the fitted linear probe's, exactly, and the
    probe's training accuracy: ``(mps, train_acc)``.

    Needs ``M >= L + 1`` (carrier + one accumulator per class). The label leg
    sits at ``l_pos = N - 1``, so training starts with a left sweep. Bond
    slot 0 is the carrier, slots 1..L the class accumulators; each site is
    divided by ``c_i``, the calibration-data mean of ``u . psi_i``, so the
    common product factor stays O(1) at any chain length. ``device=None`` is
    the card (``resolve_device``).
    """
    if M < L + 1:
        raise ValueError(f"probe_init needs M >= L+1 (got M={M}, L={L})")
    device = resolve_device(device)
    x_cal = np.asarray(x_cal, dtype=np.float64)
    N = x_cal.shape[1]
    D = 2
    W, train_acc = fit_linear_probe(x_cal, y_cal, L, ridge)
    c = _psi(x_cal).sum(axis=-1).mean(axis=0)  # (N,) mean carrier per site

    sites = np.zeros((N, M, D, M), dtype=np.float64)
    u = np.ones(D)
    for i in range(N - 1):
        sites[i, 0, :, 0] = u / c[i]
        for o in range(L):
            sites[i, 0, :, 1 + o] = W[o, i] / c[i]
            sites[i, 1 + o, :, 1 + o] = u / c[i]
    # sites[N-1] stays the zero slot (the label sits there)

    label = np.zeros((M, D, L, M), dtype=np.float64)
    for o in range(L):
        label[0, :, o, 0] = W[o, N - 1]
        label[1 + o, :, o, 0] = u
    mps = MPS(
        torch.tensor(sites, dtype=dtype, device=device),
        torch.tensor(label, dtype=dtype, device=device),
        l_pos=N - 1,
        act_fn=act_fn,
        loss_fn=loss_fn,
        T=T,
    )
    return mps, train_acc
