"""Factored two-site update: the large-bond step that never forms ``B_new``.

The counterpart of the JAX package's ``train/factored_step.py``, with the
same algebra. The updated two-site tensor is a sum of two structured terms,

    B_new = c_t * B_t + c_g * grad
    B_t[i, o, j]  = label3[i, o, k] A2m[k, j]      (the merge)
    grad[i, o, j] = Lmat[b, i] w_t[b, o, j]        (an outer product over the batch)

with ``i = (a, d1)`` the row leg (I = M*D), ``o`` the label leg, ``j = (d2,
c)`` the column leg (J' = D*M), ``c_t = 1 - lr*gamma*wd`` and ``c_g =
lr*gamma`` after the L1 clip. Every consumer of ``B_new`` is linear in it:
the Gram ``G = B_new B_new^T`` (only ``(I, I)``), the sketch ``Y0 = B_new
Omega``, the new core ``R = Q^T B_new`` and the new output ``f_new`` all
come from the factors, so the split (one power iteration with polar
Newton-Schulz orthonormalisation, the ``gramfree_split`` contract) runs
without ``(I, L*J')``. Only the clip statistics ``sum|B_t|`` and
``sum|deltaB|`` (and ``sum|B_new|`` under ``growth_cap``) look at the full
two-site tensor.

Everything here is plain torch products in full float32, or float64 for a
float64 model. The JAX package runs its iteration at ``Precision.HIGH``
(3-pass bf16) in float32; whether TF32 or 3xTF32 may stand in for that on
the card is an open decision, and no kernel runs here.
"""

from __future__ import annotations

import torch

from tensornetworkforml_torch.models.mps import apply_act_fn, loss_derivative
from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.kernels.polar_split import (
    _PE_FINAL,
    _PE_LOOP,
    _colnorm,
    _pe_schedule,
    _polar_ns_greedy,
)

# Shortened greedy Polar Express schedules for the large-bond path: loop
# (3e-3, 0.3) = 4 passes and final (1e-6, 1e-7) = 12 passes, at q >= 512
# only. At small q the colnormed iterate spreads wider and l0 = 1e-6
# under-converges, so the standard pair stays in force below q = 512.
_PE_LOOP_F = (3e-3, 0.3)
_PE_FINAL_F = (1e-6, 1e-7)


def _iterate(y0, g, n2, dead_tol, n_power: int = 1):
    """The subspace iteration of ``polar_iterate`` (colnorm -> loop NS -> G
    multiply, then colnorm -> final NS) as plain products, with the
    ``_PE_*_F`` schedules at q >= 512."""
    big = y0.shape[1] >= 512
    loop_s = _pe_schedule(*(_PE_LOOP_F if big else _PE_LOOP))
    final_s = _pe_schedule(*(_PE_FINAL_F if big else _PE_FINAL))
    g = g / torch.clamp(n2, min=1e-30)
    y = y0
    for _ in range(n_power):
        y = _colnorm(y, dead_tol)
        y = _polar_ns_greedy(y, loop_s)
        y = g @ y
    y = _colnorm(y, dead_tol)
    return _polar_ns_greedy(y, final_s)


def factored_supported(cfg, M: int, D: int) -> bool:
    """True when the factored path implements cfg's exact semantics."""
    return (
        not cfg.L2_flag
        and cfg.split_mode == "canonical"
        and cfg.svd_method == "polar"
        and cfg.rank_mode == "fixed"
        and cfg.dist_split == "none"
    )


def two_site_update_factored(
    label_site, A2, x1, x2, l_env, r_env, y_onehot, f, lr, weight_dec, T: float, cfg,
):
    """Drop-in replacement for the large-M ``two_site_update`` body.

    Returns ``(A_left, label_new, l_env_new, f_new, metrics)``; the caller
    keeps the unchanged ``E2`` (L2 is unsupported here).
    """
    M, D, L, _ = label_site.shape
    I = M * D
    Jp = D * M  # the (d2, c) column leg; the full J is L * Jp
    dtype, dev = label_site.dtype, label_site.device

    label3 = label_site.reshape(I, L, M)
    A2m = A2.reshape(M, Jp)

    # metrics on the CURRENT output (pre-update), reference discipline
    f_act = apply_act_fn(f, cfg.act_fn, T)
    zero = torch.zeros((), dtype=dtype, device=dev)
    if cfg.step_metrics:
        acc = (f_act.argmax(dim=0) == y_onehot.argmax(dim=0)).to(dtype).mean()
        mae = (y_onehot - f_act).abs().mean()
    else:
        acc = mae = zero

    loss_der = loss_derivative(f_act, y_onehot, cfg.loss_fn, cfg.act_fn, T)
    Lmat = (l_env[:, :, None] * x1[:, None, :]).reshape(-1, I)  # (B, I)
    rp = (x2[:, :, None] * r_env[:, None, :]).reshape(-1, Jp)  # (B, J')
    w_t = loss_der.T[:, :, None] * rp[:, None, :]  # (B, L, J')

    # ---- clip statistics: the only work over the full (I, L, J') tensor ----
    B_t = torch.einsum("iok,kj->ioj", label3, A2m)
    grad = torch.einsum("bi,boj->ioj", Lmat, w_t)
    delta = grad - weight_dec * B_t
    s_B = B_t.abs().sum()
    s_dB = delta.abs().sum()

    if cfg.update_mode == "normalized":
        gamma = torch.where(s_dB > 0, s_B / torch.clamp(s_dB, min=1e-30), 0.0)
    else:  # L1 clip (Network_class.py:753-757)
        gamma = torch.where(s_dB > s_B, s_B / s_dB, 1.0)
    step = lr * gamma
    # B_new = B_t + step*(grad - wd*B_t) = c_t*B_t + c_g*grad
    c_t = 1.0 - step * weight_dec
    c_g = step

    if cfg.growth_cap > 0:
        s_new = (B_t + step * delta).abs().sum()
        cap = (1.0 + cfg.growth_cap) * s_B
        g2 = torch.where(s_new > cap, cap / torch.clamp(s_new, min=1e-30), 1.0)
        c_t = c_t * g2
        c_g = c_g * g2
    del B_t, grad, delta

    # ---- the Gram G = B_new B_new^T from the factors, (I, I) -----------------
    GA = A2m @ A2m.T  # (M, M)
    T5 = torch.einsum("iok,km->iom", label3, GA)
    G_tt = torch.einsum("iom,jom->ij", T5, label3)
    T4 = torch.einsum("boj,kj->bok", w_t, A2m)
    P3 = torch.einsum("iok,bok->ib", label3, T4)  # the B_t grad^T factor
    G_x = P3 @ Lmat
    W2 = torch.einsum("boj,coj->bc", w_t, w_t)
    G_gg = Lmat.T @ (W2 @ Lmat)
    gram = c_t * c_t * G_tt + (c_t * c_g) * (G_x + G_x.T) + c_g * c_g * G_gg
    n2_new = torch.diagonal(gram).sum()

    # ---- the sketch Y0 = B_new Omega from the factors -----------------------
    q_cols = min(M, I)
    om = _svd.rangefinder_omega(L * Jp, q_cols, torch.float32, dev).to(dtype).reshape(
        L, Jp, q_cols)
    av = torch.einsum("kj,ojm->okm", A2m, om)
    y_t = torch.einsum("iok,okm->im", label3, av)
    wom = torch.einsum("boj,ojm->bm", w_t, om)
    y0 = c_t * y_t + c_g * (Lmat.T @ wom)

    # the iteration: float32 at least, float64 honoured
    it_dt = torch.float64 if dtype == torch.float64 else torch.float32
    dead_tol = 1e-6 if it_dt != torch.float64 else 1e-12
    q = _iterate(y0.to(it_dt), gram.to(it_dt), n2_new.to(it_dt), dead_tol).to(dtype)
    if q_cols < M:
        q = torch.cat([q, q.new_zeros((I, M - q_cols))], dim=1)

    # R = Q^T B_new -> the new label core (M, L, J')
    qlab = torch.einsum("iok,im->mok", label3, q)
    r_t = torch.einsum("mok,kj->moj", qlab, A2m)
    qL = Lmat @ q  # (B, m)
    r_g = torch.einsum("bm,boj->moj", qL, w_t)
    r = c_t * r_t + c_g * r_g

    A_left = q.reshape(M, D, M)
    label_new = r.reshape(M, L, D, M).permute(0, 2, 1, 3)

    # ---- the new output: carried-f identity + (B, B) Gram forms -------------
    C1 = Lmat @ Lmat.T  # (B, B)
    D2 = torch.einsum("boj,cj->obc", w_t, rp)  # (L, B, B)
    f_grad = torch.einsum("cb,obc->oc", C1, D2)
    f_new = c_t * f + c_g * f_grad

    l_env_new = qL  # == Lmat @ q, already formed for R

    if cfg.renorm_envs:
        gn = 1.0 / torch.clamp(torch.linalg.vector_norm(l_env_new, dim=1).mean(), min=1e-30)
        A_left = A_left * gn
        l_env_new = l_env_new * gn
        label_new = label_new / gn

    if cfg.step_metrics:
        metrics = {
            "accuracy": acc,
            "MAE": mae,
            "sum_abs_B": s_B,
            "sum_abs_deltaB": s_dB,
            "mean_abs_f": f.abs().mean(),
            "L2_loss": zero,
            "sum_abs_L2_grad": weight_dec * s_B,
        }
    else:
        metrics = {k: zero for k in (
            "accuracy", "MAE", "sum_abs_B", "sum_abs_deltaB", "mean_abs_f",
            "L2_loss", "sum_abs_L2_grad",
        )}
    return A_left, label_new, l_env_new, f_new, metrics
