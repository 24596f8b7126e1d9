"""One-site DMRG sweeps for the boundary-label MPS: no truncated split.

The counterpart of the JAX package's ``train/onesite.py``, with the same
semantics. Each site of the boundary-label family (``models/boundary.py``)
is updated in place and the orthogonality center moves by an exact reduced
QR (the rank never exceeds M, so nothing is truncated).

The environments ahead of the moving center are stale (computed once per
batch; those sites are untouched during the sweep); the environment behind
it is carried and extended with each just-updated, isometric site. The
environments ahead carry the label leg (they close on ``w``): ``(B, M, L)``.
The output projection ``w`` is updated once per sweep from the full-chain
environment.

The JAX sweep is a ``lax.scan`` with ``jnp.where`` on the last (first)
index; here it is a Python loop that branches on that index. No TPU kernel
lies on this path in the JAX package, and none runs here.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from tensornetworkforml_torch.models.boundary import (
    BoundaryMPS,
    boundary_forward,
    boundary_right_envs,
    right_label_step,
)
from tensornetworkforml_torch.models.mps import apply_act_fn, loss_derivative
from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    env_apply_site,
    left_env_final_fused,
    left_env_stack_fused,
)
from tensornetworkforml_torch.train.sweep import one_hot_labels
from tensornetworkforml_torch.train.trainer import _as_phi, _loader_batches
from tensornetworkforml_torch.utils.checkpoint import (
    load_boundary_training_state,
    save_boundary_training_state,
)

_FULL_F32 = ("default", "float32", "highest")


class OneSiteConfig(NamedTuple):
    """The fields and defaults of the JAX package's ``OneSiteConfig``."""

    act_fn: str = "linear"
    loss_fn: str = "MSE"
    update_w: bool = True
    # scaled-isometry gauge: fold a per-step scale into each site so the
    # carried environment keeps unit mean norm and the QR factor stays O(1).
    # Needed for chains past N ~ 500 in float32; it changes the effective
    # step size, so it stays off for short chains.
    renorm: bool = False
    # every product runs in full float32 ("default", "float32", "highest");
    # reduced precision raises (ROADMAP queue 1 item 9)
    matmul_precision: str = "default"


def check_precision(matmul_precision: str) -> None:
    """Raise for a reduced-precision ``matmul_precision``: the port runs every
    product of these trainers in full float32."""
    if matmul_precision not in _FULL_F32:
        raise NotImplementedError(
            f"matmul_precision={matmul_precision!r}: the port runs every product in "
            f"full float32 ({', '.join(_FULL_F32)}); reduced precision (TF32 or "
            "3xTF32) is an open decision (ROADMAP queue 1 item 9)"
        )


def clip_to(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Scale ``t`` down so that ``sum|t| <= sum|ref|`` (the reference's L1
    clip), as a tensor ``where``: no host synchronisation."""
    s_ref, s_t = ref.abs().sum(), t.abs().sum()
    return t * torch.where(s_t > s_ref, s_ref / torch.clamp(s_t, min=1e-30), 1.0)


def batch_metrics(f_act: torch.Tensor, y_onehot: torch.Tensor) -> dict:
    y_true = torch.argmax(y_onehot, dim=0)
    acc = (torch.argmax(f_act, dim=0) == y_true).to(f_act.dtype).mean()
    return {"accuracy": acc, "MAE": (y_onehot - f_act).abs().mean()}


def w_step(l_full, w, y_onehot, lr, weight_dec, cfg, T, dp=None) -> torch.Tensor:
    """The once-per-sweep update of the output projection from the full-chain
    left environment ``l_full (B, M)``: analytic gradient, L1 clip, ascent.
    With ``dp`` (a ``parallel.mesh.DataShards``) ``l_full`` and ``y_onehot``
    are this rank's rows and the gradient is summed over the data ranks."""
    f_act = apply_act_fn((l_full @ w).T, cfg.act_fn, T)
    loss_der = loss_derivative(f_act, y_onehot, cfg.loss_fn, cfg.act_fn, T)
    grad = torch.einsum("ob,br->ro", loss_der, l_full)
    if dp is not None:
        (grad,) = dp.sum(grad)
    dw = grad - weight_dec * w
    return w + lr * clip_to(dw, w)


def _site_update(A, x, l_env, r_envL, y_onehot, f, lr, weight_dec, T, cfg):
    """Gradient-update one site given its environments.

    ``A (M,D,M)``, ``x (B,D)``, ``l_env (B,M)``, ``r_envL (B,M,L)``; ``f (L,B)``
    is the current network output. Returns ``(A_new, metrics)``.
    """
    f_act = apply_act_fn(f, cfg.act_fn, T)
    metrics = batch_metrics(f_act, y_onehot)
    loss_der = loss_derivative(f_act, y_onehot, cfg.loss_fn, cfg.act_fn, T)
    # dA[le,d,ri] = sum_{b,o} loss_der[o,b] l_env[b,le] x[b,d] r_envL[b,ri,o]
    u = torch.einsum("ob,bro->br", loss_der, r_envL)  # (B, M)
    lx = torch.einsum("bl,bd->bld", l_env, x)
    dA = torch.einsum("bld,br->ldr", lx, u) - weight_dec * A
    return A + lr * clip_to(dA, A), metrics


def _scores(l_env, x, A, r_envL) -> torch.Tensor:
    """``f[o,b] = sum l_env[b,l] x[b,d] A[l,d,r] r_envL[b,r,o]``."""
    return torch.einsum("br,bro->ob", env_apply_site(l_env, x, A), r_envL)


def _stack_metrics(steps: list) -> dict:
    return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}


def _sweep_right(sites, w, phi, y_onehot, lr, weight_dec, T, cfg):
    """Center moves 0 -> N-1; sites end left-isometric except the last."""
    N, M, D, _ = sites.shape
    B = phi.shape[0]
    dtype, dev = sites.dtype, sites.device
    e0 = boundary_vector(M, dtype=dtype, device=dev)
    phi_t = phi.transpose(0, 1)  # (N, B, D)
    R_all = boundary_right_envs(sites, w, phi_t)  # stale, with the label leg
    eye = torch.eye(M, dtype=dtype, device=dev)

    l_env, Rf = e0.expand(B, M), eye
    new_sites, steps = [], []
    for n in range(N):
        x, r_envL = phi_t[n], R_all[n]
        A = torch.einsum("lk,kdr->ldr", Rf, sites[n])  # absorb the carried R
        A_new, metrics = _site_update(A, x, l_env, r_envL, y_onehot,
                                      _scores(l_env, x, A, r_envL), lr, weight_dec, T, cfg)
        steps.append(metrics)
        if n == N - 1:  # the last site keeps the center
            new_sites.append(A_new)
            l_env = env_apply_site(l_env, x, A_new)
            break
        # exact center move: reduced QR over the (le, d) rows, the scale
        # folded into the site as a scaled isometry (A = g Q, carry R / g)
        q, r = torch.linalg.qr(A_new.reshape(M * D, M))
        q = q.reshape(M, D, M)
        env_q = env_apply_site(l_env, x, q)
        if cfg.renorm:
            g = 1.0 / torch.clamp(torch.linalg.vector_norm(env_q, dim=1).mean(), min=1e-30)
        else:
            g = torch.ones((), dtype=dtype, device=dev)
        new_sites.append(g * q)
        Rf = r / g
        l_env = env_q * g

    if cfg.update_w:
        w = w_step(l_env, w, y_onehot, lr, weight_dec, cfg, T)
    return torch.stack(new_sites), w, _stack_metrics(steps)


def _sweep_left(sites, w, phi, y_onehot, lr, weight_dec, T, cfg):
    """Center moves N-1 -> 0; sites end right-isometric except the first."""
    N, M, D, _ = sites.shape
    B = phi.shape[0]
    dtype, dev = sites.dtype, sites.device
    e0 = boundary_vector(M, dtype=dtype, device=dev)
    phi_t = phi.transpose(0, 1)
    L_all = left_env_stack_fused(sites, phi_t, e0)  # stale: L_all[n] before site n
    eye = torch.eye(M, dtype=dtype, device=dev)

    r_envL, Rf = w.expand(B, M, w.shape[1]), eye
    new_sites, steps = [None] * N, [None] * N
    for n in range(N - 1, -1, -1):
        x, l_env = phi_t[n], L_all[n]
        A = torch.einsum("ldk,kr->ldr", sites[n], Rf)
        A_new, steps[n] = _site_update(A, x, l_env, r_envL, y_onehot,
                                       _scores(l_env, x, A, r_envL), lr, weight_dec, T, cfg)
        if n == 0:  # the first site keeps the center
            new_sites[n] = A_new
            break
        # exact center move: LQ over the (d, ri) columns (QR of the
        # transpose), with the scaled-isometry gauge as in the right sweep
        qt, rt = torch.linalg.qr(A_new.reshape(M, D * M).T)
        Q = qt.T.reshape(M, D, M)
        env_q = right_label_step(Q, x, r_envL)
        if cfg.renorm:
            g = 1.0 / torch.clamp(
                torch.linalg.vector_norm(env_q.reshape(B, -1), dim=1).mean(), min=1e-30)
        else:
            g = torch.ones((), dtype=dtype, device=dev)
        new_sites[n] = g * Q
        Rf = rt.T / g
        r_envL = env_q * g

    new_sites = torch.stack(new_sites)
    if cfg.update_w:
        l_full = left_env_final_fused(new_sites, phi_t, e0)
        w = w_step(l_full, w, y_onehot, lr, weight_dec, cfg, T)
    return new_sites, w, _stack_metrics(steps)


def onesite_sweep(
    model: BoundaryMPS,
    phi: torch.Tensor,
    y_onehot: torch.Tensor,
    lr: float,
    weight_dec: float,
    left_dir: bool,
    cfg: OneSiteConfig = None,
):
    """One full one-site sweep; returns ``(model, metrics)`` with per-step
    ``accuracy`` and ``MAE`` series of length N."""
    if cfg is None:
        cfg = OneSiteConfig(act_fn=model.act_fn, loss_fn=model.loss_fn)
    check_precision(cfg.matmul_precision)
    body = _sweep_left if left_dir else _sweep_right
    sites, w, metrics = body(
        model.sites, model.w, phi.to(model.dtype), y_onehot.to(model.dtype),
        float(lr), float(weight_dec), model.T, cfg)
    return model.replace(sites=sites, w=w), metrics


def boundary_batch(model: BoundaryMPS, x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """A loader batch on the model's device: embedded ``phi (B, N, D)`` and
    one-hot targets ``(L, B)``."""
    y = torch.as_tensor(np.asarray(y)).to(model.device)
    return _as_phi(x, model), one_hot_labels(y, model.L, model.dtype)


def boundary_accuracy(model: BoundaryMPS, loader) -> float:
    """Mean batch accuracy of ``boundary_forward`` over a loader (NaN for an
    empty one)."""
    accs = []
    for x, y in _loader_batches(loader):
        pred = torch.argmax(boundary_forward(model, _as_phi(x, model)), dim=0)
        accs.append(float((pred == torch.as_tensor(np.asarray(y)).to(model.device)).to(model.dtype).mean()))
    return float(np.mean(accs)) if accs else float("nan")


def train_boundary_model(
    model: BoundaryMPS,
    train_loader,
    val_loader,
    lr,
    n_epochs: int,
    weight_dec: float = 1e-5,
    renorm: bool = None,
    lr_sweep_decay: float = 1.0,
    verbose: bool = False,
    checkpoint_path: str = None,
    resume: bool = False,
):
    """Epoch loop with alternating one-site sweep directions.

    ``lr`` may be a float or a callable ``epoch -> float``; ``lr_sweep_decay``
    multiplies the rate once per sweep. ``renorm=None`` means ``N > 400``.
    With ``checkpoint_path``, the model and the schedule state (epoch, sweep
    counter, sweep direction) are saved after every epoch; ``resume=True``
    continues an interrupted run from it. Returns ``(model, val_acc list)``.
    """
    if renorm is None:
        renorm = model.N > 400
    cfg = OneSiteConfig(act_fn=model.act_fn, loss_fn=model.loss_fn, renorm=renorm)
    lr_fn = lr if callable(lr) else (lambda _e: lr)
    val_acc = []
    left = False
    sweep_idx = 0
    start_epoch = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        model, start_epoch, sweep_idx, left = load_boundary_training_state(
            checkpoint_path, dtype=model.dtype, device=model.device)
        if verbose and start_epoch:
            print(f"resuming from epoch {start_epoch}")
    for epoch in range(start_epoch, n_epochs):
        for x, y in _loader_batches(train_loader):
            epoch_lr = float(lr_fn(epoch)) * (lr_sweep_decay ** sweep_idx)
            sweep_idx += 1
            phi, y1h = boundary_batch(model, x, y)
            model, _ = onesite_sweep(model, phi, y1h, epoch_lr, weight_dec, left, cfg)
            left = not left
        val_acc.append(boundary_accuracy(model, val_loader))
        if verbose:
            print(f"epoch {epoch}: val {val_acc[-1]:.4f}")
        if checkpoint_path:
            save_boundary_training_state(checkpoint_path, model, epoch + 1, sweep_idx, left)
    return model, val_acc
