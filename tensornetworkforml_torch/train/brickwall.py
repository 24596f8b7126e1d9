"""Brick-wall parallel-bond training: every two-site update of a layer at once.

The counterpart of the JAX package's ``train/brickwall.py``, with the same
semantics. A brick-wall layer updates all disjoint two-site pairs together:

    even layer:  (0,1) (2,3) (4,5) ...
    odd  layer:  (1,2) (3,4) (5,6) ...

Each pair's gradient uses the environments of the current chain (computed
once per layer), so a layer is a block-Jacobi step: the exact two-site
update of every pair with the other pairs held fixed. One brick sweep is the
even layer, the odd layer and one update of the output projection. All
merges, gradients, clips and truncated splits of a layer run as K = N/2
batched problems; the split is ``ops/svd.py::batched_cholqr_split``
(matmuls and Cholesky only) or the rangefinder split pair by pair.

Scale discipline: pair splits are canonical (isometric left factor), and
``renorm=True`` balances each pair's weight evenly between its two factors
(function-preserving and local). Clipped updates are lr-relative per pair,
so a layer can grow the function by up to (1+lr)^K: keep lr ~ O(1/K) on
long chains, or take the function-space line search.

The model family is the boundary-label MPS (``models/boundary.py``). The
JAX epoch is one ``lax.scan`` over the stacked batches; here it is a loop
over them, in the same order with the same math. No TPU kernel lies on this
path in the JAX package, and none runs here.

Data parallelism (``brick_epoch(mesh=...)``, ``make_sharded_brick_step``):
every rank passes the same batch and takes its rows by its coordinate on the
mesh's ``data`` axis; each brick layer sums ALL its pair gradients and its
metric sums over the data ranks in ONE all-reduce (a second, of two scalars,
with the line search), and the ``w`` update its gradient in one more, so a
brick sweep's communication depth is three all-reduces whatever N is (the
two-site sweep needs one a step).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tensornetworkforml_torch.models.boundary import (
    BoundaryMPS,
    boundary_right_envs,
    grow_boundary_bond,
)
from tensornetworkforml_torch.models.mps import apply_act_fn, loss_derivative
from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    left_env_final_fused,
    left_env_stack_fused,
)
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.onesite import (
    batch_metrics,
    boundary_accuracy,
    boundary_batch,
    check_precision,
    w_step,
)
from tensornetworkforml_torch.train.trainer import _loader_batches
from tensornetworkforml_torch.utils.checkpoint import (
    load_boundary_training_state,
    save_boundary_training_state,
)


class BrickConfig(NamedTuple):
    """The fields and defaults of the JAX package's ``BrickConfig`` (see its
    comments for each option)."""

    act_fn: str = "linear"
    loss_fn: str = "MSE"
    update_w: bool = True
    # balance each pair's weight evenly between its two factors
    renorm: bool = True
    # max fractional growth of sum|B| per pair update (0 = unlimited)
    growth_cap: float = 0.0
    # every product runs in full float32; reduced precision raises (item 9)
    matmul_precision: str = "default"
    # "cholqr": batched matmul/Cholesky-only splits; "rangefinder":
    # ops/svd.py::_rangefinder_split (qr + eigh) on each pair
    split_method: str = "cholqr"
    # function-space line search: the 1-D optimal global step on the layer's
    # linearized aggregate response, clamped to [0, lr]
    line_search: bool = False
    # over-relaxation of the line-searched step
    line_search_relax: float = 1.0
    # step floor, as a fraction of lr, taken only when the linearized
    # descent test fails (<dF, loss_der> <= 0)
    line_search_floor: float = 0.05


def _env_stacks(sites, w, phi_t, e0):
    """Left envs before each site ``(N,B,M)``, right envs after each site
    closing on ``w`` ``(N,B,M,L)``, and the full-chain left env ``(B,M)``."""
    lefts = left_env_stack_fused(sites, phi_t, e0)
    return lefts[:-1], boundary_right_envs(sites, w, phi_t), lefts[-1]


def _split_pairs(bmats: torch.Tensor, M: int, method: str):
    if method == "cholqr":
        return _svd.batched_cholqr_split(bmats, M)
    if method == "rangefinder":
        qs, rs = zip(*(_svd._rangefinder_split(b, M, split_mode="canonical") for b in bmats))
        return torch.stack(qs), torch.stack(rs)
    raise ValueError(f"unknown split_method {method!r}; expected 'cholqr' or 'rangefinder'")


def _brick_layer(sites, w, phi_t, y_onehot, lr, weight_dec, parity, cfg, T, dp=None):
    """One brick-wall layer: batched two-site updates on all pairs starting at
    ``parity`` (0 = even bonds, 1 = odd bonds). Returns ``(new_sites, metrics)``.
    With ``dp`` (a ``parallel.mesh.DataShards``) the batch inputs are this
    rank's rows and the sums over the batch run over the data ranks."""
    N, M, D, _ = sites.shape
    dtype, dev = sites.dtype, sites.device
    K = (N - parity) // 2
    e0 = boundary_vector(M, dtype=dtype, device=dev)

    L_all, R_all, l_full = _env_stacks(sites, w, phi_t, e0)
    f_act = apply_act_fn((l_full @ w).T, cfg.act_fn, T)  # the whole layer's stale output
    loss_der = loss_derivative(f_act, y_onehot, cfg.loss_fn, cfg.act_fn, T)

    lo, hi = parity, parity + 2 * K
    A1, A2 = sites[lo:hi:2], sites[lo + 1:hi:2]  # (K, M, D, M)
    x1, x2 = phi_t[lo:hi:2], phi_t[lo + 1:hi:2]  # (K, B, D)
    Lk = L_all[lo:hi:2]  # (K, B, M) env before the pair
    Rk = R_all[lo + 1:hi:2]  # (K, B, M, L) env after the pair

    # merge and batched analytic gradient (the reference's update_B, over all
    # K pairs at once)
    B_t = torch.einsum("kaim,kmjc->kaijc", A1, A2)  # (K, M, D, D, M)
    u = torch.einsum("ob,kbco->kbc", loss_der, Rk)  # label leg closed on w
    left_part = torch.einsum("kba,kbi->kbai", Lk, x1)
    right_part = torch.einsum("kbj,kbc->kbjc", x2, u)
    grad = torch.einsum("kbai,kbjc->kaijc", left_part, right_part)
    if dp is None:
        metrics = batch_metrics(f_act, y_onehot)
    else:  # every pair's gradient and the metric sums: ONE all-reduce a layer
        L, B = y_onehot.shape
        grad, n_right, s_mae = dp.sum(
            grad, (f_act.argmax(dim=0) == y_onehot.argmax(dim=0)).to(dtype).sum(),
            (y_onehot - f_act).abs().sum())
        metrics = {"accuracy": n_right / (B * dp.size), "MAE": s_mae / (L * B * dp.size)}
    deltaB = grad - weight_dec * B_t

    # per-pair L1 clip and ascent step
    s_B = B_t.abs().sum(dim=(1, 2, 3, 4))
    s_dB = deltaB.abs().sum(dim=(1, 2, 3, 4))
    scale = torch.where(s_dB > s_B, s_B / torch.clamp(s_dB, min=1e-30), 1.0)
    direction = scale[:, None, None, None, None] * deltaB
    if cfg.line_search:
        # the layer's linearized aggregate response dF = sum_k df_k, then the
        # 1-D optimal global step on <loss_der, dF> with unit curvature
        t1 = torch.einsum("kbai,kaijc->kbjc", left_part, direction)
        t2 = torch.einsum("kbjc,kbj->kbc", t1, x2)
        dF = torch.einsum("kbc,kbco->ob", t2, Rk)
        num, den = (dF * loss_der).sum(), (dF * dF).sum()
        if dp is not None:
            num, den = dp.sum(num, den)
        den = torch.clamp(den, min=1e-30)
        gamma_raw = torch.clamp(cfg.line_search_relax * num / den, min=0.0, max=lr)
        # floor only the num <= 0 regime (weight decay dominating the clipped
        # direction), so that regularisation never deadlocks
        gamma = torch.where(num <= 0, cfg.line_search_floor * lr, gamma_raw)
        step = gamma
    else:
        gamma = torch.full((), lr, dtype=dtype, device=dev)
        step = lr
    B_new = B_t + step * direction
    if cfg.growth_cap > 0:
        s_new = B_new.abs().sum(dim=(1, 2, 3, 4))
        cap = (1.0 + cfg.growth_cap) * s_B
        g = torch.where(s_new > cap, cap / torch.clamp(s_new, min=1e-30), 1.0)
        B_new = B_new * g[:, None, None, None, None]

    # batched canonical truncated split of all K pairs
    q, r = _split_pairs(B_new.reshape(K, M * D, D * M), M, cfg.split_method)
    A1_new = q.reshape(K, M, D, M).to(dtype)
    A2_new = r.reshape(K, M, D, M).to(dtype)

    if cfg.renorm:
        # balance each pair's scale between its two factors: left = Q s_k,
        # right = right / s_k with s_k = sqrt(rho_k / sqrt(M)), so both get
        # norm sqrt(rho_k sqrt(M)) and the function is exactly preserved
        rho = torch.sqrt((A2_new ** 2).sum(dim=(1, 2, 3)))
        s = torch.sqrt(torch.clamp(rho, min=1e-30) / float(np.sqrt(M)))
        A1_new = A1_new * s[:, None, None, None]
        A2_new = A2_new / s[:, None, None, None]

    new_sites = sites.clone()
    new_sites[lo:hi:2] = A1_new
    new_sites[lo + 1:hi:2] = A2_new
    metrics["gamma"] = gamma
    return new_sites, metrics


def _w_update(sites, w, phi_t, y_onehot, lr, weight_dec, cfg, T, e0, dp=None):
    return w_step(left_env_final_fused(sites, phi_t, e0), w, y_onehot, lr, weight_dec, cfg, T,
                  dp=dp)


def _brick_sweep_body(sites, w, phi, y_onehot, lr, weight_dec, T, cfg, dp=None):
    phi_t = phi.transpose(0, 1)  # (N, B, D)
    sites, metrics = _brick_layer(sites, w, phi_t, y_onehot, lr, weight_dec, 0, cfg, T, dp)
    if sites.shape[0] >= 3:  # the odd layer exists only past two sites
        sites, _ = _brick_layer(sites, w, phi_t, y_onehot, lr, weight_dec, 1, cfg, T, dp)
    if cfg.update_w:
        e0 = boundary_vector(sites.shape[1], dtype=sites.dtype, device=sites.device)
        w = _w_update(sites, w, phi_t, y_onehot, lr, weight_dec, cfg, T, e0, dp)
    return sites, w, metrics


def brick_sweep(
    model: BoundaryMPS,
    phi: torch.Tensor,
    y_onehot: torch.Tensor,
    lr: float,
    weight_dec: float,
    cfg: BrickConfig = None,
):
    """One brick sweep (even layer + odd layer + w update) on one batch.

    Returns ``(model, metrics)``; ``metrics["accuracy"]`` and ``["MAE"]`` are
    taken on the pre-update scores, ``["gamma"]`` is the even layer's step."""
    if cfg is None:
        cfg = BrickConfig(act_fn=model.act_fn, loss_fn=model.loss_fn)
    check_precision(cfg.matmul_precision)
    sites, w, metrics = _brick_sweep_body(
        model.sites, model.w, phi.to(model.dtype), y_onehot.to(model.dtype),
        float(lr), float(weight_dec), model.T, cfg)
    return model.replace(sites=sites, w=w), metrics


def brick_epoch(
    model: BoundaryMPS,
    x_epoch,
    y_epoch,
    lr: float,
    weight_dec: float,
    cfg: BrickConfig = None,
    mesh=None,
):
    """One epoch of brick sweeps: ``x_epoch (n_batches, B, N)`` raw pixels,
    ``y_epoch (n_batches, B)`` integer labels, swept in order. Returns
    ``(model, metrics)`` with per-batch pre-update metric series.

    With a ``mesh`` every rank passes the same epoch and sweeps its rows of
    each batch (``data`` axis); the model is rank 0's, on the mesh's device,
    and every rank returns the same model and metrics, the whole batches'."""
    if cfg is None:
        cfg = BrickConfig(act_fn=model.act_fn, loss_fn=model.loss_fn)
    check_precision(cfg.matmul_precision)
    dp = None
    if mesh is not None:
        from tensornetworkforml_torch.parallel.mesh import DataShards, replicated

        dp = DataShards(mesh)
        model = model.replace(sites=replicated(mesh).local(model.sites),
                              w=replicated(mesh).local(model.w))
    dev = model.device
    x_epoch = torch.as_tensor(np.asarray(x_epoch)).to(dtype=model.dtype, device=dev)
    phi_epoch = psi_embed(x_epoch)
    y1h = F.one_hot(torch.as_tensor(np.asarray(y_epoch)).long().to(dev), model.L)
    y1h = y1h.to(model.dtype).transpose(1, 2)  # (n_batches, L, B)
    if dp is not None:
        phi_epoch, y1h = dp.rows(phi_epoch, dim=1), dp.rows(y1h, dim=2)
    sites, w = model.sites, model.w
    steps = []
    for phi, y in zip(phi_epoch, y1h):
        sites, w, metrics = _brick_sweep_body(sites, w, phi, y, float(lr), float(weight_dec),
                                              model.T, cfg, dp)
        steps.append(metrics)
    metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
    return model.replace(sites=sites, w=w), metrics


def make_sharded_brick_step(mesh, T: float, cfg: BrickConfig):
    """The data-parallel brick sweep over ``mesh``: ``step(sites, w, phi (B,
    N, D), y_onehot (L, B), lr, weight_dec) -> (sites, w, metrics)``. Every
    rank passes the replicated parameters and the same global batch and
    sweeps its rows; the parameters and metrics that come back are the whole
    batch's, the same on every rank."""
    from tensornetworkforml_torch.parallel.mesh import DataShards

    check_precision(cfg.matmul_precision)
    dp = DataShards(mesh)

    def step(sites, w, phi, y_onehot, lr, weight_dec):
        return _brick_sweep_body(sites, w, dp.rows(phi.to(sites.dtype)),
                                 dp.rows(y_onehot.to(sites.dtype), dim=1), float(lr),
                                 float(weight_dec), T, cfg, dp)

    return step


def train_brickwall(
    model: BoundaryMPS,
    train_loader,
    val_loader,
    lr,
    n_epochs: int,
    weight_dec: float = 1e-5,
    lr_sweep_decay: float = 1.0,
    verbose: bool = False,
    bond_schedule: dict = None,
    checkpoint_path: str = None,
    resume: bool = False,
    cfg: BrickConfig = None,
):
    """Epoch loop over brick sweeps. ``lr`` may be a float or a callable
    ``epoch -> float``; ``lr_sweep_decay`` multiplies the rate once per brick
    sweep. Returns ``(model, val_acc list)``.

    ``cfg`` overrides the whole ``BrickConfig``; by default it is built from
    the model's act/loss functions. ``bond_schedule`` maps ``epoch -> M``:
    the model grows to bond dimension M at the start of that epoch
    (``grow_boundary_bond``, function preserved exactly). With
    ``checkpoint_path`` the model and epoch counter are saved after every
    epoch; ``resume=True`` continues an interrupted run. Uniform batches at a
    constant in-epoch rate go through ``brick_epoch``, as in the JAX package.
    """
    if cfg is None:
        cfg = BrickConfig(act_fn=model.act_fn, loss_fn=model.loss_fn)
    lr_fn = lr if callable(lr) else (lambda _e: lr)
    val_acc = []
    sweep_idx = 0
    start_epoch = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        model, start_epoch, sweep_idx, _ = load_boundary_training_state(
            checkpoint_path, dtype=model.dtype, device=model.device)
        if verbose and start_epoch:
            print(f"resuming from epoch {start_epoch}")
    for epoch in range(start_epoch, n_epochs):
        if bond_schedule and epoch in bond_schedule:
            model = grow_boundary_bond(model, int(bond_schedule[epoch]))
            if verbose:
                print(f"epoch {epoch}: bond dimension grown to {model.M}")
        batches = list(_loader_batches(train_loader))
        shapes = {np.asarray(x).shape for x, _ in batches}
        if len(shapes) == 1 and lr_sweep_decay == 1.0:
            # uniform batches and a constant in-epoch rate: the epoch path
            x_ep = np.stack([np.asarray(x) for x, _ in batches])
            y_ep = np.stack([np.asarray(y) for _, y in batches])
            model, _ = brick_epoch(model, x_ep, y_ep, float(lr_fn(epoch)), weight_dec, cfg)
            sweep_idx += len(batches)
        else:
            for x, y in batches:
                step_lr = float(lr_fn(epoch)) * (lr_sweep_decay ** sweep_idx)
                sweep_idx += 1
                phi, y1h = boundary_batch(model, x, y)
                model, _ = brick_sweep(model, phi, y1h, step_lr, weight_dec, cfg)
        val_acc.append(boundary_accuracy(model, val_loader))
        if verbose:
            print(f"epoch {epoch}: val {val_acc[-1]:.4f}")
        if checkpoint_path:
            save_boundary_training_state(checkpoint_path, model, epoch + 1, sweep_idx, False)
    return model, val_acc
