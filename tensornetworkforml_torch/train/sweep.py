"""DMRG-style two-site sweep: the training hot path.

The counterpart of the JAX package's ``train/sweep.py``, with the same
semantics (reference ``Network_class.py:384-962``):

* one full sweep per batch; environments RIGHT of the active pair are stale
  (from the batch forward), environments LEFT of it are extended with each
  just-updated site;
* analytic gradient of the loss through the activation, summed over the
  batch; exact L2 of the whole MPS through transfer matrices, or plain
  weight decay;
* L1 clip (or the normalized step), ascent step ``B + lr * dB``, split back
  at bond dimension M.

The JAX sweep is one ``lax.scan``; here it is a Python loop over the N-1
steps, with every scalar (the clip, ``growth_cap``, ``renorm_envs``) kept as
a tensor ``where`` so a sweep on the card never waits on the host. A LEFT
sweep is a right sweep on the mirrored chain (sites reversed, bond legs
swapped), made contiguous before it reaches a kernel.

Engines: ``"xla"`` (the name is kept from the JAX package) runs each step as
plain tensor operations plus the configured split (every ``svd_method`` of
``ops/svd.py`` is ported) -- with ``svd_method="polar"`` the split's
subspace iteration is kernel K1 up to I = M*D = 768 rows, and above it the
split is gram-free with kernels K4a and K4b; with ``"rangefinder"`` the whole
split is kernel K6 from I = 128 rows (M >= 64 at D = 2); ``"hybrid"`` runs
kernel K2 (``two_site_presplit``) and then K1 on every step, above
``M*D = 256`` too (the JAX package's cap there was a VMEM limit of the TPU);
``"fused"`` runs the whole step as kernel K7 (``two_site_step``), at every
bond, all the steps of a sweep in one call (``two_site_sweep``). The
factored large-bond update (``train/factored_step.py``) takes a
step of the xla engine where the JAX package's rule sends it there
(``factored_update="on"``, or ``"auto"`` at ``M*D > 512``, for a canonical
fixed-rank polar split with no L2); it runs no kernel. ``dist_split``
(``"cholqr"`` or ``"polar"``) splits each step's two-site matrix with its
columns over ``dist_mesh``'s ``model`` axis (``parallel/dist_split.py``; the
polar form runs kernel K5 on each column block, then K1), and all-gathers the
new label core's columns over that axis, so that the next merge sees the
whole core.

Data parallelism (``parallel/dp.py``): each rank sweeps its own rows of the
batch, and ``dp`` (a ``parallel.mesh.DataShards``) turns the step's sums over
the batch -- the gradient and the step metrics -- into ONE all-reduce over
the mesh's ``data`` axis, and ``renorm_envs``' mean env norm into a second,
scalar one after the split.

While a profiler records, each sweep is a ``utils.profiling.SWEEP`` range,
its prologue (the stale environment stack and the batch output f0) a
``SWEEP_PROLOGUE`` range inside it, and each step of the xla and hybrid
engines a ``STEP`` range (``utils.collectives.STEP_RANGE``, by which
``step_collectives`` groups a data-parallel sweep's collectives); the fused
engine issues its steps from C, so it has the sweep and prologue ranges only.

``matmul_precision`` scopes the whole sweep, every engine, as the JAX
package's ``default_matmul_precision`` does (``utils/precision.py``): on the
card ``"default"``, ``"float32"`` and ``"highest"`` run cuBLAS's products in
IEEE float32, and ``"tensorfloat32"``, ``"high"`` and ``"bfloat16"`` in TF32;
on the CPU every name gives the float32 result. The splits re-enter IEEE
float32 (``ops/svd.py``), and the hand-written kernels (K1, K2, K4a and K4b
in 3xTF32, K7) keep their own precision in every mode, as the JAX package's
Pallas bodies keep theirs; what TF32 reaches is the carried environments,
the merge, the gradient, the output and, in the hybrid engine, ``R``. The
factored update's iteration keeps its own precision
(``train/factored_step.py``). The prologue's stale right environments are
K3's stack form (one launch, full float32) on float32 card inputs in every
scope, and the einsum loop on the CPU and in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tensornetworkforml_torch.models.mps import MPS, apply_act_fn, loss_derivative
from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    chain_scores,
    right_env_stack_fused,
    transfer_append,
    transfer_suffix_stack,
)
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels.env_scan import right_env_stack_chain
from tensornetworkforml_torch.ops.kernels.polar_split import polar_iterate
from tensornetworkforml_torch.ops.kernels.presplit_kernel import two_site_presplit
from tensornetworkforml_torch.ops.kernels.step_kernel import (
    label_from_kernel_layout,
    label_to_kernel_layout,
    two_site_sweep,
)
from tensornetworkforml_torch.ops.svd import truncated_svd_split
from tensornetworkforml_torch.utils.precision import matmul_precision
from tensornetworkforml_torch.utils.profiling import STEP, SWEEP, SWEEP_PROLOGUE, span
from tensornetworkforml_torch.train.factored_step import (
    factored_supported,
    two_site_update_factored,
)


class SweepConfig(NamedTuple):
    """Static sweep hyper-structure; the fields and defaults of the JAX
    package's ``SweepConfig`` (see its docstrings for each option)."""

    act_fn: str = "softmax"
    loss_fn: str = "full_cross_ent"
    L2_flag: bool = True
    svd_method: str = "svd"
    debug: bool = False
    rank_mode: str = "fixed"
    adaptive_tol: float = 1e-4
    split_mode: str = "shared"
    update_mode: str = "clip"
    matmul_precision: str = "default"
    renorm_envs: bool = False
    growth_cap: float = 0.0
    norm_spread: bool = False
    engine: str = "xla"
    dist_split: str = "none"
    dist_mesh: object = None
    step_metrics: bool = True
    factored_update: str = "auto"


def _mirror_sites(sites: torch.Tensor) -> torch.Tensor:
    """Reverse the chain and swap left/right bond legs: (n,l,d,r)->(~n,r,d,l)."""
    return sites.flip(0).permute(0, 3, 2, 1)


def _mirror_label(label_site: torch.Tensor) -> torch.Tensor:
    """(l,d,o,r) -> (r,d,o,l)."""
    return label_site.permute(3, 1, 2, 0)


def _factored_route(cfg: SweepConfig, M: int, D: int) -> bool:
    """Whether this step takes ``train/factored_step.py``: the JAX package's
    rule (``factored_update="on"``, or ``"auto"`` at ``M*D > 512``, for the
    configurations it supports)."""
    supported = factored_supported(cfg, M, D)
    if cfg.factored_update == "on" and not supported:
        raise ValueError(
            "factored_update='on' requires split_mode='canonical', "
            "svd_method='polar', L2_flag=False, rank_mode='fixed', "
            "dist_split='none'"
        )
    return cfg.factored_update != "off" and supported and (
        cfg.factored_update == "on" or M * D > 512
    )


def batch_gradient(left_part: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The two-site gradient's sum over the batch rows: ``left_part (B, M*D)``
    and ``w (B, L*D*M)`` give ``(M*D, L*D*M)``. Under data parallelism each
    rank sums its own rows here and the step's all-reduce adds the ranks'
    sums, so the whole batch is summed in another order than in one call:
    the tests reach the single-device sweep in that order through this
    name."""
    return left_part.T @ w


def two_site_update(
    label_site, A2, x1, x2, l_env, r_env, E2, r2_step, y_onehot, f,
    lr, weight_dec, rank, T: float, cfg: SweepConfig, dp=None,
):
    """ONE two-site update (the reference's ``sweep_step`` + ``update_B`` +
    ``tensor_svd``), in right-sweep orientation.

    ``label_site (M,D,L,M)``, right neighbour ``A2 (M,D,M)``, inputs
    ``x1/x2 (B,D)``, carried left environment ``l_env (B,M)`` and left L2
    transfer product ``E2 (M,M)``, stale right environment ``r_env (B,M)``
    and right transfer product ``r2_step (M,M)``, targets ``(L,B)``, the
    previous output ``f (L,B)``. Returns ``(A_left, new_label_site,
    new_l_env, new_E2, f_new, metrics)``.

    With ``dp`` (a ``parallel.mesh.DataShards``) the batch inputs are this
    rank's rows: the gradient and the metric sums are summed over the data
    ranks in one all-reduce, so the parameters and metrics that come out are
    those of the whole batch, and ``l_env_new`` and ``f_new`` this rank's rows.
    """
    M, D, L, _ = label_site.shape
    B = x1.shape[0]
    B_all = B * (dp.size if dp is not None else 1)
    dtype, dev = label_site.dtype, label_site.device
    if _factored_route(cfg, M, D):
        A_left, label_new, l_env_new, f_new, metrics = two_site_update_factored(
            label_site, A2, x1, x2, l_env, r_env, y_onehot, f, lr, weight_dec, T, cfg,
        )
        return A_left, label_new, l_env_new, E2, f_new, metrics

    # merge the active pair: B[a,i,o,j,c] (left, d1, label, d2, right)
    B_t = torch.einsum("aiok,kjc->aiojc", label_site, A2)

    f_act = apply_act_fn(f, cfg.act_fn, T)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # dB[a,i,o,j,c] = sum_b loss_der[o,b] l_env[b,a] x1[b,i] x2[b,j] r_env[b,c]
    loss_der = loss_derivative(f_act, y_onehot, cfg.loss_fn, cfg.act_fn, T)
    left_part = (l_env[:, :, None] * x1[:, None, :]).reshape(B, M * D)
    right_part = (x2[:, :, None] * r_env[:, None, :]).reshape(B, D * M)
    w_t = loss_der.T[:, :, None] * right_part[:, None, :]  # (B, L, D*M)
    deltaB = batch_gradient(left_part, w_t.reshape(B, L * D * M)).reshape(M, D, L, D, M)
    sums = [(f_act.argmax(dim=0) == y_onehot.argmax(dim=0)).to(dtype).sum(),
            (y_onehot - f_act).abs().sum(), f.abs().sum()] if cfg.step_metrics else []
    if dp is not None:  # the gradient and the metric sums: ONE all-reduce a step
        deltaB, *sums = dp.sum(deltaB, *sums)
    acc, mae, mean_abs_f = (
        (sums[0] / B_all, sums[1] / (L * B_all), sums[2] / (L * B_all)) if sums else (zero,) * 3)

    if cfg.L2_flag:
        deriv = torch.einsum(
            "aiojC,Cc->aiojc", torch.einsum("aA,AiojC->aiojC", E2, B_t), r2_step
        )
        l2_loss = weight_dec * (B_t * deriv).sum()
        l2_grad = 2.0 * weight_dec * deriv
    else:
        l2_loss = zero
        l2_grad = weight_dec * B_t
    deltaB = deltaB - l2_grad

    sum_abs_dB = deltaB.abs().sum()  # recorded pre-clip (reference :742)
    s_B = B_t.abs().sum()
    s_dB = sum_abs_dB
    if cfg.update_mode == "normalized":
        deltaB = deltaB * torch.where(s_dB > 0, s_B / torch.clamp(s_dB, min=1e-30), 0.0)
    else:  # L1 gradient clipping (Network_class.py:753-757)
        deltaB = deltaB * torch.where(s_dB > s_B, s_B / s_dB, 1.0)

    B_new = B_t + lr * deltaB
    if cfg.growth_cap > 0:
        s_new = B_new.abs().sum()
        cap = (1.0 + cfg.growth_cap) * s_B
        B_new = B_new * torch.where(s_new > cap, cap / torch.clamp(s_new, min=1e-30), 1.0)

    # the network output with the updated B (stale right environment)
    v = (left_part @ B_new.reshape(M * D, L * D * M)).reshape(B, L, D * M)
    f_new = (v * right_part[:, None, :]).sum(dim=2).T

    bmat = B_new.reshape(M * D, L * D * M)
    if bmat.dtype == torch.bfloat16:
        bmat = bmat.to(torch.float32)
    keep = rank if cfg.rank_mode == "reference" else None
    atol = 0.0
    if cfg.rank_mode == "adaptive":
        if cfg.svd_method not in ("svd", "cholsvd"):
            raise ValueError(
                "rank_mode='adaptive' needs a spectrum-producing split "
                "(svd_method='svd' or 'cholsvd'), got "
                f"{cfg.svd_method!r}"
            )
        if cfg.dist_split != "none":
            raise ValueError("rank_mode='adaptive' requires dist_split='none'")
        atol = cfg.adaptive_tol
    if cfg.dist_split != "none":
        left_flat, right_flat = _dist_split_step(bmat, M, keep, cfg)
    else:
        left_flat, right_flat = truncated_svd_split(
            bmat, M, cfg.svd_method, keep=keep, split_mode=cfg.split_mode, adaptive_tol=atol,
        )
    A_left = left_flat.reshape(M, D, M).to(dtype)
    label_new = right_flat.reshape(M, L, D, M).permute(0, 2, 1, 3).to(dtype)

    # extend the carried left environment with the UPDATED site
    l_env_new = left_part @ A_left.reshape(M * D, M)

    if cfg.renorm_envs:
        # norm transfer: unit mean env norm, compensated in the label core
        norms = torch.linalg.vector_norm(l_env_new, dim=1)
        if dp is None:
            mean_norm = norms.mean()
        else:  # the second, scalar all-reduce of a data-parallel step
            mean_norm = dp.sum(norms.sum())[0] / B_all
        g = 1.0 / torch.clamp(mean_norm, min=1e-30)
        A_left = A_left * g
        l_env_new = l_env_new * g
        label_new = label_new / g

    E2_new = transfer_append(E2, A_left) if cfg.L2_flag else E2

    if cfg.step_metrics:
        metrics = {
            "accuracy": acc,
            "MAE": mae,
            "sum_abs_B": s_B,
            "sum_abs_deltaB": sum_abs_dB,
            "mean_abs_f": mean_abs_f,
            "L2_loss": l2_loss,
            "sum_abs_L2_grad": l2_grad.abs().sum(),
        }
    else:
        metrics = {k: zero for k in (
            "accuracy", "MAE", "sum_abs_B", "sum_abs_deltaB", "mean_abs_f",
            "L2_loss", "sum_abs_L2_grad",
        )}
    if cfg.rank_mode == "adaptive":
        metrics["live_rank"] = ((right_flat * right_flat).sum(dim=1) > 0).to(dtype).sum()
    return A_left, label_new, l_env_new, E2_new, f_new, metrics


def _dist_split_step(bmat, M: int, keep, cfg: SweepConfig):
    """The bond-distributed split of one step (``cfg.dist_split``): ``Q``,
    and the new label core's columns all-gathered over the mesh's ``model``
    axis (``M * J`` floats a step), so that the next merge sees the whole
    core. Refuses what the JAX package refuses."""
    if cfg.split_mode != "canonical" or keep is not None:
        raise ValueError("dist_split requires split_mode='canonical' and rank_mode='fixed'")
    if cfg.dist_mesh is None:
        raise ValueError("dist_split set but dist_mesh is None")
    # parallel/ imports this module: bind it at call time
    from tensornetworkforml_torch.parallel import dist_split as _dist_split
    from tensornetworkforml_torch.parallel.mesh import MODEL_AXIS, Shard

    dist_fn = {
        "cholqr": _dist_split.distributed_cholqr_split,
        "polar": _dist_split.distributed_polar_split,
    }[cfg.dist_split]
    left_flat, right_loc = dist_fn(bmat, M, cfg.dist_mesh)
    return left_flat, Shard(cfg.dist_mesh, MODEL_AXIS, 1).gather(right_loc)


def _spread_label_norm(new_sites, label_final):
    """Gauge rebalance: label core to unit max-abs, the norm spread
    geometrically over the N-1 live sites; the function is preserved."""
    dtype = new_sites.dtype
    sdt = torch.promote_types(dtype, torch.float32)
    n = label_final.abs().max().to(sdt)
    safe = torch.where(n > 0, n, torch.ones((), dtype=sdt, device=n.device))
    n_live = new_sites.shape[0] - 1
    c = torch.exp(torch.log(safe) / n_live).to(dtype)
    return new_sites * c, label_final / safe.to(dtype)


def _stack_metrics(steps: list) -> dict:
    return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}


def _f32_carry(sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec):
    """The kernel engines' float32 inputs, contiguous: the label core in carry
    layout ``(L, M*D, M)``, the right sites ``(N-1, M, D, M)``, the site
    inputs, the targets, the stale environments, the boundary left
    environment, the batch output and the rates."""
    f32, dev = torch.float32, sites.device
    M, B = sites.shape[1], phi_t.shape[1]
    return (
        label_to_kernel_layout(label_site.to(f32)).contiguous(),
        sites[1:].to(f32).contiguous(),
        phi_t.to(f32).contiguous(),
        y_onehot.to(f32).contiguous(),
        r_envs.to(f32).contiguous(),
        boundary_vector(M, dtype=f32, device=dev).expand(B, M).contiguous(),
        f0.to(f32).contiguous(),
        torch.as_tensor(lr, dtype=f32, device=dev).reshape(1),
        torch.as_tensor(weight_dec, dtype=f32, device=dev).reshape(1),
    )


def _hybrid_sweep(sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec, T, cfg):
    """The hybrid engine's sweep: K2, K1 and two plain products per step."""
    N, M, D, _ = sites.shape
    L = label_site.shape[2]
    dtype, dev = sites.dtype, sites.device
    if cfg.L2_flag or cfg.split_mode != "canonical" or (
        cfg.rank_mode != "fixed" or cfg.update_mode != "clip" or cfg.dist_split != "none"
    ):
        raise ValueError(
            "engine='hybrid' requires split_mode='canonical', "
            "L2_flag=False, rank_mode='fixed', update_mode='clip', "
            "dist_split='none'"
        )
    om = _svd.rangefinder_omega(L * D * M, M, torch.float32, dev).reshape(L, D * M, M)
    lab, a2s, x, y1h, r32, l_env, f, lr32, wd32 = _f32_carry(
        sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec)
    a2ms = a2s.reshape(N - 1, M, D * M)

    A_lefts, stats_rows = [], []
    for step in range(N - 1):
        with span(STEP):
            bnew, y0, g, f_new, left_part, stats = two_site_presplit(
                lab, a2ms[step], x[step], x[step + 1], l_env, r32[step + 2], y1h, f, om,
                lr32, wd32, act_fn=cfg.act_fn, loss_fn=cfg.loss_fn, T=T, with_gram=True,
            )
            qf = polar_iterate(y0, g, stats[0, 2].reshape(1, 1))
            r = qf.T @ bnew  # R per label block: exactly the next carry layout
            if cfg.growth_cap > 0:
                cap = (1.0 + cfg.growth_cap) * stats[0, 0]
                gamma = torch.where(stats[0, 3] > cap,
                                    cap / torch.clamp(stats[0, 3], min=1e-30), 1.0)
                r = r * gamma
                f_new = f_new * gamma
            l_env_new = left_part @ qf
            a_left = qf
            if cfg.renorm_envs:
                gn = 1.0 / torch.clamp(torch.linalg.vector_norm(l_env_new, dim=1).mean(), min=1e-30)
                a_left = a_left * gn
                l_env_new = l_env_new * gn
                r = r / gn
            lab = r.reshape(L, M * D, M)
            l_env, f = l_env_new, f_new
            A_lefts.append(a_left.reshape(M, D, M).to(dtype))
            stats_rows.append(stats)

    stats = torch.cat(stats_rows).to(dtype)  # (N-1, 8)
    zeros = torch.zeros((N - 1,), dtype=dtype, device=dev)
    metrics = {
        "accuracy": stats[:, 4],
        "MAE": stats[:, 5],
        "sum_abs_B": stats[:, 0],
        "sum_abs_deltaB": stats[:, 1],
        "mean_abs_f": stats[:, 6],
        "L2_loss": zeros,
        "sum_abs_L2_grad": zeros,
    }
    label_final = label_from_kernel_layout(lab.reshape(L, M, D * M)).to(dtype)
    return torch.stack(A_lefts), label_final, f.to(dtype), metrics


def _fused_sweep(sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec, T, cfg):
    """The fused engine's sweep: K7 (``two_site_step``) at each step, all
    N - 1 steps in one call of ``two_site_sweep`` (on CPU tensors a loop of
    K7's plain version). The carry is float32 and the final output ``f``
    stays float32, as in the JAX package."""
    N, M, D, _ = sites.shape
    L = label_site.shape[2]
    dtype, dev = sites.dtype, sites.device
    if cfg.L2_flag or cfg.split_mode != "canonical" or (
        cfg.rank_mode != "fixed" or cfg.update_mode != "clip"
    ):
        raise ValueError(
            "engine='fused' requires split_mode='canonical', "
            "L2_flag=False, rank_mode='fixed', update_mode='clip'"
        )
    lab, a2s, x, y1h, r32, l_env, f, lr32, wd32 = _f32_carry(
        sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec)
    a_lefts, lab, f, metr, mean_abs_f = two_site_sweep(
        lab, a2s, x, y1h, r32, l_env, f, lr32, wd32, act_fn=cfg.act_fn, loss_fn=cfg.loss_fn,
        T=T, renorm_envs=cfg.renorm_envs, growth_cap=cfg.growth_cap,
    )
    metr = metr.to(dtype)  # (N-1, 4)
    zeros = torch.zeros((N - 1,), dtype=dtype, device=dev)
    metrics = {
        "accuracy": metr[:, 0],
        "MAE": metr[:, 1],
        "sum_abs_B": metr[:, 2],
        "sum_abs_deltaB": metr[:, 3],
        "mean_abs_f": mean_abs_f,
        "L2_loss": zeros,
        "sum_abs_L2_grad": zeros,
    }
    label_final = label_from_kernel_layout(lab).to(dtype)
    return a_lefts.reshape(N - 1, M, D, M).to(dtype), label_final, f, metrics


def _right_envs(sites, phi_t, e0) -> torch.Tensor:
    """The stale suffix environments ``(N+1, B, M)``: the stack form of K3
    (``right_env_stack_chain``, one launch, full float32 whatever the scope)
    for float32 inputs with D=2 on the card, else the einsum loop
    (``right_env_stack_fused``): on the CPU and in float64."""
    if (sites.is_cuda and phi_t.is_cuda and sites.shape[2] == 2
            and sites.dtype == phi_t.dtype == torch.float32):
        return right_env_stack_chain(sites.contiguous(), phi_t)
    return right_env_stack_fused(sites, phi_t, e0)


def _sweep_right_arrays(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg,
                        dp=None):
    """One full right sweep (label leg moves 0 -> N-1). Returns
    ``(new_sites, new_label_site, f_first, f_final, metrics)`` with per-step
    metric series of length N-1. With ``dp`` the xla engine's steps sum over
    the data ranks (``two_site_update``); the callers send the other engines
    the whole batch (``parallel/dp.py``)."""
    N, M, D, _ = sites.shape
    B = phi.shape[0]
    dtype, dev = sites.dtype, sites.device
    if cfg.engine not in ("xla", "hybrid", "fused"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    e0 = boundary_vector(M, dtype=dtype, device=dev)

    # per-batch precomputation: stale suffix environments (index 0 unused)
    with span(SWEEP_PROLOGUE):
        phi_t = phi.transpose(0, 1).contiguous()  # (N, B, D)
        r_envs = _right_envs(sites, phi_t, e0)  # (N+1, B, M)
        f0 = chain_scores(e0.expand(B, M), label_site, phi[:, 0, :], r_envs[1])

    if cfg.engine in ("hybrid", "fused"):
        engine_sweep = _hybrid_sweep if cfg.engine == "hybrid" else _fused_sweep
        A_lefts, label_final, f_final, metrics = engine_sweep(
            sites, label_site, phi_t, y_onehot, r_envs, f0, lr, weight_dec, T, cfg
        )
    else:
        r2 = transfer_suffix_stack(sites, e0) if cfg.L2_flag else None
        no_r2 = torch.zeros((M, M), dtype=dtype, device=dev)
        label, l_env, E2, f = label_site, e0.expand(B, M), torch.outer(e0, e0), f0
        lefts, steps = [], []
        for step in range(N - 1):
            with span(STEP):
                A_left, label, l_env, E2, f, metr = two_site_update(
                    label, sites[step + 1], phi_t[step], phi_t[step + 1], l_env,
                    r_envs[step + 2], E2, no_r2 if r2 is None else r2[step + 2],
                    y_onehot, f, lr, weight_dec, ranks[step], T, cfg, dp=dp,
                )
            lefts.append(A_left)
            steps.append(metr)
        A_lefts, label_final, f_final = torch.stack(lefts), label, f
        metrics = _stack_metrics(steps)

    # slots 0..N-2 hold the new left factors; the label now sits at N-1
    new_sites = torch.cat([A_lefts, torch.zeros((1, M, D, M), dtype=dtype, device=dev)])
    if cfg.norm_spread:
        new_sites, label_final = _spread_label_norm(new_sites, label_final)
    return new_sites, label_final, f0, f_final, metrics


def _sweep(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg, left_dir, dp=None):
    """A right sweep, or a left one as the right sweep of the mirrored chain,
    inside the scope of ``cfg.matmul_precision`` (one entry a sweep: every
    caller, ``sweep_once``, ``fused_epoch`` and ``parallel/dp.py``, sweeps
    through here)."""
    with span(SWEEP), matmul_precision(cfg.matmul_precision):
        return _sweep_in_scope(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg,
                               left_dir, dp)


def _sweep_in_scope(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg, left_dir,
                    dp):
    if left_dir:
        new_s, new_l, f0, f_fin, m = _sweep_right_arrays(
            _mirror_sites(sites).contiguous(),
            _mirror_label(label_site).contiguous(),
            phi.flip(1),
            y_onehot, lr, weight_dec, ranks, T, cfg, dp=dp,
        )
        return (
            _mirror_sites(new_s).contiguous(),
            _mirror_label(new_l).contiguous(),
            f0, f_fin, m,
        )
    return _sweep_right_arrays(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg,
                               dp=dp)


def _scalar(v, mps: MPS) -> torch.Tensor:
    """``v`` as a 0-d tensor of the model's dtype on its device (a fill, not
    a host-to-device copy, when ``v`` is a Python number)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=mps.dtype, device=mps.device).reshape(())
    return torch.full((), float(v), dtype=mps.dtype, device=mps.device)


def sweep_once(mps: MPS, phi, y_onehot, lr, weight_dec, cfg: SweepConfig = None,
               bond_profile=None):
    """One full sweep in the direction implied by ``mps.l_pos`` (the label
    leg must sit at a chain end). Returns ``(new_mps, f_first, f_final,
    metrics)``: ``f_first`` is the batch forward before any update and
    ``metrics`` per-step series of length N-1.

    In ``rank_mode="reference"`` the per-step rank caps follow the
    reference's bond recurrence from ``bond_profile`` (inferred from the
    zero structure if omitted); the evolved profile is returned as
    ``metrics["bond_profile"]``.
    """
    if cfg is None:
        cfg = SweepConfig(act_fn=mps.act_fn, loss_fn=mps.loss_fn)
    left_dir = mps.l_pos == mps.N - 1
    if not left_dir and mps.l_pos != 0:
        raise ValueError(
            f"sweep requires the label leg at a chain end, got l_pos={mps.l_pos}"
        )
    if cfg.rank_mode == "reference":
        from tensornetworkforml_torch.train.rank_schedule import (
            effective_bond_profile,
            reference_rank_schedule,
        )

        if bond_profile is None:
            bond_profile = effective_bond_profile(mps)
        ranks_np, counts_np, new_profile = reference_rank_schedule(
            bond_profile, mps.N, mps.D, mps.L, left_dir
        )
        ranks = [int(r) for r in ranks_np]
    else:
        new_profile = None
        counts_np = np.full((mps.N - 1,), mps.M * mps.D * mps.L * mps.D * mps.M, dtype=np.int64)
        ranks = [mps.M] * (mps.N - 1)

    new_sites, new_label, f0, f_fin, metrics = _sweep(
        mps.sites,
        mps.label_site,
        torch.as_tensor(phi).to(dtype=mps.dtype, device=mps.device),
        torch.as_tensor(y_onehot).to(dtype=mps.dtype, device=mps.device),
        _scalar(lr, mps),
        _scalar(weight_dec, mps),
        ranks,
        mps.T,
        cfg,
        left_dir,
    )
    # ragged-equivalent means for the reference's debug series
    metrics = dict(metrics)
    counts = torch.as_tensor(counts_np, dtype=mps.dtype).to(mps.device)
    metrics["mean_abs_B"] = metrics.pop("sum_abs_B") / counts
    metrics["mean_abs_deltaB"] = metrics.pop("sum_abs_deltaB") / counts
    metrics["mean_abs_L2_grad"] = metrics.pop("sum_abs_L2_grad") / counts
    if new_profile is not None:
        metrics["bond_profile"] = new_profile
    new_mps = mps.replace(
        sites=new_sites, label_site=new_label, l_pos=0 if left_dir else mps.N - 1,
    )
    return new_mps, f0, f_fin, metrics


def one_hot_labels(y: torch.Tensor, L: int, dtype) -> torch.Tensor:
    """Integer labels ``(B,)`` -> one-hot targets ``(L, B)``."""
    return F.one_hot(y.long(), L).T.to(dtype)


def train_batch(mps: MPS, x_raw, y, lr, weight_dec, cfg: SweepConfig = None):
    """Embed + forward + full sweep on one batch of RAW pixels ``(B, N)``.

    Returns ``(new_mps, batch_accuracy, metrics)``; the accuracy is that of
    the forward BEFORE the sweep, as in the reference training loop.
    """
    x = torch.as_tensor(x_raw).to(dtype=mps.dtype, device=mps.device)
    y = torch.as_tensor(y).to(device=mps.device)
    phi = psi_embed(x)
    new_mps, f0, _, metrics = sweep_once(
        mps, phi, one_hot_labels(y, mps.L, mps.dtype), lr, weight_dec, cfg
    )
    batch_acc = (f0.argmax(dim=0) == y).to(mps.dtype).mean()
    return new_mps, batch_acc, metrics
