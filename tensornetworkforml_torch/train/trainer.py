"""Epoch-level training loop with reference-compatible metrics history.

The counterpart of the JAX package's ``train/trainer.py`` (reference
``Network.train``, ``Network_class.py:261-350``): per batch a forward, the
pre-update accuracy and one full sweep in the direction given by where the
label leg sits, then a validation pass per epoch. ``var_hist`` has the
reference's layout ``(n_epochs, n_series, batches_per_epoch * (N-1))`` with
2 series (accuracy, MAE), or 7 in debug mode.

Training runs on the model's device: put the model on the card
(``product_init(..., device="cuda")``, the default) and the loaders' numpy
batches follow it there.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from tensornetworkforml_torch.models.mps import MPS, accuracy_from_scores, grow_bond, mps_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.sweep import SweepConfig, one_hot_labels, sweep_once

_DEBUG_SERIES = (
    "mean_abs_B",
    "mean_abs_deltaB",
    "accuracy",
    "mean_abs_f",
    "MAE",
    "L2_loss",
    "mean_abs_L2_grad",
)
_PLAIN_SERIES = ("accuracy", "MAE")

# bond dimension at which norm_spread="auto" engages the end-of-sweep gauge
# rebalance (the JAX package's threshold, kept so trajectories match)
_NORM_SPREAD_MIN_M = 256


def _loader_batches(loader):
    """Yield stacked ``(x, y)`` arrays from ours or reference-style loaders."""
    if hasattr(loader, "batches"):
        yield from loader.batches()
    else:  # loader with identity collate: list of (x, y) pairs
        for data in loader:
            yield np.array([p[0] for p in data]), np.array([p[1] for p in data])


def _as_phi(x, mps: MPS) -> torch.Tensor:
    """Raw pixels ``(B, N)`` (embedded here) or embedded ``(B, N, D)``."""
    x = torch.as_tensor(np.asarray(x)).to(dtype=mps.dtype, device=mps.device)
    return psi_embed(x) if x.dim() == 2 else x


def evaluate_accuracy(mps: MPS, loader) -> float:
    """Mean batch accuracy over a loader (reference validation loop)."""
    accs = []
    for x, y in _loader_batches(loader):
        scores = mps_forward(mps, _as_phi(x, mps))
        accs.append(accuracy_from_scores(scores, torch.as_tensor(np.asarray(y)).to(mps.device)))
    if not accs:
        return float("nan")
    return float(torch.stack(accs).mean())


def stall_detected(val_acc, warmup_epochs: int = 0, patience: int = 2,
                   min_delta: float = 0.005, threshold: float = 0.95,
                   n_epochs: int = None) -> bool:
    """True when a per-epoch validation-accuracy series below ``threshold``
    has PLATEAUED (the last ``patience`` epochs improved the best prior value
    by at most ``min_delta``) or, with ``n_epochs``, cannot PROJECT to the
    threshold at its recent rate inside the budget. Needs at least one
    post-warmup epoch before the window; never true once ``threshold`` was
    reached."""
    vals = [float(v) for v in val_acc]
    if len(vals) < warmup_epochs + patience + 1:
        return False
    if max(vals) >= threshold:
        return False
    window = vals[-patience:]
    prior = max(vals[:-patience])
    if max(window) <= prior + min_delta:
        return True
    if n_epochs is not None:
        best = max(vals)
        rate = max(0.0, (best - prior) / patience)
        remaining = max(0, int(n_epochs) - len(vals))
        return best + rate * remaining < threshold
    return False


def train_model(
    mps: MPS,
    train_loader,
    val_loader,
    lr: float,
    n_epochs: int = 10,
    weight_dec: float = 0.001,
    L2_flag: bool = True,
    debug: bool = False,
    svd_method: str = "svd",
    split_mode: str = "shared",
    renorm_envs: bool = False,
    growth_cap: float = 0.0,
    matmul_precision: str = "default",
    rank_mode: str = "fixed",
    adaptive_tol: float = 1e-4,
    fused: bool = True,
    verbose: bool = True,
    epoch_callback: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    warmup_epochs: int = 0,
    warmup_batch_divisor: Optional[int] = None,
    bond_schedule: Optional[dict] = None,
    restarts: int = 0,
    reinit_fn: Optional[Callable[[int], MPS]] = None,
    stall_patience: int = 2,
    stall_min_delta: float = 0.005,
    stall_threshold: float = 0.95,
    factored_update: str = "auto",
    norm_spread: str = "auto",
):
    """Train an MPS on its device; returns ``(mps, val_acc, var_hist)``.

    The options are those of the JAX package's ``train_model`` (see its
    docstring): ``lr`` may be a callable ``epoch -> float``; with
    ``checkpoint_path`` the model and epoch counter are saved after every
    epoch (the ``.npz`` training state both packages read) and
    ``resume=True`` continues from the saved epoch; ``warmup_epochs`` run at
    a batch of at most 128 (``warmup_batch_size``) unless
    ``warmup_batch_divisor`` is given; ``bond_schedule`` grows the bond
    dimension at the listed epochs; ``restarts`` retries a run that
    ``stall_detected`` flags from ``reinit_fn(attempt)`` and keeps the
    attempt with the best final validation accuracy; ``norm_spread="auto"``
    engages the end-of-sweep gauge rebalance for canonical fixed-rank
    sweeps at ``M >= 256``.

    The engine is the default (``"xla"``), as in the JAX package, whose
    ``train_model`` has no engine argument; the hybrid engine is reached
    through ``SweepConfig`` with ``sweep_once`` or ``fused_epoch``.
    """
    start_epoch = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        from tensornetworkforml_torch.utils.checkpoint import load_training_state

        mps, start_epoch = load_training_state(checkpoint_path, mps)
        if verbose and start_epoch:
            print(f"resuming from epoch {start_epoch}")
    spread_auto = norm_spread == "auto"
    cfg = SweepConfig(
        act_fn=mps.act_fn,
        loss_fn=mps.loss_fn,
        L2_flag=L2_flag,
        svd_method=svd_method,
        debug=debug,
        split_mode=split_mode,
        renorm_envs=renorm_envs,
        growth_cap=growth_cap,
        matmul_precision=matmul_precision,
        rank_mode=rank_mode,
        adaptive_tol=adaptive_tol,
        factored_update=factored_update,
        norm_spread=False if spread_auto else bool(norm_spread),
    )
    series = _DEBUG_SERIES if debug else _PLAIN_SERIES
    lr_fn = lr if callable(lr) else (lambda _epoch: lr)

    fallback_warned = False
    warm_loader = None
    if warmup_epochs > 0:
        from tensornetworkforml_torch.data.loader import warmup_batch_size, with_batch_size

        if not hasattr(train_loader, "dataset"):
            raise ValueError("warmup_epochs requires an ArrayLoader train loader")
        warm_b = (
            max(1, train_loader.batch_size // warmup_batch_divisor)
            if warmup_batch_divisor is not None
            else warmup_batch_size(train_loader.batch_size)
        )
        warm_loader = with_batch_size(train_loader, warm_b, even_batches=True)

    def _run_attempt(mps, first_epoch, abort_on_stall):
        """One attempt; returns ``(mps, val_acc, var_hist, stalled)``."""
        nonlocal fallback_warned
        val_acc: list[float] = []
        var_hist: list[list[np.ndarray]] = []
        stalled = False
        for epoch in range(first_epoch, n_epochs):
            if bond_schedule and epoch in bond_schedule:
                new_M = int(bond_schedule[epoch])
                if verbose and new_M > mps.M:
                    print(f"epoch {epoch}: growing bond dimension {mps.M} -> {new_M}")
                mps = grow_bond(mps, new_M)
            epoch_cfg = cfg
            if (spread_auto and rank_mode == "fixed" and split_mode == "canonical"
                    and mps.M >= _NORM_SPREAD_MIN_M):
                epoch_cfg = cfg._replace(norm_spread=True)
            epoch_loader = warm_loader if epoch < warmup_epochs else train_loader
            epoch_lr = float(lr_fn(epoch))
            epoch_series: dict[str, list[np.ndarray]] = {k: [] for k in series}
            train_accs = []

            # a whole epoch of uniform raw-pixel batches goes to fused_epoch
            batch_iter = None
            fallback_reason = None
            if fused and not debug and cfg.rank_mode == "fixed" and mps.l_pos == 0:
                batches = list(_loader_batches(epoch_loader))
                xs_np = [np.asarray(x) for x, _ in batches]
                ys_np = [np.asarray(y) for _, y in batches]
                uniform = (
                    len(batches) >= 2
                    and len(batches) % 2 == 0
                    and all(x.ndim == 2 for x in xs_np)
                    and len({x.shape for x in xs_np}) == 1
                    and len({y.shape for y in ys_np}) == 1
                )
                if uniform:
                    from tensornetworkforml_torch.train.epoch import fused_epoch

                    mps, accs, stepm = fused_epoch(
                        mps, np.stack(xs_np), np.stack(ys_np), epoch_lr, weight_dec, epoch_cfg,
                    )
                    train_accs = [float(a) for a in accs.cpu().numpy()]
                    epoch_series["accuracy"].append(stepm["accuracy"].cpu().numpy().reshape(-1))
                    epoch_series["MAE"].append(stepm["MAE"].cpu().numpy().reshape(-1))
                    batch_iter = ()
                else:
                    fallback_reason = "non-uniform batch shapes or odd batch count"
                    batch_iter = iter(batches)
            if batch_iter is None:
                if fused and not debug:
                    fallback_reason = (
                        f"rank_mode={cfg.rank_mode!r}" if cfg.rank_mode != "fixed"
                        else f"label leg at site {mps.l_pos} (needs 0)"
                    )
                batch_iter = _loader_batches(epoch_loader)
            if fallback_reason is not None and not fallback_warned:
                fallback_warned = True
                warnings.warn(
                    f"whole-epoch path unavailable ({fallback_reason}); sweeping "
                    "batch by batch", stacklevel=2,
                )

            n_batches = len(epoch_loader) if hasattr(epoch_loader, "__len__") else None
            for i, (x, y) in enumerate(batch_iter):
                phi = _as_phi(x, mps)
                y = torch.as_tensor(np.asarray(y)).to(mps.device)
                mps, f0, _, metrics = sweep_once(
                    mps, phi, one_hot_labels(y, mps.L, mps.dtype), epoch_lr, weight_dec,
                    epoch_cfg,
                )
                batch_acc = float(accuracy_from_scores(f0, y))
                train_accs.append(batch_acc)
                for k in series:
                    epoch_series[k].append(metrics[k].cpu().numpy())
                if verbose:
                    frac = (i + 1) * 100 / n_batches if n_batches else 0.0
                    print(f"\rEpoch {epoch}/{n_epochs} - train accuracy : "
                          f"{batch_acc:.4f} - completed : {frac:.2f} %", end=" ")

            var_hist.append(
                [np.concatenate(epoch_series[k]) for k in series]
                if train_accs else [np.zeros((0,)) for _ in series]
            )
            epoch_val = evaluate_accuracy(mps, val_loader)
            val_acc.append(epoch_val)
            if abort_on_stall and stall_detected(
                val_acc, warmup_epochs, stall_patience, stall_min_delta,
                stall_threshold, n_epochs=n_epochs,
            ):
                stalled = True
            if verbose:
                print(f"\rEpoch {epoch}/{n_epochs} - train accuracy : "
                      f"{np.mean(train_accs):.4f} - val accuracy: {epoch_val:.4f}")
            if checkpoint_path:
                from tensornetworkforml_torch.utils.checkpoint import save_training_state

                save_training_state(checkpoint_path, mps, epoch + 1)
            if epoch_callback is not None:
                epoch_callback(epoch, mps, epoch_val)
            if stalled:
                break
        return mps, val_acc, var_hist, stalled

    if restarts > 0 and reinit_fn is None:
        raise ValueError("restarts > 0 requires reinit_fn(attempt) -> MPS")
    best = None
    attempts_run = 0
    for attempt in range(max(0, int(restarts)) + 1):
        model0 = mps if attempt == 0 else reinit_fn(attempt)
        first = start_epoch if attempt == 0 else 0
        model, a_val, a_hist, stalled = _run_attempt(model0, first, attempt < restarts)
        attempts_run += 1
        score = a_val[-1] if a_val else float("-inf")
        if best is None or score > best[0]:
            best = (score, model, a_val, a_hist, first + len(a_val))
        if not stalled:
            break
        if verbose:
            print(f"validation stalled at {score:.4f}; restarting from a fresh "
                  f"init (attempt {attempt + 1}/{restarts})")
    _, mps, val_acc, var_hist, best_epoch = best
    # re-save the WINNING attempt: each attempt overwrote the same file
    if checkpoint_path and attempts_run > 1:
        from tensornetworkforml_torch.utils.checkpoint import save_training_state

        save_training_state(checkpoint_path, mps, best_epoch)
    try:
        var_hist_arr = np.array(var_hist)
    except ValueError:  # ragged per-epoch step counts (batch warmup)
        var_hist_arr = np.empty(len(var_hist), dtype=object)
        var_hist_arr[:] = var_hist
    return mps, val_acc, var_hist_arr


class Trainer:
    """Thin OO wrapper over ``train_model`` holding hyper-parameters."""

    def __init__(self, lr: float, weight_dec: float = 0.001, L2_flag: bool = True,
                 debug: bool = False, svd_method: str = "svd", split_mode: str = "shared",
                 renorm_envs: bool = False, growth_cap: float = 0.0,
                 matmul_precision: str = "default", fused: bool = True, verbose: bool = True,
                 warmup_epochs: int = 0, warmup_batch_divisor: Optional[int] = None,
                 bond_schedule: Optional[dict] = None):
        self.lr = lr
        self.weight_dec = weight_dec
        self.L2_flag = L2_flag
        self.debug = debug
        self.svd_method = svd_method
        self.split_mode = split_mode
        self.renorm_envs = renorm_envs
        self.growth_cap = growth_cap
        self.matmul_precision = matmul_precision
        self.fused = fused
        self.verbose = verbose
        self.warmup_epochs = warmup_epochs
        self.warmup_batch_divisor = warmup_batch_divisor
        self.bond_schedule = bond_schedule

    def fit(self, mps: MPS, train_loader, val_loader, n_epochs: int,
            checkpoint_path=None, resume=False):
        return train_model(
            mps, train_loader, val_loader, lr=self.lr, n_epochs=n_epochs,
            weight_dec=self.weight_dec, L2_flag=self.L2_flag, debug=self.debug,
            svd_method=self.svd_method, split_mode=self.split_mode,
            renorm_envs=self.renorm_envs, growth_cap=self.growth_cap,
            matmul_precision=self.matmul_precision, fused=self.fused,
            checkpoint_path=checkpoint_path, resume=resume, verbose=self.verbose,
            warmup_epochs=self.warmup_epochs,
            warmup_batch_divisor=self.warmup_batch_divisor,
            bond_schedule=self.bond_schedule,
        )
