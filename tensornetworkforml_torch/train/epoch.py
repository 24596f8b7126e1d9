"""One training epoch: a full sweep per batch, directions alternating.

The counterpart of the JAX package's ``fused_epoch``. There the epoch is one
compiled ``lax.scan`` over batch pairs; here it is a Python loop over the
batches on the model's device, with the same semantics: embedding, forward
and one full two-site sweep per batch, right sweeps on even batches and
mirrored left sweeps on odd ones (``Network_class.py:323-333``), so the
label leg returns to site 0 after an even number of batches. With a mesh,
every batch's samples are split over its ``data`` axis
(``parallel/dp.py::dp_sweep``).
"""

from __future__ import annotations

import torch

from tensornetworkforml_torch.models.mps import MPS
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.sweep import SweepConfig, _scalar, _sweep, one_hot_labels
from tensornetworkforml_torch.utils.profiling import EPOCH, span


def fused_epoch(mps: MPS, x_epoch, y_epoch, lr: float, weight_dec: float,
                cfg: SweepConfig = None, mesh=None):
    """Run one epoch; the label leg must start at site 0 and the number of
    batches must be even. ``x_epoch (n_batches, B, N)`` raw pixels,
    ``y_epoch (n_batches, B)`` integer labels (arrays or tensors).

    Returns ``(new_mps, batch_accs (n_batches,), step_metrics)`` where
    ``step_metrics`` holds the per-step series ``accuracy`` and ``MAE`` of
    shape ``(n_batches, N-1)``. Everything stays on the model's device.

    With a ``mesh`` (``parallel/mesh.py``), every rank passes the same epoch
    and sweeps its rows of each batch by its ``data`` coordinate, with one
    all-reduce of the gradient and metric sums a step; the model is rank
    0's, on the mesh's device, and every rank returns the same model,
    accuracies and metrics, those of the whole batches.
    """
    with span(EPOCH):
        if mesh is not None:
            from tensornetworkforml_torch.parallel.dp import batch_accuracy, dp_sweep
            from tensornetworkforml_torch.parallel.mesh import DataShards, replicate_params

            dp = DataShards(mesh)
            mps = replicate_params(mesh, mps)
        if cfg is None:
            cfg = SweepConfig(act_fn=mps.act_fn, loss_fn=mps.loss_fn)
        if mps.l_pos != 0:
            raise ValueError("fused_epoch expects the label leg at site 0")
        if len(x_epoch) % 2 != 0:
            raise ValueError("fused_epoch needs an even number of batches")
        x = torch.as_tensor(x_epoch).to(dtype=mps.dtype, device=mps.device)
        y = torch.as_tensor(y_epoch).to(device=mps.device)
        lr, wd = _scalar(lr, mps), _scalar(weight_dec, mps)
        ranks = [mps.M] * (mps.N - 1)
        sites, label = mps.sites, mps.label_site
        accs, acc_series, mae_series = [], [], []
        for b in range(x.shape[0]):
            if mesh is None:
                sites, label, f0, _, metrics = _sweep(
                    sites, label, psi_embed(x[b]), one_hot_labels(y[b], mps.L, mps.dtype), lr, wd,
                    ranks, mps.T, cfg, left_dir=b % 2 == 1,
                )
                accs.append((f0.argmax(dim=0) == y[b]).to(mps.dtype).mean())
            else:
                xb, yb = dp.rows(x[b]), dp.rows(y[b])
                sites, label, f0, _, metrics = dp_sweep(
                    sites, label, psi_embed(xb), one_hot_labels(yb, mps.L, mps.dtype), lr, wd,
                    ranks, mps.T, cfg, b % 2 == 1, dp)
                accs.append(batch_accuracy(f0, yb, dp))
            acc_series.append(metrics["accuracy"])
            mae_series.append(metrics["MAE"])
        return (
            mps.replace(sites=sites, label_site=label),
            torch.stack(accs),
            {"accuracy": torch.stack(acc_series), "MAE": torch.stack(mae_series)},
        )
