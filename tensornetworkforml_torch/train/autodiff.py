"""Autodiff training: optimise all site tensors at once with a first-order
optimiser.

The counterpart of the JAX package's ``train/autodiff.py`` (optax there,
``torch.optim`` here): differentiate the full chain contraction and step
every site at once. A finetuning stage after DMRG sweeps (bond structure
fixed), and the trainer of the ring topology (``models/ring.py``).

The step -- embedding, forward, loss, backward, optimiser -- runs the plain
forward (``models/mps.py::_forward_arrays``): the chain kernel K3 has no
backward, in either package. Bond dimensions stay fixed. A step takes its
batch as numpy arrays or as tensors on any device (a batch already on the
model's device is used in place), and records the spans of
``utils/profiling.py`` (the step, and in it the forward, the backward and
the optimiser) while a profiler records.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tensornetworkforml_torch.models.mps import MPS, _forward_arrays
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.train.trainer import _loader_batches
from tensornetworkforml_torch.utils.profiling import (
    AUTODIFF_BACKWARD,
    AUTODIFF_FORWARD,
    AUTODIFF_OPTIMIZER,
    AUTODIFF_STEP,
    span,
)


class AutodiffConfig(NamedTuple):
    loss: str = "softmax_xent"  # "softmax_xent" | "mse"
    optimizer: str = "adam"  # "adam" | "sgd"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0  # an L2 term in the loss, not decoupled decay


def _loss_fn(params, x_raw, y, l_pos, T, cfg, forward_arrays):
    sites, label_site = params
    scores = forward_arrays(sites, label_site, psi_embed(x_raw), l_pos)  # (L, B)
    if cfg.loss == "softmax_xent":
        loss = F.cross_entropy((scores / T).T, y)
    elif cfg.loss == "mse":
        y_onehot = F.one_hot(y, scores.shape[0]).T.to(scores.dtype)
        loss = ((scores - y_onehot) ** 2).mean()
    else:
        raise ValueError(f"unknown loss {cfg.loss!r}")
    if cfg.weight_decay:
        loss = loss + cfg.weight_decay * ((sites ** 2).sum() + (label_site ** 2).sum())
    acc = (torch.argmax(scores.detach(), dim=0) == y).to(scores.dtype).mean()
    return loss, acc


def make_optimizer(cfg: AutodiffConfig, params) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8 is optax's
    ``adam`` update (m_hat / (sqrt(v_hat) + eps)); plain ``SGD`` is
    ``optax.sgd``."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _on(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a tensor on any device, or anything ``np.asarray`` takes) as a
    tensor on ``device``; a tensor is moved only if it is elsewhere."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A fresh leaf tensor that takes gradients (the model's own is untouched)."""
    return t.detach().clone().requires_grad_(True)


class AutodiffTrainer:
    """Full-gradient trainer over a fixed bond structure.

    ``forward_arrays(sites, label_site, phi, l_pos) -> (L, B)`` is the
    forward to differentiate (default: the open chain's plain forward).
    The trainer optimises its own copies of the model's tensors; ``mps``
    returns the current model.
    """

    def __init__(self, mps: MPS, cfg: AutodiffConfig = AutodiffConfig(), forward_arrays=None):
        self._model = mps
        self.cfg = cfg
        self.params = [_leaf(mps.sites), _leaf(mps.label_site)]
        self.opt = make_optimizer(cfg, self.params)
        self._fwd = forward_arrays or _forward_arrays
        self._l_pos = mps.l_pos

    @property
    def mps(self) -> MPS:
        sites, label_site = (p.detach().clone() for p in self.params)
        return self._model.replace(sites=sites, label_site=label_site)

    def step(self, x_raw, y) -> tuple[float, float]:
        """One optimiser step on a batch; returns ``(loss, accuracy)``."""
        with span(AUTODIFF_STEP):
            dev, dtype = self.params[0].device, self.params[0].dtype
            x_raw = _on(x_raw, dev, dtype)
            y = _on(y, dev).long()
            self.opt.zero_grad(set_to_none=True)
            with span(AUTODIFF_FORWARD):
                loss, acc = _loss_fn(self.params, x_raw, y, self._l_pos, self._model.T,
                                     self.cfg, self._fwd)
            with span(AUTODIFF_BACKWARD):
                loss.backward()
            with span(AUTODIFF_OPTIMIZER):
                self.opt.step()
            return float(loss.detach()), float(acc)

    def fit(self, loader, n_epochs: int, verbose: bool = False):
        """Epoch loop over a loader of raw-pixel batches."""
        history = []
        for epoch in range(n_epochs):
            losses, accs = [], []
            for x, y in _loader_batches(loader):
                loss, acc = self.step(np.asarray(x).reshape(len(x), -1), y)
                losses.append(loss)
                accs.append(acc)
            history.append({"loss": float(np.mean(losses)), "accuracy": float(np.mean(accs))})
            if verbose:
                print(f"epoch {epoch}: {history[-1]}")
        return history


class BoundaryAutodiffTrainer(AutodiffTrainer):
    """Autodiff trainer for the boundary-label family: optimises ``(sites, w)``
    jointly (a finetuning stage after one-site or brick-wall training; bond
    structure fixed)."""

    def __init__(self, model, cfg: AutodiffConfig = AutodiffConfig()):
        from tensornetworkforml_torch.models.boundary import boundary_forward_arrays

        self._model = model
        self.cfg = cfg
        self.params = [_leaf(model.sites), _leaf(model.w)]
        self.opt = make_optimizer(cfg, self.params)
        self._fwd = lambda sites, w, phi, _l_pos: boundary_forward_arrays(sites, w, phi)
        self._l_pos = 0

    @property
    def mps(self):
        sites, w = (p.detach().clone() for p in self.params)
        return self._model.replace(sites=sites, w=w)

    @property
    def model(self):
        return self.mps
