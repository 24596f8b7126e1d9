"""Checkpointing in the ``.npz`` format shared with ``tensornetworkforml_tpu``.

A checkpoint holds ``sites``, ``label_site`` and a ``meta`` entry: the UTF-8
bytes of a JSON object ``{"version", "l_pos", "act_fn", "loss_fn", "T"}``
(plus ``"epoch"`` for a training state). A boundary-label model's holds
``sites``, ``w`` and ``{"version", "kind": "boundary", "act_fn", "loss_fn",
"T"}`` (plus ``"epoch"``, ``"sweep_idx"`` and ``"left"`` for a training
state). The keys, their order and the version are those of the JAX package's
``utils/checkpoint.py``, so each package reads the files the other writes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tensornetworkforml_torch.models.boundary import BoundaryMPS
from tensornetworkforml_torch.models.mps import MPS, resolve_device

_CKPT_VERSION = 1


def _meta(mps: MPS, **extra) -> np.ndarray:
    meta = {
        "version": _CKPT_VERSION,
        "l_pos": int(mps.l_pos),
        "act_fn": mps.act_fn,
        "loss_fn": mps.loss_fn,
        "T": float(mps.T),
        **extra,
    }
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _write(fh, mps: MPS, meta: np.ndarray) -> None:
    np.savez(
        fh,
        sites=mps.sites.detach().cpu().numpy(),
        label_site=mps.label_site.detach().cpu().numpy(),
        meta=meta,
    )


def mps_from_numpy(
    sites,
    label_site,
    *,
    l_pos: int = 0,
    act_fn: str = "linear",
    loss_fn: str = "cross_entropy",
    T: float = 0.1,
    device=None,
    dtype=None,
) -> MPS:
    """Build an ``MPS`` from numpy parameters (e.g. ``np.asarray`` of the
    JAX package's ``mps.sites`` and ``mps.label_site``)."""
    return MPS(
        torch.tensor(np.asarray(sites), dtype=dtype, device=device),
        torch.tensor(np.asarray(label_site), dtype=dtype, device=device),
        l_pos=l_pos,
        act_fn=act_fn,
        loss_fn=loss_fn,
        T=T,
    )


def _read(path: str, dtype, device):
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        sites = data["sites"]
        label_site = data["label_site"]
    mps = mps_from_numpy(
        sites,
        label_site,
        l_pos=meta["l_pos"],
        act_fn=meta["act_fn"],
        loss_fn=meta["loss_fn"],
        T=meta["T"],
        device=device,
        dtype=dtype,
    )
    return mps, meta


def save_checkpoint(mps: MPS, path: str) -> None:
    """Save an MPS to a self-describing ``.npz`` file."""
    _write(path, mps, _meta(mps))


def load_checkpoint(path: str, dtype=None, device=None) -> MPS:
    """Load an MPS from a ``.npz`` checkpoint written by ``save_checkpoint``
    onto ``device`` (``None``: the card, see ``resolve_device``)."""
    return _read(path, dtype, resolve_device(device))[0]


def save_training_state(path: str, mps: MPS, epoch: int) -> None:
    """Atomic mid-training checkpoint: model + epoch counter.

    The temp-file + rename makes a crash during the write recoverable (the
    previous epoch's state survives).
    """
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        _write(fh, mps, _meta(mps, epoch=int(epoch)))
    os.replace(tmp, path)


def load_training_state(path: str, template: MPS = None):
    """Load a mid-training checkpoint; returns ``(mps, next_epoch)``.

    With a ``template``, the model takes the template's dtype and device.
    """
    dtype = None if template is None else template.dtype
    device = None if template is None else template.device
    mps, meta = _read(path, dtype, device)
    return mps, int(meta.get("epoch", 0))


def boundary_from_numpy(
    sites,
    w,
    *,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    T: float = 0.1,
    dtype=None,
    device=None,
) -> BoundaryMPS:
    """Build a ``BoundaryMPS`` from numpy parameters (e.g. ``np.asarray`` of
    the JAX package's ``model.sites`` and ``model.w``)."""
    return BoundaryMPS(
        torch.tensor(np.asarray(sites), dtype=dtype, device=device),
        torch.tensor(np.asarray(w), dtype=dtype, device=device),
        act_fn=act_fn,
        loss_fn=loss_fn,
        T=T,
    )


def _boundary_meta(model: BoundaryMPS, **extra) -> np.ndarray:
    meta = {
        "version": _CKPT_VERSION,
        "kind": "boundary",
        "act_fn": model.act_fn,
        "loss_fn": model.loss_fn,
        "T": float(model.T),
        **extra,
    }
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _write_boundary(fh, model: BoundaryMPS, meta: np.ndarray) -> None:
    np.savez(
        fh,
        sites=model.sites.detach().cpu().numpy(),
        w=model.w.detach().cpu().numpy(),
        meta=meta,
    )


def save_boundary_checkpoint(model: BoundaryMPS, path: str) -> None:
    """Save a BoundaryMPS (sites + output projection) to ``.npz``."""
    _write_boundary(path, model, _boundary_meta(model))


def save_boundary_training_state(
    path: str, model: BoundaryMPS, epoch: int, sweep_idx: int = 0, left: bool = False
) -> None:
    """Atomic mid-training checkpoint for the boundary-label trainers: model,
    epoch counter and sweep-schedule state (the per-sweep lr decay and the
    alternating direction must survive a resume)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        _write_boundary(fh, model, _boundary_meta(
            model, epoch=int(epoch), sweep_idx=int(sweep_idx), left=bool(left)))
    os.replace(tmp, path)


def _read_boundary(path: str, dtype, device):
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        sites = data["sites"]
        w = data["w"]
    if meta.get("kind") != "boundary":
        raise ValueError(f"{path!r} is not a boundary-MPS checkpoint")
    model = boundary_from_numpy(sites, w, act_fn=meta["act_fn"], loss_fn=meta["loss_fn"],
                                T=meta["T"], dtype=dtype, device=device)
    return model, meta


def load_boundary_checkpoint(path: str, dtype=None, device=None) -> BoundaryMPS:
    """Load a BoundaryMPS from a ``.npz`` written by ``save_boundary_checkpoint``
    onto ``device`` (``None``: the card)."""
    return _read_boundary(path, dtype, resolve_device(device))[0]


def load_boundary_training_state(path: str, dtype=None, device=None):
    """Load a boundary-label mid-training checkpoint onto ``device``
    (``None``: the card); returns ``(model, next_epoch, sweep_idx, left)``."""
    model, meta = _read_boundary(path, dtype, resolve_device(device))
    return (
        model,
        int(meta.get("epoch", 0)),
        int(meta.get("sweep_idx", 0)),
        bool(meta.get("left", False)),
    )


def load_any_checkpoint(path: str, dtype=None, device=None):
    """Load either checkpoint family from one read of the archive's meta: an
    ``MPS`` or a ``BoundaryMPS`` according to the stored ``kind``.
    ``device=None`` is the card.
    """
    with np.load(path) as data:
        if "meta" not in data:
            raise ValueError(
                f"{path!r} is not a tensornetworkforml checkpoint: "
                "expected an .npz archive with a 'meta' JSON entry "
                "(entries found: " + ", ".join(sorted(data.files)) + ")"
            )
        meta = json.loads(bytes(data["meta"]).decode())
    if meta.get("kind") == "boundary":
        return load_boundary_checkpoint(path, dtype=dtype, device=device)
    return load_checkpoint(path, dtype=dtype, device=resolve_device(device))
