"""Checkpointing in the ``.npz`` format shared with ``tensornetworkforml_tpu``.

A checkpoint holds ``sites``, ``label_site`` and a ``meta`` entry: the UTF-8
bytes of a JSON object ``{"version", "l_pos", "act_fn", "loss_fn", "T"}``
(plus ``"epoch"`` for a training state). A boundary-label model's holds
``sites``, ``w`` and ``{"version", "kind": "boundary", "act_fn", "loss_fn",
"T"}`` (plus ``"epoch"``, ``"sweep_idx"`` and ``"left"`` for a training
state). The keys, their order and the version are those of the JAX package's
``utils/checkpoint.py``, so each package reads the files the other writes.

The reference checkpoints whole ``Network`` objects with ``pickle``
(``trained_*_model.dat``; its schema is N/D/L/M/T, the act and loss names,
``l_pos`` and the per-site arrays with their axis names). A custom
unpickler reads them WITHOUT importing the reference code, and
``save_reference_pickle`` writes one the reference can load; both packages
write the same bytes for the same model.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import sys
import types
from typing import Any

import numpy as np
import torch

from tensornetworkforml_torch.models.boundary import BoundaryMPS
from tensornetworkforml_torch.models.mps import MPS, ragged_site_list, resolve_device

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


class _RefUnpickler(pickle.Unpickler):
    """Unpickler that materialises the reference's classes as plain stubs.

    The reference pickles ``Network`` objects whose class lives in its own
    ``Network_class`` / ``Tensor_class`` modules; empty types stand in for
    them, so the attribute state loads without executing or importing
    reference code.
    """

    _SUBSTITUTE = {
        ("Network_class", "Network"),
        ("Tensor_class", "Tensor"),
        ("TensorNetwork", "Network"),
        ("TensorNetwork", "Tensor"),
        ("__main__", "Network"),
        ("__main__", "Tensor"),
    }

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in self._SUBSTITUTE:
            return type(name, (), {})
        return super().find_class(module, name)


def load_reference_pickle(path: str) -> Any:
    """Load a reference ``trained_*_model.dat`` pickle as a stub object tree."""
    with open(path, "rb") as fh:
        return _RefUnpickler(fh).load()


class _RefTensorOut:
    """Stub pickled BY REFERENCE as ``Tensor_class.Tensor``."""


class _RefNetworkOut:
    """Stub pickled BY REFERENCE as ``Network_class.Network``."""


_RefTensorOut.__module__ = "Tensor_class"
_RefTensorOut.__qualname__ = "Tensor"
_RefNetworkOut.__module__ = "Network_class"
_RefNetworkOut.__qualname__ = "Network"


def _reference_class(stub: type) -> type:
    """The class that pickles by reference as ``stub``'s module and name.

    Pickle writes only the module and the class name, and requires the
    instance's class to BE ``sys.modules[module].<name>``. So the class is
    whatever that module already holds -- the reference's own where its
    modules are importable, or the stub another package installed under the
    same name -- and the stub is installed only where the name is free.
    """
    mod_name, name = stub.__module__, stub.__qualname__
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        mod = sys.modules[mod_name] = types.ModuleType(mod_name)
    cls = getattr(mod, name, None)
    if cls is None:
        setattr(mod, name, stub)
        cls = stub
    return cls


def _axes_names(n: int, N: int, l_pos: int) -> list:
    """The reference's axis names of site ``n`` (``Network_class.py:145-148``)."""
    if n == l_pos:
        if n == 0:
            return ["l", "right", f"d{n}"]
        if n == N - 1:
            return ["left", "l", f"d{n}"]
        return ["left", "right", "l", f"d{n}"]
    if n == 0:
        return ["right", f"d{n}"]
    if n == N - 1:
        return ["left", f"d{n}"]
    return ["left", "right", f"d{n}"]


def save_reference_pickle(mps: MPS, path: str) -> None:
    """Export an MPS as a pickle LOADABLE BY THE REFERENCE CODE.

    Writes a ``Network_class.Network`` object graph (class resolved by name
    at load time where the reference modules are importable) with the
    reference's attribute surface: N/D/L/M/T, act/loss names, ``l_pos``, and
    the per-site ``Tensor``s with float64 ``elem`` arrays and
    ``axes_names``. Bonds are exported at the padded width M (the reference
    ``forward`` handles any consistent bond dims), so round-tripping through
    the reference reproduces this model's outputs exactly.
    """
    net_cls = _reference_class(_RefNetworkOut)
    tensor_cls = _reference_class(_RefTensorOut)
    As = []
    for n, elem in enumerate(ragged_site_list(mps)):
        names = _axes_names(n, mps.N, mps.l_pos)
        t = tensor_cls.__new__(tensor_cls)
        t.elem = np.ascontiguousarray(elem, dtype=np.float64)
        t.axes_names = np.array(names)
        t.history_axes_names = [np.array(names)]
        t.aggregations = {}
        t.shape = t.elem.shape
        t.rank = t.elem.ndim
        As.append(t)

    net = net_cls.__new__(net_cls)
    net.N, net.D, net.L, net.M = int(mps.N), int(mps.D), int(mps.L), int(mps.M)
    net.T = float(mps.T)
    net.act_fn = mps.act_fn
    net.loss_fn = mps.loss_fn
    net.l_pos = int(mps.l_pos)
    net.As = As
    with open(path, "wb") as fh:
        pickle.dump(net, fh)


def mps_from_reference_pickle(path: str, dtype=torch.float64, device=None) -> MPS:
    """Convert a reference checkpoint into the padded-uniform MPS on
    ``device`` (``None``: the card)."""
    return mps_from_reference_net(load_reference_pickle(path), dtype=dtype, device=device)


def mps_from_reference_net(net: Any, dtype=torch.float64, device=None) -> MPS:
    """Convert a reference ``Network``-like object into the padded MPS on
    ``device`` (``None``: the card).

    ``net`` needs the reference's attribute surface: N/M/D/L/T, l_pos,
    act_fn/loss_fn, and ``As`` -- a list of tensors with ``.elem`` arrays and
    ``.axes_names`` (axis names like ``['left','right','d5']``, the label
    site carrying an extra ``'l'`` axis; written by
    ``Network_class.py:145-148`` and mutated by training). Each ragged site
    is permuted into the ``(left, d, right)`` convention and zero-padded to
    the static bond dimension M; zero padding composed with the one-hot
    boundary contraction reproduces the ragged chain product exactly.
    """
    N, M, D, L = int(net.N), int(net.M), int(net.D), int(net.L)
    l_pos = int(net.l_pos)
    sites = np.zeros((N, M, D, M), dtype=np.float64)
    label_site = np.zeros((M, D, L, M), dtype=np.float64)

    for n, A in enumerate(net.As):
        elem = np.asarray(A.elem, dtype=np.float64)
        ax = {str(name): i for i, name in enumerate(np.asarray(A.axes_names))}
        has_left, has_right, has_label = "left" in ax, "right" in ax, "l" in ax
        # permute to (left?, d, l?, right?), then singleton axes for the
        # missing bonds at the chain's edges
        order = ([ax["left"]] if has_left else []) + [ax[f"d{n}"]]
        order += ([ax["l"]] if has_label else []) + ([ax["right"]] if has_right else [])
        elem = np.transpose(elem, order)
        if not has_left:
            elem = elem[None]
        if not has_right:
            elem = elem[..., None]
        # (ml, D, [L,] mr) with ml/mr the true (possibly truncated) bond dims
        if has_label:
            if n != l_pos:
                raise ValueError(f"label axis found at site {n}, away from l_pos={l_pos}")
            ml, _, _, mr = elem.shape
            label_site[:ml, :, :, :mr] = elem
        else:
            ml, _, mr = elem.shape
            sites[n, :ml, :, :mr] = elem

    return mps_from_numpy(sites, label_site, l_pos=l_pos, act_fn=str(net.act_fn),
                          loss_fn=str(net.loss_fn), T=float(net.T),
                          device=resolve_device(device), dtype=dtype)
