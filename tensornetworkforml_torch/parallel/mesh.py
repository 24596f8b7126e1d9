"""Device meshes over ``torch.distributed``, and the rank's share of a tensor.

The counterpart of the JAX package's ``parallel/mesh.py``. There the mesh is
a ``jax.sharding.Mesh`` and sharding is declarative: GSPMD inserts the
collectives. Here the mesh is a ``DeviceMesh`` from ``init_device_mesh``, run
the PyTorch way: one process per rank, each calling the same function with
the same global inputs, each taking its share by its coordinate on a mesh
axis, and the collectives written out on the process groups of the mesh's
rows and columns:

* ``data`` axis -- batch parallelism. Every contraction of a sweep is
  batch-local except the sums over the batch (the two-site gradient, the
  step metrics' means), which become one all-reduce over ``data``.
* ``model`` axis -- bond parallelism: the two-site matrix's columns split
  over it (``parallel/dist_split.py``), and the site stacks' right bond leg
  (``site_sharding``).

The JAX helpers keep their names and become:

* ``batch_sharding`` and ``site_sharding``: a ``Shard`` -- the split of one
  tensor dimension over one mesh axis; ``Shard.local`` gives this rank's
  slice, ``Shard.gather`` puts the slices back together (an all-gather);
* ``shard_batch``: each array's rows of this rank, on the mesh's device;
* ``replicated`` and ``replicate_params``: a broadcast from rank 0, so that
  every rank holds rank 0's tensor (``Replicated.local``).

``sum_flat`` sums several tensors over an axis in one all-reduce.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _resolve_device(device) -> torch.device:
    # models/mps.py's resolve_device, looked up at call time so that a
    # rehearsal on the CPU can replace it there
    from tensornetworkforml_torch.models import mps

    return mps.resolve_device(device)


def _init_world(device: torch.device) -> None:
    """The default process group: from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``) when it is set, else a world of one
    over an in-process ``HashStore``. NCCL on the card, gloo on the CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    device=None,
):
    """A ``DeviceMesh`` over every rank of the default process group.

    ``device=None`` is the card (NCCL) and raises without one; ``"cpu"``
    runs over gloo. With no process group yet, one is initialised: from
    torchrun's environment, or as a world of one over a ``HashStore``.
    Default shape: every rank on the ``data`` axis (pure data parallelism),
    ``model`` of size 1; ``shape=(d, m)`` gives hybrid data x bond
    parallelism. Raises ``ValueError`` when ``shape`` does not cover the
    world.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = _resolve_device(device)
    if not dist.is_initialized():
        _init_world(dev)
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def sum_flat(group, *tensors: torch.Tensor) -> list:
    """Each tensor summed over the ranks of ``group``, all of them in ONE
    all-reduce of a flat buffer (the JAX package's variadic psum); returns
    views of that buffer in the tensors' shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class Shard(NamedTuple):
    """Dimension ``dim`` of a tensor split evenly over ``axis`` of ``mesh``."""

    mesh: object
    axis: str
    dim: int

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` (a view); the dimension must divide
        evenly, as a sharded array's must in JAX."""
        n = axis_size(self.mesh, self.axis)
        size = t.shape[self.dim]
        if size % n:
            raise ValueError(
                f"dimension {self.dim} of size {size} is not divisible by mesh axis "
                f"{self.axis!r} of size {n}"
            )
        return t.narrow(self.dim, self.mesh.get_local_rank(self.axis) * (size // n), size // n)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block, concatenated in rank order: the whole tensor
        (one all-gather)."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(axis_size(self.mesh, self.axis))]
        dist.all_gather(parts, src, group=self.mesh.get_group(self.axis))
        return torch.cat(parts, dim=self.dim)


class Replicated(NamedTuple):
    """A tensor every rank holds whole: rank 0's copy, broadcast."""

    mesh: object

    def local(self, t: torch.Tensor) -> torch.Tensor:
        out = t.to(mesh_device(self.mesh)).clone().contiguous()
        dist.broadcast(out, src=0)
        return out


def batch_sharding(mesh, batch_axis: int = 0, ndim: int = 3) -> Shard:
    """The batch axis of an input split over ``data``. ``ndim`` is the JAX
    signature's; a ``Shard`` does not need it."""
    return Shard(mesh, DATA_AXIS, batch_axis)


def replicated(mesh) -> Replicated:
    return Replicated(mesh)


def site_sharding(mesh, bond_axis: int = 3) -> Shard:
    """The padded site stack ``(N, M, D, M)`` split on a bond leg over
    ``model``."""
    return Shard(mesh, MODEL_AXIS, bond_axis)


def shard_batch(mesh, *arrays, batch_axes=None):
    """Each array's batch rows of this rank, on the mesh's device (axis 0 of
    each unless ``batch_axes`` says otherwise)."""
    if batch_axes is None:
        batch_axes = [0] * len(arrays)
    dev = mesh_device(mesh)
    out = [batch_sharding(mesh, ax).local(torch.as_tensor(a)).to(dev)
           for a, ax in zip(arrays, batch_axes)]
    return out if len(out) > 1 else out[0]


def replicate_params(mesh, mps):
    """``mps`` with rank 0's parameters on every rank's device (a broadcast)."""
    rep = replicated(mesh)
    return mps.replace(sites=rep.local(mps.sites), label_site=rep.local(mps.label_site))


class DataShards:
    """The batch split over a mesh's ``data`` axis: this rank's rows
    (``batch_sharding``), and the sums over the whole batch as one
    all-reduce (``sum_flat``) -- what the JAX package's GSPMD inserts as a
    ``psum`` where a contraction sums over a sharded batch leg."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = axis_size(mesh, DATA_AXIS)

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return batch_sharding(self.mesh, dim).local(t)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return batch_sharding(self.mesh, dim).gather(t)

    def sum(self, *tensors: torch.Tensor) -> list:
        return sum_flat(self.mesh.get_group(DATA_AXIS), *tensors)
