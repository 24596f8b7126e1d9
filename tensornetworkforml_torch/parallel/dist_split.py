"""Bond-distributed two-site splits: the columns of ``B`` over a mesh axis.

The counterpart of the JAX package's ``parallel/dist_split.py``. ``B (I, J)``
has ``I = M*D`` rows and ``J = L*D*M`` columns; the columns are split over
the mesh's ``model`` axis. Every rank passes the same (replicated) ``B`` and
works on its own column block (``shard_bmat_columns``) and the matching rows
of the sketch matrix Omega, which is drawn at J rows with no tiling pad:

* per rank: the J-carrying products -- the Gram ``B B^T`` and the sketch
  ``B Omega`` over its columns -- summed across the axis by all-reduce;
  these carry all of the split's O(I J I) work;
* replicated: the (I, q)-shaped subspace iteration on the summed Gram and
  sketch, the same code as the single-device split;
* out: the isometric ``Q (I, rank)`` on every rank, and this rank's block
  of ``R = Q^T B (rank, J / n)``.

Two forms:

* ``distributed_cholqr_split``: one scalar all-reduce for ``|B|^2``, then one
  for ``Y = B Omega`` and one for ``G = B B^T``, then ``ops/svd.py``'s
  ``_cholqr_subspace`` (the core of ``batched_cholqr_split``);
* ``distributed_polar_split``: K5 (``polar_sketch_gram``) on the rank's
  columns, ONE all-reduce of ``(y, G, n2)`` as a flat buffer, then K1
  (``polar_iterate``) with that ``n2``. On a card these are the two kernels
  of ``polar_split_two_stage``; on the CPU their plain versions.

Communication per split: ``I q + I^2 + 1`` floats whatever J is, so the split
scales to any bond dimension at O(I J / n) memory a rank for its products.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.parallel.mesh import MODEL_AXIS, Shard, axis_size, sum_flat


def _column_shards(bmat: torch.Tensor, rank: int, mesh, axis: str):
    """``(q_cols, the rank's columns of B, the matching rows of Omega)``;
    raises when J does not divide over the axis."""
    I, J = bmat.shape
    n = axis_size(mesh, axis)
    if J % n:
        raise ValueError(f"column count {J} not divisible by mesh axis {axis!r} size {n}")
    q_cols = min(rank, I)
    om = _svd.rangefinder_omega(J, q_cols, bmat.dtype, bmat.device)
    return (q_cols, shard_bmat_columns(bmat, mesh, axis),
            Shard(mesh, axis, 0).local(om).contiguous())


def distributed_cholqr_split(bmat: torch.Tensor, rank: int, mesh, axis: str = MODEL_AXIS,
                             n_power: int = 3):
    """Canonical split of the replicated ``bmat (I, J)``, its columns split
    over ``axis``: ``(Q (I, q) on every rank, R_loc = Q^T B_loc (q, J / n))``
    with ``q = min(rank, I)``.

    The same as ``batched_cholqr_split(bmat[None], rank)`` up to the order of
    the sums across ranks: the subspace iteration is shared code."""
    group = mesh.get_group(axis)
    q_cols, b_loc, om_loc = _column_shards(bmat, rank, mesh, axis)
    eps = _svd._cholqr_eps(bmat.dtype, q_cols)
    bn2 = (b_loc * b_loc).sum()
    dist.all_reduce(bn2, group=group)
    bs = b_loc / torch.clamp(torch.sqrt(bn2), min=1e-30)
    y = bs @ om_loc
    dist.all_reduce(y, group=group)
    g = bs @ bs.T
    dist.all_reduce(g, group=group)
    q = _svd._cholqr_subspace(g[None], y[None], eps, n_power)[0]
    return q, q.T @ b_loc


def shard_bmat_columns(bmat: torch.Tensor, mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's column block of a replicated two-site matrix, as a
    contiguous copy (the kernels take contiguous operands)."""
    return Shard(mesh, axis, 1).local(bmat).contiguous()


def distributed_polar_split(bmat: torch.Tensor, rank: int, mesh, axis: str = MODEL_AXIS):
    """The polar split of the replicated ``bmat (I, J)`` with its columns over
    ``axis``: K5 on the rank's columns, one all-reduce of ``(y, G, n2)``, K1
    on the sums. Returns ``(Q (I, q), R_loc (q, J / n))`` in ``bmat``'s
    dtype; the kernels run in float32 (``bmat`` is cast), ``dead_tol`` is
    1e-6, 1e-12 for float64 input, as in ``polar_split_two_stage``, which is
    this split on one rank; ``R_loc`` is a plain float32 product."""
    from tensornetworkforml_torch.ops.kernels.polar_split import (
        polar_iterate,
        polar_sketch_gram,
    )

    out_dtype = bmat.dtype
    dead_tol = 1e-6 if bmat.dtype != torch.float64 else 1e-12
    _, b_loc, om_loc = _column_shards(bmat.to(torch.float32), rank, mesh, axis)
    y, g, n2 = sum_flat(mesh.get_group(axis), *polar_sketch_gram(b_loc, om_loc))
    q = polar_iterate(y, g, n2, dead_tol=dead_tol)
    return q.to(out_dtype), (q.T @ b_loc).to(out_dtype)
