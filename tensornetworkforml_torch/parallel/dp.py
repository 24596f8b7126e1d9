"""Data-parallel (and bond-parallel) sweeps over a ``torch.distributed`` mesh.

The counterpart of the JAX package's ``parallel/dp.py``. There one jitted
program runs the embedding, the forward and the whole sweep with the batch
sharded over the mesh's ``data`` axis, and GSPMD turns the two-site
gradient's sum over the batch into one ``psum`` a step. Here every rank runs
the same Python sweep on its own rows of the global batch, and the sweep
writes that all-reduce out (``train/sweep.py::two_site_update`` with a
``parallel.mesh.DataShards``): ONE all-reduce a step carries the gradient and
the step metrics' sums (a second, scalar one follows the split under
``renorm_envs``), so every rank ends the step with the same parameters.

Routes with no gradient of their own to sum -- the factored large-bond
update (``train/factored_step.py``: its ``(B, B)`` cross-sample products)
and the ``hybrid`` and ``fused`` engines (whose gradient is inside kernels K2
and K7) -- all-gather the batch once a sweep and run the unsharded sweep on
every rank, which is what GSPMD does with a kernel or a cross-sample product
it cannot partition; their results equal the single-device sweep's as well.
"""

from __future__ import annotations

import torch

from tensornetworkforml_torch.models.mps import MPS
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.parallel.mesh import (
    DataShards,
    mesh_device,
    replicated,
    site_sharding,
)
from tensornetworkforml_torch.train.sweep import (
    SweepConfig,
    _factored_route,
    _scalar,
    _sweep,
    one_hot_labels,
)


def _partitioned(cfg: SweepConfig, M: int, D: int) -> bool:
    """Whether a sweep's steps can sum their gradient over the data ranks:
    the xla engine's explicit per-step gradient, outside the factored
    route."""
    return cfg.engine == "xla" and not _factored_route(cfg, M, D)


def dp_sweep(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg, left_dir,
             dp: DataShards):
    """One sweep of the replicated model on this rank's rows ``phi (b, N, D)``,
    ``y_onehot (L, b)`` of a batch split over ``dp``'s ranks. Returns
    ``(new_sites, new_label_site, f_first, f_final, metrics)`` as
    ``train/sweep.py::_sweep`` does for the whole batch: the parameters and
    the per-step metrics are the whole batch's (the same on every rank), the
    outputs ``f`` this rank's columns."""
    N, M, D, _ = sites.shape
    if _partitioned(cfg, M, D):
        return _sweep(sites, label_site, phi, y_onehot, lr, weight_dec, ranks, T, cfg, left_dir,
                      dp=dp)
    # no explicit gradient to sum: the whole batch, once a sweep, on every rank
    new_s, new_l, f0, f_fin, metrics = _sweep(
        sites, label_site, dp.gather(phi), dp.gather(y_onehot, dim=1), lr, weight_dec, ranks,
        T, cfg, left_dir)
    return new_s, new_l, dp.rows(f0, dim=1), dp.rows(f_fin, dim=1), metrics


def batch_accuracy(f0: torch.Tensor, y: torch.Tensor, dp: DataShards) -> torch.Tensor:
    """The whole batch's accuracy from this rank's rows (one scalar
    all-reduce)."""
    right = (f0.argmax(dim=0) == y).to(f0.dtype).sum()
    return dp.sum(right)[0] / (y.shape[0] * dp.size)


def make_sharded_train_step(mesh, cfg: SweepConfig, T: float, n_labels: int, left_dir: bool,
                            shard_bonds: bool = False):
    """A mesh step: ``step(sites, label_site, x_raw (B, N), y (B,), lr, wd,
    ranks) -> (new_sites, new_label_site, batch_acc, metrics)``.

    Every rank passes the same global batch and takes its rows by its
    ``data`` coordinate. The parameters are the replicated model or, with
    ``shard_bonds``, this rank's blocks of the right bond leg over ``model``
    (``site_sharding``); they come back in the same form. ``batch_acc`` is the
    whole batch's pre-sweep accuracy and ``metrics`` the per-step series."""
    dp = DataShards(mesh)
    bonds = site_sharding(mesh)
    dev = mesh_device(mesh)

    def step(sites, label_site, x_raw, y, lr, weight_dec, ranks):
        x = dp.rows(torch.as_tensor(x_raw).to(dtype=sites.dtype, device=dev))
        y = dp.rows(torch.as_tensor(y).to(dev))
        if shard_bonds:
            sites, label_site = bonds.gather(sites), bonds.gather(label_site)
        ranks = [int(r) for r in ranks]
        new_s, new_l, f0, _, metrics = dp_sweep(
            sites, label_site, psi_embed(x), one_hot_labels(y, n_labels, sites.dtype), lr,
            weight_dec, ranks, T, cfg, left_dir, dp)
        acc = batch_accuracy(f0, y, dp)
        if shard_bonds:
            new_s, new_l = bonds.local(new_s).contiguous(), bonds.local(new_l).contiguous()
        return new_s, new_l, acc, metrics

    return step


class ShardedTrainer:
    """Data-parallel trainer: one sweep per ``step`` over a mesh.

    Every rank builds it with the same arguments and calls ``step`` with the
    same global batch; the model is rank 0's, broadcast, on the mesh's
    device. With ``shard_bonds`` each rank keeps only its block of the sites'
    and the label core's right bond leg between steps (``site_sharding``) and
    all-gathers the whole model at the start of each step (two all-gathers a
    sweep), sweeps it replicated, and keeps its block again; reading
    ``mps`` then gathers too, so every rank reads it. ``dist_split``
    (``"cholqr"`` or ``"polar"``) routes every split through
    ``parallel/dist_split.py`` over this mesh's ``model`` axis.
    """

    def __init__(self, mesh, mps: MPS, lr: float, weight_dec: float, L2_flag: bool = True,
                 svd_method: str = "svd", shard_bonds: bool = False, cfg: SweepConfig = None,
                 dist_split: str = "none"):
        self.mesh = mesh
        self.lr = lr
        self.weight_dec = weight_dec
        if dist_split != "none" and (L2_flag if cfg is None else cfg.L2_flag):
            # the bond-distributed split has no transfer-matrix L2 carry;
            # dropping the regulariser silently would change the optimisation
            raise ValueError(
                "L2_flag=True is not supported with dist_split != 'none' "
                "(exact transfer-matrix L2 is not implemented on the "
                "bond-distributed split path); pass L2_flag=False or a "
                "cfg with L2_flag=False, or use dist_split='none'"
            )
        if cfg is None:
            cfg = SweepConfig(
                act_fn=mps.act_fn, loss_fn=mps.loss_fn, L2_flag=L2_flag, svd_method=svd_method,
                split_mode="canonical" if dist_split != "none" else "shared",
            )
        if dist_split != "none":
            cfg = cfg._replace(dist_split=dist_split, dist_mesh=mesh)
        self.cfg = cfg
        self.shard_bonds = shard_bonds
        self._steps = {
            left: make_sharded_train_step(mesh, cfg, mps.T, mps.L, left, shard_bonds=shard_bonds)
            for left in (False, True)
        }
        self.mps = mps

    @property
    def mps(self) -> MPS:
        """The whole model (gathered from the ranks' blocks under
        ``shard_bonds``: a collective)."""
        if not self.shard_bonds:
            return self._mps
        bonds = site_sharding(self.mesh)
        return self._mps.replace(sites=bonds.gather(self._mps.sites),
                                 label_site=bonds.gather(self._mps.label_site))

    @mps.setter
    def mps(self, mps: MPS) -> None:
        rep = replicated(self.mesh)
        sites, label = rep.local(mps.sites), rep.local(mps.label_site)
        if self.shard_bonds:
            bonds = site_sharding(self.mesh)
            sites, label = bonds.local(sites).contiguous(), bonds.local(label).contiguous()
        self._mps = mps.replace(sites=sites, label_site=label)

    @property
    def local_sites(self) -> torch.Tensor:
        """The sites this rank holds between steps: ``(N, M, D, M / m)`` under
        ``shard_bonds``, else the whole stack."""
        return self._mps.sites

    def step(self, x_raw, y) -> float:
        """One sweep on one GLOBAL batch of raw pixels ``(B, N)`` and labels;
        returns the whole batch's accuracy before the sweep."""
        mps = self._mps
        left_dir = mps.l_pos == mps.N - 1
        new_s, new_l, acc, _ = self._steps[left_dir](
            mps.sites, mps.label_site, x_raw, y, _scalar(self.lr, mps),
            _scalar(self.weight_dec, mps), [mps.M] * (mps.N - 1))
        self._mps = mps.replace(sites=new_s, label_site=new_l, l_pos=0 if left_dir else mps.N - 1)
        return float(acc)
