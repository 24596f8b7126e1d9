"""Reference-compatible ``Network`` facade over the port's functional core.

The API surface of the reference ``Network_class.Network`` and of the JAX
package's facade: constructor signature, ``forward``, ``train``,
``accuracy``, ``sweep``, ``apply_act_func``, ``compute_loss_derivate``,
``tensor_svd``, ``compute_L2_reg``, plus checkpoint save/load. Everything
delegates to the padded-MPS engine (``models/mps.py``, ``train/sweep.py``,
``train/trainer.py``); this class holds the current ``MPS`` and adapts
layouts. Scores and derivatives come back as named ``Tensor``s.

A user of the reference can switch imports and keep their scripts:
``Network(N, M, L=2, calibration_X=x, normalize=True, act_fn='softmax',
loss_fn='full_cross_ent')`` then ``net.train(train_loader, val_loader, lr,
n_epochs, weight_dec)``. The model lives on ``device`` (``None``: the card,
see ``resolve_device``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensornetworkforml_torch.models.mps import (
    apply_act_fn,
    loss_derivative,
    mps_forward,
    mps_init,
    ragged_site_list,
    resolve_device,
)
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.tensor import Tensor


class Network:
    """Matrix Product State classifier with a reference-compatible API.

    The weights are ``mps_init``'s, drawn from a CPU ``torch.Generator``
    seeded with ``seed`` (``np.random.randint`` when None), so a seed gives
    the same model on the CPU and on the card.
    """

    def __init__(
        self,
        N: int,
        M: int,
        D: int = 2,
        L: int = 10,
        T: float = 0.1,
        normalize: bool = False,
        calibration_X: Optional[np.ndarray] = None,
        act_fn: str = "linear",
        loss_fn: str = "cross_entropy",
        check: bool = False,
        dtype=torch.float32,
        seed: Optional[int] = None,
        device=None,
    ):
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        device = resolve_device(device)
        calibration_phi = (
            None if calibration_X is None
            else torch.as_tensor(np.asarray(calibration_X)).to(dtype=dtype, device=device)
        )
        self.mps = mps_init(
            torch.Generator().manual_seed(seed),
            N=N,
            M=M,
            D=D,
            L=L,
            T=T,
            normalize=normalize,
            calibration_phi=calibration_phi,
            act_fn=act_fn,
            loss_fn=loss_fn,
            dtype=dtype,
            check=check,
            device=device,
        )

    # -- reference-compatible attribute surface ------------------------------

    @property
    def N(self) -> int:
        return self.mps.N

    @property
    def M(self) -> int:
        return self.mps.M

    @property
    def D(self) -> int:
        return self.mps.D

    @property
    def L(self) -> int:
        return self.mps.L

    @property
    def T(self) -> float:
        return self.mps.T

    @property
    def act_fn(self) -> str:
        return self.mps.act_fn

    @property
    def loss_fn(self) -> str:
        return self.mps.loss_fn

    @property
    def l_pos(self) -> int:
        return self.mps.l_pos

    @property
    def device(self) -> torch.device:
        return self.mps.device

    @property
    def As(self):
        """Ragged per-site numpy view in the reference's conventions."""
        return ragged_site_list(self.mps)

    def _phi(self, X) -> torch.Tensor:
        """An embedded batch ``(B, N, D)``, or raw pixels ``(B, N)`` embedded
        here, as the model's dtype on its device."""
        X = torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor) else X)
        X = X.to(dtype=self.mps.dtype, device=self.mps.device)
        return psi_embed(X) if X.dim() == 2 else X

    # -- inference -----------------------------------------------------------

    def forward(self, X) -> Tensor:
        """Un-activated scores as a named Tensor ``(l, b)``.

        ``X`` is an embedded batch ``(B, N, D)`` (reference convention) or
        raw pixels ``(B, N)``.
        """
        return Tensor(elem=mps_forward(self.mps, self._phi(X)), axes_names=["l", "b"])

    def apply_act_func(self, f: Tensor) -> Tensor:
        return Tensor(
            elem=apply_act_fn(f.elem, self.mps.act_fn, self.mps.T),
            axes_names=list(f.axes_names),
        )

    def compute_loss_derivate(self, f: Tensor, y) -> Tensor:
        """``y`` is one-hot ``(L, B)`` as in the reference."""
        y = torch.as_tensor(np.asarray(y)).to(dtype=self.mps.dtype, device=f.elem.device)
        return Tensor(
            elem=loss_derivative(f.elem, y, self.mps.loss_fn, self.mps.act_fn, self.mps.T),
            axes_names=list(f.axes_names),
        )

    def accuracy(self, X, y, f: Optional[Tensor] = None) -> float:
        if f is None:
            f = self.forward(X)
        y_pred = f.elem.argmax(dim=0).cpu().numpy()
        return float(np.mean(y_pred == np.asarray(y)))

    # -- training ------------------------------------------------------------

    def sweep(
        self,
        X,
        y,
        f,
        lr,
        weight_dec,
        L2_flag: bool = True,
        left_dir: bool = False,
        var_hist=None,
        debug: bool = False,
    ) -> Tensor:
        """One full optimisation sweep (reference ``Network_class.py:384``).

        ``y`` are integer labels ``(B,)`` or one-hot ``(L, B)``; ``f`` is
        accepted for signature parity (the sweep recomputes it). Appends the
        per-step series to ``var_hist`` if given.
        """
        from tensornetworkforml_torch.train.sweep import SweepConfig, sweep_once

        del f  # recomputed inside the sweep
        y = np.asarray(y)
        if y.ndim == 1:  # integer labels -> one-hot (L, B)
            y_onehot = np.zeros((self.L, len(y)))
            y_onehot[y, np.arange(len(y))] = 1.0
        else:
            y_onehot = y
        if bool(left_dir) != (self.mps.l_pos == self.N - 1):
            raise ValueError("sweep direction does not match the label-leg position")
        cfg = SweepConfig(
            act_fn=self.act_fn, loss_fn=self.loss_fn, L2_flag=L2_flag, debug=debug
        )
        self.mps, _, f_fin, metrics = sweep_once(
            self.mps, self._phi(X), torch.as_tensor(y_onehot), lr, weight_dec, cfg
        )
        if var_hist is not None:
            if debug:
                keys = ("mean_abs_B", "mean_abs_deltaB", "accuracy", "mean_abs_f",
                        "MAE", "L2_loss", "mean_abs_L2_grad")
            else:
                keys = ("accuracy", "MAE")
            for slot, key in enumerate(keys):
                var_hist[slot].extend(metrics[key].cpu().numpy().tolist())
        return Tensor(elem=f_fin, axes_names=["l", "b"])

    def train(
        self,
        train_loader,
        val_loader,
        lr,
        n_epochs: int = 10,
        weight_dec: float = 0.001,
        L2_flag: bool = True,
        debug: bool = False,
        verbose: bool = True,
        split_mode: str = "shared",
    ):
        """Reference-compatible training loop; returns ``(val_acc, var_hist)``.

        ``split_mode="canonical"`` selects the gauge-fixed DMRG sweep
        (recommended for long chains in float32; see ``models/canonical.py``).
        """
        from tensornetworkforml_torch.train.trainer import train_model

        self.mps, val_acc, var_hist = train_model(
            self.mps,
            train_loader,
            val_loader,
            lr=lr,
            n_epochs=n_epochs,
            weight_dec=weight_dec,
            L2_flag=L2_flag,
            debug=debug,
            verbose=verbose,
            split_mode=split_mode,
        )
        return val_acc, var_hist

    def tensor_svd(self, T: Tensor, left_dir: bool = False, threshold: float = 0.999):
        """Split a 2-D named tensor by truncated SVD, sqrt(S) on both sides.

        Reference semantics (``Network_class.py:839-962``): ``T`` carries
        ``aggregations['i']``/``['j']`` describing the grouped legs; middle
        positions truncate to the pre-merge 'left' bond, chain ends keep
        full rank; ``threshold`` is accepted for signature parity (it is
        unused in the reference too). Returns ``(TU, TSVh)`` with the
        original legs disaggregated.
        """
        if len(T.shape) != 2:
            raise ValueError("tensor_svd expects a 2-D tensor")
        U, S, Vh = torch.linalg.svd(T.elem, full_matrices=False)

        l_pos, N = self.l_pos, self.N
        middle = (not left_dir and 0 < l_pos < N - 2) or (left_dir and 1 < l_pos < N - 1)
        if middle and "i" in T.aggregations and "left" in T.aggregations["i"]:
            m = int(T.aggregations["i"]["left"])
        else:
            m = int(S.shape[0])
        sqrt_s = torch.sqrt(torch.clamp(S[:m], min=0.0))
        TU = Tensor(elem=U[:, :m] * sqrt_s[None, :], axes_names=["i", "right"])
        TSVh = Tensor(elem=sqrt_s[:, None] * Vh[:m, :], axes_names=["left", "j"])
        if "i" in T.aggregations:
            TU.aggregations["i"] = dict(T.aggregations["i"])
            TU.disaggregate("i")
        if "j" in T.aggregations:
            TSVh.aggregations["j"] = dict(T.aggregations["j"])
            TSVh.disaggregate("j")
        return TU, TSVh

    def compute_L2_reg(self, B: Tensor, weight_dec: float = 0.001, left_dir: bool = False):
        """Exact L2 norm of the full MPS as a function of the two-site
        tensor B, and its gradient (reference ``Network_class.py:966-1179``).

        ``B`` is a named Tensor with (optional) 'left'/'right' bond axes;
        the left/right transfer-product environments are computed from the
        current padded site stack. Returns ``(loss_term, derivate)`` with
        ``derivate`` scaled by ``2 * weight_dec`` as in the reference.
        """
        from tensornetworkforml_torch.ops.contractions import (
            boundary_vector,
            transfer_append,
            transfer_suffix_stack,
        )

        mps = self.mps
        e0 = boundary_vector(mps.M, dtype=mps.dtype, device=mps.device)
        l = mps.l_pos
        # reference env ranges: right sweep uses sites [0, l) and [l+2, N);
        # left sweep uses [0, l-1) and [l+1, N)
        left_end = l if not left_dir else l - 1
        right_start = l + 2 if not left_dir else l + 1

        E_left = torch.outer(e0, e0)
        for n in range(left_end):
            E_left = transfer_append(E_left, mps.sites[n])
        r2 = transfer_suffix_stack(mps.sites, e0)[right_start]

        axes = [str(a) for a in B.axes_names]
        elem = B.elem.to(dtype=mps.dtype, device=mps.device)
        deriv = elem
        if "left" in axes:
            li = axes.index("left")
            deriv = torch.movedim(torch.tensordot(E_left, deriv, dims=([1], [li])), 0, li)
        if "right" in axes:
            ri = axes.index("right")
            deriv = torch.movedim(torch.tensordot(deriv, r2, dims=([ri], [0])), -1, ri)
        loss_term = float(weight_dec * torch.sum(elem * deriv))
        return loss_term, Tensor(elem=2.0 * weight_dec * deriv, axes_names=axes)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Save the model as the ``.npz`` checkpoint both packages read."""
        from tensornetworkforml_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(self.mps, path)

    @classmethod
    def load(cls, path: str, dtype=None, device=None) -> "Network":
        """Load an ``.npz`` checkpoint, or a reference ``.dat`` pickle (float64
        unless ``dtype`` is given), onto ``device`` (``None``: the card)."""
        from tensornetworkforml_torch.utils.checkpoint import (
            load_checkpoint,
            mps_from_reference_pickle,
        )

        device = resolve_device(device)
        obj = cls.__new__(cls)
        if path.endswith(".dat"):
            obj.mps = mps_from_reference_pickle(path, dtype=dtype or torch.float64,
                                                device=device)
        else:
            obj.mps = load_checkpoint(path, dtype=dtype, device=device)
        return obj
