"""The MPS classifier model: parameter container, init/calibration, forward.

Model family: label-leg Matrix Product State classifier (Stoudenmire-Schwab,
arXiv:1605.05775).

* ``sites``: ONE tensor ``(N, M, D, M)`` -- every non-label site padded to
  uniform bond dimension M. The open chain ends are closed by contracting
  with the one-hot boundary vector ``e0``; edge sites keep zero entries
  outside their true bond.
* ``label_site``: the site currently carrying the label leg, ``(M, D, L, M)``.
  The slot ``sites[l_pos]`` is unused (kept zero) while the label sits there.

``MPS`` is an ``nn.Module`` whose two tensors are buffers; everything else
here is a plain function on tensors. Random draws take an explicit
``torch.Generator`` and are made on that generator's device, so one seed
gives the same weights whatever device the model is then moved to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    chain_scores,
    left_env_final_fused,
    right_env_final_fused,
)
from tensornetworkforml_torch.ops.embedding import psi_embed

ACT_FNS = ("linear", "sigmoid", "softmax")
LOSS_FNS = ("MSE", "cross_entropy", "full_cross_ent")


class MPS(nn.Module):
    """Label-leg MPS classifier parameters.

    Buffers: ``sites (N, M, D, M)``, ``label_site (M, D, L, M)``.
    Plain attributes: ``l_pos``, ``act_fn``, ``loss_fn``, ``T``.
    """

    def __init__(
        self,
        sites: torch.Tensor,
        label_site: torch.Tensor,
        l_pos: int = 0,
        act_fn: str = "linear",
        loss_fn: str = "cross_entropy",
        T: float = 0.1,
    ):
        super().__init__()
        self.register_buffer("sites", sites)
        self.register_buffer("label_site", label_site)
        self.l_pos = int(l_pos)
        self.act_fn = act_fn
        self.loss_fn = loss_fn
        self.T = T

    @property
    def N(self) -> int:
        return self.sites.shape[0]

    @property
    def M(self) -> int:
        return self.sites.shape[1]

    @property
    def D(self) -> int:
        return self.sites.shape[2]

    @property
    def L(self) -> int:
        return self.label_site.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.sites.dtype

    @property
    def device(self) -> torch.device:
        return self.sites.device

    def replace(self, **changes) -> "MPS":
        """A new ``MPS`` with the given fields replaced (this one is unchanged)."""
        fields = dict(
            sites=self.sites,
            label_site=self.label_site,
            l_pos=self.l_pos,
            act_fn=self.act_fn,
            loss_fn=self.loss_fn,
            T=self.T,
        )
        fields.update(changes)
        return MPS(**fields)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        return mps_forward(self, phi)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the card.

    The port is built for an NVIDIA GPU, so ``None`` means ``"cuda"``. On a
    machine without a card, pass ``device="cpu"`` explicitly: ``None`` then
    raises rather than running silently on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port's entry points run on the "
            "card by default -- pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _uniform(generator, shape, dtype, device):
    return torch.rand(
        shape, generator=generator, dtype=dtype, device=generator.device
    ).to(device)


def _normal(generator, shape, dtype, device):
    return torch.randn(
        shape, generator=generator, dtype=dtype, device=generator.device
    ).to(device)


def mps_init(
    generator: torch.Generator,
    N: int,
    M: int,
    D: int = 2,
    L: int = 10,
    T: float = 0.1,
    normalize: bool = False,
    calibration_phi: Optional[torch.Tensor] = None,
    act_fn: str = "linear",
    loss_fn: str = "cross_entropy",
    dtype=torch.float32,
    check: bool = False,
    device=None,
) -> MPS:
    """Build and (optionally) calibrate a fresh MPS.

    Entries uniform in [0,1], divided by the magnitude heuristic
    ``M * 0.5 * 0.64 * D`` when ``normalize`` is set, followed by a two-pass
    output calibration that rescales every site by ``max|f|^(1/N)`` so the
    un-activated output is O(1) on a calibration batch.

    ``calibration_phi`` is an already-embedded batch ``(B, N, D)``; if None
    and ``normalize`` is set, a random embedded batch of 16 samples is drawn.
    ``device=None`` is the card (``resolve_device``).
    """
    if act_fn not in ACT_FNS:
        raise ValueError(f"act_fn must be one of {ACT_FNS}")
    if loss_fn not in LOSS_FNS:
        raise ValueError(f"loss_fn must be one of {LOSS_FNS}")
    device = resolve_device(device)

    scale = float(M) * 0.5 * 0.64 * D if normalize else 1.0

    # Label leg starts at site 0. Only the left-boundary row of the edge
    # sites is populated; padding stays zero.
    label_site = torch.zeros((M, D, L, M), dtype=dtype, device=device)
    label_site[0] = _uniform(generator, (D, L, M), dtype, device) / scale

    sites = torch.zeros((N, M, D, M), dtype=dtype, device=device)
    if N > 2:
        sites[1 : N - 1] = _uniform(generator, (N - 2, M, D, M), dtype, device) / scale
    sites[N - 1, :, :, 0] = _uniform(generator, (M, D), dtype, device) / scale

    mps = MPS(sites, label_site, l_pos=0, act_fn=act_fn, loss_fn=loss_fn, T=T)

    if normalize:
        if calibration_phi is None:
            calibration_phi = psi_embed(_uniform(generator, (16, N), dtype, device))
        mps = calibrate(mps, calibration_phi.to(dtype), check=check)
    return mps


def product_init(
    generator: torch.Generator,
    N: int,
    M: int,
    D: int = 2,
    L: int = 10,
    T: float = 0.1,
    noise: float = 1e-2,
    act_fn: str = "softmax",
    loss_fn: str = "cross_entropy",
    dtype=torch.float32,
    calibration_x=None,
    canonicalize: bool = False,
    target_abs_f: float = 1.0,
    device=None,
) -> MPS:
    """Near-identity ("product state + noise") initialisation.

    Each site is ``A[l,d,r] = delta_{lr} / c_n + noise`` where ``c_n`` is
    the DATA mean of ``sum_d psi_d(x_n)`` at that pixel (from
    ``calibration_x``, raw pixels ``(B, N)``; without it the uniform-pixel
    value 4/pi is used). A chain contraction then multiplies the
    environment by a factor of mean ~1 at every site, so the output is O(1)
    for any chain length.

    ``canonicalize=True`` gauge-fixes the init into right-canonical form
    (per-step renormalised, ``models/canonical.py``) and then scales the
    label core so that max|f| on the calibration batch is ``target_abs_f``.
    ``device=None`` is the card (``resolve_device``).
    """
    if act_fn not in ACT_FNS or loss_fn not in LOSS_FNS:
        raise ValueError(f"act_fn must be in {ACT_FNS}, loss_fn in {LOSS_FNS}")
    device = resolve_device(device)
    if calibration_x is not None:
        x = torch.as_tensor(calibration_x, dtype=dtype, device=device)
        psi_sum = torch.sin(np.pi * x / 2) + torch.cos(np.pi * x / 2)
        c_n = torch.clamp(psi_sum.mean(dim=0), min=1e-3)  # (N,)
    else:
        c_n = torch.full((N,), 4.0 / np.pi, dtype=dtype, device=device)
    base = 1.0 / c_n  # (N,)

    eye = torch.eye(M, dtype=dtype, device=device)  # (l, r)
    core = eye[:, None, :].expand(M, D, M)  # unscaled identity

    sites = base[:, None, None, None] * core[None]
    sites = sites + noise * _normal(generator, (N, M, D, M), dtype, device)
    # edge padding: only the boundary row/col of the edge sites is live
    last = torch.zeros((M, D, M), dtype=dtype, device=device)
    last[:, :, 0] = base[N - 1] * core[:, :, 0] + noise * _normal(
        generator, (M, D), dtype, device
    )
    sites[N - 1] = last
    # slot 0 is the label site; zero the unused slot
    sites[0] = 0.0

    label_core = base[0] * eye[:, None, None, :].expand(M, D, L, M)
    label_full = label_core + noise * _normal(generator, (M, D, L, M), dtype, device)
    # label sits at site 0: only the boundary row is live
    label_site = torch.zeros((M, D, L, M), dtype=dtype, device=device)
    label_site[0] = label_full[0]

    mps = MPS(sites, label_site, l_pos=0, act_fn=act_fn, loss_fn=loss_fn, T=T)

    if canonicalize:
        # isometric sites bound every environment and L2 transfer product by 1
        from tensornetworkforml_torch.models.canonical import _right_canonicalize_arrays

        new_sites, new_label = _right_canonicalize_arrays(
            mps.sites, mps.label_site, renormalize=True
        )
        mps = mps.replace(sites=new_sites, label_site=new_label)
        if calibration_x is not None:
            phi_cal = psi_embed(x)
        else:
            phi_cal = psi_embed(_uniform(generator, (16, N), dtype, device))
        f_max = mps_forward(mps, phi_cal).abs().max()
        scale = target_abs_f / torch.clamp(f_max, min=1e-30)
        return mps.replace(label_site=mps.label_site * scale)

    # Large-M output-scale guard. The noise term random-walks the
    # environment: per site the amplitude grows like
    # sqrt(1 + noise^2 * M * D), so at M*D >~ 512 the init output compounds
    # to ~30-200x instead of O(1) and the first gradient steps are
    # mis-scaled by the same factor. A single scalar on the label leg
    # restores "output O(1) at init" without touching the near-identity
    # site structure; inits already in the healthy band are left
    # bit-identical.
    if calibration_x is not None:
        phi_probe = psi_embed(x)
    else:
        phi_probe = psi_embed(_uniform(generator, (16, N), dtype, device))
    f0_max = float(mps_forward(mps, phi_probe).abs().max())
    if not (0.1 <= f0_max <= 10.0) and f0_max > 0.0:
        mps = mps.replace(label_site=mps.label_site * (target_abs_f / f0_max))
    return mps


def calibrate(mps: MPS, phi: torch.Tensor, check: bool = False) -> MPS:
    """Two-pass output calibration: rescale every site by ``max|f|^(1/N)``."""
    f_max = mps_forward(mps, phi).abs().max()
    F2 = f_max ** (1.0 / mps.N)
    mps = mps.replace(sites=mps.sites / F2, label_site=mps.label_site / F2)
    if check:
        f2 = mps_forward(mps, phi)
        print(f"calibration: max|f| before={float(f_max):.4g} "
              f"after={float(f2.abs().max()):.4g}")
    return mps


def grow_bond(mps: MPS, new_M: int) -> MPS:
    """Embed the MPS into a larger bond dimension (zero padding).

    The padded slots are exactly zero, so the computed function is
    preserved (up to contraction-order rounding) while the shapes change.
    """
    N, M, D, _ = mps.sites.shape
    if new_M < M:
        raise ValueError(f"grow_bond cannot shrink: {M} -> {new_M}")
    if new_M == M:
        return mps
    sites = mps.sites.new_zeros((N, new_M, D, new_M))
    sites[:, :M, :, :M] = mps.sites
    label_site = mps.label_site.new_zeros((new_M, D, mps.L, new_M))
    label_site[:M, :, :, :M] = mps.label_site
    return mps.replace(sites=sites, label_site=label_site)


def _forward_arrays(
    sites: torch.Tensor, label_site: torch.Tensor, phi: torch.Tensor, l_pos: int
) -> torch.Tensor:
    N, M, D, _ = sites.shape
    B = phi.shape[0]
    e0 = boundary_vector(M, dtype=sites.dtype, device=sites.device)
    phi_t = phi.transpose(0, 1)  # site-major (N, B, D)

    if l_pos > 0:
        left = left_env_final_fused(sites[:l_pos], phi_t[:l_pos], e0)
    else:
        left = e0.expand(B, M)
    if l_pos < N - 1:
        right = right_env_final_fused(sites[l_pos + 1 :], phi_t[l_pos + 1 :], e0)
    else:
        right = e0.expand(B, M)
    return chain_scores(left, label_site, phi[:, l_pos, :], right)


def mps_forward(mps: MPS, phi: torch.Tensor) -> torch.Tensor:
    """Un-activated class scores ``(L, B)`` for embedded input ``(B, N, D)``.

    The contraction is the single chain
    ``e0 . A_0(x_0) ... label_site(x_l) ... A_{N-1}(x_{N-1}) . e0``
    evaluated with two environment loops that meet at the label site.
    """
    if phi.shape[1] != mps.N:
        raise ValueError(
            f"input has {phi.shape[1]} sites, the MPS has {mps.N}"
        )
    return _forward_arrays(mps.sites, mps.label_site, phi.to(mps.dtype), mps.l_pos)


def apply_act_fn(scores: torch.Tensor, act_fn: str, T: float) -> torch.Tensor:
    """Output activation over the label axis (axis 0): identity,
    temperature sigmoid or temperature softmax."""
    if act_fn == "linear":
        return scores
    if act_fn == "sigmoid":
        return torch.sigmoid(scores / T)
    if act_fn == "softmax":
        return torch.softmax(scores / T, dim=0)
    raise ValueError(f"unknown act_fn {act_fn!r}")


def loss_derivative(
    f_act: torch.Tensor, y_onehot: torch.Tensor, loss_fn: str, act_fn: str, T: float
) -> torch.Tensor:
    """Analytic dLoss/df, defined so that ASCENT steps descend the loss.

      * MSE:            y - f
      * cross_entropy:  (y - y*f)/T  when paired with softmax (simplified
                        softmax+CE gradient), else y/f
      * full_cross_ent: 1 / (f - 1[y==0] + 1e-4)
    """
    if loss_fn == "MSE":
        return y_onehot - f_act
    if loss_fn == "cross_entropy":
        if act_fn == "softmax":
            return (y_onehot - y_onehot * f_act) / T
        return y_onehot / f_act
    if loss_fn == "full_cross_ent":
        return 1.0 / (f_act - (1.0 - y_onehot) + 1e-4)
    raise ValueError(f"unknown loss_fn {loss_fn!r}")


def accuracy_from_scores(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fraction of correct argmax predictions; ``scores (L,B)``, ``y (B,)``."""
    y_pred = torch.argmax(scores, dim=0)
    return (y_pred == y).to(scores.dtype).mean()


def predict(mps: MPS, x_raw: torch.Tensor) -> torch.Tensor:
    """Predicted labels ``(B,)`` from RAW pixels ``(B, N)`` in [0, 1]."""
    scores = mps_forward(mps, psi_embed(x_raw.to(mps.dtype)))
    return torch.argmax(scores, dim=0)


def ragged_site_list(mps: MPS) -> list:
    """Export sites as ragged per-site numpy arrays.

    First site ``(L, M, D)`` [l, right, d], middle ``(M, M, D)``
    [left, right, d], last ``(M, D)`` [left, d]; the site at ``l_pos``
    carries an extra label axis. Padding is NOT stripped.
    """
    out = []
    sites = mps.sites.detach().cpu().numpy()
    label = mps.label_site.detach().cpu().numpy()  # (M, D, L, M)
    for n in range(mps.N):
        if n == mps.l_pos:
            if n == 0:
                out.append(np.transpose(label[0], (1, 2, 0)))  # (L, M<-right, D)
            elif n == mps.N - 1:
                out.append(np.transpose(label[:, :, :, 0], (0, 2, 1)))  # (left, L, D)
            else:
                out.append(np.transpose(label, (0, 3, 2, 1)))  # (left,right,L,d)
        else:
            A = sites[n]  # (left, d, right)
            if n == 0:
                out.append(A[0].T)  # (right, d)
            elif n == mps.N - 1:
                out.append(A[:, :, 0])  # (left, d)
            else:
                out.append(np.transpose(A, (0, 2, 1)))  # (left, right, d)
    return out
