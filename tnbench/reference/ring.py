"""The plain reference of the periodic (ring) MPS classifier: scores, the
loss, its gradients and Adam, all written out by hand.

The benchmark's frozen copy of the port's ``models/ring_reference.py``, so
that a change there moves no cell. Plain torch in any dtype (the benchmark
runs it in float64), on any device; it imports nothing of the program under
test and takes nothing the program made: the weights and batches come from
the benchmark's generator. Each public function runs with TF32 off for both
CUDA backends and puts the switches back after.

The model (Zhao et al., "Tensor Ring Decomposition", arXiv:1606.05535, for
the closed chain; Stoudenmire & Schwab, arXiv:1605.05775, for the classifier
around it: ``psi(x) = [sin(pi x / 2), cos(pi x / 2)]`` and a label leg):

    f_o(x) = Tr[ A_0(x_0) ... Lab_o(x_l) ... A_{N-1}(x_{N-1}) ],
    A_n(x)[l, r] = sum_d sites[n, l, d, r] psi_d(x_n),
    Lab_o(x)[l, r] = sum_d label[l, d, o, r] psi_d(x_l).

Departures from the published descriptions, all the port's: the label core
takes the place of the site at ``l_pos`` (the slot ``sites[l_pos]`` is
unused, its gradient zero); the ring trains by full gradients of the softmax
cross-entropy of ``f / T``, plus ``weight_decay`` times the squared norm of
both tensors as an L2 term of the loss, with Adam (two-site sweeps need open
boundaries).

The contraction order is not the program's: the scores start at site 0,
take the label core in its place (carrying its ``L`` index from there on)
and close with an explicit trace. The gradients come from prefix and suffix
products, ``d Tr(X A Y) / dA = (Y X)^T``, with the loss's weights folded into
the label's matrix, summed over the batch with ``psi``. Adam is
``torch.optim.Adam``'s update, written out: betas (0.9, 0.999), eps 1e-8,
bias-corrected. ``block`` splits the batch into blocks of that many rows,
which bounds the memory of the suffix products (``N`` matrices ``(block, M,
M)``) on the card.

``low=True`` rounds both operands of every product to TF32 (10 explicit
mantissa bits), as cuBLAS does when TF32 is allowed: the lower-precision
control of a float32 configuration where the program's own TF32 path cannot
run (the CPU).
"""

from __future__ import annotations

import math

import torch

from tnbench.reference.mps import tf32

BETAS = (0.9, 0.999)
EPS = 1e-8


class _ieee:
    """TF32 off for both CUDA backends inside the block; restored after."""

    def __enter__(self):
        self._before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._before
        return False


def _op(x: torch.Tensor, low: bool) -> torch.Tensor:
    return tf32(x) if low else x


def psi(x: torch.Tensor) -> torch.Tensor:
    h = (math.pi / 2.0) * x
    return torch.stack([torch.sin(h), torch.cos(h)], dim=-1)


def _site(core, phi_n, low):
    """``A(x)`` of one site, ``(B, M, M)``."""
    core, phi_n = _op(core, low), _op(phi_n, low)
    return sum(phi_n[:, d, None, None] * core[None, :, d, :] for d in range(core.shape[1]))


def _label(label, phi_l, low):
    """``Lab_o(x)`` for every class, ``(B, L, M, M)``."""
    label, phi_l = _op(label, low), _op(phi_l, low)
    return sum(phi_l[:, d, None, None, None] * label[:, d].permute(1, 0, 2)[None]
               for d in range(label.shape[1]))


def _mul(a, b, low):
    return _op(a, low) @ _op(b, low)


def _blocks(n: int, block):
    step = block or n
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _scores(sites, label, phi, l_pos, low):
    """``(B, L)`` scores of one block: the product from site 0, the label's
    ``L`` index carried from ``l_pos`` on, closed by a trace."""
    P = None
    for n in range(sites.shape[0]):
        if n == l_pos:
            lab = _label(label, phi[:, n], low)
            P = lab if P is None else _mul(P[:, None], lab, low)
        else:
            A = _site(sites[n], phi[:, n], low)
            if P is None:
                P = A
            else:
                P = _mul(P, A[:, None] if P.dim() == 4 else A, low)
    return P.diagonal(dim1=-2, dim2=-1).sum(-1)


def scores(sites, label, x, l_pos: int, dtype=torch.float64, block=None,
           low: bool = False) -> torch.Tensor:
    """Un-activated class scores ``(L, B)`` of raw pixels ``x (B, N)``."""
    s, lab = sites.to(dtype), label.to(dtype)
    with _ieee():
        out = [_scores(s, lab, psi(x[lo:hi].to(dtype)), l_pos, low)
               for lo, hi in _blocks(x.shape[0], block)]
    return torch.cat(out).T


def _xent(f, y, T):
    """Softmax cross-entropy of ``f / T`` summed over the rows, and its
    gradient by ``f`` for each row."""
    z = f / T
    zmax = z.max(dim=1, keepdim=True).values
    lse = zmax[:, 0] + torch.log(torch.exp(z - zmax).sum(dim=1))
    picked = z.gather(1, y[:, None])[:, 0]
    p = torch.exp(z - lse[:, None])
    onehot = torch.zeros_like(p)
    onehot[torch.arange(len(y), device=y.device), y] = 1.0
    return (lse - picked).sum(), (p - onehot) / T


def loss_and_grads(sites, label, x, y, l_pos: int, T: float, weight_decay: float = 0.0,
                   dtype=torch.float64, block=None, low: bool = False):
    """The mean loss over the batch ``(x (B, N), y (B,))`` and its gradients
    ``(d sites (N, M, D, M), d label (M, D, L, M))``, in ``dtype``."""
    s, lab = sites.to(dtype), label.to(dtype)
    N, M, D, _ = s.shape
    Bt = x.shape[0]
    g_s, g_lab = torch.zeros_like(s), torch.zeros_like(lab)
    total = torch.zeros((), dtype=dtype, device=s.device)
    y = y.to(s.device).long()
    with _ieee():
        for lo, hi in _blocks(Bt, block):
            phi = psi(x[lo:hi].to(dtype))
            B = hi - lo
            f = _scores(s, lab, phi, l_pos, low)  # (B, L)
            part, dz = _xent(f, y[lo:hi], T)
            total = total + part
            w = dz / Bt  # dloss / df, (B, L)
            lab_x = _label(lab, phi[:, l_pos], low)  # (B, L, M, M)
            C = [(w[:, :, None, None] * lab_x).sum(1) if n == l_pos
                 else _site(s[n], phi[:, n], low) for n in range(N)]
            eye = torch.eye(M, dtype=dtype, device=s.device).expand(B, M, M)
            suf = [None] * N
            suf[N - 1] = eye
            for n in range(N - 2, -1, -1):
                suf[n] = _mul(C[n + 1], suf[n + 1], low)
            pre = eye
            for n in range(N):
                G = _mul(suf[n], pre, low).transpose(1, 2)  # d Tr(pre A suf) / dA
                if n == l_pos:
                    g_lab += torch.einsum("bd,bo,blr->ldor", phi[:, n], w, G)
                else:
                    g_s[n] += torch.einsum("bd,blr->ldr", phi[:, n], G)
                pre = _mul(pre, C[n], low)
                suf[n] = None
    loss = total / Bt
    if weight_decay:
        loss = loss + weight_decay * ((s ** 2).sum() + (lab ** 2).sum())
        g_s = g_s + 2.0 * weight_decay * s
        g_lab = g_lab + 2.0 * weight_decay * lab
    return loss, (g_s, g_lab)


def adam(params, grads, state, lr: float):
    """One Adam update of ``params`` by ``grads`` (``state`` ``None`` before
    the first): ``torch.optim.Adam``'s update, written out."""
    if state is None:
        state = {"t": 0, "m": [torch.zeros_like(p) for p in params],
                 "v": [torch.zeros_like(p) for p in params]}
    t = state["t"] + 1
    b1, b2 = BETAS
    step_size = lr / (1 - b1 ** t)
    bc2_sqrt = math.sqrt(1 - b2 ** t)
    new, ms, vs = [], [], []
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        m = m + (1 - b1) * (g - m)
        v = b2 * v + (1 - b2) * g * g
        denom = v.sqrt() / bc2_sqrt + EPS
        new.append(p - step_size * m / denom)
        ms.append(m)
        vs.append(v)
    return new, {"t": t, "m": ms, "v": vs}


def train(sites, label, batches, l_pos: int, T: float, lr: float, weight_decay: float = 0.0,
          dtype=torch.float64, block=None, low: bool = False) -> list:
    """Adam steps, one a batch ``(x, y)`` of ``batches``, from ``(sites,
    label)``. Per step: ``loss`` (before its update), ``grads`` and the
    parameters after it (``sites``, ``label``)."""
    params = [sites.to(dtype), label.to(dtype)]
    state, out = None, []
    for x, y in batches:
        loss, grads = loss_and_grads(*params, x, y, l_pos, T, weight_decay, dtype, block, low)
        params, state = adam(params, grads, state, lr)
        out.append({"loss": loss, "grads": grads, "sites": params[0], "label": params[1]})
    return out
