"""The hybrid engine's fused pre-split step (K2).

Everything between the carried environments and the subspace iteration of
one two-site step, for the canonical / no-L2 / fixed-rank / clip family:
merge, loss derivative, gradient, plain weight decay, L1 clip, ascent
update, output recompute, and the split's two J-carrying reductions (the
sketch ``y0 = B_new Omega`` and the Gram ``G = B_new B_new^T``).

Layout: the label core is carried as ``(L, I, Mk)`` with rows ``(a, i)``
(``I = M*D``); the two-site matrix is held as per-label column blocks
``B_new (L, I, D*M)``, whose column order ``(o, j, c)`` matches the flat
``(I, L*D*M)`` matrix the xla engine splits, so the same ``Omega`` viewed as
``(L, D*M, q)`` gives the same sketch.

On CUDA tensors ``two_site_presplit`` launches the hand-written kernel
``csrc/presplit.cu`` (the counterpart of the JAX package's Pallas kernel
``two_site_presplit_pallas``); on CPU tensors it runs the plain version
``two_site_presplit_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from tensornetworkforml_torch.ops.kernels import _build

_ACT = {"linear": 0, "sigmoid": 1, "softmax": 2}
_LOSS = {"MSE": 0, "cross_entropy": 1, "full_cross_ent": 2}


def _act_and_loss_der(f, y1h, act_fn: str, loss_fn: str, T: float):
    """Activation over the label axis and the loss derivative, written as
    the kernel computes them."""
    if act_fn == "linear":
        f_act = f
    elif act_fn == "sigmoid":
        f_act = 1.0 / (1.0 + torch.exp(-f / T))
    else:  # softmax with temperature over the label axis
        z = f / T
        z = z - z.max(dim=0, keepdim=True).values
        e = torch.exp(z)
        f_act = e / e.sum(dim=0, keepdim=True)
    if loss_fn == "MSE":
        loss_der = y1h - f_act
    elif loss_fn == "cross_entropy":
        loss_der = (y1h - y1h * f_act) / T if act_fn == "softmax" else y1h / f_act
    else:  # full_cross_ent with the reference's 1e-4 epsilon
        loss_der = 1.0 / (f_act - (1.0 - y1h) + 1e-4)
    return f_act, loss_der


def two_site_presplit_reference(
    lab, a2m, x1, x2, l_env, r_env, y1h, f, om, lr, weight_dec,
    act_fn: str = "linear", loss_fn: str = "MSE", T: float = 0.1, with_gram: bool = True,
):
    """Plain version of K2; same arguments and outputs as ``two_site_presplit``."""
    I = lab.shape[1]
    DM = a2m.shape[1]
    B = x1.shape[0]
    dtype, dev = lab.dtype, lab.device
    lr = torch.as_tensor(lr, dtype=dtype, device=dev).reshape(())
    wd = torch.as_tensor(weight_dec, dtype=dtype, device=dev).reshape(())

    f_act, loss_der = _act_and_loss_der(f, y1h, act_fn, loss_fn, T)
    fmax = f_act.max(dim=0, keepdim=True).values
    hit = ((f_act >= fmax).to(dtype) * y1h).sum(dim=0)
    acc = (hit > 0).to(dtype).mean()
    mae = (y1h - f_act).abs().mean()

    left_part = (l_env[:, :, None] * x1[:, None, :]).reshape(B, I)  # (b, (a, i))
    right_part = (x2[:, :, None] * r_env[:, None, :]).reshape(B, DM)  # (b, (j, c))

    bt = lab @ a2m  # (L, I, DM)
    w = right_part[None] * loss_der[:, :, None]  # (L, B, DM)
    db = left_part.T[None] @ w - wd * bt
    s_b, s_db = bt.abs().sum(), db.abs().sum()
    eta = lr * torch.where(s_db > s_b, s_b / torch.clamp(s_db, min=1e-30), 1.0)
    bnew = bt + eta * db

    y0 = (bnew @ om).sum(dim=0)  # (I, q)
    if with_gram:
        g = (bnew @ bnew.mT).sum(dim=0)
    else:
        g = torch.zeros((8, 128), dtype=dtype, device=dev)
    v = left_part[None] @ bnew  # (L, B, DM)
    f_new = (v * right_part[None]).sum(dim=2)
    zero = torch.zeros((), dtype=dtype, device=dev)
    stats = torch.stack([
        s_b, s_db, (bnew * bnew).sum(), bnew.abs().sum(), acc, mae, f.abs().mean(), zero,
    ]).reshape(1, 8)
    return bnew, y0, g, f_new, left_part, stats


def _lib() -> ctypes.CDLL:
    lib = _build.load("presplit")
    fn = lib.tnml_presplit
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 18  # 11 inputs, 6 outputs, scratch
            + [ctypes.c_int] * 10   # L, I, Mk, DM, B, D, M, q, act, loss
            + [ctypes.c_float, ctypes.c_void_p]  # T, stream
        )
        fn.restype = ctypes.c_int
        lib.tnml_presplit_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.tnml_presplit_scratch_floats.restype = ctypes.c_long
        lib.tnml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A one-element float32 tensor on ``like``'s device, without reading a
    device value back to the host."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(1)


def two_site_presplit(
    lab: torch.Tensor,     # (L, I, Mk) label core, carry layout
    a2m: torch.Tensor,     # (Mk, D*M) right site (k, (j, c))
    x1: torch.Tensor,      # (B, D)
    x2: torch.Tensor,      # (B, D)
    l_env: torch.Tensor,   # (B, M) carried left environment
    r_env: torch.Tensor,   # (B, M) stale right environment
    y1h: torch.Tensor,     # (L, B) one-hot targets
    f: torch.Tensor,       # (L, B) carried network output
    om: torch.Tensor,      # (L, D*M, q) Omega in label blocks
    lr,
    weight_dec,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    T: float = 0.1,
    with_gram: bool = True,
):
    """Returns ``(B_new (L, I, DM), y0 (I, q), g (I, I), f_new (L, B),
    left_part (B, I), stats (1, 8))`` with stats =
    ``[sum|B|, sum|dB|, |B_new|_F^2, sum|B_new|, acc, mae, mean|f|, 0]``;
    ``g`` is an ``(8, 128)`` block of zeros when ``with_gram=False``.

    CPU tensors run ``two_site_presplit_reference``. CUDA tensors must be
    float32 and contiguous and launch the kernel (``lr`` and ``weight_dec``
    may be floats or one-element tensors); each launch adds one to
    ``two_site_presplit.launches``.
    """
    tensors = (lab, a2m, x1, x2, l_env, r_env, y1h, f, om)
    if all(t.device.type == "cpu" for t in tensors):
        return two_site_presplit_reference(
            lab, a2m, x1, x2, l_env, r_env, y1h, f, om, lr, weight_dec,
            act_fn, loss_fn, T, with_gram,
        )
    dev = lab.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "two_site_presplit takes CPU tensors or CUDA tensors on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the CUDA kernel takes float32, got " + ", ".join(str(t.dtype) for t in tensors)
        )
    if act_fn not in _ACT or loss_fn not in _LOSS:
        raise ValueError(f"unknown act_fn {act_fn!r} or loss_fn {loss_fn!r}")
    L, I, Mk = lab.shape
    B, D = x1.shape
    M = Mk
    DM = a2m.shape[1] if a2m.dim() == 2 else -1
    q = om.shape[2] if om.dim() == 3 else -1
    shapes_ok = (
        I == M * D and a2m.shape == (Mk, D * M) and x2.shape == (B, D)
        and l_env.shape == (B, M) and r_env.shape == (B, M)
        and y1h.shape == (L, B) and f.shape == (L, B) and om.shape == (L, DM, q)
    )
    if not shapes_ok:
        raise ValueError(
            "two_site_presplit shapes do not fit together: lab "
            f"{tuple(lab.shape)}, a2m {tuple(a2m.shape)}, x1 {tuple(x1.shape)}, "
            f"x2 {tuple(x2.shape)}, l_env {tuple(l_env.shape)}, r_env {tuple(r_env.shape)}, "
            f"y1h {tuple(y1h.shape)}, f {tuple(f.shape)}, om {tuple(om.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("two_site_presplit takes contiguous tensors")
    if min(L, I, DM, B, q) == 0:
        raise ValueError("two_site_presplit takes no empty dimension")
    lr_t, wd_t = _scalar(lr, lab), _scalar(weight_dec, lab)
    f32 = dict(dtype=torch.float32, device=dev)
    bnew = torch.empty((L, I, DM), **f32)
    y0 = torch.empty((I, q), **f32)
    g = torch.empty((I, I), **f32) if with_gram else torch.zeros((8, 128), **f32)
    f_new = torch.empty((L, B), **f32)
    left_part = torch.empty((B, I), **f32)
    stats = torch.empty((1, 8), **f32)
    lib = _lib()
    scratch = torch.empty((lib.tnml_presplit_scratch_floats(L, I, DM, B, q),), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tnml_presplit(
            lab.data_ptr(), a2m.data_ptr(), x1.data_ptr(), x2.data_ptr(),
            l_env.data_ptr(), r_env.data_ptr(), y1h.data_ptr(), f.data_ptr(),
            om.data_ptr(), lr_t.data_ptr(), wd_t.data_ptr(),
            bnew.data_ptr(), y0.data_ptr(), g.data_ptr() if with_gram else None,
            f_new.data_ptr(), left_part.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
            L, I, Mk, DM, B, D, M, q, _ACT[act_fn], _LOSS[loss_fn], float(T), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"two_site_presplit kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    two_site_presplit.launches += 1
    return bnew, y0, g, f_new, left_part, stats


two_site_presplit.launches = 0
