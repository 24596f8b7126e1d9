"""The fused engine's whole two-site step (K7).

One call runs one step of ``engine="fused"``: merge, metrics, analytic
gradient, plain weight decay, L1 clip, ascent update, growth cap, output
recompute, the polar split's sketch, Gram and subspace iteration, the
left-environment extension and ``renorm_envs``.

Layout: the label core is carried label-major as ``lab (L, M*D, M)`` with
rows ``(a, i)``; the step returns the next step's core as ``lab_new
(L, M, D*M)``, which is the same memory as ``(L, M*D, M)``. The sweep converts
from and to the standard ``label_site (M, D, L, M)`` once per sweep
(``label_to_kernel_layout``, ``label_from_kernel_layout``).

The split is the polar split with the sketch ``Omega =
ops.svd.rangefinder_omega(L*D*M, M)`` read per label block, one power round
and ``dead_tol = 1e-6``: the split of the xla engine's ``svd_method="polar"``
on the same matrix. Unlike the hybrid engine, which scales R and f after the
split, the growth cap scales ``B_new`` before ``f``, ``n2``, the Gram and the
sketch are formed, as the JAX package's kernel does.

On CUDA tensors ``two_site_step`` launches the hand-written kernel
``csrc/two_site_step.cu`` (the counterpart of the JAX package's Pallas kernel
``two_site_step_pallas``); on CPU tensors it runs the plain version
``two_site_step_reference``. ``two_site_sweep`` runs the N - 1 steps of a
whole fused sweep: on CUDA tensors as one call of the kernel's sweep entry,
which issues every step's launches from C (the counterpart of the JAX
package's scan over steps), on CPU tensors as a loop over
``two_site_step_reference`` (``two_site_sweep_reference``).
"""

from __future__ import annotations

import ctypes

import torch

from tensornetworkforml_torch.ops import svd as _svd
from tensornetworkforml_torch.ops.kernels import _build
from tensornetworkforml_torch.ops.kernels.polar_split import (
    _PE_FINAL,
    _PE_LOOP,
    _Coeffs,
    _coeff_block,
    _pe_schedule,
    polar_iterate_reference,
)
from tensornetworkforml_torch.ops.kernels.presplit_kernel import _ACT, _LOSS, _act_and_loss_der

DEAD_TOL = 1e-6


def label_to_kernel_layout(label_site: torch.Tensor) -> torch.Tensor:
    """``(M, D, L, M) -> (L, M*D, M)`` (label-major rows ``(a, i)``)."""
    M, D, L, M2 = label_site.shape
    return label_site.permute(2, 0, 1, 3).reshape(L, M * D, M2)


def label_from_kernel_layout(lab_new: torch.Tensor) -> torch.Tensor:
    """``(L, M, D*M) -> (M, D, L, M)`` (the sweep's standard layout)."""
    L, M, JC = lab_new.shape
    D = JC // M
    return lab_new.reshape(L, M, D, M).permute(1, 2, 0, 3)


def _omega(L: int, JC: int, M: int, device) -> torch.Tensor:
    """The sketch of the ``(I, L*JC)`` two-site matrix, in label blocks."""
    return _svd.rangefinder_omega(L * JC, M, torch.float32, device).reshape(L, JC, M)


def two_site_step_reference(
    lab, a2, x1, x2, lenv, renv, y1h, f, lr, weight_dec=0.0,
    act_fn: str = "linear", loss_fn: str = "MSE", T: float = 0.1,
    renorm_envs: bool = False, growth_cap: float = 0.0,
):
    """Plain version of K7; the arguments and outputs of ``two_site_step``.
    Runs in the inputs' dtype on their device."""
    L, I, M = lab.shape
    B, D = x1.shape
    JC = D * M
    dtype, dev = lab.dtype, lab.device
    lr = torch.as_tensor(lr, dtype=dtype, device=dev).reshape(())
    wd = torch.as_tensor(weight_dec, dtype=dtype, device=dev).reshape(())
    om = _omega(L, JC, M, dev).to(dtype)

    f_act, loss_der = _act_and_loss_der(f, y1h, act_fn, loss_fn, T)
    # accuracy by the one-hot/max rule: a sample counts when its target's
    # activation ties the maximum
    fmax = f_act.max(dim=0, keepdim=True).values
    hit = (y1h * (f_act >= fmax).to(dtype)).sum(dim=0)
    acc = (hit > 0).to(dtype).mean()
    mae = (y1h - f_act).abs().mean()

    left = (lenv[:, :, None] * x1[:, None, :]).reshape(B, I)  # (b, (a, i))
    right = (x2[:, :, None] * renv[:, None, :]).reshape(B, JC)  # (b, (j, c))
    b3 = lab @ a2.reshape(M, JC)  # (L, I, JC)
    s_b = b3.abs().sum()
    # plain weight decay folded in before the |dB| sum and the clip
    db3 = left.T[None] @ (loss_der[:, :, None] * right[None]) - wd * b3
    s_db = db3.abs().sum()
    clip = torch.where(s_db > s_b, s_b / torch.clamp(s_db, min=1e-30), 1.0)
    bn = b3 + (lr * clip) * db3
    if growth_cap > 0:  # on B_new itself, before f, n2, G and y
        s_new = bn.abs().sum()
        cap = (1.0 + growth_cap) * s_b
        bn = bn * torch.where(s_new > cap, cap / torch.clamp(s_new, min=1e-30), 1.0)

    f_new = ((left[None] @ bn) * right[None]).sum(dim=2)  # (L, B)
    n2 = (bn * bn).sum()
    y = (bn @ om).sum(dim=0)
    g = (bn @ bn.mT).sum(dim=0)
    loop_s, final_s = _pe_schedule(*_PE_LOOP), _pe_schedule(*_PE_FINAL)
    q = polar_iterate_reference(y, g, n2, 1, loop_s, final_s, DEAD_TOL)  # (I, M)

    lenv_new = left @ q
    if renorm_envs:
        gg = 1.0 / torch.clamp(torch.linalg.vector_norm(lenv_new, dim=1).mean(), min=1e-30)
        a_left, lenv_new, inv = q * gg, lenv_new * gg, 1.0 / gg
    else:
        a_left, inv = q, torch.ones((), dtype=dtype, device=dev)
    lab_new = inv * (q.T[None] @ bn)  # (L, M, JC)
    metrics = torch.stack([acc, mae, s_b, s_db]).reshape(1, 4)
    return a_left, lab_new, lenv_new, f_new, metrics


def _lib() -> ctypes.CDLL:
    lib = _build.load("two_site_step")
    fn = lib.tnml_two_site_step
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = (
            [p] * 17  # 11 inputs, 5 outputs, scratch
            + [i] * 6  # L, M, D, B, act, loss
            + [ctypes.c_float, i, ctypes.c_float]  # T, renorm_envs, growth_cap
            + [ctypes.POINTER(_Coeffs), ctypes.POINTER(_Coeffs), p]  # schedules, stream
        )
        fn.restype = ctypes.c_int
        lib.tnml_step_scratch_floats.argtypes = [i] * 4
        lib.tnml_step_scratch_floats.restype = ctypes.c_long
        lib.tnml_fused_sweep.argtypes = (
            [p] * 16  # 10 inputs, 5 outputs, workspace
            + [i] * 7  # N, L, M, D, B, act, loss
            + [ctypes.c_float, i, ctypes.c_float]  # T, renorm_envs, growth_cap
            + [ctypes.POINTER(_Coeffs), ctypes.POINTER(_Coeffs), p]  # schedules, stream
        )
        lib.tnml_fused_sweep.restype = ctypes.c_int
        lib.tnml_sweep_work_floats.argtypes = [i] * 4
        lib.tnml_sweep_work_floats.restype = ctypes.c_long
        lib.tnml_cuda_error_string.argtypes = [i]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def two_site_step(
    lab: torch.Tensor,    # (L, M*D, M) label core, carry layout
    a2: torch.Tensor,     # (M, D, M) right neighbour
    x1: torch.Tensor,     # (B, D)
    x2: torch.Tensor,     # (B, D)
    lenv: torch.Tensor,   # (B, M) carried left environment
    renv: torch.Tensor,   # (B, M) stale right environment
    y1h: torch.Tensor,    # (L, B) one-hot targets
    f: torch.Tensor,      # (L, B) carried network output
    lr,
    weight_dec=0.0,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    T: float = 0.1,
    renorm_envs: bool = False,
    growth_cap: float = 0.0,
):
    """One fused two-site step. Returns ``(a_left (M*D, M), lab_new
    (L, M, D*M), lenv_new (B, M), f_new (L, B), metrics (1, 4))`` with
    metrics ``[acc, mae, sum|B|, sum|dB|]``.

    CPU tensors run ``two_site_step_reference``. CUDA tensors must be float32
    and contiguous and launch the kernel (``lr`` and ``weight_dec`` may be
    floats or one-element tensors); each launch adds one to
    ``two_site_step.launches``.
    """
    tensors = (lab, a2, x1, x2, lenv, renv, y1h, f)
    if all(t.device.type == "cpu" for t in tensors):
        return two_site_step_reference(lab, a2, x1, x2, lenv, renv, y1h, f, lr, weight_dec,
                                       act_fn, loss_fn, T, renorm_envs, growth_cap)
    dev = lab.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "two_site_step takes CPU tensors or CUDA tensors on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the CUDA kernel takes float32, got " + ", ".join(str(t.dtype) for t in tensors)
        )
    if act_fn not in _ACT or loss_fn not in _LOSS:
        raise ValueError(f"unknown act_fn {act_fn!r} or loss_fn {loss_fn!r}")
    if lab.dim() != 3 or x1.dim() != 2:
        raise ValueError(f"lab must be (L, M*D, M) and x1 (B, D), got {tuple(lab.shape)}, "
                         f"{tuple(x1.shape)}")
    L, I, M = lab.shape
    B, D = x1.shape
    shapes_ok = (
        I == M * D and a2.shape == (M, D, M) and x2.shape == (B, D)
        and lenv.shape == (B, M) and renv.shape == (B, M)
        and y1h.shape == (L, B) and f.shape == (L, B)
    )
    if not shapes_ok:
        raise ValueError(
            "two_site_step shapes do not fit together: lab "
            f"{tuple(lab.shape)}, a2 {tuple(a2.shape)}, x1 {tuple(x1.shape)}, "
            f"x2 {tuple(x2.shape)}, lenv {tuple(lenv.shape)}, renv {tuple(renv.shape)}, "
            f"y1h {tuple(y1h.shape)}, f {tuple(f.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("two_site_step takes contiguous tensors")
    if min(L, M, D, B) == 0:
        raise ValueError("two_site_step takes no empty dimension")
    f32 = dict(dtype=torch.float32, device=dev)
    lr_t = torch.as_tensor(lr, **f32).reshape(1)
    wd_t = torch.as_tensor(weight_dec, **f32).reshape(1)
    om = _omega(L, D * M, M, dev).contiguous()
    loop_block = _coeff_block(_pe_schedule(*_PE_LOOP))
    final_block = _coeff_block(_pe_schedule(*_PE_FINAL))
    a_left = torch.empty((I, M), **f32)
    lab_new = torch.empty((L, M, D * M), **f32)
    lenv_new = torch.empty((B, M), **f32)
    f_new = torch.empty((L, B), **f32)
    metrics = torch.empty((1, 4), **f32)
    lib = _lib()
    scratch = torch.empty((lib.tnml_step_scratch_floats(L, M, D, B),), **f32)
    with torch.cuda.device(dev):
        err = lib.tnml_two_site_step(
            lab.data_ptr(), a2.data_ptr(), x1.data_ptr(), x2.data_ptr(), lenv.data_ptr(),
            renv.data_ptr(), y1h.data_ptr(), f.data_ptr(), om.data_ptr(), lr_t.data_ptr(),
            wd_t.data_ptr(), a_left.data_ptr(), lab_new.data_ptr(), lenv_new.data_ptr(),
            f_new.data_ptr(), metrics.data_ptr(), scratch.data_ptr(),
            L, M, D, B, _ACT[act_fn], _LOSS[loss_fn], float(T), int(bool(renorm_envs)),
            float(growth_cap), ctypes.byref(loop_block), ctypes.byref(final_block),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"two_site_step kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    two_site_step.launches += 1
    return a_left, lab_new, lenv_new, f_new, metrics


two_site_step.launches = 0


def two_site_sweep_reference(
    lab, a2s, x, y1h, r_envs, lenv, f, lr, weight_dec=0.0,
    act_fn: str = "linear", loss_fn: str = "MSE", T: float = 0.1,
    renorm_envs: bool = False, growth_cap: float = 0.0, step=two_site_step_reference,
):
    """Plain version of ``two_site_sweep``: a loop of ``step`` over the N - 1
    steps (``two_site_step`` there gives the per-step kernel's sweep). Returns
    what ``two_site_sweep`` returns."""
    L, I, M = lab.shape
    a_lefts, metr_rows, mean_abs_f = [], [], []
    for s in range(a2s.shape[0]):
        a_left, lab_new, lenv, f_new, metr = step(
            lab, a2s[s], x[s], x[s + 1], lenv, r_envs[s + 2], y1h, f, lr, weight_dec,
            act_fn=act_fn, loss_fn=loss_fn, T=T, renorm_envs=renorm_envs,
            growth_cap=growth_cap,
        )
        mean_abs_f.append(f.abs().mean())
        # (L, M, D*M) -> (L, M*D, M): the same memory
        lab, f = lab_new.reshape(L, I, M), f_new
        a_lefts.append(a_left)
        metr_rows.append(metr)
    return (torch.stack(a_lefts), lab.reshape(L, M, I), f, torch.cat(metr_rows),
            torch.stack(mean_abs_f))


# a fused sweep's workspace, per device and shape: one sweep at a time on a
# device's stream uses it
_WORKSPACE: dict = {}


def two_site_sweep(
    lab: torch.Tensor,     # (L, M*D, M) label core, carry layout
    a2s: torch.Tensor,     # (N-1, M, D, M) the right neighbours of the steps
    x: torch.Tensor,       # (N, B, D) site inputs
    y1h: torch.Tensor,     # (L, B) one-hot targets
    r_envs: torch.Tensor,  # (N+1, B, M) stale right environments
    lenv: torch.Tensor,    # (B, M) the boundary left environment
    f: torch.Tensor,       # (L, B) the batch output before the sweep
    lr,
    weight_dec=0.0,
    act_fn: str = "linear",
    loss_fn: str = "MSE",
    T: float = 0.1,
    renorm_envs: bool = False,
    growth_cap: float = 0.0,
):
    """A fused sweep's N - 1 steps: step s is ``two_site_step`` on
    ``a2s[s]``, ``x[s]``, ``x[s + 1]`` and ``r_envs[s + 2]`` with the carried
    label core, left environment and output. Returns ``(a_lefts (N-1, M*D,
    M), lab_final (L, M, D*M), f_final (L, B), metrics (N-1, 4), mean_abs_f
    (N-1,))``, ``mean_abs_f[s]`` the mean |f| of step s's carried output.

    CPU tensors run ``two_site_sweep_reference``. CUDA tensors must be
    float32 and contiguous, and run as one call of the kernel's sweep entry
    with the same outputs, bit for bit, as a loop of ``two_site_step`` (but
    for ``mean_abs_f``, which the kernel sums in its own order); the N - 1
    steps add N - 1 to ``two_site_step.launches``.
    """
    tensors = (lab, a2s, x, y1h, r_envs, lenv, f)
    kw = dict(act_fn=act_fn, loss_fn=loss_fn, T=T, renorm_envs=renorm_envs,
              growth_cap=growth_cap)
    if all(t.device.type == "cpu" for t in tensors):
        return two_site_sweep_reference(lab, a2s, x, y1h, r_envs, lenv, f, lr, weight_dec, **kw)
    dev = lab.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "two_site_sweep takes CPU tensors or CUDA tensors on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the CUDA kernel takes float32, got " + ", ".join(str(t.dtype) for t in tensors)
        )
    if act_fn not in _ACT or loss_fn not in _LOSS:
        raise ValueError(f"unknown act_fn {act_fn!r} or loss_fn {loss_fn!r}")
    if lab.dim() != 3 or x.dim() != 3 or a2s.dim() != 4:
        raise ValueError(f"lab must be (L, M*D, M), a2s (N-1, M, D, M) and x (N, B, D), got "
                         f"{tuple(lab.shape)}, {tuple(a2s.shape)}, {tuple(x.shape)}")
    L, I, M = lab.shape
    N, B, D = x.shape
    shapes_ok = (
        I == M * D and a2s.shape == (N - 1, M, D, M) and r_envs.shape == (N + 1, B, M)
        and lenv.shape == (B, M) and y1h.shape == (L, B) and f.shape == (L, B)
    )
    if not shapes_ok:
        raise ValueError(
            "two_site_sweep shapes do not fit together: lab "
            f"{tuple(lab.shape)}, a2s {tuple(a2s.shape)}, x {tuple(x.shape)}, r_envs "
            f"{tuple(r_envs.shape)}, lenv {tuple(lenv.shape)}, y1h {tuple(y1h.shape)}, "
            f"f {tuple(f.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("two_site_sweep takes contiguous tensors")
    if min(L, M, D, B) == 0 or N < 2:
        raise ValueError("two_site_sweep takes no empty dimension and at least one step")
    f32 = dict(dtype=torch.float32, device=dev)
    lr_t = torch.as_tensor(lr, **f32).reshape(1)
    wd_t = torch.as_tensor(weight_dec, **f32).reshape(1)
    om = _omega(L, D * M, M, dev).contiguous()
    loop_block = _coeff_block(_pe_schedule(*_PE_LOOP))
    final_block = _coeff_block(_pe_schedule(*_PE_FINAL))
    a_lefts = torch.empty((N - 1, I, M), **f32)
    lab_final = torch.empty((L, M, D * M), **f32)
    f_final = torch.empty((L, B), **f32)
    metrics = torch.empty((N - 1, 4), **f32)
    mean_abs_f = torch.empty((N - 1,), **f32)
    lib = _lib()
    key = (dev, L, M, D, B)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = torch.empty((lib.tnml_sweep_work_floats(L, M, D, B),), **f32)
    with torch.cuda.device(dev):
        err = lib.tnml_fused_sweep(
            lab.data_ptr(), a2s.data_ptr(), x.data_ptr(), r_envs.data_ptr(), y1h.data_ptr(),
            lenv.data_ptr(), f.data_ptr(), om.data_ptr(), lr_t.data_ptr(), wd_t.data_ptr(),
            a_lefts.data_ptr(), lab_final.data_ptr(), f_final.data_ptr(), metrics.data_ptr(),
            mean_abs_f.data_ptr(), _WORKSPACE[key].data_ptr(),
            N, L, M, D, B, _ACT[act_fn], _LOSS[loss_fn], float(T), int(bool(renorm_envs)),
            float(growth_cap), ctypes.byref(loop_block), ctypes.byref(final_block),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"two_site_sweep kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    two_site_step.launches += N - 1
    return a_lefts, lab_final, f_final, metrics, mean_abs_f
