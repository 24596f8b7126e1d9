"""Fused psi-embedding + MPS chain contraction: the serving forward's kernel.

``right_env_chain`` computes the right environment of the whole chain from
raw pixels. On a CUDA tensor it launches the hand-written kernel
``csrc/env_scan.cu`` (the counterpart of the JAX package's Pallas kernel
``right_env_chain_pallas``); on a CPU tensor it runs the plain version
``right_env_chain_reference``. A CUDA input the kernel does not take
raises; it never falls back to the plain version.

The kernel has two forms, chosen from ``(M, B)`` and the card's SM layout
alone (its SM count and how many clusters of 2, 3 and 4 CTAs it holds at
once): the latency form (a batch tile of 8 samples on a cluster of up to 4
CTAs, each owning a slice of A's rows) and the throughput form (64 samples a
CTA, all rows). ``plan`` mirrors the kernel's choice; ``kernel_plan`` asks
the built library which form a shape runs on the current card.
"""

from __future__ import annotations

import ctypes

import torch

from tensornetworkforml_torch.ops.contractions import (
    boundary_vector,
    chain_scores,
    right_env_final_fused,
)
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import _build


def right_env_chain_reference(sites: torch.Tensor, x_raw: torch.Tensor) -> torch.Tensor:
    """Plain version: ``sites (n, M, D, M)``, ``x_raw (B, n)`` -> ``(B, M)``.

    A loop of einsums over sites (``right_env_final_fused``) on the embedded
    pixels; any dtype and device.
    """
    e0 = boundary_vector(sites.shape[1], dtype=sites.dtype, device=sites.device)
    return right_env_final_fused(sites, psi_embed(x_raw).transpose(0, 1), e0)


LATENCY, THROUGHPUT = 0, 1
FORMS = ("latency", "throughput")
_SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into on Hopper
_ONE_CTA_AN_SM = _SMEM_LIMIT // 2 + 1024  # a latency-form CTA's least shared memory
_MAX_STAGES = 4
# clusters of 2, 3 and 4 CTAs that an H100 (132 SMs) holds at once at one CTA
# an SM (cudaOccupancyMaxActiveClusters; measured on an NVIDIA H100 80GB HBM3)
H100_CLUSTERS = {2: 66, 3: 39, 4: 30}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(form: int, C: int, BT: int, M: int) -> dict:
    """The shape plan of one form, as ``make_plan`` in ``csrc/env_scan.cu``
    computes it: the latency form has no ring (``stages`` 0), the throughput
    form's ring takes as many stages (2 to 4) as fit."""
    if form == LATENCY:
        RP, KC = 4 * (12 if C == 3 else 8), 128  # warps of 4 rows x 8 samples
    else:
        RP, KC, SR = 128, 32, 68
    Mv = _cdiv(M, KC) * KC
    fixed = 4 * (2 * Mv * BT + 6 * BT)
    stages, smem = 0, fixed
    if form == THROUGHPUT:
        fits = False
        for s in range(_MAX_STAGES, 1, -1):
            if fixed + 4 * s * RP * SR <= _SMEM_LIMIT:
                stages, smem, fits = s, fixed + 4 * s * RP * SR, True
                break
    else:
        fits, smem = fixed <= _SMEM_LIMIT, max(fixed, _ONE_CTA_AN_SM)
    return {"form": FORMS[form], "C": C, "BT": BT, "stages": stages, "smem": smem,
            "fits": fits, "passes": _cdiv(_cdiv(M, C), RP), "rows": RP}


def plan(M: int, B: int, sms: int, clusters: dict = None) -> dict:
    """The form K3 runs for ``(M, B)`` on a card with ``sms`` SMs that holds
    ``clusters[C]`` clusters of C CTAs at once (an H100's by default), as the
    kernel's ``plan`` chooses it: the throughput form once 64-sample tiles
    fill half the SMs and its buffers fit; else the latency form on 8-sample
    tiles, on the cluster of 1 to 4 CTAs whose walk costs least (waves of
    clusters x passes a CTA x rows a pass; ties to the smaller cluster)."""
    if 2 * _cdiv(B, 64) >= sms:
        t = _plan(THROUGHPUT, 1, 64, M)
        if t["fits"]:
            return _public(t)
    cap = {1: sms, **(H100_CLUSTERS if clusters is None else clusters)}
    best, best_cost = _plan(LATENCY, 1, 8, M), None
    for C in range(1, 5):
        p = _plan(LATENCY, C, 8, M)
        cost = _cdiv(_cdiv(B, 8), cap[C]) * p["passes"] * p["rows"]
        if p["fits"] and (best_cost is None or cost < best_cost):
            best, best_cost = p, cost
    return _public(best)


def _public(p: dict) -> dict:
    return {k: p[k] for k in ("form", "C", "BT", "stages", "smem", "fits")}


def _lib() -> ctypes.CDLL:
    lib = _build.load("env_scan")
    fn = lib.tnml_right_env_chain
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # sites
            ctypes.c_void_p,  # x
            ctypes.c_int,     # ldx
            ctypes.c_void_p,  # out
            ctypes.c_int,     # n
            ctypes.c_int,     # M
            ctypes.c_int,     # B
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.tnml_right_env_chain_as.argtypes = [ctypes.c_int] * 3 + fn.argtypes
        lib.tnml_right_env_chain_as.restype = ctypes.c_int
        lib.tnml_env_scan_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tnml_env_scan_plan.restype = ctypes.c_int
        lib.tnml_env_scan_card.argtypes = [ctypes.c_void_p]
        lib.tnml_env_scan_card.restype = ctypes.c_int
        lib.tnml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tnml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _query(fn, n: int, device, *args) -> list:
    lib = _lib()
    out = (ctypes.c_int * n)()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err} "
                           f"({lib.tnml_cuda_error_string(err).decode()})")
    return list(out)


def kernel_card(device=None) -> tuple[int, dict]:
    """The CUDA device's SM count and the clusters of 2, 3 and 4 CTAs it holds
    at once, as the kernel reads them: the inputs of ``plan``."""
    sms, *caps = _query("tnml_env_scan_card", 4, device)
    return sms, dict(zip((2, 3, 4), caps))


def kernel_plan(M: int, B: int, device=None) -> dict:
    """The form the built kernel launches for ``(M, B)`` on a CUDA device
    (the current one by default): ``tnml_env_scan_plan``."""
    out = _query("tnml_env_scan_plan", 6, device, M, B)
    return {"form": FORMS[out[0]], "C": out[1], "BT": out[2], "stages": out[3],
            "smem": out[4], "fits": bool(out[5])}


def right_env_chain(sites: torch.Tensor, x_raw: torch.Tensor) -> torch.Tensor:
    """Right environment of the full chain from RAW pixels.

    ``sites (n, M, 2, M)``, ``x_raw (B, n)`` -> ``(B, M)``; equals
    ``right_env_final_fused(sites, psi_embed(x_raw).transpose(0, 1), e0)``.

    CUDA inputs must be float32, ``sites`` contiguous and the rows of
    ``x_raw`` unit-stride; each launch, in the form ``plan`` gives, adds one
    to ``right_env_chain.launches``.
    """
    if sites.device.type == "cpu" and x_raw.device.type == "cpu":
        return right_env_chain_reference(sites, x_raw)
    if sites.device.type != "cuda" or x_raw.device != sites.device:
        raise ValueError(
            "right_env_chain takes CPU tensors or CUDA tensors on one device, "
            f"got sites on {sites.device} and x_raw on {x_raw.device}"
        )
    if sites.dtype != torch.float32 or x_raw.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernel takes float32, got {sites.dtype} and {x_raw.dtype}"
        )
    if sites.dim() != 4 or sites.shape[2] != 2 or sites.shape[1] != sites.shape[3]:
        raise ValueError(f"sites must be (n, M, 2, M), got {tuple(sites.shape)}")
    n, M = sites.shape[0], sites.shape[1]
    if x_raw.dim() != 2 or x_raw.shape[1] != n:
        raise ValueError(f"x_raw must be (B, {n}), got {tuple(x_raw.shape)}")
    B = x_raw.shape[0]
    ldx = x_raw.stride(0) if B > 1 else n
    if not sites.is_contiguous() or x_raw.stride(1) != 1 or ldx < n:
        raise ValueError(
            "sites must be contiguous and x_raw rows unit-stride, not overlapping"
        )
    if n == 0:
        return boundary_vector(M, device=sites.device).expand(B, M)
    out = torch.empty((B, M), dtype=torch.float32, device=sites.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(sites.device):
        stream = torch.cuda.current_stream(sites.device).cuda_stream
        err = lib.tnml_right_env_chain(
            sites.data_ptr(), x_raw.data_ptr(), ldx,
            out.data_ptr(), n, M, B, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"right_env_chain kernel failed: cudaError {err} "
            f"({lib.tnml_cuda_error_string(err).decode()})"
        )
    right_env_chain.launches += 1
    return out


right_env_chain.launches = 0


def forward_scores(mps, x_raw: torch.Tensor) -> torch.Tensor:
    """Class scores ``(L, B)`` from raw pixels via the fused chain kernel.

    Requires the label leg at site 0. The kernel contracts sites ``1..N-1``;
    the label site closes the chain with ``chain_scores`` outside it.
    """
    if mps.l_pos != 0:
        raise ValueError("the chain kernel expects the label leg at site 0")
    x_raw = torch.as_tensor(x_raw, dtype=mps.dtype, device=mps.device)
    right = right_env_chain(mps.sites[1:], x_raw[:, 1:])
    B, M = x_raw.shape[0], mps.M
    e0 = boundary_vector(M, dtype=mps.dtype, device=mps.device).expand(B, M)
    return chain_scores(e0, mps.label_site, psi_embed(x_raw[:, 0]), right)
