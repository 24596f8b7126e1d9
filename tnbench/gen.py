"""Inputs and weights made from ``--seed``, on the device, in a few large calls.

Frozen copies, written for the device, of the port's synthetic MNIST stand-in
(``data/mnist.py::synthetic_mnist``: class-dependent low-frequency patterns
plus uniform noise, in [0, 255]), of its 2x2 max-pool and of its product-state
initialisation (``models/mps.py::product_init``, as the training CLI
and the production recipe call it). They belong to the benchmark: the program under
test receives only what they make, and the reference receives the same.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """One generator for a run, on ``device``; every draw of the run comes
    from it in a fixed order."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _prototypes(side: int, n_classes: int, device) -> torch.Tensor:
    yy, xx = torch.meshgrid(torch.arange(side, dtype=torch.float64, device=device),
                            torch.arange(side, dtype=torch.float64, device=device),
                            indexing="ij")
    yy, xx = yy / (side - 1), xx / (side - 1)
    protos = []
    for c in range(n_classes):
        k1, k2 = 1 + c % 3, 1 + (c // 3) % 3
        phase = 2 * math.pi * c / n_classes
        protos.append(0.5 + 0.5 * torch.sin(2 * math.pi * (k1 * xx + k2 * yy) + phase))
    return torch.stack(protos).to(torch.float32)  # (C, side, side)


def images(gen: torch.Generator, n: int, cfg: dict, noise: float = 0.15):
    """``n`` pooled images ``(n, N)`` in [0, 1] and their labels ``(n,)``,
    on the generator's device: ``max_pool_2x2(synthetic / 255)``."""
    dev = gen.device
    side, n_classes = cfg["image_side"], cfg["L"]
    y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    base = _prototypes(side, n_classes, dev)[y]
    imgs = base * (1 - noise) + torch.rand(base.shape, generator=gen, device=dev) * noise
    p = cfg["pool"]
    pooled = imgs.reshape(n, side // p, p, side // p, p).amax(dim=(2, 4))
    x = pooled.reshape(n, -1).contiguous()
    if x.shape[1] != cfg["N"]:
        raise ValueError(f"{side}x{side} pooled by {p} gives {x.shape[1]} sites, "
                         f"the configuration has N = {cfg['N']}")
    return x, y


def psi(x: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., N)`` -> features ``(..., N, 2)``."""
    h = (math.pi / 2.0) * x
    return torch.stack([torch.sin(h), torch.cos(h)], dim=-1)


def _right_env_scores(sites, label, phi):
    """Scores ``(L, B)`` of the label-at-site-0 chain, a loop of einsums."""
    N, M = sites.shape[0], sites.shape[1]
    B = phi.shape[0]
    v = torch.zeros((B, M), dtype=sites.dtype, device=sites.device)
    v[:, 0] = 1.0
    for n in range(N - 1, 0, -1):
        w = torch.einsum("bd,br->bdr", phi[:, n], v)
        v = torch.einsum("ldr,bdr->bl", sites[n], w)
    w = phi[:, 0]
    y = torch.einsum("bd,dor->bor", w, label[0])
    return torch.einsum("bor,br->ob", y, v)


def product_weights(gen: torch.Generator, cfg: dict, calibration_x: torch.Tensor,
                    noise: float = 1e-2, target_abs_f: float = 1.0):
    """``(sites (N, M, D, M), label_site (M, D, L, M))`` in float32 on the
    generator's device, as ``product_init`` makes them for the training CLI
    and the production recipe: a near-identity product state plus Gaussian
    noise, each site scaled by the calibration batch's mean ``sum_d psi_d``
    (so a chain contraction keeps the environment O(1) at every site), the
    label leg at site 0, and the label core rescaled to max|f| =
    ``target_abs_f`` when the calibration batch's max|f| leaves [0.1, 10]
    (the large-bond guard)."""
    dev = gen.device
    N, M, D, L = cfg["N"], cfg["M"], cfg["D"], cfg["L"]
    f32 = torch.float32
    x = calibration_x.to(f32)
    psi_sum = torch.sin(math.pi * x / 2) + torch.cos(math.pi * x / 2)
    base = 1.0 / torch.clamp(psi_sum.mean(dim=0), min=1e-3)  # (N,)
    eye = torch.eye(M, dtype=f32, device=dev)
    sites = base[:, None, None, None] * eye[:, None, :].expand(M, D, M)[None]
    sites = sites + noise * torch.randn((N, M, D, M), generator=gen, dtype=f32, device=dev)
    last = torch.zeros((M, D, M), dtype=f32, device=dev)
    last[:, :, 0] = base[N - 1] * eye[:, None, 0].expand(M, D) + noise * torch.randn(
        (M, D), generator=gen, dtype=f32, device=dev)
    sites[N - 1] = last
    sites[0] = 0.0
    label_full = base[0] * eye[:, None, None, :].expand(M, D, L, M) + noise * torch.randn(
        (M, D, L, M), generator=gen, dtype=f32, device=dev)
    label = torch.zeros((M, D, L, M), dtype=f32, device=dev)
    label[0] = label_full[0]
    f_max = float(_right_env_scores(sites, label, psi(x)).abs().max())
    if not 0.1 <= f_max <= 10.0 and f_max > 0.0:
        label = label * (target_abs_f / f_max)
    return sites.contiguous(), label.contiguous()
