"""The work of the ring MPS's autodiff step (``models/ring.py::
ring_forward_arrays`` under autograd, ``train/autodiff.py``), counted from
the configuration's shapes, against ``roofline.PEAK_FLOPS`` and
``roofline.PEAK_BYTES``.

The forward carries a ``(B, M, M)`` product through the ``N - 1`` sites
after the label: each site's matrix from its core and the batch's features
(a contraction over ``D``, an einsum of ``K = D``), then one batched product
with the carry; the loop closes through the label core (one product over
``M M D``). The backward takes two batched products a site (the carry's and
the site matrix's gradients; none for the first carry, the identity), the
core's gradient (a contraction over the batch) and the closure's two
gradients. Each is counted as one contraction: its FLOPs, and its bytes
with each input read once and its output written once. The program makes
all the site matrices in one launch, and all the cores' gradients in
another; both are bound by their bytes, so their bound is the sum of the
sites' bounds either way.
"""

from __future__ import annotations

from tnbench import roofline


def product(B, M):
    """A batched product of ``(B, M, M)`` matrices."""
    return 2.0 * B * M ** 3, 4.0 * 3 * B * M * M


def site_matrix(B, M, D):
    """A site's ``(B, M, M)`` matrices from its core ``(M, D, M)`` and the
    features ``(B, D)``; its backward, the core's gradient, moves the same."""
    return 2.0 * B * M * D * M, 4.0 * (M * D * M + B * D + B * M * M)


def closure(B, M, D, L):
    """The loop closed through the label core: ``(B, M M D) @ (M M D, L)``;
    each of its two gradients moves the same."""
    return 2.0 * B * M * M * D * L, 4.0 * (B * M * M * D + M * D * L * M + L * B)


def step_launches(N, M, D, L, B) -> list:
    """``(work, count)`` of every contraction of one step, forward and
    backward."""
    n = N - 1
    return [(product(B, M), 3 * n - 1), (site_matrix(B, M, D), 2 * n),
            (closure(B, M, D, L), 3)]


def forward_flops(N, M, D, L, B) -> float:
    """FLOPs of one forward: the site matrices, the products, the closure."""
    return (N - 1) * (product(B, M)[0] + site_matrix(B, M, D)[0]) + closure(B, M, D, L)[0]


def step_flops(N, M, D, L, B) -> float:
    """FLOPs of one step's contractions, forward and backward."""
    return sum(w[0] * k for w, k in step_launches(N, M, D, L, B))


def step_bound_s(N, M, D, L, B) -> float:
    """The least time for one step's contractions: each launch at the larger
    of its FLOP time and its byte time, summed."""
    return sum(roofline.bound(*w)[0] * k for w, k in step_launches(N, M, D, L, B))
