"""The yardstick: the card's peaks, the least time for a piece of work, and
the work of each kernel and of the model, counted from the configuration's
shapes and the split's fixed pass schedule (never from a kernel's tiles or
padding).

The work functions are frozen copies of those ``chip_smoke.py`` used for its
tables (``chain_work``, ``polar_work``, ``presplit_work``, ``rf_work``,
``gram_flops``, ``bound_ms``), so the benchmark's shares do not move when
that script does. A symmetric product (a Gram ``B B^T``, ``W = Y^T Y``,
``W W``) counts as one triangle.

The configurations are IEEE float32. Their operations are bounded by the
float32-accurate rate of the tensor cores in 3xTF32 (495 TFLOP/s TF32 dense,
a third of it), so that a kernel moved onto the tensor cores still reads
under 100%; bytes by the HBM rate. Both are NVIDIA's published figures for
the H100 SXM at its full 700 W power limit.
"""

from __future__ import annotations

TF32_DENSE_FLOPS = 495e12
TC_PASSES = 3  # 3xTF32: hi*hi + hi*lo + lo*hi
PEAK_FLOPS = TF32_DENSE_FLOPS / TC_PASSES  # 165 TFLOP/s, float32-accurate
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

# the polar split's fixed schedules (ops/kernels/polar_split.py: the greedy
# minimax passes from l0 = 1e-3 to E = 0.25, then from 1e-7 to 1e-7)
POLAR_LOOP_PASSES = 5
POLAR_FINAL_PASSES = 14
# the rangefinder split's schedule (ops/kernels/split_kernel.py)
RF_OVERSAMPLE = 8
RF_ITERS = 6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time in seconds for ``flops`` operations and ``nbytes`` bytes
    on one card, the larger of the two at the peaks above, and which of the
    two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def share_pct(work: tuple[float, float], seconds: float):
    """A kernel's or a step's share of its roofline in %: its bound over the
    time it took. None when nothing was timed."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound(*work)[0] / seconds


def gram_flops(I, J):
    """FLOPs of G = B B^T for B (I, J): one triangle and the diagonal."""
    return 1.0 * I * (I + 1) * J


def chain_work(n, m, b):
    """FLOPs and bytes of K3: ``n`` sites of ``(m, 2, m)`` over ``b`` samples,
    each site's input contraction and product with the environment (4 m^2 a
    sample and site); the sites and pixels read once, the environment written
    once."""
    return 4.0 * n * b * m * m, 4.0 * (n * m * 2 * m + b * n + b * m)


def polar_work(I, q, n_loop=POLAR_LOOP_PASSES, n_final=POLAR_FINAL_PASSES, n_power=1):
    """FLOPs and bytes of K1: per pass W = y^T y and W W (one triangle each)
    and y P; the prescale Grams (one triangle) and g y; y and g read once, Q
    written once."""
    passes = n_loop * n_power + n_final
    flops = (passes * (gram_flops(q, I) + gram_flops(q, q) + 2.0 * I * q * q)
             + (n_power + 1) * gram_flops(q, I) + n_power * 2.0 * I * I * q)
    return flops, 4.0 * (2 * I * q + I * I)


def presplit_work(Lb, I, Mk, DM, B, q, D=2):
    """FLOPs and bytes of K2: the merge, the gradient, f, y and G (one
    triangle) over the ``Lb`` label blocks; its inputs (lr and wd included)
    read once, its outputs written once."""
    flops = 2.0 * Lb * I * DM * (Mk + B + q + B) + gram_flops(I, Lb * DM)
    nbytes = 4.0 * (Lb * I * Mk + Mk * DM + 2 * B * D + 2 * B * Mk + 2 * Lb * B
                    + Lb * DM * q + 2
                    + Lb * I * DM + I * q + I * I + Lb * B + B * I + 8)
    return flops, nbytes


def rf_work(I, J, q, rank, n_iter=RF_ITERS):
    """FLOPs and bytes of K6: the sketch, the Gram and |B|^2; ``n_iter``
    products with G; ``n_iter + 1`` column normalisations and Householder
    passes (8 (I-j)(q-j) at reflector j); R = Q^T B. B and Omega read once,
    Q and R written once."""
    hqr = sum(8.0 * (I - j) * (q - j) for j in range(q))
    flops = (2.0 * I * J * q + gram_flops(I, J) + 2.0 * I * J + n_iter * 2.0 * I * I * q
             + (n_iter + 1) * (hqr + 3.0 * I * q) + 2.0 * rank * I * J)
    return flops, 4.0 * (I * J + J * q + I * rank + rank * J)


# ---- the model's work: what a request and a sweep need, whatever runs them ----

def sample_flops(N, M, D, L):
    """FLOPs to score one sample: the chain of ``N - 1`` sites into the right
    environment (K3's count) and its closure with the label core."""
    return chain_work(N - 1, M, 1)[0] + 2.0 * M * D * L * M


def env_stack_flops(N, M, D, L, B):
    """FLOPs of a sweep's prologue: the stale right environments of ``N - 1``
    sites over the batch (2 M D M a sample and site) and the batch's output
    through the label core."""
    return (N - 1) * 2.0 * B * M * D * M + 2.0 * B * M * D * L * M


def step_flops(M, D, L, B, split):
    """FLOPs of one two-site step: the merge, the gradient, the output, the
    split (``"polar"`` or ``"rangefinder"``, with its sketch and Gram) and
    ``R``, and the environment update."""
    I, DM = M * D, D * M
    J = L * DM
    merge_grad_f = 2.0 * L * I * DM * (M + B + B)
    env = 2.0 * B * I * M
    if split == "polar":
        q = M
        split_flops = (2.0 * I * J * q + gram_flops(I, J) + polar_work(I, q)[0]
                       + 2.0 * q * I * J)
    elif split == "rangefinder":
        split_flops = rf_work(I, J, min(M + RF_OVERSAMPLE, I), M)[0]
    else:
        raise ValueError(f"no work count for the split {split!r}")
    return merge_grad_f + split_flops + env


def sweep_flops(N, M, D, L, B, split):
    """FLOPs of one sweep: its prologue and its ``N - 1`` steps; the same for
    every engine that runs the same split."""
    return env_stack_flops(N, M, D, L, B) + (N - 1) * step_flops(M, D, L, B, split)
