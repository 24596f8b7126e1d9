"""Teacher-MPS synthetic task: hard, capacity-sensitive, known provenance.

Labels come from random teacher MPS functions -- the student-teacher
benchmark shape: the function class is exactly the model class, so a student
with enough bond dimension can reach the ceiling, but only by recovering
entangled functions. ``margin`` drops the samples nearest the decision
boundary (Bayes accuracy stays 1.0 while the learning problem stays hard),
``teacher_m`` sets how much entanglement the student must represent.

There is ONE independent single-output near-product teacher per class: the
L scores are independent O(1)-calibrated functions, z-scored over the
candidate pool and argmax'd, so the labeling is full-rank and balanced. The
direct sum of the L chains is an MPS of bond dimension ``L * teacher_m``,
the task's capacity dial for students. (A single L-label teacher does not
work at N=196: its class scores share the whole chain and collapse to an
effective rank of ~4.)

Everything is NumPy on the host except two steps: the teachers' draw
(``teacher_mps``, from a CPU ``torch.Generator`` so that a seed gives the
same teachers on the CPU and on the card) and their forward pass
(``teacher_scores``, on the task's device). The labeling (``label_pool``)
is NumPy again and gives the same labels for the same scores.
"""

from __future__ import annotations

import numpy as np
import torch

from tensornetworkforml_torch.models.mps import MPS, mps_forward, product_init, resolve_device
from tensornetworkforml_torch.ops.embedding import psi_embed

_CHUNK = 2048  # candidates scored per forward pass


def teacher_mps(seed: int, c: int, N: int, teacher_m: int, noise: float,
                x_cal: np.ndarray, device) -> MPS:
    """Class ``c``'s teacher: a calibrated single-output near-product MPS
    (``product_init`` with per-site data calibration keeps its output O(1)
    at any N), drawn from a CPU generator seeded ``seed * 1000 + 7 + c``."""
    return product_init(
        torch.Generator().manual_seed(seed * 1000 + 7 + c),
        N=N, M=teacher_m, L=1, noise=noise, act_fn="linear", loss_fn="MSE",
        dtype=torch.float32, calibration_x=x_cal, device=device,
    )


def teacher_scores(teachers, x: np.ndarray) -> np.ndarray:
    """The teachers' outputs ``(n, L)`` on raw pixels ``x (n, N)``, computed
    on the teachers' device."""
    phi = psi_embed(torch.as_tensor(x, device=teachers[0].device))
    f = torch.cat([mps_forward(t, phi) for t in teachers], dim=0)  # (L, n)
    return f.T.cpu().numpy()


def label_pool(x, f, rng, n_train, n_test, L, margin, proto_mix, seed):
    """Label the candidate pool ``x`` from its scores ``f (n, L)``: z-score
    each teacher, argmax, drop the ``margin`` quantile of smallest top-2
    gaps, take the widest-margin ``(n_train + n_test) // L`` samples of
    each class, shuffle with ``rng`` and blend toward class prototypes by
    ``proto_mix``. Returns ``(train_x, train_y, test_x, test_y)``."""
    N = x.shape[1]
    # independent teachers have different scales; z-scoring balances the
    # argmax and is a per-class affine head, still inside the MPS class
    f = (f - f.mean(axis=0)) / np.maximum(f.std(axis=0), 1e-12)
    y = f.argmax(axis=1)
    top2 = np.sort(f, axis=1)[:, -2:]
    marg = top2[:, 1] - top2[:, 0]
    if margin > 0:
        keep = marg >= np.quantile(marg, margin)
        x, y, marg = x[keep], y[keep], marg[keep]

    # exact class balance over train+test, widest-margin samples first so
    # the difficulty stays controlled
    per_class = (n_train + n_test) // L
    idx = []
    for c in range(L):
        cand = np.flatnonzero(y == c)
        cand = cand[np.argsort(-marg[cand])]
        if len(cand) < per_class:
            raise ValueError(
                f"class {c} has only {len(cand)} samples; lower margin or "
                "raise oversampling"
            )
        idx.append(cand[:per_class])
    idx = np.concatenate(idx)
    rng.shuffle(idx)
    x, y = x[idx], y[idx]

    if proto_mix > 0:
        side = int(round(np.sqrt(N)))
        if side * side == N:  # smooth 2-D prototypes when N is square
            yy, xx = np.mgrid[0:side, 0:side] / max(side - 1, 1)
            protos = np.stack([
                0.5 + 0.5 * np.sin(
                    2 * np.pi * ((1 + c % 3) * xx + (1 + (c // 3) % 3) * yy)
                    + 2 * np.pi * c / L
                )
                for c in range(L)
            ]).reshape(L, N)
        else:
            protos = np.random.default_rng(seed + 1).random((L, N))
        x = (1.0 - proto_mix) * x + proto_mix * protos[y].astype(np.float32)

    return (
        x[:n_train], y[:n_train].astype(np.int64),
        x[n_train:n_train + n_test], y[n_train:n_train + n_test].astype(np.int64),
    )


def teacher_task(
    n_train: int = 4096,
    n_test: int = 1024,
    N: int = 196,
    L: int = 10,
    teacher_m: int = 4,
    margin: float = 0.3,
    noise: float = None,
    proto_mix: float = 0.2,
    seed: int = 0,
    device=None,
):
    """Generate ``(train_x, train_y, test_x, test_y)``: raw pixels in [0, 1]
    and labels = argmax over L independent teacher MPS outputs, z-scored
    over the candidate pool.

    Teachers are near-product chains with entanglement ``noise`` (default
    ``1/sqrt(N)``): fully random teachers give noise-like functions whose
    sample complexity explodes with N, while the near-product teacher's
    effective frequency is set by ``noise``, keeping the task learnable but
    not saturating at any chain length.

    ``margin``: the fraction of candidates discarded as closest to the
    decision boundary (by the top-2 z-score gap); 0 keeps all.
    ``proto_mix``: after labeling each sample is blended toward a smooth
    class prototype, ``x <- (1-a) x + a proto[y]``, which plants a class-mean
    channel beside the entangled teacher signal (0 keeps the pure teacher
    task, where greedy two-site sweeps from a product init do not fit even
    the train set).

    Classes come out exactly balanced over train+test combined. The pixel
    pools depend on ``seed`` alone; the teachers run on ``device``
    (``None``: the card, see ``resolve_device``).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if noise is None:
        noise = 1.0 / np.sqrt(N)
    n_want = n_train + n_test
    # oversample so the margin filter and the class balancing can discard
    n_cand = int(n_want / max(1e-6, 1.0 - margin) * 2.2) + L * 128

    x_cal = rng.random((64, N)).astype(np.float32)
    teachers = [teacher_mps(seed, c, N, teacher_m, noise, x_cal, device) for c in range(L)]

    xs, scores = [], []
    for start in range(0, n_cand, _CHUNK):
        x = rng.random((min(_CHUNK, n_cand - start), N)).astype(np.float32)
        xs.append(x)
        scores.append(teacher_scores(teachers, x))
    return label_pool(np.concatenate(xs), np.concatenate(scores), rng, n_train, n_test,
                      L, margin, proto_mix, seed)
