"""Reference-compatible bond-rank schedules for the padded sweep.

The reference truncates the two-site SVD to the PRE-merge left bond of the
left site for middle positions and keeps the full rank at chain edges
(``Network_class.py:894-910`` right sweep, ``:930-945`` left sweep). Since
bond dims there are data-independent (they follow a deterministic recurrence
in N, D, L and the current profile -- bonds collapse to ~D after the first
sweep, confirmed against the shipped checkpoints), the whole per-step rank
sequence can be computed on the host and fed to the sweep loop as data,
where it masks singular values (see ``ops/svd.py`` ``keep``).

The framework's DEFAULT training mode instead keeps a fixed rank M
("proper" two-site DMRG truncation, strictly more expressive); this module
exists for bit-parity with the reference and for importing its checkpoints
mid-training.
"""

from __future__ import annotations

import numpy as np


def fresh_bond_profile(N: int, M: int) -> list[int]:
    """Bond dims of a freshly initialised reference net: all M
    (``Network_class.py:145-148``). Entry i is the bond between sites i, i+1.
    """
    return [M] * (N - 1)


def effective_bond_profile(mps) -> list[int]:
    """Effective (nonzero-structure) bond dims of a padded MPS.

    Bond i is read off the right leg of site i (label site included); the
    padded importer writes values into the leading ``[:ml, :, :mr]`` block,
    so the effective dim is the index of the last nonzero slice + 1.
    """
    sites = mps.sites.detach().cpu().numpy()
    label = mps.label_site.detach().cpu().numpy()  # (M, D, L, M)
    N = sites.shape[0]
    bonds = []
    for i in range(N - 1):
        A = label.reshape(label.shape[0], -1, label.shape[-1]) if i == mps.l_pos \
            else sites[i]
        nz = np.flatnonzero(np.abs(A).sum(axis=(0, 1)) > 0)
        bonds.append(int(nz[-1]) + 1 if len(nz) else 1)
    return bonds


def reference_rank_schedule(
    bonds: list[int], N: int, D: int, L: int, left_dir: bool
) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Per-step SVD rank caps for one reference-faithful sweep.

    Returns ``(ranks, elem_counts, new_bonds)``: ``ranks`` (length N-1, in
    STEP order -- for a left sweep step t corresponds to reference
    position l = N-1-t), ``elem_counts`` the ragged element count of the
    two-site tensor B at each step (used to turn padded SUMS into the
    reference's ragged MEANS in the metric series), and ``new_bonds`` the
    evolved bond profile after the sweep.

    Rank rule (``Network_class.py:894-910, 930-945``): middle steps truncate
    to the pre-merge OUTER-LEFT bond of the pair; edge steps keep the full
    rank min(rows, cols) of the aggregated 2-D B.
    """
    bonds = list(bonds)
    ranks = np.zeros(N - 1, dtype=np.int32)
    counts = np.zeros(N - 1, dtype=np.int64)

    if not left_dir:
        for l in range(N - 1):  # pair (l, l+1); label at l
            left_outer = bonds[l - 1] if l > 0 else 1
            right_outer = bonds[l + 1] if l + 1 < N - 1 else 1
            rows = D * left_outer
            cols = L * D * right_outer
            if l == 0 or l == N - 2:
                k = min(rows, cols)
            else:
                k = left_outer
            new_bond = min(k, rows, cols)
            ranks[l] = k
            counts[l] = rows * cols
            bonds[l] = new_bond
    else:
        for t in range(N - 1):  # step order; reference position l = N-1-t
            l = N - 1 - t  # pair (l-1, l); label at l
            left_outer = bonds[l - 2] if l - 1 > 0 else 1
            right_outer = bonds[l] if l < N - 1 else 1
            rows = D * left_outer * L
            cols = D * right_outer
            if l == N - 1 or l == 1:
                k = min(rows, cols)
            else:
                k = left_outer
            new_bond = min(k, rows, cols)
            ranks[t] = k
            counts[t] = rows * cols
            bonds[l - 1] = new_bond

    return ranks, counts, bonds
