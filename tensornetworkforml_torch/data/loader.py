"""Host data pipeline: datasets and batching (NumPy only).

The reference uses ``torch.utils.data`` purely as batching plumbing
(``data_generator.py:90-194``): a ``NumpyDataset``, a shuffled subset, and
loaders with an identity collate that yield lists of ``(x, y)`` pairs. This
module is the port's copy of the JAX package's ``data/loader.py`` surface:

* ``ArrayLoader`` iterates like the reference loaders (lists of pairs) and
  exposes ``.batches()`` yielding stacked ``(x, y)`` arrays -- the path the
  trainer uses (one host->device copy per batch).
* ``with_batch_size`` and ``warmup_batch_size`` serve ``train_model``'s
  small-batch warmup epochs.
* ``prepare_dataset`` matches the reference signature and semantics:
  flatten, optionally psi-embed on the host (``psi_embed_host``), split by
  percentage, carve validation from the end of the train part, drop the last
  partial batch of train and validation.

The same seeds give the same batches as the JAX package's loaders.
``psi_embed_host`` is NumPy; the JAX package's ctypes path through
``native/data_core.cpp`` computes the same values and is not ported
(ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class NumpyDataset:
    """Minimal map-style dataset over parallel numpy arrays (reference
    ``data_generator.py:90-122`` equivalent, torch-free)."""

    def __init__(self, data: np.ndarray, label: np.ndarray):
        self.data = data
        self.label = label

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index):
        return (self.data[index], self.label[index])


class ArrayLoader:
    """Batched loader over (a subset of) a dataset.

    Iterating yields reference-style lists of ``(x_i, y_i)`` pairs;
    ``batches()`` yields stacked ``(x, y)`` arrays. With ``shuffle=True`` the
    subset order is re-drawn each epoch (``SubsetRandomSampler`` semantics).
    """

    def __init__(
        self,
        dataset: NumpyDataset,
        batch_size: int,
        indices: Optional[np.ndarray] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.indices = (
            np.arange(len(dataset)) if indices is None else np.asarray(indices)
        )
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            idx = self._rng.permutation(idx)
        return idx

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield self.dataset.data[sel], self.dataset.label[sel]

    def __iter__(self):
        for xb, yb in self.batches():
            yield [(xb[i], yb[i]) for i in range(len(xb))]


def with_batch_size(
    loader: ArrayLoader, batch_size: int, even_batches: bool = False
) -> ArrayLoader:
    """A view of the same (sub)dataset with a different batch size.

    Used by the large-batch warmup schedule (``train_model``): the first
    epoch(s) run at a smaller batch so the noisier per-sweep gradients
    escape init-dependent attractors that large clean batches settle into
    (measured: B=256 final-val spread 0.20 across seeds without warmup,
    0.037 with one half-batch warmup epoch).

    ``even_batches`` trims the subset so the epoch has an EVEN number of
    batches: sweep directions alternate per batch, so an odd count leaves
    the label leg at the far chain end -- which silently knocks every
    following epoch off the fused whole-epoch path.
    """
    indices = loader.indices
    if even_batches:
        n_batches = len(indices) // batch_size
        if n_batches % 2 == 1:
            indices = indices[: (n_batches - 1) * batch_size]
    return ArrayLoader(
        loader.dataset,
        batch_size,
        indices=indices,
        shuffle=loader.shuffle,
        drop_last=loader.drop_last,
        seed=None if loader.shuffle is False else int(loader._rng.integers(2**31)),
    )


def warmup_batch_size(batch_size: int) -> int:
    """The warmup-epoch batch for a given training batch: always <= 128
    (and <= batch_size // 2 for batch_size >= 2).

    The warmup mechanism needs the ABSOLUTE small-batch noise scale, not
    a fixed fraction of the training batch (measured at B=1024: a
    half-batch (512) warmup still lands in the large-batch attractor,
    test 0.38/0.71; a 128-sample warmup restores the basin, 0.97 --
    results/large_batch_quality.json). The divisor rounds UP so batches
    just under a multiple of 128 stay inside the measured basin
    (340 -> 113, not 170).
    """
    return max(1, batch_size // max(2, -(-batch_size // 128)))


def psi_embed_host(x: np.ndarray) -> np.ndarray:
    """Host psi embedding ``(..., N) -> (..., N, 2)``: ``[sin(pi x/2),
    cos(pi x/2)]`` in the dtype of ``x``."""
    half_pi_x = (np.pi / 2.0) * np.asarray(x)
    return np.stack([np.sin(half_pi_x), np.cos(half_pi_x)], axis=-1)


def prepare_dataset(
    data: np.ndarray,
    label: np.ndarray,
    train_perc: float,
    val_perc: float,
    train_batch_size: int,
    val_batch_size: int,
    test_batch_size: int,
    embed: bool = True,
    seed: Optional[int] = None,
    even_train_batches: bool = False,
):
    """Flatten, (optionally) embed, split, and build the three loaders.

    The first ``train_perc`` of the samples are train, of which the LAST
    ``val_perc`` fraction is validation; the rest is test. The train and
    validation loaders shuffle and drop the last partial batch, the test
    loader does neither. ``embed=False`` yields raw flattened pixels
    ``(B, N)``, embedded on the device by the trainer.

    ``even_train_batches`` trims the train subset to an even number of
    batches (when there are at least 3): sweep directions alternate per
    batch, and an odd count would leave the label leg at the far chain end
    and keep every later epoch off the whole-epoch path.
    """
    x = np.asarray(data).reshape(len(data), -1)
    if embed:
        x = psi_embed_host(x)

    m = int(len(x) * train_perc)
    train_set = NumpyDataset(x[:m], np.asarray(label)[:m])
    test_set = NumpyDataset(x[m:], np.asarray(label)[m:])

    train_len = int(m * (1 - val_perc))
    if even_train_batches:
        n_batches = train_len // train_batch_size
        if n_batches % 2 == 1 and n_batches >= 3:
            train_len = (n_batches - 1) * train_batch_size
    train_loader = ArrayLoader(
        train_set, train_batch_size, indices=np.arange(train_len), shuffle=True,
        drop_last=True, seed=seed,
    )
    val_loader = ArrayLoader(
        train_set, val_batch_size, indices=np.arange(train_len, m), shuffle=True,
        drop_last=True, seed=None if seed is None else seed + 1,
    )
    test_loader = ArrayLoader(test_set, test_batch_size, drop_last=False)
    return train_loader, val_loader, test_loader
