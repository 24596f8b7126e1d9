"""Named-axis tensor veneer over torch tensors (API-parity layer).

The reference builds everything on a mutable named-axis ``Tensor`` wrapper
(``TensorNetwork/Tensor_class.py``) and a generic ``contract``
(``custom_linalg_tools.py``). The compute path of this package does not go
through this layer -- the hot contractions are fixed einsums in
``ops/contractions.py`` -- but the veneer is kept for:

* API parity with the reference and the JAX package (constructor, methods
  and semantics: ``aggregate``/``disaggregate``/``transpose``/
  ``ax_to_index``/+/-), which the ``Network`` facade returns;
* interactive use and tests, where contraction by axis name is convenient.

``contract`` is one ``torch.einsum`` with the JAX package's letter
assignment and output-axis order.
"""

from __future__ import annotations

import string
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

AxisSpec = Union[str, int, Sequence[Union[str, int]]]


class Tensor:
    """A named-axis tensor (reference ``Tensor_class.Tensor`` equivalent).

    Attributes
    ----------
    elem : torch.Tensor
        The underlying tensor.
    axes_names : np.ndarray of str
        One name per axis.
    aggregations : dict
        Bookkeeping for ``aggregate``/``disaggregate`` round trips: maps an
        aggregated axis name to ``{original_name: original_dim}`` in order.

    ``elem`` given as a torch tensor stays on its device unless ``device``
    says otherwise; anything else, and a random init from ``shape``, goes to
    ``device`` (``None``: the card, see ``resolve_device``). A random init
    draws uniform [0, 1) entries from ``generator`` (a fresh CPU generator
    seeded from ``np.random`` if None) and divides them by ``scale``.
    """

    def __init__(
        self,
        elem=None,
        shape=None,
        axes_names: Optional[Sequence[str]] = None,
        scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
        device=None,
    ):
        # imported here: models/ imports this module for the facade
        from tensornetworkforml_torch.models.mps import resolve_device

        if elem is None and shape is not None:
            if generator is None:
                generator = torch.Generator().manual_seed(np.random.randint(0, 2**31 - 1))
            self.elem = torch.rand(
                tuple(shape), generator=generator, dtype=dtype, device=generator.device
            ).to(resolve_device(device)) / scale
        elif isinstance(elem, torch.Tensor):
            self.elem = elem if device is None else elem.to(device)
        elif elem is not None:
            self.elem = torch.as_tensor(np.asarray(elem), device=resolve_device(device))
        else:
            raise ValueError(
                "Tensor needs either explicit elements or a shape to random-init"
            )

        self.aggregations: dict = {}
        if axes_names is not None:
            names = list(axes_names)
            if len(names) != self.elem.dim():
                raise ValueError(
                    "The number of names should match the rank of the tensor"
                )
            self.axes_names = np.array(names, dtype=object)
        else:
            self.axes_names = None

    # ---- basic introspection -------------------------------------------------

    @property
    def shape(self):
        return tuple(self.elem.shape)

    @property
    def rank(self) -> int:
        return self.elem.dim()

    def ax_to_index(self, axes: AxisSpec):
        """Name(s) -> axis position(s)."""
        if isinstance(axes, (str, np.str_)):
            hits = np.where(self.axes_names == axes)[0]
            if len(hits) == 0:
                raise KeyError(f"axis {axes!r} not found in {list(self.axes_names)}")
            return int(hits[0])
        if isinstance(axes, (int, np.integer)):
            return int(axes)
        return [self.ax_to_index(ax) for ax in axes]

    def update_members(self, axes_names) -> None:
        self.axes_names = np.array(list(axes_names), dtype=object)

    # ---- shape manipulation --------------------------------------------------

    def transpose(self, permutation: Sequence[str]) -> "Tensor":
        """Reorder axes by name list, in place. Returns self for chaining."""
        indexes = self.ax_to_index(list(permutation))
        self.elem = self.elem.permute(indexes)
        self.update_members(permutation)
        return self

    def aggregate(
        self, axes_names: Optional[Sequence[str]] = None, new_ax_name: str = None
    ) -> "Tensor":
        """Merge several named axes into one (reshape), remembering the split.

        The aggregated axes are moved to the FRONT in the order given, then
        collapsed; original names and dims are recorded in
        ``self.aggregations[new_ax_name]`` so ``disaggregate`` can undo it.
        """
        if new_ax_name is None:
            raise ValueError("aggregate requires new_ax_name for the merged axis")
        if self.axes_names is None:
            raise ValueError("This function requires named axes")
        if axes_names is None:
            axes_names = list(self.axes_names)
        for name in axes_names:
            if name not in self.axes_names:
                raise KeyError(f"axis {name!r} not found")

        indexes = self.ax_to_index(list(axes_names))
        sizes = [self.elem.shape[i] for i in indexes]
        self.aggregations[new_ax_name] = dict(zip(list(axes_names), sizes))

        other = sorted(set(range(self.rank)) - set(indexes))
        other_names = [self.axes_names[i] for i in other]
        other_sizes = [self.elem.shape[i] for i in other]

        self.elem = self.elem.permute(indexes + other).reshape([-1] + other_sizes)
        self.update_members([new_ax_name] + other_names)
        return self

    def disaggregate(self, ax: str) -> "Tensor":
        """Undo an ``aggregate``."""
        if ax not in self.axes_names:
            raise KeyError(f"axis {ax!r} not found")
        if ax not in self.aggregations:
            raise KeyError(f"axis {ax!r} is not an aggregated axis")
        original = self.aggregations.pop(ax)
        names = list(original.keys())
        sizes = list(original.values())

        index = self.ax_to_index(ax)
        perm = [index] + [i for i in range(self.rank) if i != index]
        self.elem = self.elem.permute(perm)
        rest_names = [self.axes_names[i] for i in perm[1:]]
        self.elem = self.elem.reshape(sizes + list(self.elem.shape[1:]))
        self.update_members(names + rest_names)
        return self

    # ---- arithmetic ----------------------------------------------------------

    def _aligned(self, other: "Tensor") -> torch.Tensor:
        if not np.all(np.isin(self.axes_names, other.axes_names)):
            raise ValueError("axes don't match, cannot combine tensors")
        return other.elem.permute(other.ax_to_index(list(self.axes_names)))

    def __add__(self, other: "Tensor") -> "Tensor":
        return Tensor(elem=self.elem + self._aligned(other), axes_names=list(self.axes_names))

    def __sub__(self, other: "Tensor") -> "Tensor":
        return Tensor(elem=self.elem - self._aligned(other), axes_names=list(self.axes_names))

    def __isub__(self, other: "Tensor") -> "Tensor":
        self.elem = self.elem - self._aligned(other)
        return self

    def __iadd__(self, other: "Tensor") -> "Tensor":
        self.elem = self.elem + self._aligned(other)
        return self

    def copy(self) -> "Tensor":
        t = Tensor(elem=self.elem, axes_names=list(self.axes_names))
        t.aggregations = {k: dict(v) for k, v in self.aggregations.items()}
        return t

    def __repr__(self) -> str:
        names = list(self.axes_names) if self.axes_names is not None else None
        return f"Tensor(shape={self.shape}, axes={names})"


def _as_index_list(t: Tensor, spec) -> List[int]:
    if spec is None:
        return []
    if isinstance(spec, (str, np.str_, int, np.integer)):
        spec = [spec]
    return [t.ax_to_index(s) if not isinstance(s, (int, np.integer)) else int(s)
            for s in spec]


def contract(
    T1: Tensor,
    T2: Tensor,
    contracted_axis1=None,
    contracted_axis2=None,
    common_axis1=None,
    common_axis2=None,
    contracted=None,
    common=None,
) -> Tensor:
    """Contract two named tensors along named/indexed axes, via one einsum.

    The reference's calling conventions and output-axis order: the result's
    axes are [T1-only axes..., T2-only axes..., common axes...], where
    "common" axes are shared batch axes threaded through the product and
    "contracted" axes are summed over.
    """
    if contracted is not None:
        contracted_axis1 = contracted
        contracted_axis2 = contracted
    if common is not None:
        common_axis1 = common
        common_axis2 = common

    c1 = _as_index_list(T1, contracted_axis1)
    c2 = _as_index_list(T2, contracted_axis2)
    m1 = _as_index_list(T1, common_axis1)
    m2 = _as_index_list(T2, common_axis2)
    if len(c1) != len(c2):
        raise ValueError("number of contracted axes differs")
    if len(m1) != len(m2):
        raise ValueError("number of common axes differs")
    for a, b in zip(c1, c2):
        if T1.shape[a] != T2.shape[b]:
            raise ValueError("dimensions of contracted axes do not match")
    for a, b in zip(m1, m2):
        if T1.shape[a] != T2.shape[b]:
            raise ValueError("dimensions of common axes do not match")

    letters = iter(string.ascii_letters)
    sub1 = [next(letters) for _ in range(T1.rank)]
    sub2 = [None] * T2.rank
    for a, b in zip(c1, c2):
        sub2[b] = sub1[a]
    for a, b in zip(m1, m2):
        sub2[b] = sub1[a]
    for i in range(T2.rank):
        if sub2[i] is None:
            sub2[i] = next(letters)

    unique1 = [i for i in range(T1.rank) if i not in c1 and i not in m1]
    unique2 = [i for i in range(T2.rank) if i not in c2 and i not in m2]
    out_subs = (
        [sub1[i] for i in unique1]
        + [sub2[i] for i in unique2]
        + [sub1[i] for i in m1]
    )
    out_names = (
        [T1.axes_names[i] for i in unique1]
        + [T2.axes_names[i] for i in unique2]
        + [T1.axes_names[i] for i in m1]
    )
    spec = f"{''.join(sub1)},{''.join(sub2)}->{''.join(out_subs)}"
    out = torch.einsum(spec, T1.elem, T2.elem)
    return Tensor(elem=out, axes_names=out_names)


def partial_trace(T: Tensor, ax1: str, ax2: str) -> Tensor:
    """Trace out two axes of one tensor (used by ring-MPS topologies)."""
    i1, i2 = T.ax_to_index(ax1), T.ax_to_index(ax2)
    if T.shape[i1] != T.shape[i2]:
        raise ValueError("dimensions of traced axes do not match")
    rest = [i for i in range(T.rank) if i not in (i1, i2)]
    elem = torch.diagonal(T.elem.permute([i1, i2] + rest), dim1=0, dim2=1).sum(-1)
    return Tensor(elem=elem, axes_names=[T.axes_names[i] for i in rest])
