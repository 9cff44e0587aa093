"""Multi-dimensional index interpretation.

JAX-native re-design of the reference's index-arithmetic layer
(include/cmpt/eigen_ex/multi_indices.hpp):

- ``Slice`` (start, length, stride)           ~ multi_indices.hpp:81
- ``ProductIndices``: bijection between flat and multi indices over a
  (possibly strided, possibly non-dense) view  ~ multi_indices.hpp:126-799
  with ``shuffle``, diagonal-merge ``delta`` (stride-addition trick,
  multi_indices.hpp:357-376), and string-labeled ``from_(...).to(...)``
  relabeling (multi_indices.hpp:382-458).
- ``AddIndices``: direct-sum (block offset) arithmetic with
  ``first``/``second`` block <-> intra-block decomposition
  (multi_indices.hpp:806-894), including periodic extension.

Design note: in the reference these classes drive element-wise device
loops (the general einsum gather, einsum.hpp:1000-1018).  On an accelerator that
would be catastrophically slow, so here they are **trace-time-only
metadata** — pure Python/NumPy, never traced by JAX.  All device compute
they used to perform is expressed instead as XLA ops (reshape /
transpose / einsum) planned *from* this metadata.  Row-major (C) order
is used throughout, matching NumPy/JAX convention (the reference uses
its own explicit stride arithmetic, so no layout is inherited).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..utils.exceptions import EigenexError

__all__ = ["Slice", "ProductIndices", "AddIndices", "make_reverse_shuffle", "periodic_mod"]


def periodic_mod(i: int, n: int) -> int:
    """Non-negative modulo (cf. periodic_div/periodic_mod multi_indices.hpp:40-61)."""
    return i % n if n > 0 else 0


def make_reverse_shuffle(shuffle: Sequence[int]) -> tuple[int, ...]:
    """Inverse permutation (cf. makeReverseShuffle multi_indices.hpp:63-77)."""
    rev = [0] * len(shuffle)
    for to_pos, from_pos in enumerate(shuffle):
        rev[from_pos] = to_pos
    return tuple(rev)


@dataclasses.dataclass(frozen=True)
class Slice:
    """A strided 1-D slice: indices start + i*stride for i in [0, length)
    (cf. multi_indices.hpp:81-118)."""

    start: int
    length: int
    stride: int = 1

    def absolute(self, i: int) -> int:
        if not (0 <= i < self.length):
            raise IndexError(f"slice index {i} out of range [0, {self.length})")
        return self.start + i * self.stride

    def indices(self) -> np.ndarray:
        return self.start + self.stride * np.arange(self.length)


class ProductIndices:
    """Bijection between multi-indices and flat (absolute) indices.

    A ``ProductIndices`` is a list of per-axis ``Slice``-like
    (start, length, stride) triples plus an overall offset; a dense
    row-major view over ``dims`` is the common case
    (cf. ProductIndices/DynamicProductIndices multi_indices.hpp:126,471 —
    one dynamic-rank Python class covers both).
    """

    def __init__(
        self,
        dims: Sequence[int],
        strides: Sequence[int] | None = None,
        offset: int = 0,
        labels: Sequence[str] | None = None,
    ):
        self._dims = tuple(int(d) for d in dims)
        if any(d < 0 for d in self._dims):
            raise EigenexError(f"negative dimension in {self._dims}")
        if strides is None:
            strides = _row_major_strides(self._dims)
        self._strides = tuple(int(s) for s in strides)
        if len(self._strides) != len(self._dims):
            raise EigenexError("dims/strides rank mismatch")
        self._offset = int(offset)
        self._labels = tuple(labels) if labels is not None else None
        if self._labels is not None and len(self._labels) != len(self._dims):
            raise EigenexError("dims/labels rank mismatch")

    # -- basic properties ------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self._dims)

    @property
    def dims(self) -> tuple[int, ...]:
        return self._dims

    @property
    def strides(self) -> tuple[int, ...]:
        return self._strides

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def labels(self):
        return self._labels

    @property
    def size(self) -> int:
        """Number of addressable elements (product of dims)."""
        return int(np.prod(self._dims, dtype=np.int64)) if self._dims else 1

    def is_dense(self) -> bool:
        """True iff this is a plain row-major view with offset 0
        (cf. isDense multi_indices.hpp:172-203, modulo layout convention)."""
        return self._offset == 0 and self._strides == _row_major_strides(self._dims)

    # -- the bijection ---------------------------------------------------
    def absolute_index(self, multi: Sequence[int]) -> int:
        """multi -> flat (cf. absoluteIndex multi_indices.hpp:205-239)."""
        if len(multi) != self.rank:
            raise EigenexError(f"expected {self.rank} indices, got {len(multi)}")
        flat = self._offset
        for i, (d, s) in zip(multi, zip(self._dims, self._strides)):
            i = int(i)
            if not (0 <= i < d):
                raise IndexError(f"index {i} out of range [0, {d})")
            flat += i * s
        return flat

    def indices(self, flat: int) -> tuple[int, ...]:
        """flat -> multi; the inverse bijection for **dense** views
        (cf. indices multi_indices.hpp:241-254).  Requires is_dense()."""
        if not self.is_dense():
            raise EigenexError("indices() requires a dense row-major view")
        if not (0 <= flat < self.size):
            raise IndexError(f"flat index {flat} out of range [0, {self.size})")
        out = []
        for d in reversed(self._dims):
            out.append(flat % d)
            flat //= d
        return tuple(reversed(out))

    def absolute_index_list(self) -> np.ndarray:
        """All flat indices of this view in row-major enumeration order
        (cf. arrangeAbsoluteIndexList multi_indices.hpp:256-323)."""
        flat = np.full((), self._offset, dtype=np.int64)
        for d, s in zip(self._dims, self._strides):
            flat = flat[..., None] + s * np.arange(d, dtype=np.int64)
        return flat.reshape(-1)

    # -- view transformations -------------------------------------------
    def shuffle(self, perm: Sequence[int]) -> "ProductIndices":
        """Permute axes (cf. shuffle multi_indices.hpp:326-355)."""
        perm = tuple(int(p) for p in perm)
        if sorted(perm) != list(range(self.rank)):
            raise EigenexError(f"invalid permutation {perm} for rank {self.rank}")
        return ProductIndices(
            [self._dims[p] for p in perm],
            [self._strides[p] for p in perm],
            self._offset,
            [self._labels[p] for p in perm] if self._labels else None,
        )

    def delta(self, axis_a: int, axis_b: int) -> "ProductIndices":
        """Merge two equal-length axes into their diagonal by **adding
        strides** — the trick underlying the general einsum
        (cf. delta multi_indices.hpp:357-376, einsum.hpp:970-980).

        The merged axis takes axis_a's position; axis_b is removed.
        """
        a, b = int(axis_a), int(axis_b)
        if a == b:
            raise EigenexError("delta requires two distinct axes")
        if self._dims[a] != self._dims[b]:
            raise EigenexError(
                f"delta axes must have equal dims, got {self._dims[a]} != {self._dims[b]}"
            )
        dims, strides = list(self._dims), list(self._strides)
        strides[a] = strides[a] + strides[b]
        del dims[b], strides[b]
        labels = None
        if self._labels:
            labels = list(self._labels)
            del labels[b]
        return ProductIndices(dims, strides, self._offset, labels)

    def sliced(self, axis: int, sl: Slice) -> "ProductIndices":
        """Restrict one axis to a strided sub-range (cf. the Slice-taking
        constructors, multi_indices.hpp:126-170)."""
        if not (0 <= sl.start and sl.start + (sl.length - 1) * sl.stride < self._dims[axis]):
            raise EigenexError(f"slice {sl} out of range for axis of dim {self._dims[axis]}")
        dims, strides = list(self._dims), list(self._strides)
        offset = self._offset + sl.start * strides[axis]
        dims[axis] = sl.length
        strides[axis] = strides[axis] * sl.stride
        return ProductIndices(dims, strides, offset, self._labels)

    # -- string-labeled relabeling --------------------------------------
    def from_(self, labels: Sequence[str]) -> "_LabeledView":
        """Attach string labels; chain with ``.to(out_labels)`` to merge
        repeated labels into diagonals and reorder axes
        (cf. from().to() multi_indices.hpp:382-458)."""
        if len(labels) != self.rank:
            raise EigenexError(f"expected {self.rank} labels, got {len(labels)}")
        return _LabeledView(self, tuple(labels))

    def __repr__(self):
        lab = f", labels={self._labels}" if self._labels else ""
        return f"ProductIndices(dims={self._dims}, strides={self._strides}, offset={self._offset}{lab})"

    def __eq__(self, other):
        return (
            isinstance(other, ProductIndices)
            and self._dims == other._dims
            and self._strides == other._strides
            and self._offset == other._offset
        )

    def __hash__(self):
        return hash((self._dims, self._strides, self._offset))


class _LabeledView:
    """Intermediate of ``ProductIndices.from_``; ``.to`` finishes the relabel."""

    def __init__(self, pi: ProductIndices, labels: tuple[str, ...]):
        self._pi = pi
        self._labels = labels

    def to(self, out_labels: Sequence[str]) -> ProductIndices:
        """Merge repeated input labels by stride addition and order axes
        as ``out_labels`` (cf. multi_indices.hpp:411-458)."""
        out_labels = tuple(out_labels)
        if len(set(out_labels)) != len(out_labels):
            raise EigenexError(f"repeated output label in {out_labels}")
        positions: dict[str, list[int]] = {}
        for ax, lab in enumerate(self._labels):
            positions.setdefault(lab, []).append(ax)
        dims, strides, labs = [], [], []
        for lab in out_labels:
            if lab not in positions:
                raise EigenexError(f"output label {lab!r} not among inputs {self._labels}")
            axes = positions[lab]
            d0 = self._pi.dims[axes[0]]
            for ax in axes[1:]:
                if self._pi.dims[ax] != d0:
                    raise EigenexError(
                        f"label {lab!r} spans unequal dims "
                        f"{[self._pi.dims[a] for a in axes]}"
                    )
            dims.append(d0)
            strides.append(sum(self._pi.strides[ax] for ax in axes))
            labs.append(lab)
        return ProductIndices(dims, strides, self._pi.offset, labs)


class AddIndices:
    """Direct-sum index arithmetic: a flat index decomposes into a block
    index ("first") and an intra-block index ("second")
    (cf. AddIndices multi_indices.hpp:806-894).

    ``block_dims[b]`` is the length of block ``b``; block offsets are the
    exclusive prefix sums.  Used as the per-axis block structure of
    :class:`~eigenex_tpu.block.block_tensor.BlockTensor`.
    """

    def __init__(self, block_dims: Sequence[int]):
        self._block_dims = tuple(int(d) for d in block_dims)
        if any(d <= 0 for d in self._block_dims):
            raise EigenexError(f"block dims must be positive, got {self._block_dims}")
        self._offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(self._block_dims, dtype=np.int64))]
        )

    @property
    def num_blocks(self) -> int:
        return len(self._block_dims)

    @property
    def block_dims(self) -> tuple[int, ...]:
        return self._block_dims

    @property
    def offsets(self) -> np.ndarray:
        """Exclusive prefix sums; offsets[-1] == dim."""
        return self._offsets

    @property
    def dim(self) -> int:
        return int(self._offsets[-1])

    def absolute_index(self, first: int, second: int) -> int:
        """(block, intra) -> flat, with periodic extension of the block
        index (cf. absoluteIndex multi_indices.hpp:848-862)."""
        b = periodic_mod(int(first), self.num_blocks)
        s = int(second)
        if not (0 <= s < self._block_dims[b]):
            raise IndexError(f"intra index {s} out of range for block {b} (dim {self._block_dims[b]})")
        return int(self._offsets[b]) + s

    def first(self, flat: int) -> int:
        """flat -> block index (upper_bound search, multi_indices.hpp:863-872)."""
        flat = int(flat)
        if not (0 <= flat < self.dim):
            raise IndexError(f"flat index {flat} out of range [0, {self.dim})")
        return int(np.searchsorted(self._offsets, flat, side="right")) - 1

    def second(self, flat: int) -> int:
        """flat -> intra-block index (multi_indices.hpp:874-883)."""
        return int(flat) - int(self._offsets[self.first(flat)])

    def first_array(self, flat: np.ndarray) -> np.ndarray:
        """Vectorized ``first`` for building masks/maps at trace time."""
        return np.searchsorted(self._offsets, np.asarray(flat), side="right") - 1

    def __eq__(self, other):
        return isinstance(other, AddIndices) and self._block_dims == other._block_dims

    def __hash__(self):
        return hash(self._block_dims)

    def __repr__(self):
        return f"AddIndices(block_dims={self._block_dims})"


def _row_major_strides(dims: Iterable[int]) -> tuple[int, ...]:
    dims = tuple(dims)
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    return tuple(strides)
