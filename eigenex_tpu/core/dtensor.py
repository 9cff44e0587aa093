"""DTensor — a dynamic-rank tensor with STRING-LABELED axes.

The reference sketches (but never finishes) a dynamic-rank tensor
framework: ``DTensorImpl`` with ``copyData``/``addData``
(multi_indices.hpp:1000-1088), const/mutable reference views
(:1097-1290), ``DTensorBase``/``DTensor`` (:1292-1400), and two stubs —
a labeled view ``DTensorRefWithIIndex`` (:1402) and a lazy
``DTensorKroneckerProductRef`` (:1414).  Its evident intent: tensors
whose rank is a runtime value and whose axes are addressed by NAME, so
index bookkeeping (the ``from().to()`` relabeling of ProductIndices,
multi_indices.hpp:382-458) generalizes to whole-tensor algebra.

JAX-native realization: rank is still a trace-time property (XLA needs
static shapes), but it is a *value* of this class rather than a template
parameter — one ``DTensor`` type covers every rank, holding a dense
``jax.Array`` plus an axis-label tuple.  All arithmetic is
label-driven and lowers to single fused XLA ops:

- ``rename`` / ``transpose_to`` — pure metadata / one transpose;
- ``align + - *`` — element-wise ops that auto-transpose the operand
  into the left tensor's label order;
- ``contract`` — sum over every SHARED label (einsum), the labeled
  counterpart of ``TwoTensorPureContraction`` (einsum.hpp:40-345);
- ``trace_label`` — repeated-label diagonal reduction on one tensor;
- ``kron`` — the finished form of ``DTensorKroneckerProductRef``: outer
  product with concatenated (disjoint) labels;
- ``to(labels)`` — general einsum projection (diagonals, partial
  traces, reorders) via :func:`eigenex_tpu.ops.einsum.einsum_labels`.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops.einsum import einsum_labels
from ..utils.exceptions import EigenexError

__all__ = ["DTensor", "dtensor"]


class DTensor:
    """Dense tensor with named axes (runtime rank).

    ``DTensor(array, ("i", "j", "k"))`` — labels must be unique and
    match the array rank.  Immutable by convention: every operation
    returns a new DTensor over a new (or shared) jax.Array.
    """

    __slots__ = ("data", "labels")

    def __init__(self, data, labels: Sequence[str]):
        self.data = jnp.asarray(data)
        self.labels = tuple(str(l) for l in labels)
        if len(self.labels) != self.data.ndim:
            raise EigenexError(
                f"rank {self.data.ndim} array needs {self.data.ndim} labels, "
                f"got {self.labels}"
            )
        if len(set(self.labels)) != len(self.labels):
            raise EigenexError(f"duplicate axis labels: {self.labels}")

    # -- introspection ----------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def dim(self, label: str) -> int:
        """Axis length by name."""
        return self.data.shape[self.axis(label)]

    def axis(self, label: str) -> int:
        try:
            return self.labels.index(label)
        except ValueError:
            raise EigenexError(f"no axis labeled {label!r} in {self.labels}") from None

    def __repr__(self):
        pairs = ", ".join(f"{l}:{d}" for l, d in zip(self.labels, self.shape))
        return f"DTensor({pairs}, dtype={self.data.dtype})"

    # -- label surgery ----------------------------------------------------
    def rename(self, **mapping: str) -> "DTensor":
        """New labels by keyword: ``t.rename(i="a")`` — pure metadata
        (the labeled relabeling intent of DTensorRefWithIIndex,
        multi_indices.hpp:1402)."""
        unknown = set(mapping) - set(self.labels)
        if unknown:
            raise EigenexError(f"rename of absent labels: {sorted(unknown)}")
        return DTensor(self.data, tuple(mapping.get(l, l) for l in self.labels))

    def transpose_to(self, labels: Sequence[str]) -> "DTensor":
        """Reorder axes into the given label order (one XLA transpose)."""
        labels = tuple(labels)
        if sorted(labels) != sorted(self.labels):
            raise EigenexError(
                f"transpose_to needs a permutation of {self.labels}, got {labels}"
            )
        perm = tuple(self.axis(l) for l in labels)
        return DTensor(jnp.transpose(self.data, perm), labels)

    def align(self, other: "DTensor") -> "DTensor":
        """``other`` transposed into THIS tensor's label order (the
        prerequisite of label-safe element-wise ops)."""
        return other.transpose_to(self.labels)

    # -- projections ------------------------------------------------------
    def to(self, labels: Sequence[str]) -> "DTensor":
        """General einsum projection: reorder, sum out absent labels
        (partial trace against nothing = plain sum), all in one fused
        op.  ``t.to(("i",))`` sums every other axis."""
        labels = tuple(labels)
        out = einsum_labels([self.data], [self.labels], labels)
        return DTensor(out, labels)

    def trace_label(self, a: str, b: str, out_label: str | None = None) -> "DTensor":
        """Sum the joint diagonal of two axes (labeled partial trace).
        With ``out_label`` the diagonal is KEPT under a new name instead
        of summed — the stride-merged diagonal of the reference einsum
        (einsum.hpp:970-980) in labeled form."""
        ia, ib = self.axis(a), self.axis(b)
        if self.shape[ia] != self.shape[ib]:
            raise EigenexError(f"traced axes {a!r}/{b!r} differ: {self.shape}")
        merged = "__diag__" if out_label is None else out_label
        in_labels = tuple(merged if i in (ia, ib) else l for i, l in enumerate(self.labels))
        keep = [l for i, l in enumerate(self.labels) if i not in (ia, ib)]
        out_labels = tuple(keep) if out_label is None else tuple(keep) + (merged,)
        out = einsum_labels([self.data], [in_labels], out_labels)
        return DTensor(out, out_labels)

    # -- algebra ----------------------------------------------------------
    def _ewise(self, other, fn):
        if isinstance(other, DTensor):
            if sorted(other.labels) != sorted(self.labels):
                raise EigenexError(
                    f"element-wise op needs matching label sets: "
                    f"{self.labels} vs {other.labels}"
                )
            other = self.align(other).data
        return DTensor(fn(self.data, other), self.labels)

    def __add__(self, other):
        return self._ewise(other, jnp.add)

    def __sub__(self, other):
        return self._ewise(other, jnp.subtract)

    def __mul__(self, other):
        if isinstance(other, DTensor):
            return self._ewise(other, jnp.multiply)
        return DTensor(self.data * other, self.labels)

    __rmul__ = __mul__

    def __neg__(self):
        return DTensor(-self.data, self.labels)

    def conj(self) -> "DTensor":
        return DTensor(jnp.conj(self.data), self.labels)

    def contract(self, other: "DTensor", out_labels: Sequence[str] | None = None) -> "DTensor":
        """Contract over every SHARED label (labels appearing in both
        tensors are summed; the rest concatenate left-then-right).
        ``out_labels`` overrides the output — enabling batch labels
        (shared but kept) and reorders — via one einsum."""
        if out_labels is None:
            shared = set(self.labels) & set(other.labels)
            out_labels = tuple(l for l in self.labels if l not in shared) + tuple(
                l for l in other.labels if l not in shared
            )
        out_labels = tuple(out_labels)
        out = einsum_labels(
            [self.data, other.data], [self.labels, other.labels], out_labels
        )
        return DTensor(out, out_labels)

    def kron(self, other: "DTensor") -> "DTensor":
        """Labeled outer product — the completed
        ``DTensorKroneckerProductRef`` (multi_indices.hpp:1414-1439):
        labels must be disjoint; the result carries both label sets and
        materializes through one einsum (XLA fuses it with consumers —
        the lazy-view economics of the reference's O(1)-storage ref,
        achieved by the compiler instead of a coeff() indirection)."""
        overlap = set(self.labels) & set(other.labels)
        if overlap:
            raise EigenexError(
                f"kron needs disjoint labels; shared: {sorted(overlap)} "
                "(rename() one side, or use contract() to sum them)"
            )
        out_labels = self.labels + other.labels
        out = einsum_labels(
            [self.data, other.data], [self.labels, other.labels], out_labels
        )
        return DTensor(out, out_labels)

    def to_array(self, labels: Sequence[str] | None = None) -> jax.Array:
        """The underlying array, optionally in a given label order."""
        if labels is None:
            return self.data
        return self.transpose_to(labels).data


def dtensor(data, labels: Sequence[str]) -> DTensor:
    """Factory: ``dtensor(x, ("i", "j"))``."""
    return DTensor(data, labels)


jax.tree_util.register_pytree_node(
    DTensor,
    lambda t: ((t.data,), t.labels),
    lambda labels, children: DTensor(children[0], labels),
)
