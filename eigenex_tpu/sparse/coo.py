"""COO (triplet) sparse matrix.

JAX-native re-design of the reference's ``TripletsMatrix``
(include/cmpt/eigen_ex/triplets_matrix.hpp): a mutable host-side builder
(:class:`COOBuilder`, the analog of appendTriplet/setFromDenseMatrix/
shrink, triplets_matrix.hpp:139-296) producing an immutable device
container (:class:`COOMatrix`) whose SpMV is a vectorized
gather-multiply-``segment_sum`` instead of the reference's serial
scatter loop (triplets_matrix.hpp:314-318).

The COO path is the dtype-generic reference implementation (works for
complex); the performance path is BSR (:mod:`eigenex_tpu.sparse.bsr`)
with Pallas kernels.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError

__all__ = ["COOBuilder", "COOMatrix", "coo_from_dense", "coo_identity"]


class COOBuilder:
    """Host-side mutable triplet accumulator (cf. TripletsMatrix's mutable
    surface: resize :98, fitSize :120, appendTriplet :139,
    setFromDenseMatrix :157, setIdentity :180, shrink :238,
    += append semantics :542-560)."""

    def __init__(self, rows: int = 0, cols: int = 0, dtype=np.float64):
        self.rows = int(rows)
        self.cols = int(cols)
        self.dtype = np.dtype(dtype)
        self._r: list = []
        self._c: list = []
        self._v: list = []

    def resize(self, rows: int, cols: int) -> "COOBuilder":
        self.rows, self.cols = int(rows), int(cols)
        return self

    def fit_size(self) -> "COOBuilder":
        """Shrink-wrap dims to the largest appended index + 1
        (cf. fitSize triplets_matrix.hpp:120-137)."""
        if self._r:
            self.rows = max(self.rows, int(np.max(self._r)) + 1)
            self.cols = max(self.cols, int(np.max(self._c)) + 1)
        return self

    def append(self, row: int, col: int, value) -> "COOBuilder":
        """cf. appendTriplet triplets_matrix.hpp:139-155 (range-checked)."""
        if not (0 <= row < self.rows and 0 <= col < self.cols):
            raise EigenexError(
                f"triplet ({row},{col}) out of range for {self.rows}x{self.cols}"
            )
        self._r.append(int(row))
        self._c.append(int(col))
        self._v.append(value)
        return self

    def extend(self, rows: Iterable[int], cols: Iterable[int], values) -> "COOBuilder":
        r = np.asarray(list(rows), np.int32)
        c = np.asarray(list(cols), np.int32)
        v = np.asarray(list(values))
        if r.size and (r.min() < 0 or r.max() >= self.rows or c.min() < 0 or c.max() >= self.cols):
            raise EigenexError("triplet indices out of range")
        self._r.extend(r.tolist())
        self._c.extend(c.tolist())
        self._v.extend(v.tolist())
        return self

    def set_identity(self, n: int | None = None) -> "COOBuilder":
        """cf. setIdentity triplets_matrix.hpp:180-192."""
        if n is not None:
            self.resize(n, n)
        n = min(self.rows, self.cols)
        self._r, self._c = list(range(n)), list(range(n))
        self._v = [1] * n
        return self

    def build(self, threshold: float = 0.0, to_device: bool = True) -> "COOMatrix":
        """Sort row-major, merge duplicate entries, drop |v| <= threshold
        (the ``shrink`` pipeline triplets_matrix.hpp:194-296), then freeze
        to device arrays.

        ``to_device=False`` keeps host NumPy arrays — use when the device
        would truncate the dtype (f64 without x64) and the matrix is destined
        for host-side use (oracles, f64 refinement)."""
        r = np.asarray(self._r, np.int32)
        c = np.asarray(self._c, np.int32)
        v = np.asarray(self._v, self.dtype)
        if v.dtype == np.float64 and r.size:
            from .. import native

            if native.native_available():
                r64, c64, v = native.coo_shrink(r, c, v, self.cols, threshold)
                r, c = r64.astype(np.int32), c64.astype(np.int32)
            else:
                r, c, v = _shrink(r, c, v, self.rows, self.cols, threshold)
        else:
            r, c, v = _shrink(r, c, v, self.rows, self.cols, threshold)
        conv = jnp.asarray if to_device else (lambda a: a)
        return COOMatrix(conv(r), conv(c), conv(v), shape=(self.rows, self.cols))


def _shrink(r, c, v, rows, cols, threshold):
    """Sort, merge duplicates, drop small entries (the ``shrink`` pipeline,
    triplets_matrix.hpp:194-296).  Unlike the reference's column-major
    order, entries are sorted row-major so SpMV's ``segment_sum`` can use
    ``indices_are_sorted=True``."""
    if r.size == 0:
        return r, c, v
    flat = r.astype(np.int64) * cols + c
    order = np.argsort(flat, kind="stable")
    r, c, v, flat = r[order], c[order], v[order], flat[order]
    uniq, inv = np.unique(flat, return_inverse=True)
    merged = np.zeros(uniq.shape, v.dtype)
    np.add.at(merged, inv, v)
    keep = np.abs(merged) > threshold
    uniq, merged = uniq[keep], merged[keep]
    return (uniq // cols).astype(np.int32), (uniq % cols).astype(np.int32), merged


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Immutable COO operator container (device arrays).

    SpMV is ``segment_sum(v * x[c], r)`` — the XLA-native replacement for
    the serial scatter ``out[row] += in[col]*v`` (triplets_matrix.hpp:
    314-318); it lowers to a sorted-segment reduction.
    """

    row: jax.Array  # (nnz,) int32
    col: jax.Array  # (nnz,) int32
    val: jax.Array  # (nnz,)
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.val.shape[0]

    @property
    def dtype(self):
        return self.val.dtype

    # -- compute ---------------------------------------------------------
    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x (cf. operate triplets_matrix.hpp:324-329)."""
        contrib = self.val * x[self.col]
        return jax.ops.segment_sum(
            contrib, self.row, num_segments=self.shape[0], indices_are_sorted=True
        )

    def rmatvec(self, x: jax.Array) -> jax.Array:
        contrib = jnp.conj(self.val) * x[self.row]
        return jax.ops.segment_sum(contrib, self.col, num_segments=self.shape[1])

    def matmat(self, X: jax.Array) -> jax.Array:
        """Dense-RHS SpMM (cf. triplets_matrix.hpp:359-371)."""
        contrib = self.val[:, None] * X[self.col]
        return jax.ops.segment_sum(
            contrib, self.row, num_segments=self.shape[0], indices_are_sorted=True
        )

    # -- transforms (pure; return new containers) ------------------------
    def _resorted(self, row, col, val, shape) -> "COOMatrix":
        """Restore the row-sorted invariant that segment_sum's
        ``indices_are_sorted=True`` fast path depends on.

        Host-side operation: preserves the array kind — NumPy-backed
        (``build(to_device=False)``) matrices stay on host (keeping f64
        without x64), device-backed ones go back to the device."""
        host = isinstance(val, np.ndarray)
        r = np.asarray(row)
        c = np.asarray(col)
        v = np.asarray(val)
        order = np.lexsort((c, r))
        conv = (lambda a: a) if host else jnp.asarray
        return COOMatrix(conv(r[order]), conv(c[order]), conv(v[order]), shape)

    def transpose(self) -> "COOMatrix":
        """cf. transpose triplets_matrix.hpp:386-404 (re-sorted row-major)."""
        return self._resorted(self.col, self.row, self.val, (self.shape[1], self.shape[0]))

    def adjoint(self) -> "COOMatrix":
        """cf. adjoint triplets_matrix.hpp:406-421 (re-sorted row-major)."""
        return self._resorted(
            self.col, self.row, np.conj(np.asarray(self.val)), (self.shape[1], self.shape[0])
        )

    @property
    def T(self):
        return self.transpose()

    @property
    def H(self):
        return self.adjoint()

    def scalar_multiple(self, c) -> "COOMatrix":
        """cf. scalarMultiple triplets_matrix.hpp:423-434"""
        return COOMatrix(self.row, self.col, self.val * c, self.shape)

    def __mul__(self, c):
        return self.scalar_multiple(c)

    __rmul__ = __mul__

    def __add__(self, other: "COOMatrix") -> "COOMatrix":
        """Entry-append + merge (cf. operator+ triplets_matrix.hpp:566-571)."""
        if self.shape != other.shape:
            raise EigenexError(f"shape mismatch: {self.shape} vs {other.shape}")
        r = np.concatenate([np.asarray(self.row), np.asarray(other.row)])
        c = np.concatenate([np.asarray(self.col), np.asarray(other.col)])
        dt = np.promote_types(np.asarray(self.val).dtype, np.asarray(other.val).dtype)
        v = np.concatenate([np.asarray(self.val, dt), np.asarray(other.val, dt)])
        r, c, v = _shrink(r, c, v, self.shape[0], self.shape[1], 0.0)
        return COOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), self.shape)

    def __sub__(self, other: "COOMatrix") -> "COOMatrix":
        return self + other.scalar_multiple(-1)

    def to_dense(self) -> np.ndarray:
        """Dense HOST array (cf. makeDenseMatrix triplets_matrix.hpp:436-443).

        Computed with NumPy: this is a conversion/debug utility, device
        scatter adds nothing (and compiles slowly at size); the host copy also preserves f64 when the device
        would truncate."""
        d = np.zeros(self.shape, np.asarray(self.val).dtype)
        np.add.at(d, (np.asarray(self.row), np.asarray(self.col)), np.asarray(self.val))
        return d

    def to_scipy(self):
        """scipy.sparse.coo_matrix view (cf. makeSparseMatrix
        triplets_matrix.hpp:445-450, which converts to Eigen's sparse
        type — SciPy is the Python-ecosystem analog)."""
        import scipy.sparse as sp

        return sp.coo_matrix(
            (np.asarray(self.val), (np.asarray(self.row), np.asarray(self.col))),
            shape=self.shape,
        )

    def as_linear_operator(self) -> LinearOperator:
        """The solver bridge (cf. makeMatMulFunction triplets_matrix.hpp:373-380).

        The matvec bodies are module-level functions so jit caches by
        function identity — repeated as_linear_operator() calls reuse the
        compiled solver chunks."""
        return LinearOperator(
            _container_matvec,
            self,
            self.shape,
            self.dtype,
            rmatvec_fn=_container_rmatvec,
            matmat_fn=_container_matmat,
        )

    # -- norms (cf. l1norm/l2norm/linorm triplets_matrix.hpp:452-481) ----
    def l1norm(self) -> jax.Array:
        """max column sum of |v|"""
        colsum = jax.ops.segment_sum(jnp.abs(self.val), self.col, num_segments=self.shape[1])
        return jnp.max(colsum)

    def l2norm(self) -> jax.Array:
        """Frobenius norm (the reference's l2norm :462-470)"""
        return jnp.sqrt(jnp.sum(jnp.abs(self.val) ** 2))

    def linorm(self) -> jax.Array:
        """max row sum of |v|"""
        rowsum = jax.ops.segment_sum(
            jnp.abs(self.val), self.row, num_segments=self.shape[0], indices_are_sorted=True
        )
        return jnp.max(rowsum)

    def diagonal(self) -> jax.Array:
        """Main diagonal as a dense (n,) vector (duplicate triplets sum,
        matching the SpMV semantics) — feeds the Jacobi preconditioner
        (:func:`eigenex_tpu.solvers.precond.jacobi_preconditioner`)."""
        n = min(self.shape)
        mask = (self.row == self.col) & (self.row < n)
        return jax.ops.segment_sum(
            jnp.where(mask, self.val, 0),
            jnp.where(mask, self.row, 0),
            num_segments=n,
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row (center, radius) of the Gershgorin discs
        (cf. makeGershgorinDiscs triplets_matrix.hpp:486-510)."""
        if self.shape[0] != self.shape[1]:
            raise EigenexError("Gershgorin discs require a square matrix")
        diag_mask = self.row == self.col
        centers = jax.ops.segment_sum(
            jnp.where(diag_mask, self.val, 0), self.row, num_segments=self.shape[0],
            indices_are_sorted=True,
        )
        radii = jax.ops.segment_sum(
            jnp.where(diag_mask, 0.0, jnp.abs(self.val)),
            self.row,
            num_segments=self.shape[0],
            indices_are_sorted=True,
        )
        return centers, radii

    def estimate_eigenvalue_range(self):
        """[min, max] real-eigenvalue bounds from the Gershgorin discs —
        feeds the Lanczos shift (cf. estimateEigenvalueRange
        triplets_matrix.hpp:512-540, lanczos.hpp:191)."""
        centers, radii = self.gershgorin_discs()
        re = jnp.real(centers)
        return jnp.min(re - radii), jnp.max(re + radii)


# module-scope operator bodies: stable identity → stable jit cache
def _container_matvec(p, x):
    return p.matvec(x)


def _container_rmatvec(p, x):
    return p.rmatvec(x)


def _container_matmat(p, X):
    return p.matmat(X)


def coo_from_dense(A, threshold: float = 0.0) -> COOMatrix:
    """cf. setFromDenseMatrix triplets_matrix.hpp:157-178 (implementing the
    documented intent — the reference's `break` bug that drops the rest
    of a column at the first zero is *not* reproduced; SURVEY.md §2)."""
    A = np.asarray(A)
    r, c = np.nonzero(np.abs(A) > threshold)
    order = np.lexsort((c, r))
    r, c = r[order].astype(np.int32), c[order].astype(np.int32)
    return COOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(A[r, c]), A.shape)


def coo_identity(n: int, dtype=np.float64) -> COOMatrix:
    idx = jnp.arange(n, dtype=jnp.int32)
    return COOMatrix(idx, idx, jnp.ones((n,), dtype), (n, n))
