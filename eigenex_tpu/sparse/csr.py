"""CSR sparse matrix.

The reference only has COO (triplets_matrix.hpp); CSR is part of the
capability surface mandated by BASELINE.json ("CSR/COO/BSR storage").
The CSR row-pointer array does not help the scatter-free
``segment_sum`` execution, so :class:`CSRMatrix` stores the expanded row
ids alongside ``indptr`` — ``indptr`` serves construction, slicing and
interop; the compute path is identical to COO's sorted segment-sum.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError
from .coo import COOMatrix

__all__ = ["CSRMatrix", "csr_from_coo", "csr_from_dense"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    indptr: jax.Array  # (m+1,) int32
    indices: jax.Array  # (nnz,) int32 column ids, row-sorted
    data: jax.Array  # (nnz,)
    row_ids: jax.Array  # (nnz,) int32 expanded row ids (compute path)
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        contrib = self.data * x[self.indices]
        return jax.ops.segment_sum(
            contrib, self.row_ids, num_segments=self.shape[0], indices_are_sorted=True
        )

    def matmat(self, X: jax.Array) -> jax.Array:
        contrib = self.data[:, None] * X[self.indices]
        return jax.ops.segment_sum(
            contrib, self.row_ids, num_segments=self.shape[0], indices_are_sorted=True
        )

    def to_coo(self) -> COOMatrix:
        return COOMatrix(self.row_ids, self.indices, self.data, self.shape)

    def to_dense(self) -> jax.Array:
        return self.to_coo().to_dense()

    def to_scipy(self):
        """scipy.sparse.csr_matrix view (cf. makeSparseMatrix
        triplets_matrix.hpp:445-450)."""
        import numpy as np
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row Gershgorin (center, radius) — CSR twin of the COO/BSR
        implementations (makeGershgorinDiscs triplets_matrix.hpp:486-510),
        so Chebyshev/KPM bounds come free on any container."""
        if self.shape[0] != self.shape[1]:
            raise EigenexError("Gershgorin discs require a square matrix")
        diag_mask = self.row_ids == self.indices
        centers = jax.ops.segment_sum(
            jnp.where(diag_mask, self.data, 0), self.row_ids,
            num_segments=self.shape[0], indices_are_sorted=True,
        )
        radii = jax.ops.segment_sum(
            jnp.where(diag_mask, 0.0, jnp.abs(self.data)), self.row_ids,
            num_segments=self.shape[0], indices_are_sorted=True,
        )
        return centers, radii

    def estimate_eigenvalue_range(self):
        """[min, max] real-eigenvalue bounds from the Gershgorin discs
        (cf. estimateEigenvalueRange triplets_matrix.hpp:512-540)."""
        centers, radii = self.gershgorin_discs()
        re = jnp.real(centers)
        return jnp.min(re - radii), jnp.max(re + radii)

    def as_linear_operator(self) -> LinearOperator:
        from .coo import _container_matmat, _container_matvec

        return LinearOperator(
            _container_matvec,
            self,
            self.shape,
            self.dtype,
            rmatvec_fn=_csr_rmatvec,
            matmat_fn=_container_matmat,
        )


def _csr_rmatvec(p, x):
    return p.to_coo().rmatvec(x)


def csr_from_coo(coo: COOMatrix) -> CSRMatrix:
    r = np.asarray(coo.row)
    c = np.asarray(coo.col)
    v = np.asarray(coo.val)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    indptr = np.zeros(coo.shape[0] + 1, np.int32)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSRMatrix(
        jnp.asarray(indptr),
        jnp.asarray(c.astype(np.int32)),
        jnp.asarray(v),
        jnp.asarray(r.astype(np.int32)),
        coo.shape,
    )


def csr_from_dense(A, threshold: float = 0.0) -> CSRMatrix:
    from .coo import coo_from_dense

    return csr_from_coo(coo_from_dense(A, threshold))
