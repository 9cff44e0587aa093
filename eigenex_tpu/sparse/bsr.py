"""BSR (block-sparse row) matrix in ELLPACK-padded layout.

The reference has only COO with a serial scatter SpMV
(triplets_matrix.hpp:314-318).  This layout stores **block rows with a
fixed (padded) number of column-block slots** ("BSR-ELL"):

- ``data``:       (n_block_rows, k_max, bm, bn) dense block stack
- ``block_cols``: (n_block_rows, k_max) int32 column-block ids
  (padding slots point at block-column 0 with all-zero data, so no
  masking is needed in the inner loop)

SpMV then becomes gather + batched small matmul — entirely static
shapes, and the natural unit for row-partitioning across a device mesh
(SURVEY.md §5: the operator's rows shard over the mesh; halo exchange
moves whole x blocks).  The gather + einsum reads each block once, so
general BSR runs on XLA everywhere; the hand-written kernel exists only
for the symmetric half-traffic layout (:mod:`eigenex_tpu.sparse.sym_bsr`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError

__all__ = ["BSRMatrix", "bsr_from_coo_arrays", "bsr_from_dense"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """ELL-padded block-sparse-row matrix (immutable device container)."""

    data: jax.Array  # (nbr, kmax, bm, bn)
    block_cols: jax.Array  # (nbr, kmax) int32
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.data.shape[2], self.data.shape[3])

    @property
    def n_block_rows(self) -> int:
        return self.data.shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def k_max(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Stored (padded) entries — the work the device actually does."""
        return int(np.prod(self.data.shape))

    @property
    def _acc_dtype(self):
        """Accumulation dtype: low-precision storage (bf16/f16) still
        accumulates in f32 — SpMV is HBM-bound, so halving storage bytes
        nearly doubles nnz/s while the products accumulate at full f32."""
        if self.dtype in (jnp.bfloat16, jnp.float16):
            return jnp.float32
        return self.dtype

    def astype(self, dtype) -> "BSRMatrix":
        """Recast stored blocks (e.g. to bfloat16 for 2x SpMV bandwidth)."""
        return BSRMatrix(self.data.astype(dtype), self.block_cols, self.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x via gather + batched block matmul (XLA path)."""
        bm, bn = self.block_shape
        acc = self._acc_dtype
        xb = x.reshape(self.n_block_cols, bn)
        gathered = xb[self.block_cols]  # (nbr, kmax, bn)
        y = jnp.einsum(
            "rkij,rkj->ri",
            self.data,
            gathered.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(self.shape[0]).astype(acc)

    def matmat(self, X: jax.Array) -> jax.Array:
        """A @ X for (n, p) dense X — block-batched matmuls."""
        bm, bn = self.block_shape
        acc = self._acc_dtype
        p = X.shape[1]
        xb = X.reshape(self.n_block_cols, bn, p)
        gathered = xb[self.block_cols]  # (nbr, kmax, bn, p)
        y = jnp.einsum(
            "rkij,rkjp->rip",
            self.data,
            gathered.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(self.shape[0], p).astype(acc)

    def as_linear_operator(self) -> LinearOperator:
        from .coo import _container_matmat, _container_matvec

        return LinearOperator(
            _container_matvec,
            self,
            self.shape,
            self._acc_dtype,  # bf16 storage still yields f32 matvecs
            matmat_fn=_container_matmat,
        )

    def to_dense(self) -> jax.Array:
        bm, bn = self.block_shape
        nbr, kmax = self.block_cols.shape
        d = jnp.zeros((nbr, self.n_block_cols, bm, bn), self.dtype)
        rows = jnp.repeat(jnp.arange(nbr), kmax)
        d = d.at[rows, self.block_cols.reshape(-1)].add(
            self.data.reshape(nbr * kmax, bm, bn)
        )
        return d.transpose(0, 2, 1, 3).reshape(self.shape)

    def scalar_multiple(self, c) -> "BSRMatrix":
        return BSRMatrix(self.data * c, self.block_cols, self.shape)

    def transpose(self) -> "BSRMatrix":
        """Aᵀ as a new BSR-ELL container (host-side repack: block (r, c)
        becomes blockᵀ at (c, r) — cf. TripletsMatrix::transpose
        triplets_matrix.hpp:386-404).  Feeds the Gram operators of
        ``svds`` and rmatvec-needing pipelines."""
        data = np.asarray(self.data)
        cols = np.asarray(self.block_cols)
        nbr, kmax, bm, bn = data.shape
        nbc = self.n_block_cols
        nz = data.reshape(nbr, kmax, -1).any(axis=2)
        buckets: list[list] = [[] for _ in range(nbc)]
        for r, k in zip(*np.where(nz)):
            buckets[int(cols[r, k])].append((int(r), data[r, k].T))
        kk = max(max((len(b) for b in buckets), default=0), 1)
        out_d = np.zeros((nbc, kk, bn, bm), data.dtype)
        out_c = np.zeros((nbc, kk), np.int32)
        for c, bucket in enumerate(buckets):
            for slot, (r, blk) in enumerate(bucket):
                out_d[c, slot] = blk
                out_c[c, slot] = r
        return BSRMatrix(
            jnp.asarray(out_d), jnp.asarray(out_c), (self.shape[1], self.shape[0])
        )

    def adjoint(self) -> "BSRMatrix":
        """Aᴴ (cf. TripletsMatrix::adjoint triplets_matrix.hpp:406-421)."""
        t = self.transpose()
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            return BSRMatrix(jnp.conj(t.data), t.block_cols, t.shape)
        return t

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row (center, radius) of the Gershgorin discs, computed on
        the block data (the block analog of makeGershgorinDiscs,
        triplets_matrix.hpp:486-510): center = the diagonal entry, radius
        = Σ_j≠i |a_ij| over the padded block row (padding blocks are
        zero, so they contribute nothing)."""
        bm, bn = self.block_shape
        if self.shape[0] != self.shape[1] or bm != bn:
            raise EigenexError("Gershgorin discs require a square matrix with square blocks")
        nbr = self.n_block_rows
        row_abs = jnp.abs(self.data).sum(axis=(1, 3)).reshape(-1)  # (nbr*bm,)
        # the on-diagonal block of each block row (usually one slot)
        is_diag = (self.block_cols == jnp.arange(nbr)[:, None]).astype(self.dtype)
        dblk = jnp.einsum("rkij,rk->rij", self.data, is_diag)
        centers = jnp.diagonal(dblk, axis1=1, axis2=2).reshape(-1)
        radii = row_abs - jnp.abs(centers)
        return centers, radii

    def estimate_eigenvalue_range(self):
        """[min, max] real-eigenvalue bounds from the Gershgorin discs —
        feeds the Lanczos shift and the Chebyshev/KPM filter bounds (cf.
        estimateEigenvalueRange triplets_matrix.hpp:512-540); much
        tighter than the ±1.05‖A·v‖ power-probe fallback for diagonally
        concentrated operators."""
        centers, radii = self.gershgorin_discs()
        re = jnp.real(centers)
        return jnp.min(re - radii), jnp.max(re + radii)


def bsr_from_coo_arrays(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    shape: tuple[int, int],
    block_shape: tuple[int, int],
    dtype=None,
) -> BSRMatrix:
    """Pack host COO triplets into the padded BSR-ELL layout.

    Rows/cols beyond a block-shape multiple are zero-padded (the extra
    rows/cols are structurally zero, harmless for SpMV and Krylov use).
    """
    bm, bn = block_shape
    m = -(-shape[0] // bm) * bm
    n = -(-shape[1] // bn) * bn
    nbr, nbc = m // bm, n // bn
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, dtype)
    if val.dtype == np.float64 or val.dtype == np.float32:
        # fast native packer (eigenex_tpu/native); same output layout
        from .. import native

        if native.native_available():
            data, bcols, (m2, n2) = native.bsr_pack(
                row, col, val.astype(np.float64), shape, block_shape
            )
            return BSRMatrix(
                jnp.asarray(data.astype(val.dtype)), jnp.asarray(bcols), shape=(m2, n2)
            )
    br, bc = row // bm, col // bn
    ir, ic = row % bm, col % bn
    # group triplets by (block_row, block_col)
    key = br * nbc + bc
    order = np.argsort(key, kind="stable")
    key, br, bc, ir, ic, val = key[order], br[order], bc[order], ir[order], ic[order], val[order]
    uniq_key, start = np.unique(key, return_index=True)
    ubr, ubc = uniq_key // nbc, uniq_key % nbc
    # slot index of each unique block within its block row
    slot = np.zeros(len(uniq_key), np.int64)
    k_per_row = np.bincount(ubr, minlength=nbr)
    kmax = max(int(k_per_row.max()) if len(k_per_row) else 0, 1)
    running: dict[int, int] = {}
    for i, r in enumerate(ubr):
        running[r] = running.get(r, -1) + 1
        slot[i] = running[r]
    data = np.zeros((nbr, kmax, bm, bn), val.dtype)
    block_cols = np.zeros((nbr, kmax), np.int32)
    block_of_triplet = np.searchsorted(uniq_key, key)
    np.add.at(
        data,
        (ubr[block_of_triplet], slot[block_of_triplet], ir, ic),
        val,
    )
    block_cols[ubr, slot] = ubc
    return BSRMatrix(
        jnp.asarray(data), jnp.asarray(block_cols), shape=(m, n)
    )


def bsr_from_dense(A, block_shape: tuple[int, int], threshold: float = 0.0) -> BSRMatrix:
    A = np.asarray(A)
    r, c = np.nonzero(np.abs(A) > threshold)
    return bsr_from_coo_arrays(r, c, A[r, c], A.shape, block_shape)
