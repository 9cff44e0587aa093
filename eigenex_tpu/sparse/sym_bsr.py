"""Symmetric/Hermitian BSR matrix — half-traffic SpMV storage.

SpMV is bound by device-memory bandwidth (the block data dominates the
traffic), and the flagship Lanczos matvec is always Hermitian.  Storing
only the diagonal blocks plus the strictly-UPPER block triangle and
applying each off-diagonal block twice (y[r] += B·x[c], y[c] += Bᴴ·x[r])
cuts the bytes streamed per matvec by up to 2× — a layout-level win the
generic dense-einsum path cannot express (the reference's COO scatter,
triplets_matrix.hpp:314-318, likewise reads every stored entry; its
samples store both triangles).

Only a kernel that reads each block once collects that win: the XLA path
here reads every upper block twice (one einsum per triangle) and is the
oracle and the route for every operand the kernel does not take.  The
backend rule (:func:`kernel_route`) picks the Pallas/Triton kernel
(:mod:`eigenex_tpu.ops.pallas_spmv`) for f32/bf16 storage committed to a
CUDA device and XLA for everything else.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError
from .bsr import BSRMatrix

__all__ = ["SymBSRMatrix", "kernel_route", "sym_bsr_from_bsr"]


def kernel_route(sym) -> bool | None:
    """The backend rule: True picks the hand-written GPU kernel, False
    picks XLA.  The kernel runs when the blocks are on a CUDA device and
    their storage fits it (f32 or bf16, square power-of-two blocks, see
    :func:`~eigenex_tpu.ops.pallas_spmv.kernel_supports`).  Every other
    operand runs on XLA: f64 and complex on purpose (the kernel
    accumulates in f32), and arrays on any other device.

    None means a traced container whose storage fits the kernel: its
    device is not known while tracing, so the SpMV stages both routes
    with ``lax.platform_dependent`` and the computation compiles the
    kernel when it is lowered for CUDA and XLA's route otherwise."""
    from ..ops.pallas_spmv import kernel_supports

    if not kernel_supports(sym):
        return False
    if isinstance(sym.upper_data, jax.core.Tracer):
        return None
    return all(d.platform == "gpu" for d in sym.upper_data.devices())


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymBSRMatrix:
    """Symmetric (real) / Hermitian (complex) block matrix: diagonal
    blocks + strictly-upper BSR-ELL.  Immutable device container."""

    diag_data: jax.Array  # (nbr, bm, bm)
    upper_data: jax.Array  # (nbr, ku, bm, bm) — blocks at (r, cols[r,k]>r)
    upper_cols: jax.Array  # (nbr, ku) int32; padding slots: col 0, zero data
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    #: max (col − row) over stored upper blocks, in BLOCK units — the band
    #: reach.  −1 = unknown.  The mesh split reads it to check that the
    #: band fits one panel.
    band_reach: int = dataclasses.field(default=-1, metadata=dict(static=True))

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.diag_data.shape[1], self.diag_data.shape[2])

    @property
    def n_block_rows(self) -> int:
        return self.diag_data.shape[0]

    @property
    def dtype(self):
        return self.upper_data.dtype

    @property
    def nnz_stored(self) -> int:
        """Stored (padded) entries — ~half the applied nnz."""
        return int(np.prod(self.diag_data.shape)) + int(np.prod(self.upper_data.shape))

    @property
    def nnz_applied(self) -> int:
        """Entries the matvec effectively applies (both triangles)."""
        return int(np.prod(self.diag_data.shape)) + 2 * int(np.prod(self.upper_data.shape))

    def astype(self, dtype) -> "SymBSRMatrix":
        return SymBSRMatrix(
            self.diag_data.astype(dtype),
            self.upper_data.astype(dtype),
            self.upper_cols,
            self.shape,
            self.band_reach,
        )

    @property
    def _acc_dtype(self):
        if self.dtype in (jnp.bfloat16, jnp.float16):
            return jnp.float32
        return self.dtype

    def _xla_matvec(self, x: jax.Array) -> jax.Array:
        """Gather + batched einsum + scatter-add — oracle and CPU path."""
        bm, bn = self.block_shape
        acc = self._acc_dtype
        xb = x.reshape(-1, bn)
        # diagonal blocks act on the aligned x blocks
        y = jnp.einsum(
            "rij,rj->ri", self.diag_data, xb.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        # upper blocks: y[r] += B x[c]
        xg = xb[self.upper_cols]  # (nbr, ku, bn)
        y = y + jnp.einsum(
            "rkij,rkj->ri", self.upper_data, xg.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        # transpose (conjugate for complex) contributions: y[c] += Bᴴ x[r]
        up = (
            jnp.conj(self.upper_data)
            if jnp.issubdtype(self.dtype, jnp.complexfloating)
            else self.upper_data
        )
        contrib = jnp.einsum(
            "rkij,ri->rkj", up, xb.astype(acc), preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )  # (nbr, ku, bn)
        y = y.at[self.upper_cols].add(contrib.astype(acc))
        return y.reshape(self.shape[0]).astype(acc)

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x through the route :func:`kernel_route` picks."""
        return _sym_matvec(self, x)

    def matmat(self, X: jax.Array) -> jax.Array:
        """Y = A @ X through the route :func:`kernel_route` picks."""
        return _sym_matmat(self, X)

    def _xla_matmat(self, X: jax.Array) -> jax.Array:
        bm, bn = self.block_shape
        acc = self._acc_dtype
        p = X.shape[1]
        xb = X.reshape(-1, bn, p)
        y = jnp.einsum(
            "rij,rjp->rip", self.diag_data, xb.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        xg = xb[self.upper_cols]  # (nbr, ku, bn, p)
        y = y + jnp.einsum(
            "rkij,rkjp->rip", self.upper_data, xg.astype(acc),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        up = (
            jnp.conj(self.upper_data)
            if jnp.issubdtype(self.dtype, jnp.complexfloating)
            else self.upper_data
        )
        contrib = jnp.einsum(
            "rkij,rip->rkjp", up, xb.astype(acc), preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST,
        )
        y = y.at[self.upper_cols].add(contrib.astype(acc))
        return y.reshape(self.shape[0], p).astype(acc)

    def as_linear_operator(self, use_pallas: bool | str | None = None) -> LinearOperator:
        """``use_pallas``: None applies :func:`kernel_route` at each
        call; True forces the GPU kernel, False XLA, and "interpret" runs
        the kernel in Pallas interpret mode (tests only)."""
        if use_pallas is None:
            mv, mm = _sym_matvec, _sym_matmat
        elif use_pallas == "interpret":
            mv, mm = _sym_interpret_matvec, _sym_interpret_matmat
        elif use_pallas:
            mv, mm = _sym_kernel_matvec, _sym_kernel_matmat
        else:
            mv, mm = _sym_xla_matvec, _sym_xla_matmat
        return LinearOperator(
            mv, self, self.shape, self._acc_dtype,  # bf16 storage -> f32 matvec
            rmatvec_fn=mv,  # Hermitian: A == Aᴴ
            matmat_fn=mm,
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row Gershgorin (center, radius) on half-storage: the
        strictly-upper blocks contribute their row sums to their own rows
        AND their column sums to the mirror rows (the |Bᴴ| contribution
        of the lower triangle that is never stored).  Block analog of
        makeGershgorinDiscs (triplets_matrix.hpp:486-510)."""
        bm, bn = self.block_shape
        absd = jnp.abs(self.diag_data)  # (nbr, bm, bm)
        row_abs = absd.sum(axis=2)  # (nbr, bm)
        au = jnp.abs(self.upper_data)  # (nbr, ku, bm, bn)
        row_abs = row_abs + au.sum(axis=(1, 3))
        # mirror: |Bᴴ| row sums = |B| column sums, scattered to block c
        # (padding slots: col 0, zero blocks — add nothing)
        col_contrib = au.sum(axis=2)  # (nbr, ku, bn)
        row_abs = row_abs.at[self.upper_cols].add(col_contrib)
        centers = jnp.diagonal(self.diag_data, axis1=1, axis2=2)  # (nbr, bm)
        radii = row_abs - jnp.abs(centers)
        return centers.reshape(-1), radii.reshape(-1)

    def estimate_eigenvalue_range(self):
        """[min, max] eigenvalue bounds from the Gershgorin discs (cf.
        estimateEigenvalueRange triplets_matrix.hpp:512-540) — feeds the
        Chebyshev/KPM spectral mapping without touching full storage."""
        centers, radii = self.gershgorin_discs()
        re = jnp.real(centers)
        return jnp.min(re - radii), jnp.max(re + radii)

    def to_dense(self) -> jax.Array:
        bm, bn = self.block_shape
        nbr = self.n_block_rows
        nbc = self.shape[1] // bn
        d = jnp.zeros((nbr, nbc, bm, bn), self.dtype)
        rows = jnp.arange(nbr)
        d = d.at[rows, rows].add(self.diag_data)
        ku = self.upper_cols.shape[1]
        rr = jnp.repeat(rows, ku)
        cc = self.upper_cols.reshape(-1)
        up = self.upper_data.reshape(nbr * ku, bm, bn)
        d = d.at[rr, cc].add(up)
        upH = jnp.conj(jnp.swapaxes(up, 1, 2)) if jnp.issubdtype(
            self.dtype, jnp.complexfloating
        ) else jnp.swapaxes(up, 1, 2)
        d = d.at[cc, rr].add(upH)
        return d.transpose(0, 2, 1, 3).reshape(self.shape)


def _sym_kernel_matvec(p, x, interpret=False):
    from ..ops.pallas_spmv import sym_bsr_matvec_pallas

    return sym_bsr_matvec_pallas(p, x, interpret=interpret)


def _sym_kernel_matmat(p, X, interpret=False):
    from ..ops.pallas_spmv import sym_bsr_matmat_pallas

    return sym_bsr_matmat_pallas(p, X, interpret=interpret)


def _sym_interpret_matvec(p, x):
    return _sym_kernel_matvec(p, x, interpret=True)


def _sym_interpret_matmat(p, X):
    return _sym_kernel_matmat(p, X, interpret=True)


def _sym_xla_matvec(p, x):
    return p._xla_matvec(x)


def _sym_xla_matmat(p, X):
    return p._xla_matmat(X)


def _routed(kernel, xla):
    def apply(p, x):
        route = kernel_route(p)
        if route is None:
            return jax.lax.platform_dependent(p, x, cuda=kernel, default=xla)
        return (kernel if route else xla)(p, x)

    return apply


_sym_matvec = _routed(_sym_kernel_matvec, _sym_xla_matvec)
_sym_matmat = _routed(_sym_kernel_matmat, _sym_xla_matmat)


def sym_bsr_from_bsr(bsr: BSRMatrix, *, check: bool = False, atol: float = 0.0) -> SymBSRMatrix:
    """Pack a full-storage BSR matrix into symmetric (diag + upper)
    storage.  The strictly-LOWER blocks are dropped — the matvec
    reconstructs them as the (conjugate) transposes of the upper blocks,
    so the input must actually be symmetric/Hermitian (``check=True``
    verifies each dropped block against its mirror)."""
    if bsr.shape[0] != bsr.shape[1]:
        raise EigenexError("symmetric storage requires a square matrix")
    bm, bn = bsr.block_shape
    if bm != bn:
        raise EigenexError("symmetric storage requires square blocks")
    data = np.asarray(bsr.data)
    cols = np.asarray(bsr.block_cols)
    nbr, kmax = cols.shape
    rows = np.arange(nbr)[:, None]  # (nbr, 1)

    nz = data.reshape(nbr, kmax, -1).any(axis=2)  # (nbr, kmax)
    is_diag = nz & (cols == rows)
    is_upper = nz & (cols > rows)

    # diagonal: sum the (usually single) on-diagonal slot per row
    diag = np.einsum("rkij,rk->rij", data, is_diag.astype(data.dtype))

    if check:
        herm = np.iscomplexobj(data)
        lower: dict[tuple, np.ndarray] = {}
        for r, k in zip(*np.where(nz & (cols < rows))):
            lower[(int(r), int(cols[r, k]))] = data[r, k]
        upper_keys = set()
        for r, k in zip(*np.where(is_upper)):
            c = int(cols[r, k])
            upper_keys.add((int(r), c))
            mirror = lower.get((c, int(r)))
            mirror = 0 if mirror is None else mirror
            want = data[r, k].conj().T if herm else data[r, k].T
            if not np.allclose(mirror, want, atol=atol, rtol=0):
                raise EigenexError(
                    f"matrix is not symmetric at block ({r}, {c}); "
                    "sym_bsr_from_bsr would silently change it"
                )
        # the dropped blocks are the LOWER ones — each must have an upper
        # mirror, else e.g. a lower-triangle-only store would silently
        # become diagonal-only
        for (r, c) in lower:
            if (c, r) not in upper_keys:
                raise EigenexError(
                    f"lower block ({r}, {c}) has no upper mirror — the "
                    "matrix is not symmetric (or is stored lower-triangle-"
                    "only, which sym_bsr_from_bsr does not accept)"
                )
        dsym = np.conj(np.swapaxes(diag, 1, 2)) if herm else np.swapaxes(diag, 1, 2)
        bad = np.where(~np.isclose(diag, dsym, atol=atol, rtol=0).all(axis=(1, 2)))[0]
        if bad.size:
            raise EigenexError(f"diagonal block {int(bad[0])} is not symmetric")

    # pack the upper slots left (stable argsort floats is_upper slots to
    # the front of each row) — vectorized: no per-block-row Python loop
    ku = max(int(is_upper.sum(axis=1).max(initial=0)), 1)
    order = np.argsort(~is_upper, axis=1, kind="stable")[:, :ku]  # (nbr, ku)
    valid = np.take_along_axis(is_upper, order, axis=1)
    ud = np.take_along_axis(data, order[:, :, None, None], axis=1).copy()
    ud[~valid] = 0
    uc = np.where(valid, np.take_along_axis(cols, order, axis=1), 0).astype(np.int32)
    # band reach (block units): max col − row over REAL upper slots
    # (padding slots point at col 0 and would give a negative reach,
    # masked out here)
    reach = int((np.where(valid, uc, 0) - rows).max(initial=0))
    return SymBSRMatrix(
        jnp.asarray(diag), jnp.asarray(ud), jnp.asarray(uc), bsr.shape, max(reach, 0)
    )
