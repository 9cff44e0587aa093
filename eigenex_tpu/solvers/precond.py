"""Preconditioner constructors for the block/iterative solvers.

The reference has no preconditioning anywhere (its solvers consume a
bare ``MatMulFunction``, lanczos.hpp:116); preconditioners are net-new
framework surface feeding :func:`~eigenex_tpu.solvers.lobpcg.lobpcg`
(``preconditioner=``), ``eigsh(..., preconditioner=)`` and the CG/GMRES
inner solves.  On the device a preconditioner application must itself be
jit-friendly elementwise/matmul work; the constructors here return plain
callables on (n,) vectors or (n, b) blocks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.exceptions import EigenexError

__all__ = ["jacobi_preconditioner"]


def _extract_diagonal(A):
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    if isinstance(A, COOMatrix):
        return A.diagonal()
    if isinstance(A, BSRMatrix):
        nbr, kmax, bm, bn = A.data.shape
        if bm != bn:
            raise EigenexError("Jacobi preconditioner needs square blocks")
        data = np.asarray(A.data)
        cols = np.asarray(A.block_cols)
        d = np.zeros(A.shape[0], data.dtype)
        r_idx, k_idx = np.nonzero(cols == np.arange(nbr)[:, None])
        for r, k in zip(r_idx, k_idx):  # ≤1 diagonal slot per block row
            d[r * bm : (r + 1) * bm] += np.diagonal(data[r, k])
        return jnp.asarray(d)
    if isinstance(A, SymBSRMatrix):
        diag = np.asarray(A.diag_data)  # (nbr, bm, bm)
        d = np.concatenate([np.diagonal(blk) for blk in diag])
        return jnp.asarray(d[: A.shape[0]])
    A = jnp.asarray(A)
    if A.ndim == 1:
        return A  # already a diagonal vector
    if A.ndim == 2 and A.shape[0] == A.shape[1]:
        return jnp.diagonal(A)
    raise EigenexError(
        f"cannot extract a diagonal from operand of shape {getattr(A, 'shape', None)}"
    )


def jacobi_preconditioner(A, *, sigma=0.0, floor: float = 1e-30):
    """``T(r) ≈ (diag(A) − σ)⁻¹ r`` — the diagonal (Jacobi) preconditioner.

    ``A``: a sparse container (COO/BSR/SymBSR), a dense square matrix, or
    directly the (n,) diagonal vector.  ``sigma`` shifts the diagonal
    (preconditioning ``A − σI`` for shift-invert inner solves).  Entries
    with ``|d − σ| ≤ floor`` are passed through unscaled (a zero diagonal
    carries no curvature information).  The returned callable accepts a
    vector or an (n, b) block — the LOBPCG residual-block contract.
    """
    d = _extract_diagonal(A) - sigma
    mag = jnp.abs(d)
    inv = jnp.where(mag > floor, 1.0 / jnp.where(mag > floor, d, 1), 1.0)

    def apply(r):
        r = jnp.asarray(r)
        return r * (inv[:, None] if r.ndim == 2 else inv)

    return apply
