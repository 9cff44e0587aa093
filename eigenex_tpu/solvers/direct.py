"""Direct (factorization-free) shift-invert operators for structured
matrices.

Shift-invert Lanczos needs (A − σI)⁻¹x per matvec.  For banded
structure, iterative inner solves (CG/GMRES) are the wrong tool — a
tridiagonal system solves EXACTLY in one fused XLA pass
(``lax.linalg.tridiagonal_solve``, the Thomas-algorithm primitive), so
σ-targeted eigenpairs of e.g. the 1D Laplacian (BASELINE config 1, whose
low end is clustered at relative gaps ~1e-7 and needs thousands of plain
Lanczos iterations) converge in a handful of outer iterations with an
exact, jittable inner solve.

The reference has no linear solver at all; its route to clustered
spectra is running Lanczos to the full subspace (lanczos.hpp:744-768).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError

__all__ = ["tridiagonal_operator", "tridiagonal_shift_invert_operator"]


def _as_bands(dl, d, du, dtype):
    d = jnp.asarray(d, dtype)
    n = d.shape[0]
    dl = jnp.zeros((n,), dtype) if dl is None else jnp.asarray(dl, dtype)
    du = jnp.zeros((n,), dtype) if du is None else jnp.asarray(du, dtype)
    if dl.shape == (n - 1,):  # accept length n-1 off-diagonals
        dl = jnp.concatenate([jnp.zeros((1,), dtype), dl])
    if du.shape == (n - 1,):
        du = jnp.concatenate([du, jnp.zeros((1,), dtype)])
    if dl.shape != (n,) or du.shape != (n,):
        raise EigenexError("tridiagonal bands must have length n or n-1")
    # tridiagonal_solve convention: dl[0] == 0, du[-1] == 0
    dl = dl.at[0].set(0)
    du = du.at[-1].set(0)
    return dl, d, du


def _tridiag_matvec(p, x):
    dl, d, du = p
    y = d * x
    y = y.at[:-1].add(du[:-1] * x[1:])
    y = y.at[1:].add(dl[1:] * x[:-1])
    return y


def tridiagonal_operator(dl, d, du, dtype=None) -> LinearOperator:
    """Matrix-free tridiagonal operator from its bands.

    dl: sub-diagonal (length n, dl[0] ignored, or length n-1);
    d: diagonal (n,); du: super-diagonal (length n, du[-1] ignored, or
    length n-1)."""
    dtype = jnp.asarray(d).dtype if dtype is None else jnp.dtype(dtype)
    dl, d, du = _as_bands(dl, d, du, dtype)
    n = d.shape[0]
    return LinearOperator(_tridiag_matvec, (dl, d, du), (n, n), dtype)


def _tridiag_si_matvec(p, x):
    dl, ds, du = p
    return lax.linalg.tridiagonal_solve(dl, ds, du, x[:, None])[:, 0]


def _tridiag_si_matmat(p, X):
    dl, ds, du = p
    return lax.linalg.tridiagonal_solve(dl, ds, du, X)


def tridiagonal_shift_invert_operator(dl, d, du, sigma, dtype=None) -> LinearOperator:
    """(A − σI)⁻¹ for a tridiagonal A, solved EXACTLY per matvec with
    ``lax.linalg.tridiagonal_solve`` — no inner iteration, no inner
    tolerance.  Eigenvalues θ of the returned operator map back as
    λ = σ + 1/θ; the pairs nearest σ are the most dominant."""
    dtype = jnp.asarray(d).dtype if dtype is None else jnp.dtype(dtype)
    dl, d, du = _as_bands(dl, d, du, dtype)
    ds = d - jnp.asarray(sigma, dtype)
    n = d.shape[0]
    return LinearOperator(
        _tridiag_si_matvec,
        (dl, ds, du),
        (n, n),
        dtype,
        matmat_fn=_tridiag_si_matmat,
    )
