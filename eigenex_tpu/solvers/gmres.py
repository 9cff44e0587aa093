"""Restarted GMRES for general (non-Hermitian) matrix-free operators.

Companion to :mod:`eigenex_tpu.solvers.cg` (Hermitian): GMRES(m) gives
the shift-invert inner solve for *Arnoldi* eigenproblems and general
linear systems.  Reuses the Arnoldi engine verbatim — each cycle builds
the Krylov basis + Hessenberg with :func:`arnoldi_steps` (masked CGS2 on
the matrix units, static shapes), then solves the tiny (m+1, m) least-squares
problem on host and updates the iterate with one basis matmul.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import EigenexError
from ..utils.tolerance import default_tolerance
from .arnoldi import arnoldi_steps, init_arnoldi_state

__all__ = ["gmres_solve", "shift_invert_operator_general"]


def gmres_solve(
    op,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    restart: int = 32,
    tol: float | None = None,
    max_restarts: int = 100,
):
    """Solve A x = b with restarted GMRES(m).

    Returns (x, relative_residual, cycles)."""
    op = aslinearoperator(op) if not isinstance(op, LinearOperator) else op
    if op.shape[0] != op.shape[1]:
        raise EigenexError("GMRES requires a square operator")
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    b = jnp.asarray(b, op.dtype)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, op.dtype)
    bnorm = float(jnp.linalg.norm(b))
    if bnorm == 0:
        return jnp.zeros_like(b), 0.0, 0

    rel = np.inf
    x_prev = x
    for cycle in range(max_restarts):
        r = b - op.matvec(x)
        beta = float(jnp.linalg.norm(r))
        rel = beta / bnorm
        if not np.isfinite(rel):
            # numerical failure: return the last finite iterate, flagged
            return x_prev, float("inf"), cycle
        if rel <= tol:
            return x, rel, cycle
        x_prev = x
        m = min(restart, op.shape[0])
        # breakdown_threshold=0: ||r|| is already known > 0 (rel > tol) and
        # the absolute dtype default would spuriously reject small-norm
        # residuals of well-scaled systems
        state = init_arnoldi_state(op, m, v0=r, breakdown_threshold=0.0)
        state = arnoldi_steps(op, state, m, breakdown_threshold=0.0)
        k = int(state.k)
        H = np.asarray(
            state.H[: k + 1, :k],
            np.complex128 if jnp.iscomplexobj(state.H) else np.float64,
        )
        e1 = np.zeros(k + 1, H.dtype)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H, e1, rcond=None)
        x = x + jnp.matmul(state.V[:k].T, jnp.asarray(y, op.dtype), precision="highest")
    r = b - op.matvec(x)
    rel = float(jnp.linalg.norm(r)) / bnorm
    return x, rel, max_restarts


def gmres_solve_jit(op, b, x0=None, *, restart: int = 32, cycles: int = 10, tol=0.0):
    """Fully jittable GMRES(m) with residual-controlled restart cycles.

    All device compute: per cycle one Arnoldi build (the same chunk the
    eigensolver uses) + an on-device least-squares (SVD) of the tiny
    (m+1, m) Hessenberg, inside ``lax.while_loop`` — at most ``cycles``
    cycles, stopping early once the relative residual reaches ``tol``.
    The residual is read off the small least-squares problem
    (‖b − A·x_new‖ = min_y ‖β e₁ − H̄ y‖, the GMRES identity), so the
    stopping test costs no extra matvec.  ``tol=0`` reproduces the plain
    fixed-budget loop.  Non-finite iterates (operator overflow) terminate
    the loop with the last finite ``x``.

    Use inside jitted pipelines (e.g. shift-invert matvecs); for
    host-controlled stopping with unlimited restarts use
    :func:`gmres_solve`."""
    from ..utils.tolerance import real_dtype_of
    from .arnoldi import ArnoldiState, _arnoldi_chunk

    op = aslinearoperator(op) if not isinstance(op, LinearOperator) else op
    m = min(int(restart), op.shape[0])
    n = op.shape[1]
    dtype = op.dtype
    rdt = real_dtype_of(dtype)
    b = jnp.asarray(b, dtype)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype)
    zero_deflate = jnp.zeros((0, n), dtype)
    bnorm = jnp.linalg.norm(b).astype(rdt)
    safe_bnorm = jnp.where(bnorm > 0, bnorm, jnp.ones((), rdt))
    tol = jnp.asarray(tol, rdt)
    cycles = int(cycles)

    def cond(carry):
        x, i, rel = carry
        return (i < cycles) & (rel > tol) & jnp.isfinite(rel)

    def body(carry):
        x, i, _ = carry
        r = b - op.matvec(x)
        beta = jnp.linalg.norm(r).astype(rdt)
        safe = jnp.where(beta > 0, beta, 1)
        state = ArnoldiState(
            V=jnp.zeros((m + 1, n), dtype).at[0].set(r / safe.astype(dtype)),
            H=jnp.zeros((m + 1, m), dtype),
            k=jnp.zeros((), jnp.int32),
            breakdown=(beta <= jnp.asarray(0, rdt)).astype(jnp.bool_),
            residue=beta.astype(rdt),
            failed=jnp.zeros((), jnp.bool_),
        )
        state = _arnoldi_chunk(
            op,
            state,
            jnp.asarray(0, dtype),
            jnp.asarray(1e-30, rdt),
            zero_deflate,
            num_steps=m,
            has_deflate=False,
        )
        e1 = jnp.zeros((m + 1,), dtype).at[0].set(beta.astype(dtype))
        y, *_ = jnp.linalg.lstsq(state.H, e1)
        res_small = jnp.linalg.norm(jnp.matmul(state.H, y, precision="highest") - e1).astype(rdt)
        x_new = x + jnp.matmul(state.V[:m].T, y, precision="highest")
        ok = jnp.all(jnp.isfinite(x_new)) & jnp.logical_not(state.failed)
        x_new = jnp.where(ok, x_new, x)
        rel_new = jnp.where(ok, res_small / safe_bnorm, jnp.asarray(jnp.inf, rdt))
        return (x_new, i + 1, rel_new)

    # the initial "residual" sentinel must be FINITE (the cond's isfinite
    # guard is for mid-run overflow) and larger than any meaningful tol
    x, _, _ = jax.lax.while_loop(
        cond, body, (x, jnp.zeros((), jnp.int32), jnp.asarray(jnp.finfo(rdt).max, rdt))
    )
    return x


def shift_invert_operator_general(
    op, sigma, *, restart: int = 48, cycles: int = 24, tol: float | None = None
) -> LinearOperator:
    """(A − σI)⁻¹ for a general operator, inner-solved with jittable
    residual-controlled GMRES(restart) — feeds :class:`ArnoldiEigenSolver`
    for interior eigenvalues of nonsymmetric operators.

    ``tol``: inner relative-residual target per applied matvec; the outer
    Ritz accuracy is bounded below by this (a loose inner solve silently
    degrades eigenvalues), so it defaults to the dtype tolerance
    (1e-12 f64 / 1e-4 f32, cf. lanczos.hpp:67-78).  ``cycles`` is now
    only a cap — early stopping makes a generous budget cheap."""
    from ..utils.tolerance import default_tolerance

    op = aslinearoperator(op)
    sigma = jnp.asarray(sigma, op.dtype)
    restart = int(restart)
    cycles = int(cycles)
    if tol is None:
        tol = default_tolerance(op.dtype)
    tol = float(tol)

    def si_matvec(p, x):
        from .cg import _cgls_loop

        inner_op, sig = p
        shifted = LinearOperator(
            lambda pp, v: pp[0].matvec(v) - pp[1] * v,
            (inner_op, sig),
            inner_op.shape,
            inner_op.dtype,
            # explicit adjoint so CGLS needs no vjp retrace per call
            rmatvec_fn=lambda pp, v: pp[0].rmatvec(v) - jnp.conj(pp[1]) * v,
        )
        y = gmres_solve_jit(shifted, x, restart=restart, cycles=cycles, tol=tol)
        # Restarted GMRES(m) can STAGNATE on nonnormal operators (a known
        # failure mode, not an implementation defect) — and a silently
        # wrong inner solve poisons every outer Ritz pair while the outer
        # iteration happily "converges".  Verify the true residual and
        # fall back to CGLS (normal equations — SPD for any nonsingular
        # shift, monotone residual), warm-started from the GMRES iterate.
        rel = jnp.linalg.norm(x - shifted.matvec(y)) / jnp.linalg.norm(x)
        y_safe = jnp.where(jnp.all(jnp.isfinite(y)), y, jnp.zeros_like(y))
        return jax.lax.cond(
            jnp.isfinite(rel) & (rel <= tol),
            lambda: y,
            lambda: _cgls_loop(
                shifted, x, y_safe, jnp.asarray(tol),
                max_iters=restart * cycles, axis_name=None,
            )[0],
        )

    return LinearOperator(si_matvec, (op, sigma), op.shape, op.dtype)
