"""Matrix-free conjugate-gradient solver and shift-invert operators.

The reference has no linear solver, but BASELINE.json config 5 demands
**shift-invert Lanczos** ("10^8-row BSR Hamiltonian ... shift-invert
Lanczos"), whose operator is (A − σI)⁻¹ applied per matvec.  For a
Hermitian A the natural accelerator-native inner solver is CG: matrix-free,
static shapes, one ``lax.while_loop``, axis-name aware so the same code
runs row-sharded under ``shard_map`` (inner products complete with
``psum``, exactly like the Lanczos Gram-Schmidt).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import EigenexError
from ..utils.tolerance import default_tolerance

__all__ = ["cg_solve", "cgls_solve", "minres_solve", "shift_invert_operator"]


def _cg_body_factory(axis_name):
    def psum_if(x):
        return lax.psum(x, axis_name) if axis_name is not None else x

    def vdot(a, b):
        return psum_if(jnp.vdot(a, b, precision="highest"))

    return psum_if, vdot


@partial(jax.jit, static_argnames=("max_iters", "axis_name"))
def _cg_loop(op: LinearOperator, b, x0, tol, *, max_iters: int, axis_name: str | None):
    psum_if, vdot = _cg_body_factory(axis_name)
    bnorm2 = jnp.real(vdot(b, b))
    target2 = (tol**2) * bnorm2

    def cond(carry):
        i, x, r, p, rs = carry
        # the isfinite guard stops the loop as soon as the recurrence goes
        # non-finite (overflow/NaN operator) instead of iterating garbage
        return (i < max_iters) & (jnp.real(rs) > target2) & jnp.isfinite(jnp.real(rs))

    def body(carry):
        i, x, r, p, rs = carry
        ap = op.matvec(p)
        alpha = rs / vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = vdot(r, r)
        p = r + (rs_new / rs) * p
        return i + 1, x, r, p, rs_new

    r0 = b - op.matvec(x0)
    rs0 = vdot(r0, r0)
    i, x, r, p, rs = lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), x0, r0, r0, rs0))
    return x, jnp.sqrt(jnp.abs(rs)), i


def cg_solve(
    op,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    tol: float | None = None,
    max_iters: int = 1000,
    axis_name: str | None = None,
):
    """Solve A x = b for Hermitian positive/negative-definite A.

    Returns (x, residual_norm, iterations).  Under ``shard_map``, pass
    the mesh ``axis_name`` and a local-shard operator."""
    op = aslinearoperator(op) if not isinstance(op, LinearOperator) else op
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    return _cg_loop(op, b, x0, jnp.asarray(tol), max_iters=int(max_iters), axis_name=axis_name)


def _shifted_matvec(p, v):
    return p[0].matvec(v) - p[1] * v


def _shifted_rmatvec(p, v):
    return p[0].rmatvec(v) - jnp.conj(p[1]) * v


def shift_invert_operator(
    op, sigma, *, tol: float = 1e-10, max_iters: int = 2000, solver: str = "cg"
) -> LinearOperator:
    """(A − σI)⁻¹ as a matrix-free operator for shift-invert Lanczos:
    eigenvalues near σ become dominant, so interior/targeted eigenpairs
    converge in few outer iterations (BASELINE.json config 5).

    The returned operator's eigenvalues are 1/(λ−σ); recover λ as
    σ + 1/θ.  ``solver="cg"`` converges fastest for a definite shift
    (σ outside the spectrum, e.g. below the Gershgorin lower bound for
    the ground state); for interior σ the indefinite system is detected
    by true residual and re-solved with MINRES automatically, so any
    non-eigenvalue σ is valid.  ``solver="minres"`` skips CG and runs
    MINRES directly — the right choice when σ is known to be interior."""
    op = aslinearoperator(op)
    if op.shape[0] != op.shape[1]:
        raise EigenexError("shift-invert requires a square operator")
    if solver not in ("cg", "minres"):
        raise EigenexError(f"solver must be 'cg' or 'minres', got {solver!r}")
    sigma = jnp.asarray(sigma, op.dtype)
    max_iters = int(max_iters)  # static, closed over (not a traced leaf)

    if solver == "minres":

        def si_matvec_minres(p, x):
            inner_op, sig, tl = p
            shifted = LinearOperator(
                _shifted_matvec, (inner_op, sig), inner_op.shape, inner_op.dtype,
                rmatvec_fn=_shifted_rmatvec,
            )
            y, _, _ = _minres_loop(
                shifted, x, jnp.zeros_like(x), tl, max_iters=max_iters, axis_name=None
            )
            return y

        return LinearOperator(
            si_matvec_minres, (op, sigma, jnp.asarray(tol)), op.shape, op.dtype
        )

    def si_matvec(p, x):
        inner_op, sig, tl = p
        shifted = LinearOperator(
            _shifted_matvec, (inner_op, sig), inner_op.shape, inner_op.dtype,
            rmatvec_fn=_shifted_rmatvec,
        )
        y, _, _ = _cg_loop(shifted, x, jnp.zeros_like(x), tl, max_iters=max_iters, axis_name=None)
        # CG is only guaranteed for definite (A − σI); an interior σ makes
        # it indefinite and CG can stagnate or diverge SILENTLY, poisoning
        # every outer Ritz value.  Detect by true residual and fall back
        # to MINRES — the minimum-residual Hermitian-indefinite solver
        # (convergence ~κ where the normal-equations route pays κ²) —
        # warm-started from the CG iterate.
        rel = jnp.linalg.norm(x - shifted.matvec(y)) / jnp.linalg.norm(x)
        # warm start only when the CG iterate is finite (0*NaN would
        # still be NaN, hence the elementwise where)
        y_safe = jnp.where(jnp.all(jnp.isfinite(y)), y, jnp.zeros_like(y))
        return jax.lax.cond(
            jnp.isfinite(rel) & (rel <= tl),
            lambda: y,
            lambda: _minres_loop(
                shifted, x, y_safe, tl, max_iters=max_iters, axis_name=None
            )[0],
        )

    return LinearOperator(
        si_matvec, (op, sigma, jnp.asarray(tol)), op.shape, op.dtype
    )


@partial(jax.jit, static_argnames=("max_iters", "axis_name"))
def _cgls_loop(op: LinearOperator, b, x0, tol, *, max_iters: int, axis_name: str | None):
    """CGLS (CG on the normal equations AᴴA x = Aᴴ b, Björck's stable
    recurrence): guaranteed-convergent least-squares/indefinite fallback
    where plain CG (indefinite A) or restarted GMRES (stagnation) fail.
    The adjoint comes from ``op.rmatvec`` — vjp-derived when the operator
    has no explicit one.  Returns (x, ‖r‖, iterations)."""
    psum_if, vdot = _cg_body_factory(axis_name)
    bnorm2 = jnp.real(vdot(b, b))
    target2 = (tol**2) * bnorm2

    r0 = b - op.matvec(x0)
    s0 = op.rmatvec(r0)
    gamma0 = jnp.real(vdot(s0, s0))
    # two-sided stop: true residual (consistent systems) OR normal-equation
    # residual ‖Aᴴr‖ (least-squares optimum of inconsistent systems, where
    # ‖r‖ never gets small — iterating past it makes β = γ'/γ pure noise
    # and DIVERGES the iterate)
    gamma_tgt = (tol**2) * gamma0

    def cond(carry):
        i, x, r, p, gamma, rn2 = carry
        return (
            (i < max_iters)
            & (rn2 > target2)
            & (gamma > gamma_tgt)
            & jnp.isfinite(rn2)
        )

    def body(carry):
        i, x, r, p, gamma, _ = carry
        q = op.matvec(p)
        qq = jnp.real(vdot(q, q))
        alpha = (gamma / jnp.where(qq > 0, qq, 1)).astype(x.dtype)
        x = x + alpha * p
        r = r - alpha * q
        s = op.rmatvec(r)
        gamma_new = jnp.real(vdot(s, s))
        beta = (gamma_new / jnp.where(gamma > 0, gamma, 1)).astype(x.dtype)
        p = s + beta * p
        return i + 1, x, r, p, gamma_new, jnp.real(vdot(r, r))

    i, x, r, p, gamma, rn2 = lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), x0, r0, s0, gamma0, jnp.real(vdot(r0, r0)))
    )
    return x, jnp.sqrt(jnp.abs(rn2)), i


def cgls_solve(
    op,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    tol: float | None = None,
    max_iters: int = 2000,
    axis_name: str | None = None,
):
    """Least-squares solve min ‖A x − b‖ via CGLS (works for any A,
    including indefinite Hermitian and rectangular operators).

    Returns (x, residual_norm, iterations)."""
    op = aslinearoperator(op) if not isinstance(op, LinearOperator) else op
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    if x0 is None:
        x0 = jnp.zeros((op.shape[1],), op.dtype)
    return _cgls_loop(op, b, x0, jnp.asarray(tol), max_iters=int(max_iters), axis_name=axis_name)


@partial(jax.jit, static_argnames=("max_iters", "axis_name"))
def _minres_loop(op: LinearOperator, b, x0, tol, *, max_iters: int, axis_name: str | None):
    """MINRES (Paige & Saunders 1975): minimum-residual Krylov solve for
    HERMITIAN (possibly indefinite) systems — the principled inner solver
    for interior shift-invert, converging like κ where CGLS pays κ².
    Lanczos three-term recurrence + Givens QR of the tridiagonal, all
    short recurrences; axis-aware (psum'd reductions) so the same code
    runs shard-local under ``shard_map``.  Returns (x, ‖r‖, iterations)."""
    psum_if, vdot = _cg_body_factory(axis_name)
    rdt = jnp.zeros((), b.dtype).real.dtype
    bnorm = jnp.sqrt(jnp.real(vdot(b, b)))
    target = tol * bnorm

    r0 = b - op.matvec(x0)
    beta1 = jnp.sqrt(jnp.real(vdot(r0, r0)))
    safe_b1 = jnp.where(beta1 > 0, beta1, 1)
    v = r0 / safe_b1.astype(b.dtype)

    zeros = jnp.zeros_like(b)
    # carry: i, x, v_old, v, w_old, w, beta, eta, c_old, c, s_old, s, rnorm
    def cond(carry):
        i, x, *_, rnorm = carry
        return (i < max_iters) & (rnorm > target) & jnp.isfinite(rnorm)

    def body(carry):
        i, x, v_old, v, w_old, w, beta, eta, c_old, c, s_old, s, rnorm = carry
        av = op.matvec(v)
        alpha = jnp.real(vdot(v, av))  # Hermitian: real diagonal
        r_next = av - alpha.astype(b.dtype) * v - beta.astype(b.dtype) * v_old
        beta_next = jnp.sqrt(jnp.real(vdot(r_next, r_next)))
        v_next = r_next / jnp.where(beta_next > 0, beta_next, 1).astype(b.dtype)
        # previous two rotations applied to the new tridiagonal column
        delta = c * alpha - c_old * s * beta
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        # new rotation annihilating beta_next
        rho1 = jnp.sqrt(delta * delta + beta_next * beta_next)
        safe_r1 = jnp.where(rho1 > 0, rho1, 1)
        c_new = delta / safe_r1
        s_new = beta_next / safe_r1
        w_new = (v - rho3.astype(b.dtype) * w_old - rho2.astype(b.dtype) * w) / safe_r1.astype(b.dtype)
        x = x + (c_new * eta).astype(b.dtype) * w_new
        eta_new = -s_new * eta
        # ‖r_k‖ = |eta_{k+1}| exactly (minimum-residual recursion)
        return (
            i + 1, x, v, v_next, w, w_new, beta_next, eta_new,
            c, c_new, s, s_new, jnp.abs(eta_new),
        )

    one = jnp.ones((), rdt)
    zero = jnp.zeros((), rdt)
    init = (
        jnp.zeros((), jnp.int32), x0, zeros, v, zeros, zeros,
        zero, beta1, one, one, zero, zero, beta1,
    )
    out = lax.while_loop(cond, body, init)
    return out[1], out[-1], out[0]


def minres_solve(
    op,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    tol: float | None = None,
    max_iters: int = 2000,
    axis_name: str | None = None,
):
    """Solve A x = b for HERMITIAN A (definite or indefinite) with MINRES.

    Returns (x, residual_norm, iterations).  Under ``shard_map``, pass the
    mesh ``axis_name`` and a shard-local operator."""
    op = aslinearoperator(op) if not isinstance(op, LinearOperator) else op
    if op.shape[0] != op.shape[1]:
        raise EigenexError("MINRES requires a square (Hermitian) operator")
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    return _minres_loop(op, b, x0, jnp.asarray(tol), max_iters=int(max_iters), axis_name=axis_name)
