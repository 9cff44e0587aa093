"""Krylov f(A)|v⟩ and exp(xA)|v⟩ application.

JAX-native re-design of the reference's function solvers:

- ``LanczosFunctionSolver`` (lanczos.hpp:938-1002): f(A)v for Hermitian A
  via the eigen-expansion of the Lanczos tridiagonal —
  f(A)v ≈ ‖v‖ · V_kᵀ · Y · f(θ) · Yᵀ e₁.
- ``LanczosExponentialSolver`` (lanczos.hpp:1005-1196) with its four
  strategies: dense eigendecomposition (``solveWithEigens`` :1024),
  Krylov expansion (``solveWithLanczos`` :1061), plain Taylor series
  (``solveWithTaylorNoDivision`` :1085) and Taylor with automatic step
  splitting by spectral radius (``solveWithTaylorAutoDivision``
  :1135-1146).
- The Taylor-series primitive itself (``OperateAsExp`` util.hpp:305-397).

The Taylor loop is a ``lax.while_loop`` (static shapes, data-dependent
termination on the term norm) and everything is jit-able; the Lanczos
path reuses :func:`eigenex_tpu.solvers.lanczos.lanczos_steps`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.tolerance import default_tolerance, is_complex_dtype
from .lanczos import init_lanczos_state, lanczos_steps, tridiagonal_eigh

__all__ = [
    "lanczos_function_apply",
    "lanczos_expmv",
    "taylor_expmv",
    "taylor_expmv_auto",
    "dense_expmv",
    "expm_multiply",
    "LanczosFunctionSolver",
    "LanczosExponentialSolver",
]


def lanczos_function_apply(
    op,
    v: jax.Array,
    f: Callable[[np.ndarray], np.ndarray],
    num_steps: int = 64,
    *,
    reorthogonalize_interval: int = 1,
) -> jax.Array:
    """f(A)|v⟩ for Hermitian A via Lanczos eigen-expansion
    (cf. LanczosFunctionSolver::solve lanczos.hpp:956-989, implementing
    the documented intent — the reference's uninitialized-``flambda``
    bug, SURVEY.md §2, is not reproduced).

    ``f`` maps a host float64 array of Ritz values to (possibly complex)
    values; the Krylov basis build is all device compute.
    """
    op = aslinearoperator(op)
    nrm = jnp.linalg.norm(v)
    state = init_lanczos_state(op, int(num_steps), v0=v)
    state = lanczos_steps(
        op, state, int(num_steps), reorthogonalize_interval=reorthogonalize_interval
    )
    k = int(state.k)
    if k == 0:
        raise LanczosError("Lanczos produced no steps")
    alpha = np.asarray(state.alpha[:k], np.float64)
    beta = np.asarray(state.beta[:k], np.float64)
    theta, Y = tridiagonal_eigh(alpha, beta)
    ftheta = np.asarray(f(theta))
    # f(T) e1 = Y f(θ) Yᵀ e1  (lanczos.hpp:976-988)
    coeff = Y @ (ftheta * np.conj(Y[0, :]))
    out_dtype = jnp.promote_types(op.dtype, jnp.asarray(coeff).dtype)
    return nrm.astype(out_dtype) * jnp.matmul(
        state.V[:k].T.astype(out_dtype), jnp.asarray(coeff, out_dtype), precision="highest"
    )


def lanczos_expmv(op, v: jax.Array, x=1.0, num_steps: int = 64) -> jax.Array:
    """exp(xA)|v⟩ via the Lanczos expansion
    (cf. solveWithLanczos lanczos.hpp:1061-1083)."""
    x = complex(x) if np.iscomplexobj(np.asarray(x)) else float(np.real_if_close(x))
    return lanczos_function_apply(op, v, lambda th: np.exp(x * th), num_steps)


def dense_expmv(A: jax.Array, v: jax.Array, x=1.0) -> jax.Array:
    """exp(xA)|v⟩ by dense Hermitian eigendecomposition
    (cf. solveWithEigens lanczos.hpp:1024-1059; the reference's ordered
    summation by sign of Re x (:1044-1052) controls roundoff in a serial
    sum — the device computes the expansion as one fused matmul chain in
    the accumulation dtype instead)."""
    A = jnp.asarray(A)
    w, U = jnp.linalg.eigh(A)
    x = jnp.asarray(x)
    phase = jnp.exp(x * w.astype(x.dtype if jnp.iscomplexobj(x) else w.dtype))
    dt = jnp.promote_types(U.dtype, phase.dtype)
    return jnp.matmul(
        U.astype(dt) * phase.astype(dt)[None, :],
        jnp.matmul(U.conj().T.astype(dt), v.astype(dt), precision="highest"),
        precision="highest",
    )


@partial(jax.jit, static_argnames=("max_terms",))
def _taylor_expmv_jit(op: LinearOperator, v, x, tol, *, max_terms: int):
    """Σ_k (xA)^k v / k! until the running term is negligible
    (cf. OperateAsExp util.hpp:305-397 and solveWithTaylorNoDivision
    lanczos.hpp:1085-1133)."""

    def cond(carry):
        k, term, acc = carry
        tn = jnp.linalg.norm(term)
        an = jnp.linalg.norm(acc)
        return (k < max_terms) & (tn > tol * an)

    def body(carry):
        k, term, acc = carry
        term = x * op.matvec(term) / (k + 1)
        return k + 1, term, acc + term

    # promote v so x (possibly complex) composes
    dt = jnp.promote_types(jnp.asarray(v).dtype, jnp.asarray(x).dtype)
    v = jnp.asarray(v, dt)
    x = jnp.asarray(x, dt)
    k0 = jnp.zeros((), jnp.int32)
    _, _, acc = lax.while_loop(cond, body, (k0, v, v))
    return acc


def taylor_expmv(op, v, x=1.0, *, tol: float | None = None, max_terms: int = 256):
    """Taylor exp(xA)v without step division."""
    op = aslinearoperator(op)
    if tol is None:
        tol = default_tolerance(op.dtype)
    dt = jnp.promote_types(op.dtype, jnp.asarray(x).dtype)
    if dt != op.dtype and is_complex_dtype(dt):
        # wrap a real operator so it accepts complex iterates
        base = op
        op = LinearOperator(
            lambda p, z: p.matvec(jnp.real(z)).astype(dt) + 1j * p.matvec(jnp.imag(z)).astype(dt),
            base,
            base.shape,
            dt,
        )
    return _taylor_expmv_jit(op, v, jnp.asarray(x, dt), jnp.asarray(tol), max_terms=max_terms)


def taylor_expmv_auto(
    op,
    v,
    x=1.0,
    *,
    spectral_bound: float | None = None,
    theta: float = 1.0,
    tol: float | None = None,
    max_terms: int = 64,
):
    """Taylor exp(xA)v with automatic step splitting: x is divided into
    ⌈|x|·ρ(A)/θ⌉ equal sub-steps so each Taylor series converges fast
    (cf. solveWithTaylorAutoDivision lanczos.hpp:1135-1196, which splits
    by the spectral radius :1145-1146).

    ``spectral_bound``: an upper bound on ρ(A); if None it is taken from
    the operator's Gershgorin range when the underlying container
    provides one (cf. estimateEigenvalueRange triplets_matrix.hpp:512),
    else estimated with a short Lanczos run.
    """
    op = aslinearoperator(op)
    if spectral_bound is None:
        est = getattr(op, "_params", None)
        if hasattr(est, "estimate_eigenvalue_range"):
            lo, hi = est.estimate_eigenvalue_range()
            spectral_bound = float(max(abs(float(lo)), abs(float(hi))))
        else:
            state = init_lanczos_state(op, min(20, op.shape[0]), v0=v)
            state = lanczos_steps(op, state, min(20, op.shape[0]))
            k = int(state.k)
            ritz = tridiagonal_eigh(
                np.asarray(state.alpha[:k]), np.asarray(state.beta[:k]), eigvals_only=True
            )
            spectral_bound = float(np.max(np.abs(ritz))) * 1.1 + 1e-30
    n_div = max(1, int(np.ceil(abs(complex(x)) * spectral_bound / theta)))
    x_step = x / n_div
    out = jnp.asarray(v)
    for _ in range(n_div):
        out = taylor_expmv(op, out, x_step, tol=tol, max_terms=max_terms)
    return out


def expm_multiply(op, v, x=1.0, method: str = "auto", **kw):
    """Dispatch to the exp(xA)v strategies (the
    ``LanczosExponentialSolver`` surface, lanczos.hpp:1005-1196)."""
    if method in ("auto", "lanczos"):
        return lanczos_expmv(op, v, x, **kw)
    if method == "taylor":
        return taylor_expmv(op, v, x, **kw)
    if method == "taylor_auto":
        return taylor_expmv_auto(op, v, x, **kw)
    if method == "dense":
        if isinstance(op, LinearOperator):
            # materialize the matrix through the operator interface
            op_lo = op
            A = op_lo.matmat(jnp.eye(op_lo.shape[1], dtype=op_lo.dtype))
            return dense_expmv(A, v, x)
        return dense_expmv(op, v, x)
    raise LanczosError(f"unknown expm method {method!r}")


class LanczosFunctionSolver:
    """Class wrapper for API parity with the reference
    (cf. LanczosFunctionSolver lanczos.hpp:938)."""

    def __init__(self, operator=None, num_steps: int = 64):
        self.operator = operator
        self.num_steps = num_steps

    def solve(self, f, v):
        return lanczos_function_apply(self.operator, v, f, self.num_steps)


class LanczosExponentialSolver:
    """Class wrapper for API parity with the reference
    (cf. LanczosExponentialSolver lanczos.hpp:1005)."""

    def __init__(self, operator=None, num_steps: int = 64):
        self.operator = operator
        self.num_steps = num_steps

    def solve_with_eigens(self, v, x=1.0):
        op = aslinearoperator(self.operator)
        A = op.matmat(jnp.eye(op.shape[1], dtype=op.dtype))
        return dense_expmv(A, v, x)

    def solve_with_lanczos(self, v, x=1.0):
        return lanczos_expmv(self.operator, v, x, self.num_steps)

    def solve_with_taylor_no_division(self, v, x=1.0, **kw):
        return taylor_expmv(self.operator, v, x, **kw)

    def solve_with_taylor_auto_division(self, v, x=1.0, **kw):
        return taylor_expmv_auto(self.operator, v, x, **kw)
