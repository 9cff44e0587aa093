"""Lanczos eigensolver for Hermitian matrix-free operators.

JAX-native re-design of the reference's Lanczos stack
(include/cmpt/eigen_ex/lanczos.hpp): ``LanczosBase`` (basis builder,
:105), ``LanczosEigenSolver`` (:469) with its fluent configuration
(:517-622), convergence machinery (:853-896) and breakdown semantics
(:316-347,433-437).  ``LanczosFunctionSolver``/``LanczosExponentialSolver``
live in :mod:`eigenex_tpu.solvers.functions`.

Key architectural departures from the reference (per SURVEY.md §7):

- The growing ``std::vector`` basis (lanczos.hpp:235) becomes a
  **preallocated** ``(m+1, n)`` array updated with ``.at[k].set`` inside
  ``lax.fori_loop`` — XLA requires static shapes.
- The per-step selective reorthogonalization loop of k sequential dots
  (lanczos.hpp:411-426) becomes masked **CGS2**: two basis matmuls on
  the matrix units (:func:`eigenex_tpu.ops.orthogonalize.cgs2`).
- The data-dependent C++ ``while`` with per-step tridiagonal
  re-eigendecomposition (lanczos.hpp:744-781) becomes a host control
  loop around jitted fixed-size step *chunks*: convergence is checked
  every ``check_every`` iterations on the host from the (tiny) α/β
  arrays, avoiding per-step device→host syncs.  The tridiagonal
  eigenproblem is O(k²)–O(k³) on k ≤ a few hundred and stays on host
  NumPy (float64), which also gives the 1e-10-grade accuracy the
  baseline demands regardless of device dtype.
- Breakdown (β ≤ threshold ⇒ invariant subspace found,
  lanczos.hpp:331-347,433-437) is carried as a flag in the loop state
  and surfaced as ``termination="breakdown"`` — never an exception at
  runtime (can't raise under jit).

All device compute is dtype-generic (f32/f64/c64/c128); the Krylov
recurrence coefficients α/β are always kept in the real dtype of the
operator scalar type.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.operators import LinearOperator, aslinearoperator
from ..ops.orthogonalize import cgs2, project_out
from ..utils.exceptions import LanczosError
from ..utils.prng import random_vector
from ..utils.tolerance import (
    default_breakdown_threshold,
    default_tolerance,
    real_dtype_of,
)
from ..utils.trace import ConvergenceTrace, Severity

__all__ = [
    "UNLIMITED",
    "LanczosOptions",
    "LanczosState",
    "LanczosResult",
    "LanczosEigenSolver",
    "lanczos_steps",
    "init_lanczos_state",
    "tridiagonal_eigh",
]

#: sentinel for "no limit" (cf. LanczosEigenSolver::unlimited lanczos.hpp:493)
UNLIMITED = -1


# ---------------------------------------------------------------------------
# Options (cf. fluent setters lanczos.hpp:517-622 and defaults :260-271,657-668)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LanczosOptions:
    """Configuration knobs, mirroring the reference's setter surface
    (sample_lanczos2.cpp:42-56 enumerates it).

    tolerance: relative successive-Ritz-change threshold; None → dtype
        default (1e-12 f64 / 1e-4 f32, lanczos.hpp:67-78).
    min_iterations / max_iterations: iteration bounds; UNLIMITED = -1
        means no minimum / run to the full subspace (lanczos.hpp:493).
    max_subspace: preallocation bound on the Krylov dimension (a
        knob of this library: static shapes require it; capped at n).
    reorthogonalize_interval: CGS2 against the whole basis every this
        many steps; 1 = full reorthogonalization, 0 = never
        (cf. reorthogonalizeInterval lanczos.hpp:411-426).
    max_eigenvalues: how many eigenpairs to return (lanczos.hpp:786-795).
    eigenvalue_indices: which (sorted-ascending) Ritz indices to track
        for convergence; negatives count from the top
        (cf. getFormalIndex lanczos.hpp:837-851).  None → first
        ``max_eigenvalues`` indices.
    eigenvalue_shift: σ applied as A+σI during iteration and subtracted
        from reported eigenvalues (lanczos.hpp:155,390-392,786).
    breakdown_threshold: β below this ⇒ invariant subspace
        (lanczos.hpp:433-437); None → dtype default.
    check_every: host convergence-check interval in iterations (a
        knob of this library; the reference checks every step).
    compute_eigenvectors: build Ritz vectors (lanczos.hpp:798-817).
    seed: PRNG seed for the random initial vector (lanczos.hpp:125-135).
    """

    tolerance: float | None = None
    min_iterations: int = UNLIMITED
    max_iterations: int = UNLIMITED
    max_subspace: int = 256
    reorthogonalize_interval: int = 1
    max_eigenvalues: int = 1
    eigenvalue_indices: tuple[int, ...] | None = None
    eigenvalue_shift: float | complex = 0.0
    breakdown_threshold: float | None = None
    check_every: int = 8
    compute_eigenvectors: bool = True
    seed: int = 0

    def tracked_indices(self) -> tuple[int, ...]:
        if self.eigenvalue_indices is not None:
            return tuple(self.eigenvalue_indices)
        return tuple(range(self.max_eigenvalues))


# ---------------------------------------------------------------------------
# State & result pytrees
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LanczosState:
    """Carried Krylov state — an explicit pytree, so checkpoint/resume is
    ``orbax``/``np.savez`` on this object (the reference's in-memory
    ``continueToCompute`` state, lanczos.hpp:235-245,696-712, made
    serializable)."""

    V: jax.Array  # (m+1, n) orthonormal basis rows (rows >= k are garbage)
    alpha: jax.Array  # (m,) real diagonal
    beta: jax.Array  # (m,) real off-diagonal; beta[k-1] links V[k-1],V[k]
    k: jax.Array  # () int32, number of completed steps
    breakdown: jax.Array  # () bool
    failed: jax.Array  # () bool — NaN/Inf detected (numerical failure)


@dataclasses.dataclass
class LanczosResult:
    """Eigenpairs + diagnostics (cf. eigenvalues()/eigenvectors() accessors
    lanczos.hpp:633-654 and termination bookkeeping :743-768)."""

    eigenvalues: np.ndarray  # (p,) ascending
    eigenvectors: jax.Array | None  # (n, p) columns, or None
    iterations: int
    converged: bool
    termination: str  # "converged" | "breakdown" | "max_iterations" | "full_subspace"
    trace: ConvergenceTrace

    def residual_norms(self, op: LinearOperator) -> np.ndarray:
        """‖A x_i − λ_i x_i‖ for each returned pair — the acceptance
        check of the reference samples (sample_arnoldi.cpp:42-52)."""
        if self.eigenvectors is None:
            raise LanczosError("eigenvectors were not computed")
        ax = op.matmat(self.eigenvectors)
        r = ax - self.eigenvectors * jnp.asarray(self.eigenvalues)[None, :]
        return np.asarray(jnp.linalg.norm(r, axis=0))


# ---------------------------------------------------------------------------
# The jitted Krylov chunk
# ---------------------------------------------------------------------------
def init_lanczos_state(
    op: LinearOperator,
    max_subspace: int,
    v0: jax.Array | None = None,
    *,
    seed: int = 0,
    deflate: jax.Array | None = None,
    breakdown_threshold: float | None = None,
) -> LanczosState:
    """Allocate state and set the (deflated, normalized) initial vector
    (cf. setInitialLanczosvector lanczos.hpp:299-329)."""
    n = op.shape[1]
    m = int(max_subspace)
    dtype = op.dtype
    rdt = real_dtype_of(dtype)
    if v0 is None:
        v0 = random_vector(jax.random.PRNGKey(seed), n, dtype, normalize=False)
    v0 = jnp.asarray(v0, dtype)
    if deflate is not None:
        # deflation against user "orthogonalizingVectors" (lanczos.hpp:312-314)
        v0 = project_out(jnp.asarray(deflate, dtype), v0)
    nrm = float(jnp.linalg.norm(v0))
    thr = breakdown_threshold
    if thr is None:
        thr = default_breakdown_threshold(dtype)
    if not np.isfinite(nrm):
        raise LanczosError(f"initial vector is not finite (norm {nrm})")
    if nrm <= thr:
        # initial-vector breakdown is a *configuration* failure and can be
        # raised eagerly on host (cf. lanczos.hpp:316-321)
        raise LanczosError(
            f"initial vector has (post-deflation) norm {nrm:.3e} <= breakdown "
            f"threshold {thr:.3e}"
        )
    v0 = v0 / nrm
    V = jnp.zeros((m + 1, n), dtype).at[0].set(v0)
    return LanczosState(
        V=V,
        alpha=jnp.zeros((m,), rdt),
        beta=jnp.zeros((m,), rdt),
        k=jnp.zeros((), jnp.int32),
        breakdown=jnp.zeros((), jnp.bool_),
        failed=jnp.zeros((), jnp.bool_),
    )


def _lanczos_chunk_body(
    op: LinearOperator,
    state: LanczosState,
    shift,
    breakdown_threshold,
    deflate,
    *,
    num_steps: int,
    reorthogonalize_interval: int,
    has_deflate: bool,
    axis_name: str | None = None,
):
    """Run up to ``num_steps`` Lanczos three-term-recurrence steps.

    Implements the hot loop of updateLanczosSteps (lanczos.hpp:371-450):
    matvec + shift (:389-392), recurrence (:404-407), masked-CGS2
    reorthogonalization (:411-426), β breakdown check (:429-437) — under
    ``lax.fori_loop`` with all shapes static.  Steps after breakdown or
    subspace exhaustion are no-ops via ``lax.cond``.

    ``axis_name``: when set, the body runs inside ``shard_map`` with the
    basis/vectors row-sharded over that mesh axis — every inner product
    and norm completes its partial sums with ``lax.psum`` (the
    distributed-Gram-Schmidt design, SURVEY.md §5); the operator is then
    expected to be a *local-shard* operator (see
    :mod:`eigenex_tpu.parallel.distributed`).
    """
    m = state.alpha.shape[0]
    rdt = state.alpha.dtype
    dtype = state.V.dtype
    row_ids = lax.broadcasted_iota(jnp.int32, (m + 1, 1), 0).squeeze(-1)

    def psum_if(x):
        return lax.psum(x, axis_name) if axis_name is not None else x

    def vnorm(v):
        return jnp.sqrt(
            psum_if(jnp.sum(jnp.real(v) ** 2 + (jnp.imag(v) ** 2 if jnp.iscomplexobj(v) else 0.0)))
        )

    def step(state: LanczosState) -> LanczosState:
        k = state.k
        vk = state.V[k]
        with jax.named_scope("lanczos/matvec"):
            w = op.matvec(vk) + jnp.asarray(shift, dtype) * vk
        if reorthogonalize_interval == 1:
            # fused path: the masked-CGS2 coefficients against rows <= k
            # CONTAIN the recurrence — c[k] = <v_k, w> is alpha_k and
            # c[k-1] the beta_prev term — so no separate alpha dot-product
            # (one fewer psum per step on a mesh) and no explicit
            # three-term subtraction (it is the k, k-1 part of the
            # projection).  Numerically this is exactly Arnoldi's
            # Hessenberg-column CGS2 specialized to a Hermitian operator.
            mask = row_ids <= k
            with jax.named_scope("lanczos/reorth"):
                w, c = cgs2(state.V, w, axis_name=axis_name, mask=mask)
            alpha_k = jnp.real(c[k]).astype(rdt)
            if has_deflate:
                # deflate AFTER the projection: the CGS coefficients are
                # O(1) here, so projecting against V re-introduces a
                # deflate component of order |c|·(V's deflate drift) that
                # would otherwise amplify geometrically step over step
                # (lanczos.hpp:421-425)
                w = project_out(deflate, w, axis_name=axis_name)
        else:
            if has_deflate:
                # keep iterates out of the user-supplied deflation space
                # (lanczos.hpp:421-425)
                w = project_out(deflate, w, axis_name=axis_name)
            alpha_k = psum_if(jnp.real(jnp.vdot(vk, w))).astype(rdt)
            # three-term recurrence (beta[k-1] term masked out at k == 0)
            km1 = jnp.maximum(k - 1, 0)
            beta_prev = jnp.where(k > 0, state.beta[km1], jnp.zeros((), rdt))
            w = w - alpha_k.astype(dtype) * vk - beta_prev.astype(dtype) * state.V[km1]
            if reorthogonalize_interval > 0:
                mask = row_ids <= k

                def reorth(w):
                    with jax.named_scope("lanczos/reorth"):
                        w2, _ = cgs2(state.V, w, axis_name=axis_name, mask=mask)
                    return w2

                do = (k + 1) % reorthogonalize_interval == 0
                w = lax.cond(do, reorth, lambda w: w, w)
        beta_k = vnorm(w).astype(rdt)
        # NaN/Inf guard (cf. the reference's failure-first design,
        # lanczos.hpp:316-347,433-437: every numerical failure terminates
        # cleanly): a non-finite alpha/beta means the matvec overflowed or
        # produced NaN — stop, don't iterate garbage to max_iters.
        failed_now = jnp.logical_not(jnp.isfinite(alpha_k) & jnp.isfinite(beta_k))
        broke = jnp.logical_not(failed_now) & (
            beta_k <= jnp.asarray(breakdown_threshold, rdt)
        )
        ok = jnp.logical_not(broke | failed_now)
        safe = jnp.where(ok, beta_k, jnp.ones((), rdt))
        # unconditional single-row write (a lax.cond over V would make XLA
        # copy the whole basis buffer every step); on breakdown/failure the
        # row is written as zeros and never read (k stops advancing);
        # jnp.where (selection, not multiplication) keeps NaNs out.
        v_next = jnp.where(ok, w / safe.astype(dtype), jnp.zeros_like(w))
        V = state.V.at[k + 1].set(v_next)
        zero = jnp.zeros((), rdt)
        return LanczosState(
            V=V,
            alpha=state.alpha.at[k].set(jnp.where(failed_now, zero, alpha_k)),
            beta=state.beta.at[k].set(jnp.where(ok, beta_k, zero)),
            k=k + jnp.where(failed_now, 0, 1).astype(k.dtype),
            breakdown=state.breakdown | broke,
            failed=state.failed | failed_now,
        )

    def body(_, state):
        active = (
            jnp.logical_not(state.breakdown)
            & jnp.logical_not(state.failed)
            & (state.k < m)
        )
        return lax.cond(active, step, lambda s: s, state)

    return lax.fori_loop(0, num_steps, body, state)


_lanczos_chunk = jax.jit(
    _lanczos_chunk_body,
    static_argnames=("num_steps", "reorthogonalize_interval", "has_deflate", "axis_name"),
)


def lanczos_steps(
    op: LinearOperator,
    state: LanczosState,
    num_steps: int,
    *,
    shift=0.0,
    breakdown_threshold: float | None = None,
    reorthogonalize_interval: int = 1,
    deflate: jax.Array | None = None,
) -> LanczosState:
    """Public fixed-step basis builder (the ``LanczosBase`` role,
    lanczos.hpp:105-465) — fully jittable, used by the solver and the
    benchmarks."""
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    has_deflate = deflate is not None
    if not has_deflate:
        deflate = jnp.zeros((0, op.shape[1]), op.dtype)
    return _lanczos_chunk(
        op,
        state,
        jnp.asarray(shift),
        jnp.asarray(breakdown_threshold, real_dtype_of(op.dtype)),
        jnp.asarray(deflate, op.dtype),
        num_steps=int(num_steps),
        reorthogonalize_interval=int(reorthogonalize_interval),
        has_deflate=has_deflate,
    )


# ---------------------------------------------------------------------------
# Host-side tridiagonal eigenproblem + convergence logic
# ---------------------------------------------------------------------------
def tridiagonal_eigh(alpha: np.ndarray, beta: np.ndarray, eigvals_only=False):
    """Eigendecomposition of the k×k symmetric tridiagonal T(α, β) on
    host float64 (the replacement for
    SelfAdjointEigenSolver::computeFromTridiagonal, lanczos.hpp:779-781).
    """
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    k = alpha.shape[0]
    try:
        from scipy.linalg import eigh_tridiagonal

        if eigvals_only:
            return eigh_tridiagonal(alpha, beta[: k - 1], eigvals_only=True)
        return eigh_tridiagonal(alpha, beta[: k - 1])
    except Exception:
        T = np.diag(alpha)
        if k > 1:
            T += np.diag(beta[: k - 1], 1) + np.diag(beta[: k - 1], -1)
        if eigvals_only:
            return np.linalg.eigvalsh(T)
        return np.linalg.eigh(T)


def _formal_indices(indices: Sequence[int], count: int) -> list[int]:
    """Map tracked indices (negatives from the top) into [0, count)
    (cf. getFormalIndex lanczos.hpp:837-851)."""
    out = []
    for i in indices:
        j = i if i >= 0 else count + i
        if 0 <= j < count:
            out.append(j)
        else:
            return []  # not enough Ritz values yet to track all requested
    return out


def _phase_fix(X: jax.Array, eps: float = 0.0) -> jax.Array:
    """Make the first significantly-nonzero coefficient of each column
    real-positive (cf. lanczos.hpp:806-816)."""
    absX = jnp.abs(X)
    thresh = jnp.max(absX, axis=0, keepdims=True) * 1e-6 + eps
    sig = absX > thresh
    first = jnp.argmax(sig, axis=0)  # first True per column
    lead = X[first, jnp.arange(X.shape[1])]
    denom = jnp.abs(lead)
    phase = jnp.where(denom > 0, lead / jnp.where(denom > 0, denom, 1), jnp.ones_like(lead))
    return X * jnp.conj(phase)[None, :]


@partial(jax.jit, static_argnames=("k",))
def _ritz_vectors(V: jax.Array, Y: jax.Array, k: int) -> jax.Array:
    """x_j = Σ_m Y[m, j] · V[m]  (lanczos.hpp:798-804), one matmul;
    then normalize + phase-fix (:806-816)."""
    X = jnp.matmul(V[:k].T, Y.astype(V.dtype), precision="highest")  # (n, p)
    X = X / jnp.linalg.norm(X, axis=0, keepdims=True)
    return _phase_fix(X)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------
class LanczosEigenSolver:
    """Hermitian eigensolver driver (cf. LanczosEigenSolver lanczos.hpp:469).

    Typical use::

        solver = LanczosEigenSolver(op, LanczosOptions(max_eigenvalues=5))
        result = solver.compute()

    or with reference-style fluent configuration
    (cf. lanczos.hpp:517-622)::

        result = (LanczosEigenSolver(op)
                  .set_tolerance(1e-10)
                  .set_max_eigenvalues(3)
                  .set_reorthogonalize_interval(1)
                  .compute())
    """

    def __init__(self, operator=None, options: LanczosOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or LanczosOptions()
        self.state: LanczosState | None = None
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._deflate = None
        self._result: LanczosResult | None = None

    # -- fluent configuration (lanczos.hpp:517-622) ----------------------
    def _set(self, **kw) -> "LanczosEigenSolver":
        self.options = dataclasses.replace(self.options, **kw)
        return self

    def set_tolerance(self, tol):
        return self._set(tolerance=tol)

    def set_min_iterations(self, n):
        return self._set(min_iterations=n)

    def set_max_iterations(self, n):
        return self._set(max_iterations=n)

    def set_max_subspace(self, n):
        return self._set(max_subspace=n)

    def set_reorthogonalize_interval(self, n):
        return self._set(reorthogonalize_interval=n)

    def set_max_eigenvalues(self, n):
        return self._set(max_eigenvalues=n)

    def set_eigenvalue_indices(self, idx):
        return self._set(eigenvalue_indices=tuple(idx))

    def set_eigenvalue_shift(self, s):
        return self._set(eigenvalue_shift=s)

    def set_breakdown_threshold(self, t):
        return self._set(breakdown_threshold=t)

    def set_check_every(self, n):
        return self._set(check_every=n)

    def set_seed(self, s):
        return self._set(seed=s)

    def set_initial_vector(self, v0):
        """cf. setInitialVector lanczos.hpp:214"""
        self._initial_vector = v0
        return self

    def set_orthogonalizing_vectors(self, D):
        """Deflation space rows (cf. orthogonalizingVectors lanczos.hpp:153)."""
        self._deflate = D
        return self

    def set_all_settings_default(self):
        """cf. setAllSettingsDefault lanczos.hpp:657-668"""
        self.options = LanczosOptions()
        return self

    # -- derived settings ------------------------------------------------
    def _resolved(self, op: LinearOperator):
        n = op.shape[1]
        o = self.options
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        max_iters = o.max_iterations if o.max_iterations != UNLIMITED else n
        m = min(o.max_subspace, n, max_iters) if max_iters > 0 else min(o.max_subspace, n)
        min_iters = max(o.min_iterations, 0)
        return tol, bd, m, max_iters, min_iters

    # -- main entry points ----------------------------------------------
    def compute(self, operator=None) -> LanczosResult:
        """Run from scratch (cf. compute lanczos.hpp:717-738: clears state,
        sets the initial vector, runs mainCalculation_)."""
        if operator is not None:
            self.operator = aslinearoperator(operator)
        if self.operator is None:
            raise LanczosError("no operator set")
        op = self.operator
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"Lanczos requires a square operator, got {op.shape}")
        self.trace = ConvergenceTrace()
        _, bd, m, _, _ = self._resolved(op)
        self.state = init_lanczos_state(
            op,
            m,
            self._initial_vector,
            seed=self.options.seed,
            deflate=self._deflate,
            breakdown_threshold=bd,
        )
        self.trace.log(Severity.INFO, "compute: start")
        return self._main_loop()

    def continue_to_compute(self) -> LanczosResult:
        """Resume iteration with retained basis/α/β after the user changed
        settings — operator must be unchanged (cf. continueToCompute
        lanczos.hpp:696-712 and the documented constraint :699)."""
        if self.state is None:
            return self.compute()
        op = self.operator
        _, _, m, _, _ = self._resolved(op)
        cur_m = self.state.alpha.shape[0]
        if m > cur_m:
            # grow the preallocated buffers, preserving history
            s = self.state
            pad = m - cur_m
            self.state = LanczosState(
                V=jnp.concatenate([s.V, jnp.zeros((pad, s.V.shape[1]), s.V.dtype)], 0),
                alpha=jnp.concatenate([s.alpha, jnp.zeros((pad,), s.alpha.dtype)]),
                beta=jnp.concatenate([s.beta, jnp.zeros((pad,), s.beta.dtype)]),
                k=s.k,
                breakdown=s.breakdown,
                failed=s.failed,
            )
        self.trace.log(Severity.INFO, "continueToCompute: resuming")
        return self._main_loop()

    def _run_chunk(self, op, state, num_steps, breakdown_threshold) -> "LanczosState":
        """One jitted chunk of iterations; overridden by the distributed
        solver (eigenex_tpu.parallel.distributed) to run under shard_map."""
        o = self.options
        return lanczos_steps(
            op,
            state,
            num_steps,
            shift=o.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval,
            deflate=self._deflate,
        )

    # -- the host control loop (mainCalculation_, lanczos.hpp:740-830) ---
    def _main_loop(self) -> LanczosResult:
        op = self.operator
        o = self.options
        tol, bd, m, max_iters, min_iters = self._resolved(op)
        tracked = o.tracked_indices()
        n = op.shape[1]
        t0 = time.perf_counter()
        prev_tracked: np.ndarray | None = None
        termination = None
        converged = False

        while True:
            k = int(self.state.k)
            alpha = np.asarray(self.state.alpha[:k], np.float64) if k else np.zeros(0)
            beta = np.asarray(self.state.beta[:k], np.float64) if k else np.zeros(0)
            ritz = tridiagonal_eigh(alpha, beta, eigvals_only=True) if k else np.zeros(0)
            idx = _formal_indices(tracked, k)
            cur_tracked = ritz[idx] if idx else np.zeros(0)
            resid = float(beta[k - 1]) if k else float("nan")
            self.trace.record(k, cur_tracked, resid, time.perf_counter() - t0)

            # -- termination checks, in the reference's order (:744-768) --
            if bool(self.state.failed):
                # NaN/Inf detected in the recurrence (cf. the reference's
                # failure-first exits, lanczos.hpp:316-347) — stop cleanly
                # with only the finite pre-failure steps retained
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite alpha/beta "
                    "(operator overflow or NaN) — check operator scaling/dtype",
                )
                if k == 0:
                    raise LanczosError(
                        "numerical failure on the first Lanczos step: the "
                        "operator produced non-finite values (overflow/NaN)"
                    )
                break
            if bool(self.state.breakdown):
                termination = "breakdown"
                self.trace.log(
                    Severity.INFO,
                    f"breakdown at k={k}: invariant subspace found (β ≤ {bd:.1e})",
                )
                converged = bool(idx)
                break
            if k >= m:
                termination = "full_subspace" if m >= n else "max_iterations"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max_iterations={m}")
                else:
                    self.trace.log(Severity.INFO, f"full Krylov subspace reached (k={k}=n)")
                converged = termination == "full_subspace"
                break
            if (
                k >= min_iters
                and idx
                and prev_tracked is not None
                and len(prev_tracked) == len(cur_tracked)
            ):
                # relative successive-Ritz change scaled by spectral spread
                # (lanczos.hpp:869-896)
                spread = float(ritz[-1] - ritz[0]) if k > 1 else 0.0
                scale = spread if spread > 0 else max(float(np.max(np.abs(ritz))), 1.0)
                delta = float(np.max(np.abs(cur_tracked - prev_tracked))) / scale
                if delta <= tol:
                    termination = "converged"
                    converged = True
                    self.trace.log(
                        Severity.INFO, f"converged at k={k}: max rel Δritz {delta:.3e} ≤ {tol:.1e}"
                    )
                    break
            prev_tracked = cur_tracked if idx else None

            # chunk size is kept constant so _lanczos_chunk compiles once per
            # solver config; steps past m are no-ops inside the loop body
            self.state = self._run_chunk(op, self.state, o.check_every, bd)

        # -- extraction (lanczos.hpp:779-817) --------------------------------
        k = int(self.state.k)
        if k == 0:
            raise LanczosError("no Lanczos steps were performed")
        alpha = np.asarray(self.state.alpha[:k], np.float64)
        beta = np.asarray(self.state.beta[:k], np.float64)
        evals, Y = tridiagonal_eigh(alpha, beta)
        sel = _formal_indices(tracked, k)
        if not sel:
            sel = list(range(min(o.max_eigenvalues, k)))
        evals_out = evals[sel] - np.real(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _ritz_vectors(self.state.V, jnp.asarray(Y[:, sel]), k)
        self._result = LanczosResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    # -- reference-style accessors --------------------------------------
    @property
    def eigenvalues(self):
        if self._result is None:
            raise LanczosError("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise LanczosError("compute() has not been run")
        return self._result.eigenvectors

    def has_error(self):
        return self.trace.has_error()

    def has_warn(self):
        return self.trace.has_warn()
