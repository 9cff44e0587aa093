"""Arnoldi eigensolver for general (non-Hermitian) matrix-free operators.

JAX-native re-design of the reference's Arnoldi stack
(include/cmpt/eigen_ex/arnoldi.hpp): ``ArnoldiBase`` (:54) with its
Hessenberg-building full Gram-Schmidt loop (:312-396) and
``ArnoldiEigenSolver`` (:445) with dominant-|λ| sorting (:813-819),
eigenvector lift V·y (:841-851) and phase fixing (:853-865).

Shares the architecture of :mod:`eigenex_tpu.solvers.lanczos` (the
reference likewise shares its config/convergence machinery between the
two, arnoldi.hpp:6):

- preallocated ``(m+1, n)`` basis + ``(m+1, m)`` Hessenberg, updated in
  ``lax.fori_loop`` chunks with static shapes;
- the per-step full modified-GS against all previous vectors
  (arnoldi.hpp:380-383) becomes masked CGS2 — two matmuls whose
  total coefficients *are* the Hessenberg column;
- the dense Hessenberg eigenproblem (Eigen::EigenSolver /
  ComplexEigenSolver via EigenSolverTraits, arnoldi.hpp:472-501) runs on
  host NumPy float64/complex128 every ``check_every`` iterations;
- residue breakdown (residue ≤ threshold ⇒ invariant subspace,
  arnoldi.hpp:277-288) is a carried flag.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.operators import LinearOperator, aslinearoperator
from ..ops.orthogonalize import cgs2, project_out
from ..utils.exceptions import ArnoldiError
from ..utils.prng import random_vector
from ..utils.tolerance import (
    default_breakdown_threshold,
    default_tolerance,
    real_dtype_of,
)
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import UNLIMITED, LanczosOptions, _phase_fix

__all__ = [
    "ArnoldiOptions",
    "ArnoldiState",
    "ArnoldiResult",
    "ArnoldiEigenSolver",
    "arnoldi_steps",
    "init_arnoldi_state",
]


# Arnoldi reuses the Lanczos option surface (the reference shares the
# fluent config between solvers, arnoldi.hpp:6,208-218); only the
# tracked-index semantics differ: indices refer to the |λ|-descending
# order (arnoldi.hpp:813-819).
ArnoldiOptions = LanczosOptions


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ArnoldiState:
    """Carried Arnoldi state (basis + Hessenberg; cf. arnoldi.hpp:190-206)."""

    V: jax.Array  # (m+1, n) orthonormal basis rows
    H: jax.Array  # (m+1, m) Hessenberg (real dtype of op for real ops)
    k: jax.Array  # () int32 completed steps
    breakdown: jax.Array  # () bool
    residue: jax.Array  # () real — ‖w‖ after last orthogonalization (arnoldi.hpp:348)
    failed: jax.Array  # () bool — NaN/Inf detected (numerical failure)


@dataclasses.dataclass
class ArnoldiResult:
    eigenvalues: np.ndarray  # (p,) complex, sorted by |λ| descending
    eigenvectors: jax.Array | None  # (n, p) complex columns
    iterations: int
    converged: bool
    termination: str
    trace: ConvergenceTrace

    def residual_norms(self, op: LinearOperator) -> np.ndarray:
        """‖A x − λ x‖ per pair — the ‖A·P − P·D‖ ≈ 0 acceptance identity
        (sample_arnoldi.cpp:42-52)."""
        if self.eigenvectors is None:
            raise ArnoldiError("eigenvectors were not computed")
        # combine on host: a one-shot diagnostic
        X = np.asarray(self.eigenvectors)
        lam = np.asarray(self.eigenvalues)
        if np.iscomplexobj(X) and not jnp.issubdtype(op.dtype, jnp.complexfloating):
            # complex Ritz vectors over a real operator: apply to re/im parts
            ax = np.asarray(op.matmat(jnp.asarray(X.real, op.dtype))) + 1j * np.asarray(
                op.matmat(jnp.asarray(X.imag, op.dtype))
            )
        else:
            ax = np.asarray(op.matmat(jnp.asarray(X, op.dtype)))
            if not np.iscomplexobj(X):
                lam = lam.real
        r = ax - X * lam[None, :]
        return np.linalg.norm(r, axis=0)


def init_arnoldi_state(
    op: LinearOperator,
    max_subspace: int,
    v0: jax.Array | None = None,
    *,
    seed: int = 0,
    deflate: jax.Array | None = None,
    breakdown_threshold: float | None = None,
) -> ArnoldiState:
    """cf. setInitialArnoldivector arnoldi.hpp:246-275."""
    n = op.shape[1]
    m = int(max_subspace)
    dtype = op.dtype
    rdt = real_dtype_of(dtype)
    if v0 is None:
        v0 = random_vector(jax.random.PRNGKey(seed), n, dtype, normalize=False)
    v0 = jnp.asarray(v0, dtype)
    if deflate is not None:
        v0 = project_out(jnp.asarray(deflate, dtype), v0)
    nrm = float(jnp.linalg.norm(v0))
    thr = breakdown_threshold if breakdown_threshold is not None else default_breakdown_threshold(dtype)
    if not np.isfinite(nrm):
        raise ArnoldiError(f"initial vector is not finite (norm {nrm})")
    if nrm <= thr:
        raise ArnoldiError(
            f"initial vector has (post-deflation) norm {nrm:.3e} <= breakdown threshold {thr:.3e}"
        )
    V = jnp.zeros((m + 1, n), dtype).at[0].set(v0 / nrm)
    return ArnoldiState(
        V=V,
        H=jnp.zeros((m + 1, m), dtype),
        k=jnp.zeros((), jnp.int32),
        breakdown=jnp.zeros((), jnp.bool_),
        residue=jnp.asarray(nrm, rdt),
        failed=jnp.zeros((), jnp.bool_),
    )


def _arnoldi_chunk_body(
    op: LinearOperator,
    state: ArnoldiState,
    shift,
    breakdown_threshold,
    deflate,
    *,
    num_steps: int,
    has_deflate: bool,
    axis_name: str | None = None,
):
    """The hot loop of updateArnoldiSteps (arnoldi.hpp:312-396): matvec +
    shift (:369-372), deflation (:373-375), full GS Hessenberg column
    (:377-384) via masked CGS2, residue (:348,385).

    ``axis_name``: set when running inside ``shard_map`` with the basis
    row-sharded — inner products/norms complete with ``lax.psum`` and the
    operator is a local-shard operator (same scheme as the Lanczos chunk,
    eigenex_tpu.parallel.distributed)."""
    m = state.H.shape[1]
    dtype = state.V.dtype
    rdt = state.residue.dtype
    row_ids = lax.broadcasted_iota(jnp.int32, (m + 1, 1), 0).squeeze(-1)

    def psum_if(x):
        return lax.psum(x, axis_name) if axis_name is not None else x

    def vnorm(v):
        return jnp.sqrt(
            psum_if(
                jnp.sum(jnp.real(v) ** 2 + (jnp.imag(v) ** 2 if jnp.iscomplexobj(v) else 0.0))
            )
        )

    def step(state: ArnoldiState) -> ArnoldiState:
        k = state.k
        vk = state.V[k]
        w = op.matvec(vk) + jnp.asarray(shift, dtype) * vk
        if has_deflate:
            w = project_out(deflate, w, axis_name=axis_name)
        mask = row_ids <= k
        w, h_col = cgs2(state.V, w, axis_name=axis_name, mask=mask)
        if has_deflate:
            # re-deflate after the O(1)-coefficient projection: it
            # reintroduces a deflate component proportional to the basis'
            # accumulated deflate drift, which otherwise grows
            # geometrically (cf. arnoldi.hpp:373-375)
            w = project_out(deflate, w, axis_name=axis_name)
        residue = vnorm(w).astype(rdt)
        # NaN/Inf guard (cf. the reference's residue-breakdown exits,
        # arnoldi.hpp:277-288): non-finite Hessenberg column or residue
        # means the matvec overflowed — terminate, don't iterate garbage.
        failed_now = jnp.logical_not(
            jnp.isfinite(residue) & jnp.all(jnp.isfinite(h_col))
        )
        broke = jnp.logical_not(failed_now) & (
            residue <= jnp.asarray(breakdown_threshold, rdt)
        )
        ok = jnp.logical_not(broke | failed_now)
        safe = jnp.where(ok, residue, jnp.ones((), rdt))
        # unconditional single-row write (a lax.cond over V would copy the
        # whole basis each step); the row is zero on breakdown/failure,
        # never read; jnp.where (selection) keeps NaNs out.
        v_next = jnp.where(ok, w / safe.astype(dtype), jnp.zeros_like(w))
        # column k of H: projection coefficients + subdiagonal residue
        h_col = h_col.at[k + 1].set(jnp.where(ok, residue, 0).astype(dtype))
        h_col = jnp.where(failed_now, jnp.zeros_like(h_col), h_col)
        H = state.H.at[:, k].set(h_col)
        V = state.V.at[k + 1].set(v_next)
        return ArnoldiState(
            V=V,
            H=H,
            k=k + jnp.where(failed_now, 0, 1).astype(k.dtype),
            breakdown=state.breakdown | broke,
            residue=jnp.where(failed_now, state.residue, residue),
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


_arnoldi_chunk = jax.jit(
    _arnoldi_chunk_body, static_argnames=("num_steps", "has_deflate", "axis_name")
)


def arnoldi_steps(
    op: LinearOperator,
    state: ArnoldiState,
    num_steps: int,
    *,
    shift=0.0,
    breakdown_threshold: float | None = None,
    deflate: jax.Array | None = None,
) -> ArnoldiState:
    """Public fixed-step basis/Hessenberg builder (the ``ArnoldiBase``
    role, arnoldi.hpp:54-443) — fully jittable."""
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    has_deflate = deflate is not None
    if not has_deflate:
        deflate = jnp.zeros((0, op.shape[1]), op.dtype)
    return _arnoldi_chunk(
        op,
        state,
        jnp.asarray(shift),
        jnp.asarray(breakdown_threshold, real_dtype_of(op.dtype)),
        jnp.asarray(deflate, op.dtype),
        num_steps=int(num_steps),
        has_deflate=has_deflate,
    )


def _sorted_desc_indices(evals: np.ndarray) -> np.ndarray:
    """Stable sort by |λ| descending (cf. compute_sorted_indices
    arnoldi.hpp:893-913)."""
    return np.argsort(-np.abs(evals), kind="stable")


def _formal_indices(indices, count):
    out = []
    for i in indices:
        j = i if i >= 0 else count + i
        if 0 <= j < count:
            out.append(j)
        else:
            return []
    return out


def _lift_ritz(V: jax.Array, Y: np.ndarray, k: int) -> np.ndarray:
    """x_j = Σ_m Y[m,j] V[m] (arnoldi.hpp:841-851) + normalize/phase-fix
    (:853-865).

    Runs on HOST NumPy: Ritz lifting happens once per solve (not a hot
    path) and Y is complex in general — a single device→host pull of
    the basis is the simple choice."""
    Vh = np.asarray(V[:k])
    X = Vh.T @ np.asarray(Y)
    X = X / np.linalg.norm(X, axis=0, keepdims=True)
    # phase fix: first significantly-nonzero coefficient made real-positive
    absX = np.abs(X)
    thresh = absX.max(axis=0, keepdims=True) * 1e-6
    first = np.argmax(absX > thresh, axis=0)
    lead = X[first, np.arange(X.shape[1])]
    denom = np.abs(lead)
    phase = np.where(denom > 0, lead / np.where(denom > 0, denom, 1), 1.0)
    return X * np.conj(phase)[None, :]


class ArnoldiEigenSolver:
    """General eigensolver driver for dominant eigenpairs
    (cf. ArnoldiEigenSolver arnoldi.hpp:445).

    ``eigenvalue_indices`` index into the |λ|-descending ordering; the
    default tracks the ``max_eigenvalues`` most dominant pairs."""

    def __init__(self, operator=None, options: ArnoldiOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or ArnoldiOptions()
        self.state: ArnoldiState | None = None
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._deflate = None
        self._result: ArnoldiResult | None = None

    # fluent configuration, same surface as Lanczos (arnoldi.hpp:545-679)
    def _set(self, **kw):
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
        self._initial_vector = v0
        return self

    def set_orthogonalizing_vectors(self, D):
        self._deflate = D
        return self

    def set_all_settings_default(self):
        self.options = ArnoldiOptions()
        return self

    def _resolved(self, op):
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
        return tol, bd, m, max(o.min_iterations, 0)

    def compute(self, operator=None) -> ArnoldiResult:
        """cf. compute arnoldi.hpp:741-762"""
        if operator is not None:
            self.operator = aslinearoperator(operator)
        if self.operator is None:
            raise ArnoldiError("no operator set")
        op = self.operator
        if op.shape[0] != op.shape[1]:
            raise ArnoldiError(f"Arnoldi requires a square operator, got {op.shape}")
        self.trace = ConvergenceTrace()
        _, bd, m, _ = self._resolved(op)
        self.state = init_arnoldi_state(
            op,
            m,
            self._initial_vector,
            seed=self.options.seed,
            deflate=self._deflate,
            breakdown_threshold=bd,
        )
        self.trace.log(Severity.INFO, "compute: start")
        return self._main_loop()

    def continue_to_compute(self) -> ArnoldiResult:
        """cf. continueToCompute arnoldi.hpp:720-736 (operator must be
        unchanged)."""
        if self.state is None:
            return self.compute()
        op = self.operator
        _, _, m, _ = self._resolved(op)
        cur_m = self.state.H.shape[1]
        if m > cur_m:
            s = self.state
            pad = m - cur_m
            H = jnp.zeros((m + 1, m), s.H.dtype)
            H = H.at[: cur_m + 1, :cur_m].set(s.H)
            self.state = ArnoldiState(
                V=jnp.concatenate([s.V, jnp.zeros((pad, s.V.shape[1]), s.V.dtype)], 0),
                H=H,
                k=s.k,
                breakdown=s.breakdown,
                residue=s.residue,
                failed=s.failed,
            )
        self.trace.log(Severity.INFO, "continueToCompute: resuming")
        return self._main_loop()

    def _main_loop(self) -> ArnoldiResult:
        op = self.operator
        o = self.options
        tol, bd, m, min_iters = self._resolved(op)
        tracked = o.tracked_indices()
        n = op.shape[1]
        t0 = time.perf_counter()
        prev_tracked = None
        termination = None
        converged = False

        while True:
            k = int(self.state.k)
            if k:
                Hk = np.asarray(self.state.H[:k, :k], np.complex128 if jnp.iscomplexobj(self.state.H) else np.float64)
                evals = np.linalg.eigvals(Hk)
                order = _sorted_desc_indices(evals)
                evals_sorted = evals[order]
            else:
                evals_sorted = np.zeros(0, np.complex128)
            idx = _formal_indices(tracked, k)
            cur_tracked = evals_sorted[idx] if idx else np.zeros(0, np.complex128)
            resid = float(self.state.residue)
            self.trace.record(k, cur_tracked, resid, time.perf_counter() - t0)

            if bool(self.state.failed):
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite Hessenberg/residue "
                    "(operator overflow or NaN)",
                )
                if k == 0:
                    raise ArnoldiError(
                        "numerical failure on the first Arnoldi step: the "
                        "operator produced non-finite values (overflow/NaN)"
                    )
                break
            if bool(self.state.breakdown):
                termination = "breakdown"
                converged = bool(idx)
                self.trace.log(
                    Severity.INFO,
                    f"breakdown at k={k}: residue ≤ {bd:.1e} (invariant subspace)",
                )
                break
            if k >= m:
                termination = "full_subspace" if m >= n else "max_iterations"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max_iterations={m}")
                converged = termination == "full_subspace"
                break
            if (
                k >= min_iters
                and idx
                and prev_tracked is not None
                and len(prev_tracked) == len(cur_tracked)
            ):
                # successive-eigenvalue test scaled by dominant magnitude
                # (cf. arnoldi.hpp:954-996)
                scale = max(float(np.max(np.abs(evals_sorted))), 1e-300)
                delta = float(np.max(np.abs(cur_tracked - prev_tracked))) / scale
                if delta <= tol:
                    termination = "converged"
                    converged = True
                    self.trace.log(
                        Severity.INFO, f"converged at k={k}: max rel Δλ {delta:.3e} ≤ {tol:.1e}"
                    )
                    break
            prev_tracked = cur_tracked if idx else None

            self.state = arnoldi_steps(
                op,
                self.state,
                o.check_every,
                shift=o.eigenvalue_shift,
                breakdown_threshold=bd,
                deflate=self._deflate,
            )

        # extraction: Hessenberg eigendecomposition, |λ|-desc sort,
        # shift-back, eigenvector lift (arnoldi.hpp:805-865)
        k = int(self.state.k)
        if k == 0:
            raise ArnoldiError("no Arnoldi steps were performed")
        Hk = np.asarray(
            self.state.H[:k, :k],
            np.complex128 if jnp.iscomplexobj(self.state.H) else np.float64,
        )
        evals, Y = np.linalg.eig(Hk)
        order = _sorted_desc_indices(evals)
        sel = _formal_indices(tracked, k)
        if not sel:
            sel = list(range(min(o.max_eigenvalues, k)))
        chosen = order[sel]
        evals_out = evals[chosen] - complex(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _lift_ritz(self.state.V, Y[:, chosen], k)
        self._result = ArnoldiResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    @property
    def eigenvalues(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvectors

    def has_error(self):
        return self.trace.has_error()

    def has_warn(self):
        return self.trace.has_warn()
