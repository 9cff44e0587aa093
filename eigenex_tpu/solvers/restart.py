"""Thick-restart Lanczos (TRLM) for Hermitian operators.

The reference can only grow its Krylov basis until memory/iteration
limits (lanczos.hpp:744-768) — for clustered spectra (e.g. the low end
of a Laplacian) that means the full subspace is needed for 1e-10
accuracy.  Thick restart (Wu & Simon 2000) bounds memory at
``max_subspace`` while retaining the convergence of a long run: when the
subspace fills, the best ``num_kept`` Ritz vectors are compressed into
the leading basis slots (one batched matmul), the residual vector is
appended, and iteration continues with the arrowhead-projected matrix.

Design: the engine is the *Arnoldi* chunk
(:func:`eigenex_tpu.solvers.arnoldi.arnoldi_steps`) — its per-step
masked-CGS2 against the whole basis computes exactly the projected-
matrix column needed after a restart (where the three-term recurrence
does not hold), with static shapes throughout; Hermiticity is recovered
on host by symmetrizing the tiny projected matrix before its ``eigh``.
The restart compression ``V_new = Yᵀ V`` is a single (p, m) x (m, n)
matmul.  Convergence uses the proper Lanczos residual bound
|β_m · y_{m,i}| ≤ tol·scale rather than the reference's successive-
value test.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.tolerance import default_breakdown_threshold, default_tolerance
from ..utils.trace import ConvergenceTrace, Severity
from .arnoldi import ArnoldiState, arnoldi_steps, init_arnoldi_state
from .lanczos import LanczosOptions, LanczosResult, _ritz_vectors

__all__ = ["ThickRestartLanczosEigenSolver", "ThickRestartOptions"]


@dataclasses.dataclass(frozen=True)
class ThickRestartOptions(LanczosOptions):
    """LanczosOptions plus restart knobs.

    num_kept: Ritz vectors retained at each restart (None → a standard
        heuristic, min(max(2·nev, nev+8), m−2)).
    max_restarts: restart cycles before giving up.
    """

    num_kept: int | None = None
    max_restarts: int = 100


@jax.jit
def _compress_basis(V: jax.Array, Yk: jax.Array, r: jax.Array) -> jax.Array:
    """V_new[0:p] = Ykᵀ V[:m];  V_new[p] = r;  rest zero — one matmul."""
    m = Yk.shape[0]
    p = Yk.shape[1]
    out = jnp.zeros_like(V)
    compressed = jnp.matmul(V[:m].T, Yk.astype(V.dtype), precision="highest").T  # (p, n)
    out = out.at[:p].set(compressed)
    out = out.at[p].set(r)
    return out


class ThickRestartLanczosEigenSolver:
    """Hermitian eigensolver with bounded memory via thick restarts.

    Drop-in alternative to :class:`LanczosEigenSolver` when
    ``max_subspace`` ≪ what plain Lanczos would need (clustered spectra,
    huge n).  Tracks the ``eigenvalue_indices`` of the ascending Ritz
    ordering (negatives from the top), like the plain solver."""

    def __init__(self, operator=None, options: ThickRestartOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or ThickRestartOptions()
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._result: LanczosResult | None = None

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        o = self.options
        n = op.shape[1]
        nev = o.max_eigenvalues
        m = min(o.max_subspace, n)
        if m < nev + 2:
            raise LanczosError(f"max_subspace={m} too small for {nev} eigenpairs")
        p = o.num_kept if o.num_kept is not None else min(max(2 * nev, nev + 8), m - 2)
        p = min(p, m - 2)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        tracked = o.tracked_indices()
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        state = init_arnoldi_state(op, m, self._initial_vector, seed=o.seed, breakdown_threshold=bd)
        total_iters = 0
        termination = "max_restarts"
        converged = False

        for restart in range(o.max_restarts + 1):
            k0 = int(state.k)
            state = self._run_arnoldi_chunk(op, state, m - k0, bd)
            k = int(state.k)
            total_iters += k - k0
            if bool(state.failed):
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at {total_iters} total iterations: "
                    "non-finite projection (operator overflow or NaN)",
                )
                if k == 0:
                    raise LanczosError("numerical failure on the first Lanczos step")
                break
            Hk = np.asarray(state.H[:k, :k], np.float64 if not jnp.iscomplexobj(state.H) else np.complex128)
            Hk = (Hk + Hk.conj().T) / 2  # restore Hermiticity of the projection
            theta, Y = np.linalg.eigh(Hk)
            beta_m = float(self.state_residue(state))
            # Lanczos residual bound per Ritz pair: |β_m · y_{m-1,i}|
            resid = np.abs(beta_m * Y[k - 1, :])
            idx = [i if i >= 0 else k + i for i in tracked]
            idx = [i for i in idx if 0 <= i < k]
            spread = float(theta[-1] - theta[0]) if k > 1 else 1.0
            scale = max(spread, float(np.max(np.abs(theta))) if k else 1.0, 1e-300)
            cur = theta[idx] if idx else np.zeros(0)
            self.trace.record(total_iters, cur, float(np.max(resid[idx]) if idx else np.nan),
                              time.perf_counter() - t0)

            if bool(state.breakdown):
                termination = "breakdown"
                converged = True
                self.trace.log(Severity.INFO, f"breakdown at {total_iters} total iterations")
                break
            if idx and np.all(resid[idx] <= tol * scale):
                termination = "converged"
                converged = True
                self.trace.log(
                    Severity.INFO,
                    f"converged after {restart} restarts / {total_iters} iterations "
                    f"(max residual bound {float(np.max(resid[idx])):.3e})",
                )
                break
            if restart == o.max_restarts:
                self.trace.log(Severity.WARN, f"stopped at max_restarts={o.max_restarts}")
                break

            # ---- thick restart: keep the tracked pairs + nearest extras ----
            keep = self._select_keep(theta, idx, p, k)
            Yk = Y[:, keep]
            r = state.V[k]  # unit residual direction
            V_new = _compress_basis(state.V, jnp.asarray(Yk), r)
            pk = len(keep)
            H_new = np.zeros_like(Hk, shape=(m + 1, m))
            H_new[:pk, :pk] = np.diag(theta[keep])
            # arrowhead coupling row: <r, A u_i> = β_m y_{m-1,i}
            H_new[pk, :pk] = beta_m * Y[k - 1, keep]
            state = ArnoldiState(
                V=V_new,
                H=jnp.asarray(H_new, state.H.dtype),
                k=jnp.asarray(pk, jnp.int32),
                breakdown=jnp.zeros((), jnp.bool_),
                residue=state.residue,
                failed=jnp.zeros((), jnp.bool_),
            )

        # ---- extraction ----
        k = int(state.k)
        Hk = np.asarray(state.H[:k, :k], np.float64 if not jnp.iscomplexobj(state.H) else np.complex128)
        Hk = (Hk + Hk.conj().T) / 2
        theta, Y = np.linalg.eigh(Hk)
        sel = [i if i >= 0 else k + i for i in tracked]
        sel = [i for i in sel if 0 <= i < k] or list(range(min(nev, k)))
        evals = theta[sel] - np.real(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _ritz_vectors(state.V, jnp.asarray(Y[:, sel]), k)
        self._result = LanczosResult(
            eigenvalues=evals,
            eigenvectors=vecs,
            iterations=total_iters,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        """One jitted Arnoldi chunk; overridden by the distributed variant
        (eigenex_tpu.parallel.distributed) to run under shard_map."""
        return arnoldi_steps(
            op,
            state,
            num_steps,
            shift=self.options.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
        )

    @staticmethod
    def state_residue(state: ArnoldiState) -> float:
        return float(state.residue)

    @staticmethod
    def _select_keep(theta: np.ndarray, tracked_idx: list[int], p: int, k: int) -> list[int]:
        """Tracked Ritz indices first, then nearest neighbors by position
        (keeps the restart subspace centered on the wanted part of the
        spectrum)."""
        keep = list(dict.fromkeys(tracked_idx))
        lo = min(keep) if keep else 0
        hi = max(keep) if keep else -1
        grow_lo, grow_hi = lo - 1, hi + 1
        while len(keep) < min(p, k - 1):
            if grow_lo >= 0:
                keep.append(grow_lo)
                grow_lo -= 1
            elif grow_hi < k:
                keep.append(grow_hi)
                grow_hi += 1
            else:
                break
            if len(keep) < min(p, k - 1) and grow_hi < k:
                keep.append(grow_hi)
                grow_hi += 1
        return sorted(set(keep))

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
