"""Block Lanczos for Hermitian operators.

Net-new relative to the reference (which iterates single vectors only):
block Krylov iteration with block width ``b`` multiplies the operator by
``b`` vectors at once — the SpMM path that actually feeds the matrix units dense
columns (single-vector SpMV is HBM-bound; the block version amortizes
every operator byte over b right-hand sides) — and, unlike single-vector
Lanczos, resolves degenerate/clustered eigenvalues (a multiplicity-m
eigenvalue needs m independent directions, which one Krylov vector can
never provide).

Structure mirrors the Arnoldi engine: preallocated basis rows,
masked-CGS2 block orthogonalization (two (m, n)x(n, b) matmuls per
pass), thin-QR of each residual block for the next basis block, and the
band-projected matrix assembled in the Hessenberg buffer; the host loop
symmetrizes and eigh's it every check.
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
from ..utils.exceptions import LanczosError
from ..utils.prng import random_matrix
from ..utils.tolerance import (
    default_breakdown_threshold,
    default_tolerance,
    real_dtype_of,
)
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import LanczosOptions, LanczosResult, _ritz_vectors

__all__ = ["BlockLanczosEigenSolver", "BlockLanczosOptions", "block_lanczos_steps"]


@dataclasses.dataclass(frozen=True)
class BlockLanczosOptions(LanczosOptions):
    """LanczosOptions plus the Krylov block width."""

    block_size: int = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockLanczosState:
    V: jax.Array  # (m + b, n) basis rows, filled in b-row blocks
    H: jax.Array  # (m + b, m) band-projected matrix columns
    k: jax.Array  # () int32 — filled rows (multiple of b)
    breakdown: jax.Array  # () bool
    failed: jax.Array  # () bool — NaN/Inf detected (numerical failure)


def init_block_lanczos_state(
    op: LinearOperator, max_subspace: int, block_size: int, v0=None, *, seed=0
) -> BlockLanczosState:
    n = op.shape[1]
    b = int(block_size)
    m = (int(max_subspace) // b) * b
    if m < 2 * b:
        raise LanczosError(f"max_subspace={max_subspace} too small for block size {b}")
    dtype = op.dtype
    if v0 is None:
        v0 = random_matrix(jax.random.PRNGKey(seed), b, n, dtype)
    v0 = jnp.asarray(v0, dtype)
    if v0.shape != (b, n):
        raise LanczosError(f"initial block must be ({b}, {n}), got {v0.shape}")
    # orthonormalize the starting block (thin QR of the transpose)
    q, _ = jnp.linalg.qr(v0.T)
    V = jnp.zeros((m + b, n), dtype).at[:b].set(q.T)
    return BlockLanczosState(
        V=V,
        H=jnp.zeros((m + b, m), dtype),
        k=jnp.asarray(b, jnp.int32),
        breakdown=jnp.zeros((), jnp.bool_),
        failed=jnp.zeros((), jnp.bool_),
    )


@partial(jax.jit, static_argnames=("num_steps", "block_size"))
def _block_chunk(
    op: LinearOperator,
    state: BlockLanczosState,
    shift,
    breakdown_threshold,
    *,
    num_steps: int,
    block_size: int,
):
    b = block_size
    m = state.H.shape[1]
    dtype = state.V.dtype
    rdt = real_dtype_of(dtype)
    row_ids = lax.broadcasted_iota(jnp.int32, (m + b, 1), 0).squeeze(-1)

    def step(state: BlockLanczosState) -> BlockLanczosState:
        k = state.k
        Qj = lax.dynamic_slice_in_dim(state.V, k - b, b, axis=0)  # (b, n)
        W = op.matmat(Qj.T).T + jnp.asarray(shift, dtype) * Qj  # (b, n)
        mask = (row_ids < k)[:, None]
        # block CGS2: two projection passes against all filled rows
        C_total = jnp.zeros((m + b, b), dtype)
        for _ in range(2):
            # HIGHEST: TF32 here would leave the basis orthogonal only
            # to ~1e-3 (see ops/orthogonalize.py precision note)
            C = jnp.where(mask, jnp.matmul(state.V.conj(), W.T, precision="highest"), 0)  # (m+b, b)
            W = W - jnp.matmul(C.T, state.V, precision="highest")
            C_total = C_total + C
        # thin QR of the residual block: W.T = Q R
        Q, R = jnp.linalg.qr(W.T)  # (n, b), (b, b)
        # phase-fix so R has non-negative real diagonal (deterministic):
        # Q' = Q·diag(phase), R' = diag(conj(phase))·R keeps Q'R' = QR
        d = jnp.diagonal(R)
        phase = jnp.where(jnp.abs(d) > 0, d / jnp.where(jnp.abs(d) > 0, jnp.abs(d), 1), 1)
        Q = Q * phase[None, :]
        R = jnp.conj(phase)[:, None] * R
        # breakdown: residual block rank-deficient
        rmin = jnp.min(jnp.abs(jnp.diagonal(R)))
        # H column block k-b..k: projections + the new R block rows
        Hcol = C_total  # (m+b, b) — includes rows < k
        Hcol = lax.dynamic_update_slice(Hcol, R.astype(dtype), (k, jnp.asarray(0, k.dtype)))
        # NaN/Inf guard: a non-finite projected column means the operator
        # overflowed — stop cleanly instead of filling H with garbage
        failed_now = jnp.logical_not(
            jnp.isfinite(rmin) & jnp.all(jnp.isfinite(Hcol))
        )
        broke = jnp.logical_not(failed_now) & (
            rmin <= jnp.asarray(breakdown_threshold, rdt)
        )
        ok = jnp.logical_not(broke | failed_now)
        Hcol = jnp.where(failed_now, jnp.zeros_like(Hcol), Hcol)
        H = lax.dynamic_update_slice(state.H, Hcol, (jnp.asarray(0, k.dtype), k - b))
        H = jnp.where(failed_now, state.H, H)
        # unconditional block write (cond over V copies the whole basis);
        # zeros on breakdown/failure, never read; where() keeps NaNs out
        Qw = jnp.where(ok, Q.T, jnp.zeros_like(Q.T))
        V = lax.dynamic_update_slice(state.V, Qw, (k, jnp.asarray(0, k.dtype)))
        return BlockLanczosState(
            V=V,
            H=H,
            k=k + jnp.where(failed_now, 0, b).astype(k.dtype),
            breakdown=state.breakdown | broke,
            failed=state.failed | failed_now,
        )

    def body(_, s):
        # a step at k computes H's column block k-b..k, so the last useful
        # step starts at k == m (filling columns m-b..m and basis rows
        # m..m+b); k reaches m+b when the projected matrix is complete
        active = jnp.logical_not(s.breakdown) & jnp.logical_not(s.failed) & (s.k <= m)
        return lax.cond(active, step, lambda s: s, s)

    return lax.fori_loop(0, num_steps, body, state)


def block_lanczos_steps(op, state, num_steps, *, shift=0.0, breakdown_threshold=None, block_size=None):
    op = aslinearoperator(op)
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    if block_size is None:
        raise LanczosError("block_size required")
    return _block_chunk(
        op,
        state,
        jnp.asarray(shift),
        jnp.asarray(breakdown_threshold, real_dtype_of(op.dtype)),
        num_steps=int(num_steps),
        block_size=int(block_size),
    )


class BlockLanczosEigenSolver:
    """Hermitian eigensolver iterating b vectors at a time."""

    def __init__(self, operator=None, options: BlockLanczosOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or BlockLanczosOptions()
        self.trace = ConvergenceTrace()
        self._initial_block = None
        self._result: LanczosResult | None = None

    def set_initial_block(self, v0):
        self._initial_block = v0
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
        b = o.block_size
        n = op.shape[1]
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        m = min(o.max_subspace, n)
        state = init_block_lanczos_state(op, m, b, self._initial_block, seed=o.seed)
        m = state.H.shape[1]
        tracked = o.tracked_indices()
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()
        prev = None
        termination = None
        converged = False
        steps_per_check = max(1, o.check_every // b)

        while True:
            # a step starting at k writes H columns k-b..k then advances k,
            # so the filled Rayleigh dimension is k - b (capped at m)
            k = min(int(state.k) - b, m)
            Hk = np.asarray(
                state.H[:k, :k],
                np.complex128 if jnp.iscomplexobj(state.H) else np.float64,
            )
            Hk = (Hk + Hk.conj().T) / 2
            theta = np.linalg.eigvalsh(Hk) if k else np.zeros(0)
            idx = [i if i >= 0 else k + i for i in tracked]
            idx = [i for i in idx if 0 <= i < k]
            cur = theta[idx] if idx else np.zeros(0)
            self.trace.record(k, cur, float("nan"), time.perf_counter() - t0)

            if bool(state.failed):
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite projected block "
                    "(operator overflow or NaN)",
                )
                if k <= 0:
                    raise LanczosError(
                        "numerical failure on the first block-Lanczos step"
                    )
                break
            if bool(state.breakdown):
                termination = "breakdown"
                # rank deficiency of ONE residual direction does not imply
                # the tracked Ritz values converged (unlike single-vector
                # Lanczos, where β=0 means an exactly-invariant subspace);
                # report converged only if the successive test had passed
                converged = bool(
                    idx
                    and prev is not None
                    and len(prev) == len(cur)
                    and theta.size > 1
                    and float(np.max(np.abs(cur - prev)))
                    <= tol * max(float(theta[-1] - theta[0]), 1.0)
                )
                self.trace.log(
                    Severity.INFO,
                    f"block breakdown at k={k} (rank-deficient residual block)",
                )
                break
            if int(state.k) > m:
                termination = "full_subspace" if m >= n else "max_iterations"
                converged = termination == "full_subspace"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max subspace {m}")
                break
            if idx and prev is not None and len(prev) == len(cur):
                spread = float(theta[-1] - theta[0]) if k > 1 else 0.0
                scale = spread if spread > 0 else max(float(np.max(np.abs(theta))), 1.0)
                if float(np.max(np.abs(cur - prev))) / scale <= tol:
                    termination = "converged"
                    converged = True
                    break
            prev = cur if idx else None
            state = block_lanczos_steps(
                op, state, steps_per_check, shift=o.eigenvalue_shift,
                breakdown_threshold=bd, block_size=b,
            )

        k = min(int(state.k) - b, m)
        Hk = np.asarray(
            state.H[:k, :k], np.complex128 if jnp.iscomplexobj(state.H) else np.float64
        )
        Hk = (Hk + Hk.conj().T) / 2
        theta, Y = np.linalg.eigh(Hk)
        sel = [i if i >= 0 else k + i for i in tracked]
        sel = [i for i in sel if 0 <= i < k] or list(range(min(o.max_eigenvalues, k)))
        evals = theta[sel] - np.real(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _ritz_vectors(state.V, jnp.asarray(Y[:, sel]), k)
        self._result = LanczosResult(
            eigenvalues=evals,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result
