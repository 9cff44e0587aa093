"""Chebyshev-filtered subspace iteration — interior eigenpairs without
linear solves.

The reference's only interior-targeting tool is the eigenvalue shift
(lanczos.hpp:155,390-392), which can only push one spectral end; ARPACK
practice (and this framework's ``eigsh(sigma=…)``) uses shift-invert,
which needs an inner linear solve per matvec.  The Chebyshev route
replaces the solve with a POLYNOMIAL of the operator: scaled Chebyshev
polynomials grow exponentially outside [-1, 1], so mapping the unwanted
spectral range onto [-1, 1] turns p(A) into a filter that amplifies the
window around the target σ by factors of ~cosh(m·acosh(|t(σ)|)).

On an accelerator this is the most compiler-friendly eigensolver in the library:
one iteration = a degree-m three-term SpMM recurrence (``lax.fori_loop``
of ``op.matmat`` — the bf16/Pallas block path) + one thin-QR + one small
Rayleigh–Ritz; no inner CG/GMRES, no data-dependent control flow on
device, and the SpMM amortizes every operator byte over the block width
(docs/DESIGN.md §2).

Spectral bounds come from Gershgorin (``estimate_eigenvalue_range``,
triplets_matrix.hpp:512-540) or a few Lanczos steps; over-estimates only
weaken the filter, never break correctness.
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
from ..utils.tolerance import default_tolerance, real_dtype_of
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import LanczosResult

__all__ = [
    "ChebyshevFilterOptions",
    "ChebyshevFilterSolver",
    "chebyshev_filter_apply",
    "chebyshev_bandpass_apply",
    "eigsh_window",
    "cholesky_qr2",
    "as_filter_operator",
]


@partial(jax.jit, static_argnames=("degree",))
def chebyshev_filter_apply(
    op: LinearOperator, X: jax.Array, lo, hi, *, degree: int
) -> jax.Array:
    """Apply the degree-``m`` Chebyshev filter p_m(A)·X that damps the
    spectral interval [lo, hi] onto Chebyshev's equi-oscillation region
    and amplifies everything outside it.

    Standard three-term recurrence on the affine-mapped operator
    t(A) = (2A − (hi+lo)I) / (hi − lo):
        T_0 = X,  T_1 = t(A)X,  T_{k+1} = 2·t(A)T_k − T_{k-1}.
    All device work is ``op.matmat`` (the SpMM/matmul path); the loop is a
    ``lax.fori_loop`` with static shapes.
    """
    c = (hi + lo) / 2.0
    e = (hi - lo) / 2.0
    dtype = X.dtype

    def t_apply(V):
        return (op.matmat(V).astype(dtype) - c * V) / e

    T0 = X
    T1 = t_apply(X)

    def body(_, carry):
        tkm1, tk = carry
        tkp1 = 2.0 * t_apply(tk) - tkm1
        return tk, tkp1

    _, Tm = lax.fori_loop(0, degree - 1, body, (T0, T1))
    return Tm


def _bandpass_coefficients(alpha: float, beta: float, degree: int) -> np.ndarray:
    """Jackson-damped Chebyshev expansion coefficients of the indicator
    function of [alpha, beta] ⊂ [-1, 1] (the KPM/EVSL spectrum-slicing
    filter).  With t = cos θ:  c_0 = (θ_α − θ_β)/π,
    c_k = 2(sin kθ_α − sin kθ_β)/(kπ);  Jackson damping suppresses the
    Gibbs oscillation so the filter is ≈1 inside the window and decays
    monotonically to ≈0 outside."""
    th_a = float(np.arccos(np.clip(alpha, -1.0, 1.0)))
    th_b = float(np.arccos(np.clip(beta, -1.0, 1.0)))  # th_b <= th_a
    k = np.arange(1, degree + 1)
    c = np.empty(degree + 1)
    c[0] = (th_a - th_b) / np.pi
    c[1:] = 2.0 * (np.sin(k * th_a) - np.sin(k * th_b)) / (k * np.pi)
    M = degree
    g = (
        (M - k + 1) * np.cos(np.pi * k / (M + 1))
        + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))
    ) / (M + 1)
    c[1:] *= g
    return c


@partial(jax.jit, static_argnames=("degree",))
def chebyshev_bandpass_apply(
    op: LinearOperator, X: jax.Array, lam_min, lam_max, coeffs, *, degree: int
) -> jax.Array:
    """p(A)·X for the degree-``m`` bandpass polynomial with Chebyshev
    coefficients ``coeffs`` on the spectrum mapped [lam_min, lam_max] →
    [-1, 1]: accumulate Σ_k c_k T_k(t(A))·X by the three-term recurrence
    — one ``op.matmat`` per degree, a ``lax.fori_loop`` on device."""
    c = (lam_max + lam_min) / 2.0
    e = (lam_max - lam_min) / 2.0
    dtype = X.dtype
    coeffs = jnp.asarray(coeffs, real_dtype_of(dtype))

    def t_apply(V):
        return (op.matmat(V).astype(dtype) - c * V) / e

    T0 = X
    T1 = t_apply(X)
    acc0 = coeffs[0] * T0 + coeffs[1] * T1

    def body(k, carry):
        tkm1, tk, acc = carry
        tkp1 = 2.0 * t_apply(tk) - tkm1
        return tk, tkp1, acc + coeffs[k] * tkp1

    _, _, acc = lax.fori_loop(2, degree + 1, body, (T0, T1, acc0))
    return acc


@dataclasses.dataclass(frozen=True)
class ChebyshevFilterOptions:
    """Knobs for :class:`ChebyshevFilterSolver`.

    degree: filter polynomial degree per outer iteration (device cost =
    degree SpMMs); higher degree = sharper filter, fewer outer
    Rayleigh–Ritz rounds.
    spectral_bounds: (min, max) estimate of the FULL spectrum; None
    derives it from ``estimate_eigenvalue_range`` when the operand
    carries one, else from a short power/Lanczos probe.
    """

    degree: int = 20
    tolerance: float | None = None
    max_iterations: int = 100
    seed: int = 0
    compute_eigenvectors: bool = True
    spectral_bounds: tuple[float, float] | None = None


def _qr_orthonormalize(X):
    return jnp.linalg.qr(X)[0]


def as_filter_operator(A) -> LinearOperator:
    """Coerce dense / LinearOperator / sparse-container operands — the
    containers go through ``as_linear_operator()`` so their Gershgorin
    range stays reachable via ``op._params``."""
    if hasattr(A, "as_linear_operator"):
        return A.as_linear_operator()
    return aslinearoperator(A)


@jax.jit
def cholesky_qr2(X):
    """Orthonormalize a tall block by TWO rounds of (shifted) Cholesky QR
    — only (b, b) Grams and right triangular solves touch the column
    dimension, so a row-sharded X stays row-sharded (tall-skinny
    ``jnp.linalg.qr`` would gather the panel to one device).  The second
    round restores orthogonality to working precision for the moderate
    condition numbers a filtered block has after its previous
    orthonormalization; a tiny trace-scaled ridge keeps the first
    Cholesky from failing on near-rank-deficient blocks."""

    def one(X):
        G = jnp.matmul(X.conj().T, X, precision="highest")
        b = G.shape[0]
        eps = jnp.finfo(X.dtype).eps
        ridge = 10.0 * b * eps * (jnp.trace(jnp.real(G)) / b + eps)
        L = jnp.linalg.cholesky(G + ridge * jnp.eye(b, dtype=G.dtype))
        # Q = X · L^{-H}: right-side triangular solve, row-local in X
        return jax.lax.linalg.triangular_solve(
            L.conj().T, X, left_side=False, lower=False
        )

    return one(one(X))


@jax.jit
def _rr_stage(op: LinearOperator, Q):
    """Rayleigh–Ritz on an orthonormal block: H = Qᴴ A Q (+ AQ reused
    for residuals after rotation on host)."""
    AQ = op.matmat(Q)
    H = jnp.matmul(Q.conj().T, AQ.astype(Q.dtype), precision="highest")
    return AQ, H


@jax.jit
def _rotate_stage(Q, AQ, Y, lam):
    """X = Q·Y, R = (AQ)·Y − X·diag(λ), residual norms."""
    X = jnp.matmul(Q, Y, precision="highest")
    R = jnp.matmul(AQ.astype(Q.dtype), Y, precision="highest") - X * lam[None, :]
    rn = jnp.linalg.norm(R, axis=0)
    return X, rn


class ChebyshevFilterSolver:
    """``k`` eigenpairs inside the window [σ_lo, σ_hi] of a Hermitian
    operator by bandpass-filtered subspace iteration.

    Each outer round applies the Jackson-damped Chebyshev BANDPASS
    polynomial of the window (≈1 inside, decaying to ≈0 outside — the
    EVSL/KPM spectrum-slicing filter) to the block, re-orthonormalizes,
    and Rayleigh–Ritz-rotates; in-window Ritz pairs converge at the
    ratio of the filter values just outside vs inside the window, with
    ZERO linear solves — every device op is an ``op.matmat`` SpMM.
    """

    def __init__(
        self,
        operator=None,
        window: tuple[float, float] | None = None,
        options: ChebyshevFilterOptions | None = None,
        *,
        block_size: int = 8,
        initial_block: jax.Array | None = None,
        orthonormalize=None,
    ):
        self.operator = as_filter_operator(operator) if operator is not None else None
        self.window = window
        self.options = options or ChebyshevFilterOptions()
        self.block_size = int(block_size)
        #: start block override (n, block_size) — the mesh front end uses
        #: a padding-supported block so zero-padded rows stay invariant
        self.initial_block = initial_block
        #: orthonormalization X -> Q override; default tall-skinny QR.
        #: The mesh route substitutes CholeskyQR2 (row-local + small
        #: Grams) so the panel never gathers to one device.
        self.orthonormalize = orthonormalize or _qr_orthonormalize
        self.trace = ConvergenceTrace()
        self._result: LanczosResult | None = None

    def _spectral_bounds(self, op):
        o = self.options
        if o.spectral_bounds is not None:
            return float(o.spectral_bounds[0]), float(o.spectral_bounds[1])
        est = getattr(op, "_params", None)
        if est is not None and hasattr(est, "estimate_eigenvalue_range"):
            # sparse-container operand: Gershgorin bounds for free
            # (estimateEigenvalueRange triplets_matrix.hpp:512-540)
            lo, hi = est.estimate_eigenvalue_range()
            return float(lo), float(hi)
        # short power-iteration probe on A and -A: cheap, safe to
        # over-estimate (Gershgorin-grade accuracy is enough)
        n = op.shape[0]
        v = random_matrix(jax.random.PRNGKey(self.options.seed + 7), 1, n, op.dtype).T
        for _ in range(15):
            v = op.matvec(v[:, 0])
            v = (v / jnp.linalg.norm(v))[:, None]
        rq = float(jnp.real(jnp.vdot(v[:, 0], op.matvec(v[:, 0]))))
        nrm = float(jnp.linalg.norm(op.matvec(v[:, 0])))
        # |λ|max ≤ nrm bound both ends; widen by 5% for safety
        lo, hi = -1.05 * max(nrm, abs(rq)), 1.05 * max(nrm, abs(rq))
        return lo, hi

    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = as_filter_operator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        if self.window is None:
            raise LanczosError("no target window set")
        s_lo, s_hi = float(self.window[0]), float(self.window[1])
        if not s_lo < s_hi:
            raise LanczosError(f"window must satisfy lo < hi, got {self.window}")
        o = self.options
        b = self.block_size
        n = op.shape[0]
        if b > n:
            raise LanczosError(f"block size {b} exceeds n={n}")
        dtype = op.dtype
        tol = o.tolerance if o.tolerance is not None else default_tolerance(dtype)
        lam_min, lam_max = self._spectral_bounds(op)
        # margin keeps the window strictly inside the damped complement
        span = lam_max - lam_min
        eps = 1e-12 * max(abs(lam_min), abs(lam_max), 1.0)
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        if self.initial_block is not None:
            if self.initial_block.shape != (n, b):
                raise LanczosError(
                    f"initial_block must be (n, block_size) = ({n}, {b}), "
                    f"got {self.initial_block.shape}"
                )
            X = jnp.asarray(self.initial_block, dtype)
        else:
            X = random_matrix(jax.random.PRNGKey(o.seed), b, n, dtype).T
        lam = np.zeros(b)
        scale = max(abs(lam_min), abs(lam_max), 1.0)
        termination = None
        converged = False
        it = 0
        rn = None
        prev_conv = None
        if s_lo - lam_min <= eps and lam_max - s_hi <= eps:
            raise LanczosError(
                f"window [{s_lo}, {s_hi}] covers the whole estimated "
                f"spectrum [{lam_min}, {lam_max}] — use a direct eigensolver"
            )
        # map the window into the [-1, 1] image of the (slightly widened)
        # spectral range and build the bandpass coefficients once
        lo_m, hi_m = lam_min - 0.005 * span, lam_max + 0.005 * span
        ctr, ext = (hi_m + lo_m) / 2.0, (hi_m - lo_m) / 2.0
        coeffs = _bandpass_coefficients(
            (s_lo - ctr) / ext, (s_hi - ctr) / ext, o.degree
        )

        for it in range(1, o.max_iterations + 1):
            X = chebyshev_bandpass_apply(
                op, X, lo_m, hi_m, coeffs, degree=o.degree
            )
            Q = self.orthonormalize(X)
            AQ, H = _rr_stage(op, Q)
            Hh = np.asarray(H, np.complex128 if jnp.iscomplexobj(H) else np.float64)
            Hh = (Hh + Hh.conj().T) / 2
            if not np.all(np.isfinite(Hh)):
                termination = "numerical_failure"
                self.trace.log(
                    Severity.ERROR,
                    f"iteration {it}: non-finite projected matrix (filter "
                    "overflow — reduce degree or widen bounds)",
                )
                break
            theta, Y = np.linalg.eigh(Hh)
            X, rn = _rotate_stage(Q, AQ, jnp.asarray(Y, Q.dtype), jnp.asarray(theta, real_dtype_of(dtype)))
            lam = theta
            rn_np = np.asarray(rn, np.float64)
            in_win = (theta >= s_lo) & (theta <= s_hi)
            self.trace.record(
                it, theta[in_win], float(rn_np.max()), time.perf_counter() - t0
            )
            # an unconverged BUFFER direction (a mix of eigenvectors from
            # both sides of the window) has a Rayleigh quotient inside the
            # window but a residual of the order of the mixed eigenvalue
            # spread — a GHOST, not a converging pair.  Converged pairs
            # pass the tol test; a still-converging true pair sits in the
            # ambiguous band (tol, √tol]·scale and we keep iterating;
            # residuals far above √tol·scale are ghosts and are excused.
            scalev = scale + np.abs(theta)
            conv_m = in_win & (rn_np <= tol * scalev)
            ambiguous = in_win & ~conv_m & (rn_np <= np.sqrt(tol) * scalev)
            cur = theta[conv_m]
            if (
                cur.size
                and not np.any(ambiguous)
                and prev_conv is not None
                and cur.size == prev_conv.size
                and np.all(np.abs(cur - prev_conv) <= tol * scale)
            ):
                termination = "converged"
                converged = True
                break
            prev_conv = cur
        else:
            termination = "max_iterations"
            self.trace.log(
                Severity.WARN, f"stopped at max_iterations={o.max_iterations}"
            )

        # final selection: in-window pairs that actually converged (the
        # residual filter drops ghosts); on max_iterations fall back to
        # the sub-√tol set so callers still see the best-effort pairs
        rn_np = np.asarray(rn, np.float64) if rn is not None else np.full(b, np.inf)
        scalev = scale + np.abs(lam)
        conv_m = (lam >= s_lo) & (lam <= s_hi) & (rn_np <= tol * scalev)
        if not converged and not np.any(conv_m):
            conv_m = (lam >= s_lo) & (lam <= s_hi) & (rn_np <= np.sqrt(tol) * scalev)
        sel = np.nonzero(conv_m)[0]
        if sel.size == 0:
            self.trace.log(
                Severity.WARN,
                f"no Ritz values inside [{s_lo}, {s_hi}] after {it} "
                "iterations (window may be empty of spectrum)",
            )
            converged = False
        self._result = LanczosResult(
            eigenvalues=lam[sel],
            eigenvectors=(X[:, sel] if o.compute_eigenvectors and sel.size else None),
            iterations=it,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result


def mesh_filter_operand(A, mesh, matvec_mode, spectral_bounds, seed, use_pallas=False):
    """(mesh LinearOperator, orig_n, padded_n, bounds) shared by the
    mesh-aware Chebyshev/KPM front ends: pad the container for the mesh,
    take spectral bounds from the ORIGINAL operator (its Gershgorin if
    available — padding adds eigenvalue 0 but a padding-supported start
    block never touches that invariant subspace), and build the
    global-array shard_map operator for the SpMM chains."""
    from ..parallel.distributed import mesh_operator, pad_bsr_for_mesh
    from ..sparse.bsr import BSRMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    if not isinstance(A, (BSRMatrix, SymBSRMatrix)):
        raise LanczosError(
            "mesh= requires a block-sparse operand (BSRMatrix or "
            "SymBSRMatrix) so the operator's rows can be partitioned"
        )
    orig_n = A.shape[0]
    if spectral_bounds is not None:
        bounds = (float(spectral_bounds[0]), float(spectral_bounds[1]))
    else:
        lo, hi = A.estimate_eigenvalue_range()
        bounds = (float(lo), float(hi))
    axis = mesh.axis_names[0]
    if len(mesh.axis_names) >= 2:
        # 2-axis mesh: panel-grid operator (full-storage BSR only)
        from ..parallel.distributed import mesh_operator_2d

        if isinstance(A, SymBSRMatrix):
            raise LanczosError(
                "2-axis meshes use the panel-grid operator, which needs "
                "full-storage BSR — convert the SymBSRMatrix, or use a "
                "1-axis mesh with matvec_mode='sym_halo'"
            )
        nrc = mesh.shape[axis] * mesh.shape[mesh.axis_names[1]]
        padded = pad_bsr_for_mesh(A, nrc)
        op = mesh_operator_2d(padded, mesh)
        return op, orig_n, padded.shape[0], bounds
    padded = pad_bsr_for_mesh(A, mesh.shape[axis])
    op = mesh_operator(
        padded, mesh, axis_name=axis, matvec_mode=matvec_mode, use_pallas=use_pallas
    )
    return op, orig_n, padded.shape[0], bounds


def _padding_safe_block(orig_n, padded_n, b, dtype, seed):
    X0 = random_matrix(jax.random.PRNGKey(seed), b, orig_n, dtype).T
    if padded_n == orig_n:
        return X0
    return jnp.zeros((padded_n, b), dtype).at[:orig_n].set(X0)


def eigsh_window(
    A,
    window: tuple[float, float],
    *,
    block_size: int = 8,
    degree: int = 20,
    tol: float | None = None,
    max_iterations: int = 100,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    use_pallas: bool | str = False,
) -> LanczosResult:
    """All eigenpairs of a Hermitian operator inside ``window`` (up to
    ``block_size`` of them) by Chebyshev-filtered subspace iteration —
    the solve-free alternative to ``eigsh(sigma=…)`` for interior
    windows.  ``block_size`` should exceed the expected eigenvalue count
    in the window by a few vectors of slack.

    ``mesh``: a ``jax.sharding.Mesh`` runs every SpMM of the filter
    chain row-partitioned over the device mesh (block-sparse operands
    only; ``matvec_mode`` as in the distributed Lanczos drivers) with
    CholeskyQR2 panel orthonormalization — the filter is a pure matmat
    chain, the most mesh-friendly solver in the library.

    An :class:`~eigenex_tpu.sparse.accelerate.AcceleratedOperator`
    operand runs the filter over the permuted block container with a
    padding-safe start block and restores eigenvectors to original
    coordinates (complex Hermitian included: the block is doubled on the
    real embedding and the doubled window contents deduped)."""
    from ..sparse.accelerate import AcceleratedOperator

    if isinstance(A, AcceleratedOperator):
        return _window_on_accelerated(
            A, window, block_size=block_size, degree=degree, tol=tol,
            max_iterations=max_iterations, spectral_bounds=spectral_bounds,
            seed=seed, mesh=mesh, matvec_mode=matvec_mode,
        )
    if mesh is None:
        return ChebyshevFilterSolver(
            A,
            window,
            ChebyshevFilterOptions(
                degree=degree,
                tolerance=tol,
                max_iterations=max_iterations,
                seed=seed,
                spectral_bounds=spectral_bounds,
            ),
            block_size=block_size,
        ).compute()
    op, orig_n, padded_n, bounds = mesh_filter_operand(
        A, mesh, matvec_mode, spectral_bounds, seed, use_pallas
    )
    X0 = _padding_safe_block(orig_n, padded_n, block_size, op.dtype, seed)
    res = ChebyshevFilterSolver(
        op,
        window,
        ChebyshevFilterOptions(
            degree=degree,
            tolerance=tol,
            max_iterations=max_iterations,
            seed=seed,
            spectral_bounds=bounds,
        ),
        block_size=block_size,
        initial_block=X0,
        orthonormalize=cholesky_qr2,
    ).compute()
    if res.eigenvectors is not None and res.eigenvectors.shape[0] != orig_n:
        res.eigenvectors = res.eigenvectors[:orig_n]
    return res


def _window_on_accelerated(
    acc, window, *, block_size, degree, tol, max_iterations, spectral_bounds,
    seed, mesh=None, matvec_mode="allgather",
):
    """eigsh_window driver for an AcceleratedOperator: permuted-space
    filter iteration with a padding-safe start block; eigenvectors
    restored (and the doubled spectrum of a complexified operand
    deduped by value + overlap).

    ``mesh``: the packed container is row-partitioned over the device
    mesh (sym_halo ring for SymBSR storage; multi-axis meshes flatten —
    the round-5 accelerate x mesh composition on the filter path)."""
    import numpy as np

    from ..sparse.accelerate import dedup_embedded_pairs

    mult = 2 if acc.complexified else 1
    dtype = acc.as_linear_operator().dtype
    solver_kwargs = {}
    if mesh is None:
        operand = acc.matrix
        padded_n = acc.shape[0]
    else:
        from ..parallel.distributed import prepare_packed_mesh

        mesh, matvec_mode = prepare_packed_mesh(acc.matrix, mesh, matvec_mode)
        operand, _orig_n, padded_n, bounds = mesh_filter_operand(
            acc.matrix, mesh, matvec_mode, spectral_bounds, seed
        )
        spectral_bounds = bounds
        solver_kwargs = dict(orthonormalize=cholesky_qr2)
    X0 = _padding_safe_block(acc.n_work, padded_n, mult * block_size, dtype, seed)
    # single-device: spectral_bounds=None lets the solver power-probe the
    # bounds (Gershgorin on random operators is far too wide and
    # collapses the filter's selectivity).  The pads' zero eigenvalue may
    # fall outside those bounds, where |T_k| grows — harmless: the
    # padding-safe start block has EXACTLY zero pad components and the
    # structurally-zero pad rows keep them zero through every filter
    # application.
    res = ChebyshevFilterSolver(
        operand,
        window,
        ChebyshevFilterOptions(
            degree=degree,
            tolerance=tol,
            max_iterations=max_iterations,
            seed=seed,
            spectral_bounds=spectral_bounds,
        ),
        block_size=mult * block_size,
        initial_block=X0,
        **solver_kwargs,
    ).compute()
    if res.eigenvectors is not None and res.eigenvectors.shape[0] != acc.shape[0]:
        # mesh padding rows beyond the accelerate pad — slice them off
        res.eigenvectors = res.eigenvectors[: acc.shape[0]]
    lam = np.asarray(res.eigenvalues)
    vecs = (
        acc.restore(np.asarray(res.eigenvectors))
        if res.eigenvectors is not None
        else None
    )
    if acc.complexified and lam.size:
        keep = dedup_embedded_pairs(lam, vecs)
        lam = lam[keep]
        if vecs is not None:
            vecs = vecs[:, keep]
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0), 1e-300)
    res.eigenvalues = lam
    res.eigenvectors = vecs
    return res
