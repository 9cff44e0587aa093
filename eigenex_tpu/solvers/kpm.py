"""Kernel polynomial method (KPM): stochastic spectral density, counts,
and whole-interval eigensolving.

Net-new capability (the reference computes individual eigenpairs only;
its sole spectrum-wide tool is the Gershgorin range,
triplets_matrix.hpp:486-523).  KPM estimates GLOBAL spectral structure
of a Hermitian operator from matvecs alone:

- Chebyshev moments μ_k = tr T_k(t(A)) by Hutchinson stochastic trace
  estimation — on the device this is one three-term SpMM recurrence over a
  block of random probes (``op.matmat`` per degree, matmul path, zero host
  syncs inside the jitted moment loop);
- Jackson-damped moment summation gives the density of states (DOS)
  and eigenvalue COUNTS per interval (``eigenvalue_count``);
- :func:`eigsh_range` combines the two: estimate counts, partition
  [a, b] into slices each holding ≲ block_size eigenvalues, and run the
  Chebyshev bandpass solver (:mod:`eigenex_tpu.solvers.chebyshev`) per
  slice — every eigenpair in an interval, with zero linear solves.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.prng import random_matrix
from ..utils.tolerance import real_dtype_of
from .chebyshev import ChebyshevFilterOptions, ChebyshevFilterSolver, as_filter_operator

__all__ = [
    "chebyshev_moments",
    "spectral_density",
    "eigenvalue_count",
    "eigsh_range",
]


@partial(jax.jit, static_argnames=("n_moments",))
def _moment_recurrence(op: LinearOperator, Z, lam_min, lam_max, n_norm, *, n_moments: int):
    """Hutchinson Chebyshev moments: μ_k = E[zᴴ T_k(t(A)) z] over the
    probe block Z (n, p), with t mapping [lam_min, lam_max] → [-1, 1].
    One fori_loop, two carried blocks — the KPM inner loop.

    ``n_norm``: per-state normalization length.  On a padded mesh
    operand this is the ORIGINAL n — probes are zero on the padding
    rows, so zᴴT_k z is exactly the original operator's trace estimate
    and μ_0 stays 1."""
    c = (lam_max + lam_min) / 2.0
    e = (lam_max - lam_min) / 2.0
    dtype = Z.dtype
    rdt = real_dtype_of(dtype)
    p = Z.shape[1]

    def t_apply(V):
        return (op.matmat(V).astype(dtype) - c * V) / e

    def probe_mean(V):
        # mean over probes of Re⟨z_i, v_i⟩ / n: with unit-modulus probe
        # entries E[zᴴ T_k z] = tr T_k, so this estimates tr T_k / n
        # (μ_0 = 1 exactly)
        return (jnp.mean(jnp.real(jnp.sum(Z.conj() * V, axis=0))) / n_norm).astype(rdt)

    T0 = Z
    T1 = t_apply(Z)
    mu = jnp.zeros(n_moments, rdt)
    mu = mu.at[0].set(probe_mean(T0))
    mu = mu.at[1].set(probe_mean(T1))

    def body(k, carry):
        tkm1, tk, mu = carry
        tkp1 = 2.0 * t_apply(tk) - tkm1
        return tk, tkp1, mu.at[k].set(probe_mean(tkp1))

    _, _, mu = lax.fori_loop(2, n_moments, body, (T0, T1, mu))
    return mu


def _jackson(M: int) -> np.ndarray:
    k = np.arange(M)
    return (
        (M - k + 1) * np.cos(np.pi * k / (M + 1))
        + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))
    ) / (M + 1)


def _bounds_of(op, A, spectral_bounds, seed):
    if spectral_bounds is not None:
        return float(spectral_bounds[0]), float(spectral_bounds[1])
    est = getattr(op, "_params", None)
    if est is not None and hasattr(est, "estimate_eigenvalue_range"):
        lo, hi = est.estimate_eigenvalue_range()
        return float(lo), float(hi)
    if hasattr(A, "estimate_eigenvalue_range"):
        lo, hi = A.estimate_eigenvalue_range()
        return float(lo), float(hi)
    n = op.shape[0]
    v = random_matrix(jax.random.PRNGKey(seed + 11), 1, n, op.dtype).T
    for _ in range(15):
        v = op.matvec(v[:, 0])
        v = (v / jnp.linalg.norm(v))[:, None]
    nrm = float(jnp.linalg.norm(op.matvec(v[:, 0])))
    return -1.05 * nrm, 1.05 * nrm


def chebyshev_moments(
    A,
    n_moments: int = 128,
    *,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    probe_rows: int | None = None,
):
    """(μ (n_moments,), (λ_min, λ_max)) — Jackson-undamped Hutchinson
    Chebyshev moments of the spectral measure of a Hermitian operator,
    normalized per state (μ_0 ≈ 1).

    ``mesh``: run the moment SpMM recurrence row-partitioned over the
    device mesh (block-sparse operands; ``matvec_mode`` as in the
    distributed drivers).  Probes are supported on the ORIGINAL rows,
    so padding added for the mesh never enters the trace estimate."""
    n_true = None
    if mesh is not None:
        from .chebyshev import mesh_filter_operand

        op, n_true, _padded_n, bounds = mesh_filter_operand(
            A, mesh, matvec_mode, spectral_bounds, seed
        )
        spectral_bounds = bounds
    else:
        op = as_filter_operator(A)
    if op.shape[0] != op.shape[1]:
        raise LanczosError("KPM requires a square operator")
    lo, hi = _bounds_of(op, A, spectral_bounds, seed)
    span = hi - lo
    lo_m, hi_m = lo - 0.005 * span, hi + 0.005 * span
    n_rows = op.shape[0] if n_true is None else n_true
    if probe_rows is not None:
        # caller-declared probe support (e.g. an AcceleratedOperator's
        # unpadded working rows): pad rows stay out of the trace
        n_rows = min(n_rows, int(probe_rows))
    Z = random_matrix(jax.random.PRNGKey(seed), n_probes, n_rows, op.dtype).T
    # Rademacher probes have lower Hutchinson variance than Gaussian for
    # real dtypes; keep Gaussian for complex (phases already uniform)
    if not jnp.iscomplexobj(Z):
        Z = jnp.sign(Z) * 1.0
    else:
        Z = Z / jnp.abs(Z)
    if n_rows != op.shape[0]:  # mesh padding: zero probe rows beyond n
        Z = jnp.zeros((op.shape[0], n_probes), op.dtype).at[:n_rows].set(Z)
    mu = _moment_recurrence(
        op, Z, lo_m, hi_m, jnp.asarray(float(n_rows)), n_moments=n_moments
    )
    return np.asarray(mu, np.float64), (lo_m, hi_m)


def spectral_density(
    A,
    n_moments: int = 128,
    *,
    n_probes: int = 16,
    grid: int = 400,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
):
    """(λ grid, DOS estimate ρ(λ)) with ∫ρ ≈ n — the Jackson-damped KPM
    density of states."""
    op = as_filter_operator(A) if mesh is None else None
    n = op.shape[0] if op is not None else A.shape[0]
    mu, (lo, hi) = chebyshev_moments(
        A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
        mesh=mesh, matvec_mode=matvec_mode,
    )
    g = _jackson(n_moments)
    t = np.cos(np.pi * (np.arange(grid) + 0.5) / grid)[::-1]  # Chebyshev nodes
    Tk = np.cos(np.arange(n_moments)[None, :] * np.arccos(t)[:, None])
    w = (mu * g) * np.r_[1.0, 2.0 * np.ones(n_moments - 1)]
    rho_t = (Tk @ w) / (np.pi * np.sqrt(1.0 - t**2))
    ctr, ext = (hi + lo) / 2.0, (hi - lo) / 2.0
    lam_grid = ctr + ext * t
    return lam_grid, n * rho_t / ext


def eigenvalue_count(
    A,
    interval: tuple[float, float],
    n_moments: int = 160,
    *,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    _moments=None,
) -> float:
    """Estimated number of eigenvalues in ``interval`` — the Jackson-
    damped KPM estimate of tr 1_{[a,b]}(A); error scales like
    O(n/(n_moments·√n_probes)) plus the filter transition width."""
    n = A.shape[0] if hasattr(A, "shape") else as_filter_operator(A).shape[0]
    if _moments is not None:
        mu, (lo, hi) = _moments
    else:
        mu, (lo, hi) = chebyshev_moments(
            A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
            mesh=mesh, matvec_mode=matvec_mode,
        )
    n_moments = mu.shape[0]
    ctr, ext = (hi + lo) / 2.0, (hi - lo) / 2.0
    a = np.clip((float(interval[0]) - ctr) / ext, -1.0, 1.0)
    b = np.clip((float(interval[1]) - ctr) / ext, -1.0, 1.0)
    th_a, th_b = np.arccos(a), np.arccos(b)
    k = np.arange(1, n_moments)
    c = np.empty(n_moments)
    c[0] = (th_a - th_b) / np.pi
    c[1:] = 2.0 * (np.sin(k * th_a) - np.sin(k * th_b)) / (k * np.pi)
    g = _jackson(n_moments)
    return float(n * np.sum(mu * g * c))


def eigsh_range(
    A,
    interval: tuple[float, float],
    *,
    block_size: int = 12,
    slack: int = 4,
    degree: int = 60,
    tol: float | None = None,
    max_iterations: int = 300,
    n_moments: int = 160,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
):
    """ALL eigenpairs of a Hermitian operator inside ``interval`` by KPM
    count estimation + Chebyshev bandpass spectrum slicing.

    ``mesh``: every stage (moment SpMMs, per-slice bandpass filtering)
    runs row-partitioned over the device mesh — interior eigenpairs at
    mesh scale with ZERO linear solves (block-sparse operands only).

    The interval is partitioned (by the KPM cumulative count) into
    slices estimated to hold ``block_size − slack`` eigenvalues each;
    each slice runs :class:`ChebyshevFilterSolver` with ``block_size``
    vectors (the slack absorbs count-estimate error).  Returns a
    :class:`~eigenex_tpu.solvers.lanczos.LanczosResult` with all found
    pairs sorted ascending; ``converged`` is the AND over slices.
    """
    from ..sparse.accelerate import AcceleratedOperator

    acc = A if isinstance(A, AcceleratedOperator) else None
    if acc is not None and mesh is not None:
        # round-5 composition on the filter path: moments and per-slice
        # windows run over the mesh-partitioned packed container (the
        # sym_halo ring); multi-axis meshes flatten, band reach validated
        from ..parallel.distributed import prepare_packed_mesh

        mesh, matvec_mode = prepare_packed_mesh(acc.matrix, mesh, matvec_mode)
    if mesh is None and acc is None:
        as_filter_operator(A)  # validates the operand type early
    a, b_hi = float(interval[0]), float(interval[1])
    if not a < b_hi:
        raise LanczosError(f"interval must satisfy a < b, got {interval}")
    if acc is not None:
        import types

        # moments over the block container with probes supported on the
        # unpadded rows (counts then exclude the pads' zero eigenvalues);
        # counts scale by the probe support, not the padded dimension
        mu_pack = chebyshev_moments(
            acc.matrix, n_moments, n_probes=n_probes,
            spectral_bounds=spectral_bounds, seed=seed, probe_rows=acc.n_work,
            mesh=mesh, matvec_mode=matvec_mode,
        )
        count_operand = types.SimpleNamespace(shape=(acc.n_work, acc.n_work))
    else:
        mu_pack = chebyshev_moments(
            A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
            mesh=mesh, matvec_mode=matvec_mode,
        )
        count_operand = A
    lo, hi = mu_pack[1]
    # the real embedding doubles every eigenvalue of H, so raw KPM counts
    # over a complexified operator are 2x the true count; slice sizing
    # uses the corrected total (the per-slice eigsh_window calls dedup
    # their own doubled contents), while the bisection below compares raw
    # counts against raw-count targets so no factor enters there
    cf = 0.5 if (acc is not None and acc.complexified) else 1.0
    total_raw = eigenvalue_count(count_operand, (a, b_hi), _moments=mu_pack)
    total = cf * total_raw
    per = max(block_size - slack, 1)
    n_slices = max(1, int(np.ceil(total / per)))
    # slice boundaries at equal estimated counts (monotone bisection on
    # the KPM cumulative count)
    edges = [a]
    for s in range(1, n_slices):
        target = total_raw * s / n_slices
        x_lo, x_hi = edges[-1], b_hi
        for _ in range(40):
            mid = (x_lo + x_hi) / 2
            if eigenvalue_count(count_operand, (a, mid), _moments=mu_pack) < target:
                x_lo = mid
            else:
                x_hi = mid
        edges.append((x_lo + x_hi) / 2)
    edges.append(b_hi)

    from .lanczos import LanczosResult

    vals, vecs, conv = [], [], True
    iters = 0
    for s in range(n_slices):
        # tiny overlap between slices avoids losing an eigenvalue that
        # sits exactly on a boundary; duplicates are merged below
        w_lo = edges[s] - (0 if s == 0 else 1e-9 * (hi - lo))
        w_hi = edges[s + 1] + (0 if s == n_slices - 1 else 1e-9 * (hi - lo))
        from .chebyshev import eigsh_window

        res = eigsh_window(
            A,
            (w_lo, w_hi),
            block_size=block_size,
            degree=degree,
            tol=tol,
            max_iterations=max_iterations,
            seed=seed + s,
            spectral_bounds=(lo, hi),
            mesh=mesh,
            matvec_mode=matvec_mode,
        )
        conv &= bool(res.converged)
        iters += res.iterations
        if res.eigenvalues.size:
            vals.append(np.asarray(res.eigenvalues))
            if res.eigenvectors is not None:
                vecs.append(np.asarray(res.eigenvectors))
    if vals:
        lam = np.concatenate(vals)
        X = np.concatenate(vecs, axis=1) if vecs else None
        order = np.argsort(lam)
        lam = lam[order]
        X = X[:, order] if X is not None else None
        # merge boundary duplicates (same eigenvalue found by two slices)
        if lam.size > 1:
            scale = max(abs(lo), abs(hi), 1.0)
            keep = np.r_[True, np.diff(lam) > 1e-9 * scale]
            # keep multiplicities: only drop when the vectors are parallel
            for i in np.nonzero(~keep)[0]:
                if X is not None:
                    ov = abs(np.vdot(X[:, i - 1], X[:, i]))
                    if ov < 0.9:
                        keep[i] = True
            lam = lam[keep]
            X = X[:, keep] if X is not None else None
    else:
        lam, X = np.zeros(0), None
    from ..utils.trace import ConvergenceTrace

    return LanczosResult(
        eigenvalues=lam,
        eigenvectors=(jnp.asarray(X) if X is not None else None),
        iterations=iters,
        converged=conv and lam.size > 0,
        termination="converged" if conv and lam.size else "max_iterations",
        trace=ConvergenceTrace(),
    )
