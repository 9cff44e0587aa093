"""One-call eigensolver front ends (scipy.sparse.linalg-style).

Convenience layer that picks the right driver from the problem
statement — the "a user of the reference should find everything they
need" surface for people arriving from scipy/ARPACK:

- :func:`eigsh` — Hermitian: ``which`` in {"SA", "LA"} (smallest/largest
  algebraic), optional ``sigma`` (shift-invert targeting via
  residual-controlled GMRES).  Chooses plain Lanczos when the subspace
  covers the problem, thick-restart otherwise; with ``mesh=`` the
  iteration runs row-partitioned over the device mesh
  (:class:`~eigenex_tpu.parallel.distributed.DistributedThickRestartLanczosEigenSolver`).
- :func:`eigs` — general: ``which`` in {"LM", "SM", "LR", "SR", "LI",
  "SI"} eigenpairs via Krylov–Schur (the restart compression keeps the
  requested end of the spectrum); optional ``sigma`` (GMRES shift-invert
  for interior targets, ``which`` then applying to θ = 1/(λ−σ) as in
  scipy), optional ``mesh=`` (distributed Krylov–Schur).

Both accept dense matrices, ``LinearOperator``s, or the sparse
containers (:class:`~eigenex_tpu.sparse.coo.COOMatrix`,
:class:`~eigenex_tpu.sparse.bsr.BSRMatrix`) directly.  With a COOMatrix
operand, ``refine=True`` polishes the returned pairs on host float64
(shifted inverse iteration — the hybrid-precision path that recovers
the reference's f64-exact extraction, lanczos.hpp:779-817 /
arnoldi.hpp:805-865, from a low-precision device iteration).
"""

from __future__ import annotations

import numpy as np

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import EigenexError
from .gmres import shift_invert_operator_general
from .krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions
from .lanczos import LanczosEigenSolver, LanczosOptions, LanczosResult
from .restart import ThickRestartLanczosEigenSolver, ThickRestartOptions

__all__ = ["eigsh", "eigs", "svds"]


def _resolve_operand(A):
    """(operator, coo_or_None, bsr_or_None) from any accepted operand."""
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    if isinstance(A, COOMatrix):
        return A.as_linear_operator(), A, None
    if isinstance(A, BSRMatrix):
        return A.as_linear_operator(), None, A
    if isinstance(A, SymBSRMatrix):
        return A.as_linear_operator(), None, None
    if isinstance(A, LinearOperator):
        return A, None, None
    return aslinearoperator(A), None, None


def _to_bsr_for_mesh(A, coo, bsr, block_shape):
    """Coerce the operand to a block container for the distributed
    drivers.  A SymBSRMatrix passes through unchanged — the sym_halo
    mode consumes half-traffic storage natively (an accelerate()-packed
    operator rides the mesh this way; restore the eigenvectors with the
    AcceleratedOperator afterwards)."""
    from ..sparse.bsr import bsr_from_coo_arrays
    from ..sparse.sym_bsr import SymBSRMatrix

    if isinstance(A, SymBSRMatrix):
        return A
    if bsr is not None:
        return bsr
    if coo is not None:
        if block_shape is None:
            # SQUARE blocks: rows and cols pad identically, so the padded
            # operator stays square for the Lanczos/Arnoldi drivers
            block_shape = (4, 4)
        return bsr_from_coo_arrays(
            np.asarray(coo.row),
            np.asarray(coo.col),
            np.asarray(coo.val),
            coo.shape,
            block_shape,
        )
    raise EigenexError(
        "mesh= requires a sparse operand (COOMatrix or BSRMatrix) so the "
        "operator's rows can be partitioned over the device mesh"
    )


def eigsh(
    A,
    k: int = 6,
    *,
    which: str = "SA",
    sigma=None,
    M=None,
    preconditioner=None,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 200,
    max_iterations: int = 200,
    seed: int = 0,
    inner_tol: float | None = None,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    refine: bool | int = False,
    v0=None,
    accelerate: bool = False,
    use_pallas: bool | str | None = None,
) -> LanczosResult:
    """k extremal (or σ-targeted) eigenpairs of a Hermitian operator.

    which: "SA" (smallest algebraic), "LA" (largest algebraic), "BE"
    (both ends, k split half/half with the extra pair on the high end),
    "LM" (largest magnitude — both ends tracked, k selected by |λ|), or
    "SM" (smallest magnitude = shift-invert at σ=0, scipy's own
    recipe); ignored when ``sigma`` is given (returns the pairs nearest
    σ).  Results are always in ascending-λ order (scipy convention).
    M: Hermitian positive-definite right-hand operator of the
    GENERALIZED problem ``A x = λ M x`` — routes to the block
    preconditioned LOBPCG driver (:func:`~eigenex_tpu.solvers.lobpcg.lobpcg`),
    optionally with ``preconditioner`` (``T ≈ A⁻¹`` applied blockwise).
    inner_tol: relative-residual target of the MINRES inner solve
    backing ``sigma`` targeting (CG with MINRES/CGLS rescue on the mesh
    route) — the outer eigenvalue error tracks this knob (default: 1e-2
    of the outer tolerance).
    mesh: a ``jax.sharding.Mesh`` routes the iteration to the
    distributed thick-restart driver (sparse operands only).
    refine: with a COOMatrix operand, polish the pairs on host f64.
    v0: initial Krylov vector (scipy parity); original-space for
    accelerated operands.
    accelerate: repack a scalar-sparse operand through
    :func:`eigenex_tpu.sparse.accelerate.accelerate` (RCM reorder +
    dense-block storage and the half-traffic symmetric kernel — the fast
    path for unstructured operators; complex Hermitian included) and
    solve in permuted space, restoring eigenvectors to original
    coordinates.  An
    :class:`~eigenex_tpu.sparse.accelerate.AcceleratedOperator` operand
    takes this route implicitly.
    use_pallas: with ``mesh=`` and ``matvec_mode="sym_halo"``, the
    shard-LOCAL symmetric SpMV: None (default) applies the backend rule
    of :func:`~eigenex_tpu.sparse.sym_bsr.kernel_route` (the GPU kernel
    for f32/bf16 storage on a CUDA device, XLA otherwise), True forces
    the kernel, False XLA, "interpret" runs the kernel in Pallas
    interpret mode (tests only).  The other mesh modes run on XLA.
    """
    from ..sparse.accelerate import AcceleratedOperator
    from ..sparse.coo import COOMatrix as _COO

    orig_operand = A
    if accelerate and not isinstance(A, AcceleratedOperator):
        if M is not None or preconditioner is not None:
            raise EigenexError(
                "accelerate=True cannot combine with M=/preconditioner= "
                "(the LOBPCG route consumes the operand directly)"
            )
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A, symmetric=True)
    if isinstance(A, AcceleratedOperator):
        if mesh is not None:
            return _eigsh_accelerated_mesh(
                A, k, which=which, sigma=sigma, tol=tol,
                max_subspace=max_subspace, max_restarts=max_restarts,
                seed=seed, inner_tol=inner_tol, refine=refine, v0=v0,
                coo=orig_operand if isinstance(orig_operand, _COO) else None,
                mesh=mesh, matvec_mode=matvec_mode, use_pallas=use_pallas,
            )
        return _eigsh_accelerated(
            A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
            max_restarts=max_restarts, max_iterations=max_iterations, seed=seed,
            inner_tol=inner_tol, refine=refine, v0=v0,
            coo=orig_operand if isinstance(orig_operand, _COO) else None,
        )

    op, coo, bsr = _resolve_operand(A)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise EigenexError("eigsh requires a square operator")
    if which not in ("SA", "LA", "BE", "LM", "SM"):
        raise EigenexError(
            f"which must be one of 'SA', 'LA', 'BE', 'LM', 'SM', got {which!r}"
        )
    if which == "SM" and sigma is None:
        # smallest magnitude = pairs nearest 0: reuse the shift-invert
        # machinery with sigma = 0 (scipy/ARPACK's own recommendation)
        sigma = 0.0

    if M is not None or preconditioner is not None:
        if v0 is not None:
            raise EigenexError("v0= is not supported on the LOBPCG (M=/preconditioner=) route")
        if sigma is not None or mesh is not None:
            raise EigenexError(
                "M=/preconditioner= (the LOBPCG route) cannot be combined "
                "with sigma= or mesh="
            )
        if which not in ("SA", "LA"):
            raise EigenexError(
                "the LOBPCG route targets spectrum extremes only: use "
                "which='SA' or 'LA' with M=/preconditioner="
            )
        from .lobpcg import lobpcg

        opM = _resolve_operand(M)[0] if M is not None else None
        res = lobpcg(
            op,
            k,
            B=opM,
            preconditioner=preconditioner,
            largest=(which == "LA"),
            tol=tol,
            max_iterations=max_iterations,
            seed=seed,
        )
        order = np.argsort(np.asarray(res.eigenvalues))  # ascending, as the
        res.eigenvalues = np.asarray(res.eigenvalues)[order]  # Lanczos routes
        if res.eigenvectors is not None:
            res.eigenvectors = res.eigenvectors[:, order]
        return _maybe_refine_hermitian(res, coo, refine)

    if mesh is not None:
        if v0 is not None:
            raise EigenexError("v0= is not supported with mesh= (the drivers build padding-safe starts)")
        if sigma is not None:
            # Distributed shift-invert: every outer Lanczos matvec is a
            # mesh-parallel CG solve of (A − σI) y = x with psum-completed
            # inner products — the BASELINE config-5 pipeline in one call.
            # Interior σ makes the shift indefinite; the inner solve then
            # falls back to mesh-parallel MINRES automatically (checked by
            # true residual), so any σ is fair game.
            from ..parallel.distributed import DistributedShiftInvertLanczosEigenSolver

            if inner_tol is None:
                from ..utils.tolerance import default_tolerance

                outer = tol if tol is not None else default_tolerance(op.dtype)
                inner_tol = max(outer * 1e-2, 1e-14)
            bsr_op = _to_bsr_for_mesh(A, coo, bsr, block_shape)
            m = min(max_subspace or max(4 * k + 16, 32), n)
            kk = min(k, m // 2 - 1) if m // 2 - 1 > 0 else k
            both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
            if len(mesh.axis_names) >= 2:
                # 2-axis mesh: MINRES shift-invert over the R x C panel-
                # grid operator under the single-controller Lanczos (the
                # eigsh 2-axis pattern) — not a silent axis-0 decomposition
                from ..parallel.distributed import (
                    _padding_safe_v0,
                    mesh_operator_2d,
                    pad_bsr_for_mesh,
                )
                from .cg import shift_invert_operator as _si_h

                nrc = mesh.shape[mesh.axis_names[0]] * mesh.shape[mesh.axis_names[1]]
                padded = pad_bsr_for_mesh(bsr_op, nrc)
                op2 = mesh_operator_2d(padded, mesh)
                si2 = _si_h(
                    op2, sigma, tol=inner_tol, solver="minres",
                    max_iters=min(4 * n, 10000),
                )
                solver = LanczosEigenSolver(
                    si2,
                    LanczosOptions(
                        max_eigenvalues=2 * kk, eigenvalue_indices=both_ends,
                        tolerance=tol, max_subspace=m, seed=seed,
                    ),
                )
                if padded.shape[0] != n:
                    solver.set_initial_vector(
                        _padding_safe_v0(n, padded.shape[0], op2.dtype, seed)
                    )
                res = solver.compute()
                if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
                    res.eigenvectors = res.eigenvectors[:n]
                theta = np.asarray(res.eigenvalues)
                nz = np.abs(theta) > 0
                lam_all = np.where(
                    nz, float(np.real(sigma)) + 1.0 / np.where(nz, theta, 1.0), np.inf
                )
                res = _select_nearest_sigma(res, lam_all, sigma, k)
                res = _check_true_residuals(
                    res, op, "eigsh sigma+mesh 2d (MINRES shift-invert)", tol
                )
                return _maybe_refine_hermitian(res, coo, refine)
            res = DistributedShiftInvertLanczosEigenSolver(
                bsr_op,
                mesh,
                LanczosOptions(
                    max_eigenvalues=2 * kk, eigenvalue_indices=both_ends,
                    tolerance=tol, max_subspace=m, seed=seed,
                ),
                axis_name=mesh.axis_names[0],
                matvec_mode=matvec_mode,
                use_pallas=use_pallas,
                sigma=float(np.real(sigma)),
                cg_tol=inner_tol,
            ).compute()
            if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
                res.eigenvectors = res.eigenvectors[:n]
            lam_all = np.asarray(res.eigenvalues)
            res = _select_nearest_sigma(res, lam_all, sigma, k)
            res = _check_true_residuals(res, op, "eigsh sigma+mesh (CG/MINRES shift-invert)", tol)
            return _maybe_refine_hermitian(res, coo, refine)
        from ..parallel.distributed import DistributedThickRestartLanczosEigenSolver
        from ..sparse.sym_bsr import SymBSRMatrix as _Sym

        bsr_op = _to_bsr_for_mesh(A, coo, bsr, block_shape)
        if isinstance(bsr_op, _Sym):
            if matvec_mode == "allgather":
                # half-traffic storage has exactly one mesh mode
                matvec_mode = "sym_halo"
            elif matvec_mode != "sym_halo":
                raise EigenexError(
                    "a SymBSRMatrix operand supports matvec_mode='sym_halo' only"
                )
        indices, n_track, lm_post = _which_indices(which, k)
        m = min(max_subspace or max(6 * n_track + 32, 64), n)
        axis_name = mesh.axis_names[0]
        if len(mesh.axis_names) >= 2:
            # 2-axis mesh: panel-grid operator (n/C + n/R wire per
            # matvec) under the single-controller thick-restart driver
            from ..parallel.distributed import (
                _padding_safe_v0,
                mesh_operator_2d,
                pad_bsr_for_mesh,
            )

            nrc = mesh.shape[axis_name] * mesh.shape[mesh.axis_names[1]]
            padded = pad_bsr_for_mesh(bsr_op, nrc)
            op2 = mesh_operator_2d(padded, mesh)
            solver = ThickRestartLanczosEigenSolver(
                op2,
                ThickRestartOptions(
                    max_eigenvalues=n_track, eigenvalue_indices=indices,
                    tolerance=tol, max_subspace=m, max_restarts=max_restarts,
                    seed=seed,
                ),
            )
            if padded.shape[0] != n:
                solver.set_initial_vector(
                    _padding_safe_v0(n, padded.shape[0], op2.dtype, seed)
                )
            res = solver.compute()
            if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
                res.eigenvectors = res.eigenvectors[:n]
            if lm_post:
                res = _postselect_lm(res, k)
            return _maybe_refine_hermitian(res, coo, refine)
        res = DistributedThickRestartLanczosEigenSolver(
            bsr_op,
            mesh,
            ThickRestartOptions(
                max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
            ),
            axis_name=axis_name,
            matvec_mode=matvec_mode,
            use_pallas=use_pallas,
        ).compute()
        if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
            # BSR conversion may have padded the operand before the mesh
            # padding the driver already undoes — slice to the true n
            res.eigenvectors = res.eigenvectors[:n]
        if lm_post:
            res = _postselect_lm(res, k)
        return _maybe_refine_hermitian(res, coo, refine)

    if sigma is not None:
        # Shift-invert: pairs nearest σ have the LARGEST |θ| of
        # (A − σI)⁻¹ — θ can be large positive (λ just above σ) or large
        # negative (λ just below σ), so track BOTH spectral ends and pick
        # by |θ|.  The inner solve is MINRES: for a HERMITIAN shift it
        # strictly dominates restarted GMRES (short recurrence, no
        # restart stagnation, no basis storage) and handles the
        # indefinite (A − σI) that any interior σ produces (CG does not).
        if inner_tol is None:
            from ..utils.tolerance import default_tolerance

            outer = tol if tol is not None else default_tolerance(op.dtype)
            inner_tol = max(outer * 1e-2, 1e-14)
        from .cg import shift_invert_operator as _si_hermitian

        si = _si_hermitian(
            op, sigma, tol=inner_tol, solver="minres", max_iters=min(4 * n, 10000)
        )
        m = min(max_subspace or max(4 * k + 16, 32), n)
        kk = min(k, m // 2 - 1) if m // 2 - 1 > 0 else k
        both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
        si_solver = LanczosEigenSolver(
            si,
            LanczosOptions(
                max_eigenvalues=2 * kk,
                eigenvalue_indices=both_ends,
                tolerance=tol,
                max_subspace=m,
                seed=seed,
            ),
        )
        if v0 is not None:
            si_solver.set_initial_vector(v0)
        res = si_solver.compute()
        theta = np.asarray(res.eigenvalues)
        nonzero = np.abs(theta) > 0
        lam_all = np.where(nonzero, float(np.real(sigma)) + 1.0 / np.where(nonzero, theta, 1.0), np.inf)
        res = _select_nearest_sigma(res, lam_all, sigma, k)
        res = _check_true_residuals(res, op, "eigsh sigma (MINRES shift-invert)", tol)
        return _maybe_refine_hermitian(res, coo, refine)

    indices, n_track, lm_post = _which_indices(which, k)
    m = min(max_subspace or max(6 * n_track + 32, 64), n)
    if m >= n:
        # full subspace available: plain Lanczos terminates exactly
        solver = LanczosEigenSolver(
            op,
            LanczosOptions(
                max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=n, seed=seed,
            ),
        )
    else:
        solver = ThickRestartLanczosEigenSolver(
            op,
            ThickRestartOptions(
                max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
            ),
        )
    if v0 is not None:
        solver.set_initial_vector(v0)
    res = solver.compute()
    if lm_post:
        res = _postselect_lm(res, k)
    return _maybe_refine_hermitian(res, coo, refine)


def _which_indices(which: str, k: int):
    """(tracked Ritz indices, tracked count, lm_postselect) for the
    Hermitian ``which`` modes.  BE splits k over both ends (extra pair to
    the high end on odd k, scipy convention); LM tracks k from each end
    and post-selects by |λ|."""
    if which == "SA":
        return tuple(range(k)), k, False
    if which == "LA":
        return tuple(range(-k, 0)), k, False
    if which == "BE":
        kl = k // 2
        return tuple(range(kl)) + tuple(range(-(k - kl), 0)), k, False
    return tuple(range(k)) + tuple(range(-k, 0)), 2 * k, True  # LM


def _postselect_lm(res: LanczosResult, k: int) -> LanczosResult:
    """Keep the k largest-|λ| pairs of the both-ends tracked set,
    returned in ascending order (scipy eigsh convention)."""
    lam = np.asarray(res.eigenvalues)
    pick = np.argsort(-np.abs(lam), kind="stable")[:k]
    order = pick[np.argsort(lam[pick])]
    vecs = res.eigenvectors[:, order] if res.eigenvectors is not None else None
    return LanczosResult(
        eigenvalues=lam[order],
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _select_nearest_sigma(res: LanczosResult, lam_all, sigma, k: int) -> LanczosResult:
    """Keep the k pairs nearest σ (ascending λ order), dropping the rest
    of the tracked both-ends Ritz set."""
    pick = np.argsort(np.abs(lam_all - float(np.real(sigma))))[:k]
    order = pick[np.argsort(lam_all[pick])]
    vecs = res.eigenvectors[:, order] if res.eigenvectors is not None else None
    return LanczosResult(
        eigenvalues=lam_all[order],
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _maybe_refine_hermitian(res: LanczosResult, coo, refine) -> LanczosResult:
    if not refine:
        return res
    if coo is None:
        raise EigenexError("refine=True requires a COOMatrix operand")
    if res.eigenvectors is None:
        raise EigenexError("refine=True requires computed eigenvectors")
    from .refine import inverse_iteration_refine

    iters = int(refine) if not isinstance(refine, bool) else 2
    lam, X, _ = inverse_iteration_refine(
        coo, np.asarray(res.eigenvectors), res.eigenvalues, iters=iters
    )
    order = np.argsort(lam)
    return LanczosResult(
        eigenvalues=lam[order],
        eigenvectors=X[:, order],
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _eigsh_accelerated(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, max_iterations,
    seed, inner_tol, refine, v0, coo,
) -> LanczosResult:
    """eigsh driver for an :class:`AcceleratedOperator`: solve over the
    permuted+padded block container, restore eigenvectors to original
    coordinates, and (for complexified operands) collapse the doubled
    spectrum of the real embedding.

    The start vector is always padding-safe (zero in the structurally-
    zero pad rows), so the Krylov space never leaves the embedded
    subspace and no spurious pad eigenvalues enter the tracked set."""
    from ..parallel.distributed import _padding_safe_v0

    if v0 is not None:
        v0e = acc.embed(np.asarray(v0))
    else:
        v0e = _padding_safe_v0(
            acc.n_work, acc.shape[0], acc.as_linear_operator().dtype, seed
        )
    # complexified: every eigenvalue of H appears (up to) twice in the
    # real embedding — track 2k and dedup after restoring
    mult = 2 if acc.complexified else 1
    res = eigsh(
        acc.matrix, mult * k, which=which, sigma=sigma, tol=tol,
        max_subspace=max_subspace, max_restarts=max_restarts,
        max_iterations=max_iterations, seed=seed, inner_tol=inner_tol, v0=v0e,
    )
    return _restore_accelerated(res, acc, k, refine, coo)


def _restore_accelerated(res, acc, k, refine, coo) -> LanczosResult:
    """Shared tail of the accelerated eigsh routes: restore eigenvectors
    through the permutation, collapse the doubled spectrum of a
    complexified operand, optionally refine on the original COO.

    Pairs need not both converge (a clean Krylov space holds ONE vector
    per 2-D embedded eigenspace; duplicates enter only via restarts/
    rounding), so dedup goes by value-closeness AND vector overlap
    rather than blindly taking every other entry.  Any unit real vector
    q = α[Re v, Im v] + β[−Im v, Re v] restores to the valid unit
    complex eigenvector (α+iβ)v, so one representative per group
    suffices."""
    lam = np.asarray(res.eigenvalues)
    vecs = (
        acc.restore(np.asarray(res.eigenvectors))
        if res.eigenvectors is not None
        else None
    )
    if acc.complexified:
        from ..sparse.accelerate import dedup_embedded_pairs

        keep = dedup_embedded_pairs(lam, vecs, keep_max=k)
        lam = lam[keep]
        if vecs is not None:
            vecs = vecs[:, keep]
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0), 1e-300)
    res2 = LanczosResult(
        eigenvalues=lam,
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )
    if refine:
        return _maybe_refine_hermitian(res2, coo, refine)
    return res2


def _eigsh_accelerated_mesh(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo, mesh, matvec_mode, use_pallas=None,
) -> LanczosResult:
    """eigsh for an :class:`AcceleratedOperator` UNDER a device mesh —
    the one-call composition of the two flagship capabilities: RCM +
    half-traffic block pack (``accelerate=``) and row-partitioned
    iteration (``mesh=``), the bridge to operators that exceed one
    chip's HBM (BASELINE config 5).

    The packed :class:`~eigenex_tpu.sparse.sym_bsr.SymBSRMatrix` is
    row-partitioned via the ``sym_halo`` ppermute ring (half-traffic
    storage has exactly one mesh mode); a multi-axis mesh is flattened
    over all its devices (the ring is a 1-axis row partition).  The
    start vector is zero on BOTH padding kinds (accelerate's block pad
    and the mesh row pad), so the Krylov space never leaves the
    embedded subspace; eigenvectors restore through the permutation as
    on the single-device route."""
    import jax.numpy as jnp

    from ..parallel.distributed import (
        DistributedShiftInvertLanczosEigenSolver,
        DistributedThickRestartLanczosEigenSolver,
        _padding_safe_v0,
        prepare_packed_mesh,
    )

    mat = acc.matrix
    mesh, matvec_mode = prepare_packed_mesh(mat, mesh, matvec_mode)
    axis = mesh.axis_names[0]
    if which == "SM" and sigma is None:
        sigma = 0.0
    mult = 2 if acc.complexified else 1
    n_work = acc.n_work
    dtype = acc.as_linear_operator().dtype

    def _start_vector(padded_n: int):
        if v0 is not None:
            v0e = acc.embed(np.asarray(v0))
            if padded_n != v0e.shape[0]:
                v0e = jnp.zeros((padded_n,), v0e.dtype).at[: v0e.shape[0]].set(v0e)
            return v0e
        return _padding_safe_v0(n_work, padded_n, dtype, seed)

    if sigma is not None:
        if inner_tol is None:
            from ..utils.tolerance import default_tolerance

            outer = tol if tol is not None else default_tolerance(dtype)
            inner_tol = max(outer * 1e-2, 1e-14)
        m = min(max_subspace or max(4 * mult * k + 16, 32), n_work)
        kk = min(mult * k, m // 2 - 1) if m // 2 - 1 > 0 else mult * k
        both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
        solver = DistributedShiftInvertLanczosEigenSolver(
            mat,
            mesh,
            LanczosOptions(
                max_eigenvalues=2 * kk, eigenvalue_indices=both_ends,
                tolerance=tol, max_subspace=m, seed=seed,
            ),
            axis_name=axis,
            matvec_mode=matvec_mode,
            use_pallas=use_pallas,
            sigma=float(np.real(sigma)),
            cg_tol=inner_tol,
        )
        solver.set_initial_vector(_start_vector(solver.bsr.shape[0]))
        res = solver.compute()
        lam_all = np.asarray(res.eigenvalues)
        res = _select_nearest_sigma(res, lam_all, sigma, mult * k)
        res = _check_true_residuals(
            res, acc.as_linear_operator(), "eigsh accelerate+mesh sigma", tol
        )
        return _restore_accelerated(res, acc, k, refine, coo)

    indices, n_track, lm_post = _which_indices(which, mult * k)
    m = min(max_subspace or max(6 * n_track + 32, 64), n_work)
    solver = DistributedThickRestartLanczosEigenSolver(
        mat,
        mesh,
        ThickRestartOptions(
            max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
            max_subspace=m, max_restarts=max_restarts, seed=seed,
        ),
        axis_name=axis,
        matvec_mode=matvec_mode,
        use_pallas=use_pallas,
    )
    solver.set_initial_vector(_start_vector(solver.bsr.shape[0]))
    res = solver.compute()
    if lm_post:
        res = _postselect_lm(res, mult * k)
    return _restore_accelerated(res, acc, k, refine, coo)


def eigs(
    A,
    k: int = 6,
    *,
    which: str = "LM",
    sigma=None,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 100,
    seed: int = 0,
    inner_tol: float | None = None,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    refine: bool | int = False,
    v0=None,
    accelerate: bool = False,
):
    """k eigenpairs of a general operator, selected by ``which``.

    which: scipy ``eigs`` convention — "LM" (largest magnitude, the
    default), "SM", "LR"/"SR" (real part), "LI"/"SI" (imaginary part).
    With ``sigma`` the selection applies to the shift-inverted spectrum
    θ = 1/(λ−σ), matching scipy: the default "LM" means nearest-σ pairs.
    mesh: a ``jax.sharding.Mesh`` routes the iteration to the
    distributed Krylov–Schur driver (sparse operands only).
    inner_tol: GMRES target for ``sigma`` shift-invert (default: 1e-2 of
    the outer tolerance).  refine: with a COOMatrix operand, polish the
    returned pairs with f64 complex inverse iteration
    (:func:`~eigenex_tpu.solvers.refine.general_inverse_iteration_refine`).
    v0: initial Krylov vector (scipy parity; original-space for
    accelerated operands).  accelerate: repack a scalar-sparse operand
    through the RCM + block pipeline
    (:func:`eigenex_tpu.sparse.accelerate.accelerate`) and solve in
    permuted space.  COMPLEX general operators ride the same fast path
    through the real embedding [[A,−B],[B,A]] (a real general operator
    on the block kernels — reference flagship class,
    arnoldi.hpp:472-501/sample_lanczos2.cpp): the doubled spectrum
    {λ}∪{λ̄} is reconstructed and deduped on restore, as in
    :func:`eigenex_tpu.sparse.realify.eigs_realified` but at block-kernel
    speed; ``sigma`` must be real on this route (the embedding is real).
    """
    from ..sparse.accelerate import AcceleratedOperator
    from ..sparse.coo import COOMatrix as _COO

    orig_operand = A
    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A)
    if isinstance(A, AcceleratedOperator):
        if A.complexified:
            if mesh is not None:
                raise EigenexError(
                    "eigs: a complexified accelerated operand cannot combine "
                    "with mesh= yet — run the real-embedding reconstruction "
                    "single-device, or shard the packed container manually"
                )
            return _eigs_accelerated_complex(
                A, k, which=which, sigma=sigma, tol=tol,
                max_subspace=max_subspace, max_restarts=max_restarts,
                seed=seed, inner_tol=inner_tol, refine=refine, v0=v0,
                coo=orig_operand if isinstance(orig_operand, _COO) else None,
            )
        return _eigs_accelerated(
            A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
            max_restarts=max_restarts, seed=seed, inner_tol=inner_tol,
            refine=refine, v0=v0,
            coo=orig_operand if isinstance(orig_operand, _COO) else None,
            mesh=mesh, matvec_mode=matvec_mode,
        )

    op, coo, bsr = _resolve_operand(A)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise EigenexError("eigs requires a square operator")
    if which not in ("LM", "SM", "LR", "SR", "LI", "SI"):
        raise EigenexError(
            f"which must be one of 'LM','SM','LR','SR','LI','SI', got {which!r}"
        )
    m = min(max_subspace or max(4 * k + 24, 48), n)

    if mesh is not None:
        if v0 is not None:
            raise EigenexError(
                "v0= is not supported with mesh= (the drivers build "
                "padding-safe starts)"
            )
        if sigma is not None:
            # Distributed GMRES shift-invert: the mesh operator makes
            # (A − σI)⁻¹-via-GMRES a global-array operator whose every
            # matvec runs shard_map'd over the mesh; the Krylov–Schur
            # controller stays single-host on replicated small state.
            from ..parallel.distributed import mesh_operator, pad_bsr_for_mesh
            from ..parallel.distributed import _padding_safe_v0

            if inner_tol is None:
                from ..utils.tolerance import default_tolerance

                outer = tol if tol is not None else default_tolerance(op.dtype)
                inner_tol = max(outer * 1e-2, 1e-14)
            bsr_op = _to_bsr_for_mesh(A, coo, bsr, block_shape)
            axis = mesh.axis_names[0]
            if len(mesh.axis_names) >= 2:
                # 2-axis mesh: R x C panel-grid operator (n/C + n/R wire
                # per matvec) instead of silently decomposing over axis 0
                from ..parallel.distributed import mesh_operator_2d

                nrc = mesh.shape[axis] * mesh.shape[mesh.axis_names[1]]
                padded = pad_bsr_for_mesh(bsr_op, nrc)
                mop = mesh_operator_2d(padded, mesh)
            else:
                padded = pad_bsr_for_mesh(bsr_op, mesh.shape[axis])
                mop = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
            si = shift_invert_operator_general(mop, sigma, tol=inner_tol)
            solver = KrylovSchurArnoldiSolver(
                si,
                KrylovSchurOptions(
                    max_eigenvalues=k, tolerance=tol, max_subspace=m,
                    max_restarts=max_restarts, seed=seed, which=which,
                ),
            )
            if padded.shape[0] != n:
                # padding adds eigenvalue -1/sigma to the SI operator; a
                # padding-supported v0 would chase that ghost
                solver.set_initial_vector(
                    _padding_safe_v0(n, padded.shape[0], mop.dtype, seed)
                )
            res = solver.compute()
            # θ already which-ordered by the solver (scipy: which applies
            # to the transformed spectrum); back-transform in place
            res.eigenvalues = complex(sigma) + 1.0 / res.eigenvalues
            if res.eigenvectors is not None:
                res.eigenvectors = res.eigenvectors[:n]
            res = _check_true_residuals(res, op, "eigs sigma+mesh (GMRES shift-invert)", tol)
            return _maybe_refine_general(res, coo, refine, which, sigma)
        bsr_op = _to_bsr_for_mesh(A, coo, bsr, block_shape)
        if len(mesh.axis_names) >= 2:
            # 2-axis mesh: single-controller Krylov-Schur over the R x C
            # panel-grid operator (the eigsh 2-axis pattern)
            from ..parallel.distributed import (
                _padding_safe_v0,
                mesh_operator_2d,
                pad_bsr_for_mesh,
            )

            nrc = mesh.shape[mesh.axis_names[0]] * mesh.shape[mesh.axis_names[1]]
            padded = pad_bsr_for_mesh(bsr_op, nrc)
            op2 = mesh_operator_2d(padded, mesh)
            solver = KrylovSchurArnoldiSolver(
                op2,
                KrylovSchurOptions(
                    max_eigenvalues=k, tolerance=tol, max_subspace=m,
                    max_restarts=max_restarts, seed=seed, which=which,
                ),
            )
            if padded.shape[0] != n:
                solver.set_initial_vector(
                    _padding_safe_v0(n, padded.shape[0], op2.dtype, seed)
                )
            res = solver.compute()
        else:
            from ..parallel.distributed import DistributedKrylovSchurArnoldiSolver

            res = DistributedKrylovSchurArnoldiSolver(
                bsr_op,
                mesh,
                KrylovSchurOptions(
                    max_eigenvalues=k, tolerance=tol, max_subspace=m,
                    max_restarts=max_restarts, seed=seed, which=which,
                ),
                axis_name=mesh.axis_names[0],
                matvec_mode=matvec_mode,
            ).compute()
        if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
            res.eigenvectors = res.eigenvectors[:n]
        return _maybe_refine_general(res, coo, refine, which)

    if sigma is not None:
        if inner_tol is None:
            from ..utils.tolerance import default_tolerance

            outer = tol if tol is not None else default_tolerance(op.dtype)
            inner_tol = max(outer * 1e-2, 1e-14)
        si = shift_invert_operator_general(op, sigma, tol=inner_tol)
        ks = KrylovSchurArnoldiSolver(
            si,
            KrylovSchurOptions(
                max_eigenvalues=k, tolerance=tol, max_subspace=m,
                max_restarts=max_restarts, seed=seed, which=which,
            ),
        )
        if v0 is not None:
            ks.set_initial_vector(v0)
        res = ks.compute()
        # θ already which-ordered by the solver (scipy: which applies to
        # the transformed spectrum θ = 1/(λ−σ)); back-transform in place
        res.eigenvalues = complex(sigma) + 1.0 / res.eigenvalues
        res = _check_true_residuals(res, op, "eigs sigma (GMRES shift-invert)", tol)
        return _maybe_refine_general(res, coo, refine, which, sigma)
    ks = KrylovSchurArnoldiSolver(
        op,
        KrylovSchurOptions(
            max_eigenvalues=k, tolerance=tol, max_subspace=m,
            max_restarts=max_restarts, seed=seed, which=which,
        ),
    )
    if v0 is not None:
        ks.set_initial_vector(v0)
    res = ks.compute()
    return _maybe_refine_general(res, coo, refine, which)


def _maybe_refine_general(res, coo, refine, which: str | None = None, sigma=None):
    """Refinement must not discard the route's ordering semantics: on
    the sigma paths ``which`` applies to θ = 1/(λ−σ) (scipy), so the
    refined pairs are re-sorted by the same transformed key — defaulting
    to LM on λ would silently reorder a nearest-σ result (ADVICE r3)."""
    if not refine:
        return res
    if coo is None:
        raise EigenexError("refine=True requires a COOMatrix operand")
    if res.eigenvectors is None:
        raise EigenexError("refine=True requires computed eigenvectors")
    from .refine import general_inverse_iteration_refine
    from .krylov_schur import _which_key

    iters = int(refine) if not isinstance(refine, bool) else 100
    lam, X, _ = general_inverse_iteration_refine(
        coo, np.asarray(res.eigenvectors), np.asarray(res.eigenvalues), iters=iters
    )
    if sigma is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            key_vals = 1.0 / (lam - complex(sigma))
    else:
        key_vals = lam
    order = np.argsort(_which_key(key_vals, which or "LM"), kind="stable")
    res.eigenvalues = lam[order]
    res.eigenvectors = X[:, order]
    return res


def _eigs_accelerated(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo, mesh=None, matvec_mode="allgather",
):
    """eigs driver for a (real) :class:`AcceleratedOperator`: solve over
    the permuted+padded block container with a padding-safe start,
    restore eigenvectors to original coordinates.

    ``mesh``: the packed GENERAL container rides the distributed
    Krylov–Schur driver (allgather/halo/colsplit row partitions); a
    packed SYMMETRIC container uses the sym_halo ring.  Multi-axis
    meshes flatten (one row axis is the partition)."""
    from ..parallel.distributed import _padding_safe_v0

    if mesh is not None:
        from ..parallel.distributed import (
            DistributedKrylovSchurArnoldiSolver,
            prepare_packed_mesh,
        )

        if sigma is not None:
            raise EigenexError(
                "eigs: accelerate= with mesh= supports sigma=None for now "
                "(shift-invert over the packed mesh container: use eigsh "
                "for Hermitian operators, or the manual mesh_operator route)"
            )
        mesh, matvec_mode = prepare_packed_mesh(acc.matrix, mesh, matvec_mode)
        m = min(max_subspace or max(4 * k + 24, 48), acc.n_work)
        solver = DistributedKrylovSchurArnoldiSolver(
            acc.matrix,
            mesh,
            KrylovSchurOptions(
                max_eigenvalues=k, tolerance=tol, max_subspace=m,
                max_restarts=max_restarts, seed=seed, which=which,
            ),
            axis_name=mesh.axis_names[0],
            matvec_mode=matvec_mode,
        )
        if v0 is not None:
            v0e = acc.embed(np.asarray(v0))
            if solver.bsr.shape[0] != v0e.shape[0]:
                import jax.numpy as jnp

                v0e = jnp.zeros((solver.bsr.shape[0],), v0e.dtype).at[
                    : v0e.shape[0]
                ].set(v0e)
        else:
            v0e = _padding_safe_v0(
                acc.n_work, solver.bsr.shape[0],
                acc.as_linear_operator().dtype, seed,
            )
        solver.set_initial_vector(v0e)
        res = solver.compute()
        if res.eigenvectors is not None:
            res.eigenvectors = acc.restore(np.asarray(res.eigenvectors))
        if refine:
            return _maybe_refine_general(res, coo, refine, which, sigma)
        return res

    if v0 is not None:
        v0e = acc.embed(np.asarray(v0))
    else:
        v0e = _padding_safe_v0(
            acc.n_work, acc.shape[0], acc.as_linear_operator().dtype, seed
        )
    res = eigs(
        acc.matrix, k, which=which, sigma=sigma, tol=tol,
        max_subspace=max_subspace, max_restarts=max_restarts, seed=seed,
        inner_tol=inner_tol, v0=v0e,
    )
    if res.eigenvectors is not None:
        res.eigenvectors = acc.restore(np.asarray(res.eigenvectors))
    if refine:
        return _maybe_refine_general(res, coo, refine, which, sigma)
    return res


def _eigs_accelerated_complex(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo,
):
    """eigs for a COMPLEXIFIED (complex general) AcceleratedOperator.

    The packed container is the real embedding [[A,−B],[B,A]], whose
    spectrum is {λ}∪{λ̄}.  Krylov–Schur runs in real arithmetic on the
    block kernels; each computed pair (θ, q) reconstructs the genuine
    A-pair as z = q_top + i·q_bot (norm ≈ √2·|c| for a genuine pair, ≈ 0
    for a mirror pair, whose A-pair is instead (θ̄, conj reconstruction))
    — the :func:`~eigenex_tpu.sparse.realify.eigs_realified` recipe
    lifted onto the accelerated path (reference: arnoldi.hpp:472-501).
    2k pairs are tracked so A's k best under ``which`` are guaranteed
    present among the embedded 2k (the conj mirrors can shadow at most k
    slots)."""
    from ..parallel.distributed import _padding_safe_v0
    from .krylov_schur import _which_key

    if sigma is not None and abs(complex(sigma).imag) > 0:
        raise EigenexError(
            "eigs(accelerate=True) on a complex operator supports REAL "
            "sigma only (the iteration runs on the real embedding); for "
            "complex shifts use the scalar eigs_realified path"
        )
    n = acc.orig_shape[0]
    if v0 is not None:
        v0e = acc.embed(np.asarray(v0))
    else:
        v0e = _padding_safe_v0(
            acc.n_work, acc.shape[0], acc.as_linear_operator().dtype, seed
        )
    res = eigs(
        acc.matrix, min(2 * k, max(acc.n_work - 2, 1)), which=which,
        sigma=sigma, tol=tol, max_subspace=max_subspace,
        max_restarts=max_restarts, seed=seed, inner_tol=inner_tol, v0=v0e,
    )
    theta = np.asarray(res.eigenvalues, np.complex128)
    if res.eigenvectors is None:
        raise EigenexError("complexified eigs needs eigenvectors to split the embedding")
    Q = np.asarray(res.eigenvectors, np.complex128)  # (n_pad, p)

    op = acc.as_linear_operator()

    def apply_A(z):
        """A·z for complex z through the packed REAL embedding (embed
        realifies + permutes + pads; restore reassembles complex)."""
        return acc.restore(np.asarray(op.matvec(acc.embed(z))))

    cands = []
    for j in range(Q.shape[1]):
        for lam, q in ((complex(theta[j]), Q[:, j]),
                       (np.conj(complex(theta[j])), np.conj(Q[:, j]))):
            z = acc.restore(q)  # q_top + i q_bot through the permutation
            nz = np.linalg.norm(z)
            if nz < 0.3:  # mirror pair: no A-component (genuine ≈ √2)
                continue
            z = z / nz
            r = float(np.linalg.norm(apply_A(z) - lam * z))
            cands.append((lam, z, r))
    cands.sort(key=lambda t: t[2])  # cleanest representative survives dedup
    scale = max((abs(c[0]) for c in cands), default=1.0)
    close = max(tol if tol is not None else 0.0, 1e-6) * max(scale, 1.0)
    kept: list[tuple] = []
    for lam, z, r in cands:
        dup = any(
            abs(lam - lk) <= close and abs(np.vdot(zk, z)) > 0.9
            for lk, zk, _ in kept
        )
        if not dup:
            kept.append((lam, z, r))
    lam_all = np.array([t[0] for t in kept], np.complex128)
    if sigma is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            keyv = 1.0 / (lam_all - complex(sigma))
    else:
        keyv = lam_all
    order = np.argsort(_which_key(keyv, which), kind="stable")[:k]
    res.eigenvalues = lam_all[order]
    res.eigenvectors = (
        np.stack([kept[i][1] for i in order], axis=1)
        if len(order)
        else np.zeros((n, 0), np.complex128)
    )
    if refine:
        return _maybe_refine_general(res, coo, refine, which, sigma)
    return res


def _check_true_residuals(res, op, label: str, user_tol: float | None = None):
    """Post-hoc honesty check for the shift-invert routes: measure the
    true eigenpair residuals ‖A v − λ v‖ on the ORIGINAL operator.

    A silently failed inner solve (CG on an indefinite shift, stagnated
    restarted GMRES) makes the outer iteration converge cleanly to
    eigenpairs of the wrong operator; the residual on A is the only
    signal.  The solvers now carry MINRES/CGLS fallbacks that should prevent
    this, but the check is cheap (k matvecs) and turns any remaining
    failure into ``converged=False`` + an ERROR trace instead of wrong
    numbers."""
    import jax.numpy as jnp

    from ..utils.tolerance import default_tolerance
    from ..utils.trace import Severity

    if res.eigenvectors is None:
        return res
    lam = np.asarray(res.eigenvalues)
    if lam.size == 0 or not np.all(np.isfinite(lam)):
        return res
    V = jnp.asarray(res.eigenvectors)
    if jnp.iscomplexobj(V) and not jnp.issubdtype(jnp.dtype(op.dtype), jnp.complexfloating):
        AV = (
            np.asarray(op.matmat(jnp.real(V).astype(op.dtype))).astype(np.complex128)
            + 1j * np.asarray(op.matmat(jnp.imag(V).astype(op.dtype))).astype(np.complex128)
        )
    else:
        AV = np.asarray(op.matmat(V.astype(op.dtype)))
    Vn = np.asarray(V)
    resid = np.linalg.norm(AV - Vn * lam[None, :], axis=0) / np.maximum(
        np.linalg.norm(Vn, axis=0), 1e-300
    )
    scale = max(float(np.max(np.abs(lam))), 1.0)
    rel = float(np.max(resid)) / scale
    # honor a LOOSER user-requested tolerance: a run legitimately
    # converged to tol=1e-3 must not be flagged as an inner-solve
    # failure by the dtype floor (ADVICE r3)
    threshold = max(1e-6, 100.0 * default_tolerance(op.dtype))
    if user_tol is not None:
        threshold = max(threshold, 100.0 * float(user_tol))
    res.trace.log(
        Severity.INFO, f"{label}: max true eigenpair residual {rel:.3e} (relative)"
    )
    if not np.isfinite(rel) or rel > threshold:
        res.converged = False
        res.termination = "inner_solve_failure"
        res.trace.log(
            Severity.ERROR,
            f"{label}: true residual {rel:.3e} exceeds {threshold:.1e} — the "
            "shift-invert inner solve failed; returned eigenpairs are unreliable",
        )
    return res


def _gram_right_mv(op, x):  # G = A†A
    return op.rmatvec(op.matvec(x))


def _gram_left_mv(op, x):  # G = AA†
    return op.matvec(op.rmatvec(x))


def _mesh_gram_right_mv(p, x):  # G = AᴴA through two mesh matvecs
    opA, opH = p
    return opH.matvec(opA.matvec(x))


def _mesh_gram_left_mv(p, x):  # G = AAᴴ
    opA, opH = p
    return opA.matvec(opH.matvec(x))


def svds(
    A,
    k: int = 6,
    *,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 200,
    seed: int = 0,
    return_singular_vectors: bool = True,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    accelerate: bool = False,
):
    """Top-``k`` singular triplets of a sparse / matrix-free operator —
    scipy.sparse.linalg.svds-style one-call front end.

    Runs Hermitian Lanczos (plain or thick-restart) on the smaller-side
    Gram operator G = A†A or AA† without materializing G (two matvecs
    per application — BASELINE config 4's route generalized to arbitrary
    operators; cf. :func:`eigenex_tpu.ops.sparse_svd.truncated_svd_via_lanczos`
    for the dense-tensor form).  Requires an operand with an adjoint
    (dense, COOMatrix, or a LinearOperator with ``rmatvec_fn``).

    Returns ``(U (nrows,k), s (k,) descending, Vh (k,ncols))``, or just
    ``s`` when ``return_singular_vectors=False``.

    ``mesh``: run both Gram matvecs (A then Aᴴ, each a shard_map'd
    row-partitioned SpMV) over the device mesh — sparse operands only;
    rows AND cols pad independently to the mesh (``pad_bsr_rect``).

    ``accelerate``: repack the operand through
    :func:`eigenex_tpu.sparse.accelerate.accelerate` first — for
    RECTANGULAR operators that is the bipartite-RCM two-sided
    permutation + general BSR-ELL pack, putting both Gram matvecs on the
    dense-block kernels instead of the scalar COO path (an
    :class:`~eigenex_tpu.sparse.accelerate.AcceleratedOperator` operand
    takes this route implicitly)."""
    import jax.numpy as jnp

    from ..sparse.accelerate import AcceleratedOperator

    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A)
    if isinstance(A, AcceleratedOperator):
        return _svds_accelerated(
            A, k, tol=tol, max_subspace=max_subspace, max_restarts=max_restarts,
            seed=seed, return_singular_vectors=return_singular_vectors,
            mesh=mesh, matvec_mode=matvec_mode,
        )

    op, coo, bsr = _resolve_operand(A)
    if mesh is not None:
        from ..parallel.distributed import (
            _padding_safe_v0,
            mesh_operator,
            pad_bsr_rect,
        )

        bsr_op = _to_bsr_for_mesh(A, coo, bsr, block_shape)
        if len(mesh.axis_names) >= 2:
            # the Gram pipeline is two RECTANGULAR 1-D row-partitioned
            # matvecs (A then A^H) — a panel grid needs square operands,
            # so a multi-axis mesh is FLATTENED over all its devices
            # rather than silently decomposing over axis 0
            from jax.sharding import Mesh as _Mesh

            mesh = _Mesh(mesh.devices.reshape(-1), ("rows",))
        axis = mesh.axis_names[0]
        padded = pad_bsr_rect(bsr_op, mesh.shape[axis])
        padH = padded.adjoint()
        opA = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
        opH = mesh_operator(padH, mesh, axis_name=axis, matvec_mode=matvec_mode)
        nrows, ncols = op.shape  # the ORIGINAL (unpadded) problem
        small = min(nrows, ncols)
        if k > small:
            raise EigenexError(f"k={k} exceeds min(shape)={small}")
        use_right = ncols <= nrows
        dim = ncols if use_right else nrows
        dim_pad = padded.shape[1] if use_right else padded.shape[0]
        g = LinearOperator(
            _mesh_gram_right_mv if use_right else _mesh_gram_left_mv,
            (opA, opH),
            (dim_pad, dim_pad),
            opA.dtype,
        )
        m = min(max_subspace or max(4 * k + 16, 32), dim)
        indices = tuple(range(-k, 0))
        if m >= dim:
            solver = LanczosEigenSolver(
                g,
                LanczosOptions(
                    max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
                    max_subspace=min(dim_pad, m + (dim_pad - dim)), seed=seed,
                    compute_eigenvectors=return_singular_vectors,
                ),
            )
        else:
            solver = ThickRestartLanczosEigenSolver(
                g,
                ThickRestartOptions(
                    max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
                    max_subspace=m, max_restarts=max_restarts, seed=seed,
                    compute_eigenvectors=return_singular_vectors,
                ),
            )
        if dim_pad != dim:
            solver.set_initial_vector(_padding_safe_v0(dim, dim_pad, g.dtype, seed))
        res = solver.compute()
        theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)
        s = np.sqrt(theta)
        if not return_singular_vectors:
            return s
        W = res.eigenvectors[:, ::-1]  # (dim_pad, k), descending σ
        safe = jnp.asarray(np.where(s > 0, s, 1.0), g.dtype)
        if use_right:
            V = W  # padded right singular vectors
            U = opA.matmat(V) / safe[None, :]
        else:
            U = W
            V = opH.matmat(U) / jnp.conj(safe)[None, :]
        return U[:nrows], s, jnp.conj(V[:ncols]).T
    if not op.has_adjoint:
        raise EigenexError(
            "svds requires an operator with an adjoint (rmatvec); dense "
            "matrices, COOMatrix, and LinearOperator(rmatvec_fn=...) all "
            "provide one"
        )
    nrows, ncols = op.shape
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim = ncols if use_right else nrows
    g = LinearOperator(
        _gram_right_mv if use_right else _gram_left_mv, op, (dim, dim), op.dtype
    )
    m = min(max_subspace or max(4 * k + 16, 32), dim)
    indices = tuple(range(-k, 0))  # largest Ritz values of G
    if m >= dim:
        res = LanczosEigenSolver(
            g,
            LanczosOptions(
                max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=dim, seed=seed,
                compute_eigenvectors=return_singular_vectors,
            ),
        ).compute()
    else:
        res = ThickRestartLanczosEigenSolver(
            g,
            ThickRestartOptions(
                max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
                compute_eigenvectors=return_singular_vectors,
            ),
        ).compute()
    theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)  # descending
    s = np.sqrt(theta)
    if not return_singular_vectors:
        return s
    W = res.eigenvectors[:, ::-1]  # (dim, k) for descending σ
    safe = jnp.asarray(np.where(s > 0, s, 1.0), op.dtype)
    if use_right:
        V = W
        U = op.matmat(V) / safe[None, :]
    else:
        U = W
        V = op.H.matmat(U) / jnp.conj(safe)[None, :]
    return U, s, jnp.conj(V).T


def _svds_accelerated(
    acc, k, *, tol, max_subspace, max_restarts, seed, return_singular_vectors,
    mesh=None, matvec_mode="allgather",
):
    """svds driver for an :class:`AcceleratedOperator`: Hermitian Lanczos
    on the smaller-side Gram operator of the PACKED container (two
    dense-block matvecs per application), with a padding-safe start and
    two-sided restore — left singular vectors through the row
    permutation, right through the column permutation.

    ``mesh``: both Gram matvecs (A then Aᴴ, each its own lane-native
    packed container) run row-partitioned over the device mesh — the
    full accelerate × mesh composition on the SVD path.

    Reference class: TensorSVD at BASELINE config-4 scale
    (tensor_svd.hpp:172); it replaces the scalar COO Gram path."""
    import jax.numpy as jnp

    from ..parallel.distributed import _padding_safe_v0
    from ..sparse.sym_bsr import SymBSRMatrix as _Sym

    if acc.complexified and acc.symmetric:
        raise EigenexError(
            "svds on a complexified HERMITIAN operator is redundant — its "
            "singular values are |eigenvalues|; use eigsh"
        )
    if acc.complexified and mesh is not None:
        raise EigenexError(
            "svds: a complexified accelerated operand cannot combine with "
            "mesh= (the doubled-spectrum reconstruction is host-side)"
        )
    mult = 2 if acc.complexified else 1
    mat = acc.matrix
    if mesh is not None:
        from ..parallel.distributed import mesh_operator, prepare_packed_mesh

        if isinstance(mat, _Sym):
            raise EigenexError(
                "svds(mesh=) on a SYMMETRIC accelerated operand is "
                "redundant — use eigsh(acc, mesh=...); the mesh Gram "
                "pipeline consumes general packs"
            )
        mesh, matvec_mode = prepare_packed_mesh(mat, mesh, matvec_mode)
        axis = mesh.axis_names[0]
        nd = mesh.shape[axis]
        # A and Aᴴ must chain exactly under the mesh: pad BOTH sides to
        # the common lcm(bm, bn)·nd grid (A's rows and Aᴴ's cols are the
        # same dimension tiled by different block dims)
        from ..sparse.bsr import BSRMatrix as _BSR

        bm, bn = mat.block_shape
        unit = int(np.lcm(bm, bn)) * nd

        def _pad_to(b, M2, N2):
            add = (M2 - b.shape[0]) // b.block_shape[0]
            data, cols = b.data, b.block_cols
            if add:
                data = jnp.concatenate(
                    [data, jnp.zeros((add,) + tuple(data.shape[1:]), data.dtype)]
                )
                cols = jnp.concatenate(
                    [cols, jnp.zeros((add, cols.shape[1]), cols.dtype)]
                )
            return _BSR(data, cols, (M2, N2))

        M2 = -(-mat.shape[0] // unit) * unit
        N2 = -(-mat.shape[1] // unit) * unit
        padded = _pad_to(mat, M2, N2)
        padH = _pad_to(acc.adjoint_matrix(), N2, M2)
        opA = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
        opH = mesh_operator(padH, mesh, axis_name=axis, matvec_mode=matvec_mode)
        nrows, ncols = acc.orig_shape
        small = min(nrows, ncols)
        if k > small:
            raise EigenexError(f"k={k} exceeds min(shape)={small}")
        use_right = ncols <= nrows
        dim_work = acc.n_work if use_right else acc.m_work
        dim_pad = N2 if use_right else M2
        g = LinearOperator(
            _mesh_gram_right_mv if use_right else _mesh_gram_left_mv,
            (opA, opH),
            (dim_pad, dim_pad),
            opA.dtype,
        )
        m = min(max_subspace or max(4 * k + 16, 32), dim_work)
        indices = tuple(range(-k, 0))
        solver = ThickRestartLanczosEigenSolver(
            g,
            ThickRestartOptions(
                max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
                compute_eigenvectors=return_singular_vectors,
            ),
        )
        if dim_pad != dim_work:
            solver.set_initial_vector(_padding_safe_v0(dim_work, dim_pad, g.dtype, seed))
        res = solver.compute()
        theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)
        s = np.sqrt(theta)
        if not return_singular_vectors:
            return s
        W = res.eigenvectors[:, ::-1]
        safe = jnp.asarray(np.where(s > 0, s, 1.0), g.dtype)
        if use_right:
            V = acc.restore_right(np.asarray(W)[: mat.shape[1]])
            AW = np.asarray(opA.matmat(W) / safe[None, :])
            U = acc.restore(AW[: mat.shape[0]])
        else:
            U = acc.restore(np.asarray(W)[: mat.shape[0]])
            HW = np.asarray(opH.matmat(W) / safe[None, :])
            V = acc.restore_right(HW[: mat.shape[1]])
        return U, s, np.conj(V).T

    opA = mat.as_linear_operator()
    # adjoint_matrix packs A-dagger with its own lane-native blocks when
    # the host triplets were retained (2x the block-transpose route)
    opH = opA if isinstance(mat, _Sym) else acc.adjoint_matrix().as_linear_operator()
    nrows, ncols = acc.orig_shape
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim_work = acc.n_work if use_right else acc.m_work
    dim_pad = mat.shape[1] if use_right else mat.shape[0]
    g = LinearOperator(
        _mesh_gram_right_mv if use_right else _mesh_gram_left_mv,
        (opA, opH),
        (dim_pad, dim_pad),
        opA.dtype,
    )
    kk = mult * k  # complexified: sigma(A) appears twice in the embedding
    m = min(max_subspace or max(4 * kk + 16, 32), dim_work)
    indices = tuple(range(-kk, 0))
    if m >= dim_work:
        solver = LanczosEigenSolver(
            g,
            LanczosOptions(
                max_eigenvalues=kk, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=min(dim_pad, m + (dim_pad - dim_work)), seed=seed,
                compute_eigenvectors=return_singular_vectors or mult == 2,
            ),
        )
    else:
        solver = ThickRestartLanczosEigenSolver(
            g,
            ThickRestartOptions(
                max_eigenvalues=kk, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
                compute_eigenvectors=return_singular_vectors or mult == 2,
            ),
        )
    if dim_pad != dim_work:
        solver.set_initial_vector(_padding_safe_v0(dim_work, dim_pad, g.dtype, seed))
    res = solver.compute()
    theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)
    s = np.sqrt(theta)
    if not return_singular_vectors and mult == 1:
        return s
    W = res.eigenvectors[:, ::-1]  # (dim_pad, kk), descending sigma
    safe = jnp.asarray(np.where(s > 0, s, 1.0), g.dtype)
    if acc.complexified:
        # general complex A through the real embedding M = [[B,-C],[C,B]]:
        # each sigma of A appears twice (right space spans [Re v, Im v] and
        # [-Im v, Re v]); restore() reassembles a valid complex vector from
        # any unit member, so dedup by value + vector overlap keeps one
        # representative per sigma (square operand: row/col perms coincide)
        from ..sparse.accelerate import dedup_embedded_pairs

        V = acc.restore(np.asarray(W))
        U = acc.restore(np.asarray(opA.matmat(W) / safe[None, :]))
        keep = dedup_embedded_pairs(s, V, keep_max=k)
        s, V, U = s[keep], V[:, keep], U[:, keep]
        V = V / np.maximum(np.linalg.norm(V, axis=0), 1e-300)
        U = U / np.maximum(np.linalg.norm(U, axis=0), 1e-300)
        if not return_singular_vectors:
            return s
        return U, s, np.conj(V).T
    if use_right:
        V = acc.restore_right(np.asarray(W))
        U = acc.restore(np.asarray(opA.matmat(W) / safe[None, :]))
    else:
        U = acc.restore(np.asarray(W))
        V = acc.restore_right(np.asarray(opH.matmat(W) / safe[None, :]))
    return U, s, np.conj(V).T
