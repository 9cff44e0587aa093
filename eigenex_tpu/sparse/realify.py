"""Real embedding of complex operators — complex Krylov through real arithmetic.

The reference templates its solvers over complex scalars
(sample_lanczos2.cpp:13-57).  SURVEY.md §7 prescribes "complex as
paired real arrays" for backends without a complex dtype; the clean
algebraic form of that is the standard real embedding

    z = x + i y   ↦   [x, y]              (stacked real vector, dim 2n)
    H = A + i B   ↦   [[A, -B], [B, A]]   (real matrix, dim 2n x 2n)

For Hermitian H (A symmetric, B antisymmetric) the embedding is real
**symmetric**, and its spectrum is that of H with every eigenvalue
doubled: each complex eigenpair (λ, v) yields the orthogonal real pair
[Re v, Im v] and [-Im v, Re v].  So complex Hermitian eigenproblems run
through the entirely-real Lanczos path (and the real symmetric block
routes); callers deduplicate the
doubled Ritz values (:func:`dedup_doubled_eigenvalues`) and reassemble
complex vectors (:func:`complex_from_real`).

For GENERAL (non-Hermitian) complex H the same embedding works — its
spectrum is {λ_j} ∪ {conj λ_j}: the complex eigenvector of the embedding
for a genuine eigenvalue λ of H is [z; −iz] (check: R[z;−iz] =
[Az+iBz; Bz−iAz] = λ[z;−iz]), while conj λ carries the mirror vector
[z̄; i z̄].  :func:`eigs_realified` runs the real Krylov–Schur solver on
the embedding and reconstructs/deduplicates H's eigenpairs — the
all-real path for the reference's fully complex-templated
Arnoldi (arnoldi.hpp:472-501, sample_lanczos2.cpp:13).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.exceptions import EigenexError
from ..utils.tolerance import real_dtype_of
from .coo import COOMatrix

__all__ = [
    "realify_coo",
    "real_from_complex",
    "complex_from_real",
    "dedup_doubled_eigenvalues",
    "eigs_realified",
]


def realify_coo(coo: COOMatrix) -> COOMatrix:
    """[[A, -B], [B, A]] real embedding of a complex COO matrix.

    Real inputs are returned unchanged.  Entries with zero imaginary
    (or zero real) part are dropped from the corresponding quadrant."""
    if not jnp.issubdtype(coo.dtype, jnp.complexfloating):
        return coo
    n_r, n_c = coo.shape
    r = np.asarray(coo.row, np.int64)
    c = np.asarray(coo.col, np.int64)
    v = np.asarray(coo.val)
    a, b = v.real, v.imag
    rows, cols, vals = [], [], []
    am = a != 0
    bm = b != 0
    # top-left A, bottom-right A
    rows += [r[am], r[am] + n_r]
    cols += [c[am], c[am] + n_c]
    vals += [a[am], a[am]]
    # top-right -B, bottom-left B
    rows += [r[bm], r[bm] + n_r]
    cols += [c[bm] + n_c, c[bm]]
    vals += [-b[bm], b[bm]]
    rr = np.concatenate(rows)
    cc = np.concatenate(cols)
    vv = np.concatenate(vals)
    order = np.lexsort((cc, rr))
    rdt = real_dtype_of(coo.dtype)
    return COOMatrix(
        jnp.asarray(rr[order].astype(np.int32)),
        jnp.asarray(cc[order].astype(np.int32)),
        jnp.asarray(vv[order].astype(rdt)),
        (2 * n_r, 2 * n_c),
    )


def real_from_complex(z) -> jax.Array:
    """z (n,) complex → [Re z, Im z] (2n,) real."""
    z = jnp.asarray(z)
    return jnp.concatenate([jnp.real(z), jnp.imag(z)])


def complex_from_real(x) -> np.ndarray:
    """[x, y] (2n,) real → x + i y (n,) complex (host array)."""
    x = np.asarray(x)
    if x.shape[-1] % 2:
        raise EigenexError("realified vector length must be even")
    n = x.shape[-1] // 2
    return x[..., :n] + 1j * x[..., n:]


def eigs_realified(
    coo: COOMatrix,
    k: int = 6,
    *,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 100,
    seed: int = 0,
    refine: bool | int = False,
):
    """k dominant eigenpairs of a GENERAL complex operator using only
    real device arithmetic.

    Runs Krylov–Schur on the real embedding [[A,−B],[B,A]] (spectrum
    {λ} ∪ {conj λ}), then reconstructs H's pairs: for each real-side Ritz
    pair (θ, q), z = q_top + i·q_bot is 2c·z for a genuine pair and ≈ 0
    for a mirror pair (whose H-pair is recovered by conjugating), so the
    reconstruction norm itself separates the doubled spectrum.
    Remaining duplicates (real eigenvalues; conjugate-paired spectra)
    dedup by eigenvalue closeness + vector overlap, keeping the smaller
    residual.

    ``refine``: truthy → polish the reconstructed pairs with
    :func:`eigenex_tpu.solvers.refine.general_inverse_iteration_refine`
    (an int sets the iteration count).

    Returns (evals (≤k,) complex128 |λ|-descending, X (n, ≤k) complex128
    columns, residuals (≤k,) f64)."""
    from ..solvers.api import eigs

    if not jnp.issubdtype(coo.dtype, jnp.complexfloating):
        raise EigenexError("eigs_realified expects a complex operator; use eigs")
    n = coo.shape[0]
    R = realify_coo(coo)
    res = eigs(
        R.as_linear_operator(),
        k=min(2 * k, 2 * n - 2),
        tol=tol,
        max_subspace=max_subspace,
        max_restarts=max_restarts,
        seed=seed,
    )
    evals = np.asarray(res.eigenvalues, np.complex128)
    X = np.asarray(res.eigenvectors, np.complex128)  # (2n, p), unit columns

    import scipy.sparse as sp

    A = sp.csr_matrix(
        (np.asarray(coo.val, np.complex128), (np.asarray(coo.row), np.asarray(coo.col))),
        shape=coo.shape,
    )
    cands = []
    for j in range(X.shape[1]):
        q = X[:, j]
        for lam, z in (
            (evals[j], q[:n] + 1j * q[n:]),
            (np.conj(evals[j]), np.conj(q[:n]) + 1j * np.conj(q[n:])),
        ):
            nz = np.linalg.norm(z)
            # a genuine pair reconstructs with norm √2 (unit q); a mirror
            # pair with ~0 — 0.3 splits them with wide margin
            if nz < 0.3:
                continue
            z = z / nz
            r = float(np.linalg.norm(A @ z - lam * z))
            cands.append((complex(lam), z, r))
    # best-residual first so dedup keeps the cleanest representative
    cands.sort(key=lambda t: t[2])
    scale = max((abs(c[0]) for c in cands), default=1.0)
    close = max(tol if tol is not None else 0.0, 1e-6) * max(scale, 1.0)
    kept: list[tuple] = []
    for lam, z, r in cands:
        dup = any(
            abs(lam - lk) <= close and abs(np.vdot(zk, z)) > 0.9 for lk, zk, _ in kept
        )
        if not dup:
            kept.append((lam, z, r))
    kept.sort(key=lambda t: -abs(t[0]))
    kept = kept[:k]
    lam_out = np.array([t[0] for t in kept], np.complex128)
    X_out = np.stack([t[1] for t in kept], axis=1) if kept else np.zeros((n, 0), np.complex128)
    res_out = np.array([t[2] for t in kept], np.float64)
    if refine and kept:
        from ..solvers.refine import general_inverse_iteration_refine

        iters = int(refine) if not isinstance(refine, bool) else 60
        lam_out, X_out, res_out = general_inverse_iteration_refine(
            coo, X_out, lam_out, iters=iters
        )
        order = np.argsort(-np.abs(lam_out), kind="stable")
        lam_out, X_out, res_out = lam_out[order], X_out[:, order], res_out[order]
    return lam_out, X_out, res_out


def dedup_doubled_eigenvalues(evals: np.ndarray, tol: float | None = None) -> np.ndarray:
    """Collapse the doubled spectrum of a realified Hermitian operator:
    consecutive pairs within ``tol`` merge to one eigenvalue."""
    evals = np.asarray(evals)
    if tol is None:
        spread = float(evals.max() - evals.min()) if evals.size > 1 else 1.0
        tol = max(spread, 1.0) * 1e-8
    out = []
    i = 0
    while i < len(evals):
        if i + 1 < len(evals) and abs(evals[i + 1] - evals[i]) <= tol:
            out.append((evals[i] + evals[i + 1]) / 2)
            i += 2
        else:
            out.append(evals[i])
            i += 1
    return np.asarray(out)
