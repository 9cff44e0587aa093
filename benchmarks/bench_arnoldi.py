"""BASELINE config 2: Arnoldi on a nonsymmetric sparse operator —
2D convection-diffusion (5-point stencil + upwind convection) at n=10^5.

Builds the COO on host (vectorized NumPy), iterates f32 Arnoldi on the
device for the dominant eigenpairs, then polishes on host f64 with the
residual-controlled block inverse iteration
(solvers.refine.general_inverse_iteration_refine) and certifies via the
f64 BACKWARD error ‖A x − λ x‖/‖λ‖ (no dense oracle exists at this size,
and the upwind operator's forward eigenproblem is ill-posed beyond its
pseudospectral radius — see tests/test_baseline_configs.py config 2).

Usage: python benchmarks/bench_arnoldi.py [--nx 316]   # n = nx*nx
"""

import argparse
import json
import sys
import time

import numpy as np


def convection_diffusion_coo(nx: int, conv: float = 0.4):
    """5-point Laplacian + upwind convection on an nx × nx grid."""
    n = nx * nx
    i = np.arange(nx)
    jj, ii = np.meshgrid(i, i)  # ii: row block (y), jj: col (x)
    u = (ii * nx + jj).ravel()

    rows, cols, vals = [u], [u], [np.full(n, 4.0)]

    def add(mask, dst_offset, val):
        uu = u[mask.ravel()]
        rows.append(uu)
        cols.append(uu + dst_offset)
        vals.append(np.full(len(uu), val))

    add(ii > 0, -nx, -1.0 - conv)
    add(ii < nx - 1, +nx, -1.0 + conv)
    add(jj > 0, -1, -1.0 - conv)
    add(jj < nx - 1, +1, -1.0 + conv)
    r = np.concatenate(rows).astype(np.int64)
    c = np.concatenate(cols).astype(np.int64)
    v = np.concatenate(vals)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order], n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=316)  # 316^2 = 99856 ≈ 1e5
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from eigenex_tpu.solvers.krylov_schur import (
        KrylovSchurArnoldiSolver,
        KrylovSchurOptions,
    )
    from eigenex_tpu.sparse.coo import COOMatrix

    t0 = time.time()
    r, c, v, n = convection_diffusion_coo(args.nx)
    print(f"# n={n:,} nnz={len(v):,} built in {time.time()-t0:.1f}s", file=sys.stderr)

    coo32 = COOMatrix(
        jnp.asarray(r.astype(np.int32)),
        jnp.asarray(c.astype(np.int32)),
        jnp.asarray(v.astype(np.float32)),
        (n, n),
    )
    t0 = time.time()
    res = KrylovSchurArnoldiSolver(
        coo32.as_linear_operator(),
        KrylovSchurOptions(
            max_eigenvalues=4, tolerance=5e-6, max_subspace=96, max_restarts=40
        ),
    ).compute()
    t_solve = time.time() - t0
    print(
        f"# Krylov-Schur Arnoldi on {jax.default_backend()}: {res.iterations} iters "
        f"in {t_solve:.1f}s ({res.termination})",
        file=sys.stderr,
    )
    print(f"# dominant eigenvalues: {res.eigenvalues}", file=sys.stderr)

    # f64 residual certificate from host triplets
    import scipy.sparse as sp

    A64 = sp.csr_matrix((v, (r, c)), shape=(n, n))
    X = np.asarray(res.eigenvectors)
    lam = np.asarray(res.eigenvalues)
    resid = np.linalg.norm(A64 @ X - X * lam[None, :], axis=0)
    print(f"# f64 residuals (device pairs): {resid}", file=sys.stderr)

    # host f64 polish: shift-invert Arnoldi seeded with the device's
    # dominant Ritz pair (one LU + m triangular solves — block inverse
    # iteration refactorizes p LUs per step and stalls ~1e-8 at this n)
    from eigenex_tpu.sparse.coo import COOMatrix
    from eigenex_tpu.solvers.refine import shift_invert_arnoldi_refine

    t0 = time.time()
    # host-resident f64 triplets (a device COOMatrix would truncate to f32)
    coo64 = COOMatrix(r.astype(np.int32), c.astype(np.int32), v, (n, n))
    top = int(np.argmax(np.abs(lam)))
    lam64, X64, resid64 = shift_invert_arnoldi_refine(
        coo64, complex(lam[top]) * (1 + 1e-6) + 1e-6j, k=4, m=100, v0=X[:, top]
    )
    t_refine = time.time() - t0
    backward = float(resid64.max()) / float(np.abs(lam64).max())
    print(
        f"# refined eigenvalues: {lam64} in {t_refine:.1f}s, "
        f"backward error {backward:.2e}",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "arnoldi_convection_diffusion",
                "n": n,
                "nnz": len(v),
                "dominant_abs": float(np.abs(lam64).max()),
                "max_residual_device": float(resid.max()),
                "backward_error_refined": backward,
                "iterations": res.iterations,
                "solve_seconds": t_solve,
                "refine_seconds": t_refine,
                "iters_per_s": res.iterations / t_solve,
            }
        )
    )


if __name__ == "__main__":
    main()
