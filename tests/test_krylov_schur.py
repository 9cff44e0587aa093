"""Krylov–Schur restarted Arnoldi tests — the bounded-memory dominant-
eigenpair solver for clustered nonsymmetric spectra."""

import jax.numpy as jnp
import numpy as np
import pytest

from eigenex_tpu.solvers.krylov_schur import (
    KrylovSchurArnoldiSolver,
    KrylovSchurOptions,
)
from eigenex_tpu.utils.prng import random_matrix


def sort_desc(v):
    return v[np.argsort(-np.abs(v), kind="stable")]


class TestKrylovSchur:
    def test_real_clustered_dominant(self):
        """Dominant pairs of a clustered spectrum with a small basis —
        plain Arnoldi at the same subspace stalls."""
        rng = np.random.default_rng(0)
        n = 300
        d = np.linspace(1.0, 4.0, n)
        d[-1], d[-2] = 4.3, 4.2  # modest gaps at the top
        Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        A = jnp.asarray(Q @ np.diag(d) @ Q.T)
        res = KrylovSchurArnoldiSolver(
            A,
            KrylovSchurOptions(
                max_eigenvalues=2, tolerance=1e-10, max_subspace=30, seed=0,
                max_restarts=100,
            ),
        ).compute()
        assert res.converged, res.termination
        np.testing.assert_allclose(np.sort(res.eigenvalues.real), [4.2, 4.3], atol=1e-7)

    def test_complex_eigenvalue_pairs_real_operator(self, key):
        """Real nonsymmetric operator with complex dominant pairs — the
        re-realified restart path."""
        n = 120
        A = random_matrix(key, n, n, jnp.float64)
        ref = sort_desc(np.linalg.eigvals(np.asarray(A)))
        res = KrylovSchurArnoldiSolver(
            A,
            KrylovSchurOptions(
                max_eigenvalues=4, tolerance=1e-9, max_subspace=40, seed=1,
                max_restarts=150,
            ),
        ).compute()
        assert res.converged
        # conjugate-pair members tie in |λ|; compare conj-insensitively
        def canon(v):
            v = np.asarray(v)
            return np.sort_complex(np.where(v.imag < 0, np.conj(v), v))

        np.testing.assert_allclose(canon(res.eigenvalues), canon(ref[:4]), atol=1e-6)

    def test_complex_operator(self, key):
        n = 80
        A = random_matrix(key, n, n, jnp.complex128)
        ref = sort_desc(np.linalg.eigvals(np.asarray(A)))
        res = KrylovSchurArnoldiSolver(
            A,
            KrylovSchurOptions(
                max_eigenvalues=3, tolerance=1e-9, max_subspace=30, seed=2,
                max_restarts=150,
            ),
        ).compute()
        assert res.converged
        np.testing.assert_allclose(
            np.sort_complex(res.eigenvalues), np.sort_complex(ref[:3]), atol=1e-6
        )

    def test_residual_certificate(self, key):
        n = 100
        A = random_matrix(key, n, n, jnp.float64)
        op = None
        res = KrylovSchurArnoldiSolver(
            A,
            KrylovSchurOptions(max_eigenvalues=3, tolerance=1e-10, max_subspace=36, seed=3),
        ).compute()
        X = np.asarray(res.eigenvectors)
        lam = res.eigenvalues
        r = np.asarray(A).astype(complex) @ X - X * lam[None, :]
        assert np.linalg.norm(r, axis=0).max() < 1e-6

    @pytest.mark.parametrize("nx", [48, 64, 80])
    def test_converged_pairs_meet_tolerance_nonnormal(self, nx):
        """"converged" means every RETURNED pair's residual is within the
        tolerance, also on a strongly non-normal operator (upwind
        convection–diffusion, f32, packed), where the eigenvectors'
        residuals can exceed the Schur vectors' by 10-100×."""
        import scipy.sparse as sp

        from eigenex_tpu.solvers.api import eigs
        from eigenex_tpu.sparse.coo import COOMatrix

        n = nx * nx
        i = np.arange(nx)
        jj, ii = np.meshgrid(i, i)
        u = (ii * nx + jj).ravel()
        rows, cols, vals = [u], [u], [np.full(n, 4.0)]
        for mask, off, val in (
            (ii > 0, -nx, -1.4), (ii < nx - 1, nx, -0.6),
            (jj > 0, -1, -1.4), (jj < nx - 1, 1, -0.6),
        ):
            uu = u[mask.ravel()]
            rows.append(uu); cols.append(uu + off); vals.append(np.full(len(uu), val))
        r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
        tol = 1e-4
        coo = COOMatrix(r.astype(np.int32), c.astype(np.int32), v.astype(np.float32), (n, n))
        res = eigs(coo, k=4, tol=tol, accelerate=True)
        assert res.converged, res.termination
        A = sp.csr_matrix((v, (r, c)), shape=(n, n))
        X = np.asarray(res.eigenvectors, np.complex128)
        X = X / np.linalg.norm(X, axis=0)
        lam = np.asarray(res.eigenvalues)
        resid = np.linalg.norm(A @ X - X * lam[None, :], axis=0)
        # the f32 Arnoldi relation's rounding adds to the estimate
        assert resid.max() <= 2 * tol * np.abs(lam).max()
