"""Real-embedding tests: complex Hermitian eigenproblems through the
all-real path."""

import jax.numpy as jnp
import numpy as np
import pytest

from eigenex_tpu import COOBuilder, LanczosEigenSolver, LanczosOptions, coo_from_dense
from eigenex_tpu.sparse.realify import (
    complex_from_real,
    dedup_doubled_eigenvalues,
    real_from_complex,
    realify_coo,
)


def complex_hermitian_coo(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A[rng.random((n, n)) > 0.3] = 0
    H = (A + A.conj().T) / 2
    return coo_from_dense(H), H


def test_embedding_matvec(rng):
    coo, H = complex_hermitian_coo()
    R = realify_coo(coo)
    assert R.shape == (80, 80)
    z = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    y_complex = H @ z
    y_real = np.asarray(R.matvec(jnp.asarray(real_from_complex(jnp.asarray(z)))))
    np.testing.assert_allclose(complex_from_real(y_real), y_complex, atol=1e-12)


def test_embedding_symmetric():
    coo, _ = complex_hermitian_coo()
    R = np.asarray(realify_coo(coo).to_dense())
    np.testing.assert_allclose(R, R.T, atol=1e-14)


def test_doubled_spectrum():
    coo, H = complex_hermitian_coo()
    R = np.asarray(realify_coo(coo).to_dense())
    ev_r = np.linalg.eigvalsh(R)
    ev_c = np.linalg.eigvalsh(H)
    np.testing.assert_allclose(ev_r, np.sort(np.repeat(ev_c, 2)), atol=1e-10)
    np.testing.assert_allclose(dedup_doubled_eigenvalues(ev_r), ev_c, atol=1e-8)


def test_real_passthrough():
    coo = coo_from_dense(np.eye(3))
    assert realify_coo(coo) is coo


def test_lanczos_on_realified_matches_complex_oracle():
    """The headline use: complex Hermitian ground state computed entirely
    with real arithmetic (the all-real path)."""
    n = 60
    b = COOBuilder(n, n, np.complex128)
    for i in range(n):
        b.append(i, i, 2.0)
        if i + 1 < n:
            b.append(i, i + 1, -1.0j)
            b.append(i + 1, i, +1.0j)
    coo = b.build()
    ref = np.linalg.eigvalsh(np.asarray(coo.to_dense()))

    R = realify_coo(coo)
    res = LanczosEigenSolver(
        R.as_linear_operator(),
        LanczosOptions(max_eigenvalues=2, tolerance=1e-14, max_subspace=2 * n, seed=0),
    ).compute()
    # doubled spectrum: Ritz values pair up; first two pairs = lowest two λ
    got = dedup_doubled_eigenvalues(res.eigenvalues)
    np.testing.assert_allclose(got[:1], ref[:1], atol=1e-9)
    # eigenvector reassembles into a complex eigenvector of H
    v = complex_from_real(np.asarray(res.eigenvectors[:, 0]))
    Hd = np.asarray(coo.to_dense())
    r = Hd @ v - ref[0] * v
    assert np.linalg.norm(r) < 1e-7


# ---------------------------------------------------------------------------
# General (non-Hermitian) complex operators through the real embedding
# (arnoldi.hpp:472-501's complex solver traits, realified)
# ---------------------------------------------------------------------------
def complex_general_coo(n=40, seed=3, spread=True):
    rng = np.random.default_rng(seed)
    # well-separated dominant spectrum: diagonal + small random coupling
    d = (np.arange(1, n + 1) * (1 + 0.5j)) if spread else rng.standard_normal(n)
    A = np.diag(d).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return coo_from_dense(A), A


class TestEigsRealified:
    def test_embedding_spectrum_is_lambda_and_conj(self):
        coo, A = complex_general_coo(12)
        R = np.asarray(realify_coo(coo).to_dense())
        ev_r = np.sort_complex(np.linalg.eigvals(R))
        ev_c = np.linalg.eigvals(A)
        both = np.sort_complex(np.concatenate([ev_c, np.conj(ev_c)]))
        np.testing.assert_allclose(ev_r, both, atol=1e-10)

    def test_dominant_pairs_match_numpy_eig(self):
        from eigenex_tpu.sparse.realify import eigs_realified

        coo, A = complex_general_coo(40)
        lam, X, res = eigs_realified(coo, k=3, tol=1e-12, max_subspace=60)
        true = np.linalg.eigvals(A)
        true = true[np.argsort(-np.abs(true))][:3]
        np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(true), atol=1e-7)
        # residuals certify the eigenvectors too
        for j in range(3):
            assert res[j] <= 1e-6 * np.abs(lam[j])

    def test_refine_reaches_f64(self):
        from eigenex_tpu.sparse.realify import eigs_realified

        coo, A = complex_general_coo(40)
        lam, X, res = eigs_realified(coo, k=3, tol=1e-10, max_subspace=60, refine=True)
        true = np.linalg.eigvals(A)
        true = true[np.argsort(-np.abs(true))][:3]
        np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(true), atol=1e-11)
        assert np.all(res <= 1e-11 * np.max(np.abs(lam)))

    def test_conjugate_paired_spectrum_dedups(self):
        # a REAL matrix stored as complex: spectrum contains conjugate
        # pairs, so the embedding has each eigenvalue twice — dedup must
        # still return distinct pairs
        from eigenex_tpu.sparse.realify import eigs_realified

        rng = np.random.default_rng(7)
        A = np.diag(np.arange(1.0, 21.0)).astype(np.complex128)
        A += 0.3 * rng.standard_normal((20, 20))
        coo = coo_from_dense(A)
        lam, X, res = eigs_realified(coo, k=4, tol=1e-12, max_subspace=38)
        true = np.linalg.eigvals(A)
        true = true[np.argsort(-np.abs(true))][:4]
        np.testing.assert_allclose(
            np.sort_complex(lam), np.sort_complex(true), atol=1e-6
        )

    def test_rejects_real_operator(self):
        import pytest as _pytest

        from eigenex_tpu.sparse.realify import eigs_realified
        from eigenex_tpu.utils.exceptions import EigenexError

        coo = coo_from_dense(np.eye(8))
        with _pytest.raises(EigenexError):
            eigs_realified(coo, k=2)
