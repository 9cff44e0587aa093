"""Hybrid-precision refinement: f32-grade Ritz pairs → 1e-10-grade
eigenvalues (the f32-device accuracy bridge)."""

import jax.numpy as jnp
import numpy as np

from eigenex_tpu import LanczosEigenSolver, LanczosOptions, coo_from_dense
from eigenex_tpu.solvers.refine import inverse_iteration_refine, rayleigh_refine


def make_problem(n=80, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    A[np.abs(A) < 0.8] = 0  # sparsify
    A = (A + A.T) / 2
    return coo_from_dense(A), np.linalg.eigvalsh(A)


def test_rayleigh_refine_squares_the_error():
    coo, ref = make_problem()
    # f32 solve: eigenvalues/vectors good to ~1e-6
    coo32 = coo_from_dense(np.asarray(coo.to_dense(), np.float32))
    # drive the f32 iteration to stagnation (residuals ~ f32 eps · ‖A‖)
    res = LanczosEigenSolver(
        coo32.as_linear_operator(),
        LanczosOptions(max_eigenvalues=3, tolerance=1e-9, max_subspace=80, seed=0),
    ).compute()
    f32_err = np.abs(np.asarray(res.eigenvalues) - ref[:3]).max()
    lam, resid = rayleigh_refine(coo, res.eigenvectors)
    ref_err = np.abs(lam - ref[:3]).max()
    assert ref_err < 1e-8           # ~ε² of the f32 vectors
    assert ref_err < f32_err        # strictly better than the f32 values
    assert np.all(resid < 1e-2)


def test_inverse_iteration_full_precision():
    coo, ref = make_problem(seed=1)
    coo32 = coo_from_dense(np.asarray(coo.to_dense(), np.float32))
    res = LanczosEigenSolver(
        coo32.as_linear_operator(),
        LanczosOptions(max_eigenvalues=2, max_subspace=80, seed=1),
    ).compute()
    lam, X, resid = inverse_iteration_refine(coo, res.eigenvectors)
    np.testing.assert_allclose(lam, ref[:2], atol=1e-11)
    assert np.all(resid < 1e-9)
    # vectors are true f64 eigenvectors now
    d = np.asarray(coo.to_dense())
    np.testing.assert_allclose(d @ X, X * lam[None, :], atol=1e-9)


# ---------------------------------------------------------------------------
# General (non-Hermitian) f64 refinement — the polish that recovers the
# reference's f64-exact Arnoldi extraction (arnoldi.hpp:805-865) from a
# low-precision device iteration (VERDICT round-1 item 2)
# ---------------------------------------------------------------------------
class TestGeneralRefine:
    def _problem(self, n=50, seed=5):
        rng = np.random.default_rng(seed)
        A = np.diag(np.arange(1.0, n + 1.0)) + 0.1 * rng.standard_normal((n, n))
        return coo_from_dense(A), A

    def test_polishes_f32_grade_pairs_to_f64(self):
        from eigenex_tpu.solvers.refine import general_inverse_iteration_refine

        coo, A = self._problem()
        true_ev, true_X = np.linalg.eig(A)
        order = np.argsort(-np.abs(true_ev))[:4]
        rng = np.random.default_rng(0)
        # f32-grade input: perturb the exact pairs at the 1e-5 level
        X0 = true_X[:, order] + 1e-5 * (
            rng.standard_normal((50, 4)) + 1j * rng.standard_normal((50, 4))
        )
        lam0 = true_ev[order] + 1e-5
        lam, X, res = general_inverse_iteration_refine(coo, X0, lam0, iters=3)
        np.testing.assert_allclose(lam, true_ev[order], atol=1e-11)
        assert np.all(res <= 1e-11 * np.max(np.abs(lam)))

    def test_complex_conjugate_pair(self):
        from eigenex_tpu.solvers.refine import general_inverse_iteration_refine

        # real matrix with a genuine complex pair
        A = np.array([[0.0, -2.0], [2.0, 0.0]])
        A = np.block([[A, np.zeros((2, 3))], [np.zeros((3, 2)), np.diag([1.0, 2.0, 3.0])]])
        coo = coo_from_dense(A)
        lam, X, res = general_inverse_iteration_refine(
            coo,
            np.array([[1.0, 1.0], [1j, -1j], [0, 0], [0, 0], [0, 0]], np.complex128),
            np.array([2.1j, -2.1j]),
            iters=3,
        )
        # sort by imaginary part: sort_complex keys on the real part,
        # which is pure ±1e-33 noise for this skew pair
        np.testing.assert_allclose(lam[np.argsort(lam.imag)], [-2j, 2j], atol=1e-12)

    def test_rayleigh_general(self):
        from eigenex_tpu.solvers.refine import general_rayleigh_refine

        coo, A = self._problem(30)
        ev, X = np.linalg.eig(A)
        lam, res = general_rayleigh_refine(coo, X[:, :3])
        np.testing.assert_allclose(lam, ev[:3], atol=1e-10)
        assert np.all(res <= 1e-10)


class TestShiftInvertArnoldiRefine:
    def test_converges_from_seed(self):
        from eigenex_tpu.solvers.refine import shift_invert_arnoldi_refine

        rng = np.random.default_rng(5)
        B = np.diag(np.arange(1.0, 41.0)) + np.triu(rng.standard_normal((40, 40)), 1)
        coo = coo_from_dense(B)
        seed_vec = rng.standard_normal(40)
        lam, X, res = shift_invert_arnoldi_refine(
            coo, 39.4 + 0.2j, k=3, m=25, v0=seed_vec
        )
        ref = np.sort(np.linalg.eigvals(B).real)[::-1][:3]
        np.testing.assert_allclose(np.sort(lam.real)[::-1], ref, atol=1e-9)
        assert np.max(res) < 1e-10

    def test_recentering_rounds(self):
        # start with a deliberately bad sigma: the re-centering rounds
        # must walk it onto the dominant pair
        from eigenex_tpu.solvers.refine import shift_invert_arnoldi_refine

        rng = np.random.default_rng(6)
        B = np.diag(np.linspace(1.0, 20.0, 30)) + 0.1 * rng.standard_normal((30, 30))
        coo = coo_from_dense(B)
        lam, X, res = shift_invert_arnoldi_refine(coo, 25.0 + 0.5j, k=2, m=15, rounds=4)
        ref = np.linalg.eigvals(B)
        ref = ref[np.argsort(-np.abs(ref))][:2]
        assert np.max(res) < 1e-10
        np.testing.assert_allclose(
            np.sort_complex(lam), np.sort_complex(ref), atol=1e-8
        )
