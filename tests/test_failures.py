"""NaN/Inf numerical-failure detection in every solver loop.

The reference treats numerical failure as first-class (initial-vector
breakdown lanczos.hpp:316-321, beta-breakdown :433-437, Arnoldi residue
:277-288 all terminate cleanly).  The recurrence runs under jit
where exceptions can't be raised, so failure is a carried flag: a
non-finite alpha/beta/Hessenberg column stops iteration and surfaces
``termination="numerical_failure"`` + an ERROR trace event, never
garbage eigenvalues.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from eigenex_tpu.core.operators import LinearOperator, aslinearoperator
from eigenex_tpu.solvers.arnoldi import ArnoldiEigenSolver, ArnoldiOptions
from eigenex_tpu.solvers.block_lanczos import BlockLanczosEigenSolver, BlockLanczosOptions
from eigenex_tpu.solvers.cg import cg_solve
from eigenex_tpu.solvers.gmres import gmres_solve, gmres_solve_jit
from eigenex_tpu.solvers.krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions
from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions
from eigenex_tpu.solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from eigenex_tpu.utils.exceptions import ArnoldiError, LanczosError


def _overflow_op(n=32, dtype=jnp.float32, blowup=1e30):
    """Hermitian f32 operator whose matvec overflows: ||A v|| ~ 1e30 for a
    unit v, so beta^2 = 1e60 -> Inf in float32 on the very first step's
    norm, poisoning the recurrence the way SURVEY.md section 5's guards
    anticipate."""
    d = jnp.linspace(1.0, 2.0, n, dtype=dtype) * jnp.asarray(blowup, dtype)
    return LinearOperator(lambda p, x: p * x, d, (n, n), dtype)


def _nan_after_op(n=32, dtype=jnp.float64, good_steps=3):
    """Tridiagonal operator that returns NaN once the iterate has spread
    past ``good_steps`` coordinates.  Start Krylov iteration from e1
    (:func:`_e1`) and the failure hits after ~``good_steps`` steps —
    a mid-run numerical failure, not an immediate one."""
    diag = jnp.arange(1, n + 1, dtype=dtype)

    def mv(p, x):
        # pentadiagonal so a width-2 Krylov block stays full rank
        y = p * x
        y = y.at[:-1].add(x[1:]).at[1:].add(x[:-1])
        y = y.at[:-2].add(0.5 * x[2:]).at[2:].add(0.5 * x[:-2])
        # trips once the Krylov front reaches coordinate ``good_steps``
        bad = jnp.sum(jnp.abs(x[good_steps:])) > 1e-9
        return jnp.where(bad, jnp.full_like(y, jnp.nan), y)

    return LinearOperator(mv, diag, (n, n), dtype)


def _inf_op(n=32, dtype=jnp.float32):
    """Matvec that overflows f32 outright (x·3e38·3e38 → ±Inf)."""
    big = jnp.asarray(3e38, dtype)
    return LinearOperator(lambda p, x: (x * big) * big, None, (n, n), dtype)


def _e1(n, dtype=jnp.float64):
    return jnp.zeros((n,), dtype).at[0].set(1.0)


def _nan_op(n=16, dtype=jnp.float64):
    return LinearOperator(lambda p, x: jnp.full_like(x, jnp.nan), None, (n, n), dtype)


class TestLanczosFailure:
    def test_overflow_on_first_step_raises(self):
        # beta overflows on the very first step (k=0): nothing usable was
        # computed, so the clean surface is an exception, like the
        # reference's initial breakdown (lanczos.hpp:316-321)
        with pytest.raises(LanczosError):
            LanczosEigenSolver(
                _overflow_op(), LanczosOptions(max_subspace=16, check_every=4)
            ).compute()

    def test_error_logged(self):
        s = LanczosEigenSolver(
            _nan_after_op(), LanczosOptions(max_subspace=16, check_every=4)
        ).set_initial_vector(_e1(32))
        s.compute()
        assert s.has_error()

    def test_nan_midrun_keeps_finite_prefix(self):
        res = (
            LanczosEigenSolver(
                _nan_after_op(), LanczosOptions(max_subspace=16, check_every=4)
            )
            .set_initial_vector(_e1(32))
            .compute()
        )
        assert res.termination == "numerical_failure"
        assert res.iterations >= 1
        assert np.all(np.isfinite(res.eigenvalues))

    def test_nan_from_start_raises(self):
        with pytest.raises(LanczosError):
            LanczosEigenSolver(_nan_op(), LanczosOptions(max_subspace=8)).compute()

    def test_healthy_run_unaffected(self):
        n = 24
        A = np.diag(np.arange(1.0, n + 1))
        res = LanczosEigenSolver(
            aslinearoperator(jnp.asarray(A)),
            LanczosOptions(max_eigenvalues=3, max_subspace=n, tolerance=1e-12),
        ).compute()
        assert res.termination in ("converged", "full_subspace", "breakdown")
        np.testing.assert_allclose(res.eigenvalues, [1.0, 2.0, 3.0], atol=1e-9)


class TestArnoldiFailure:
    def test_nan_midrun_terminates_cleanly(self):
        res = (
            ArnoldiEigenSolver(
                _nan_after_op(), ArnoldiOptions(max_subspace=16, check_every=4)
            )
            .set_initial_vector(_e1(32))
            .compute()
        )
        assert res.termination == "numerical_failure"
        assert not res.converged
        assert np.all(np.isfinite(np.asarray(res.eigenvalues).view(np.float64)))

    def test_nan_from_start_raises(self):
        with pytest.raises(ArnoldiError):
            ArnoldiEigenSolver(_nan_op(), ArnoldiOptions(max_subspace=8)).compute()


class TestRestartedFailure:
    def test_thick_restart(self):
        res = (
            ThickRestartLanczosEigenSolver(
                _nan_after_op(64, good_steps=5),
                ThickRestartOptions(max_eigenvalues=2, max_subspace=16, max_restarts=5),
            )
            .set_initial_vector(_e1(64))
            .compute()
        )
        assert res.termination == "numerical_failure"
        assert np.all(np.isfinite(res.eigenvalues))

    def test_krylov_schur(self):
        res = (
            KrylovSchurArnoldiSolver(
                _nan_after_op(64, good_steps=5),
                KrylovSchurOptions(max_eigenvalues=2, max_subspace=16, max_restarts=5),
            )
            .set_initial_vector(_e1(64))
            .compute()
        )
        assert res.termination == "numerical_failure"
        assert np.all(np.isfinite(np.asarray(res.eigenvalues).view(np.float64)))


class TestBlockLanczosFailure:
    def test_overflow_on_first_step_raises(self):
        with pytest.raises(LanczosError):
            BlockLanczosEigenSolver(
                _inf_op(64),
                BlockLanczosOptions(block_size=4, max_subspace=32, check_every=4),
            ).compute()

    def test_nan_midrun_terminates_cleanly(self):
        v0 = jnp.zeros((2, 64), jnp.float64).at[0, 0].set(1.0).at[1, 1].set(1.0)
        res = (
            BlockLanczosEigenSolver(
                _nan_after_op(64, good_steps=10),
                BlockLanczosOptions(block_size=2, max_subspace=32, check_every=4),
            )
            .set_initial_block(v0)
            .compute()
        )
        assert res.termination == "numerical_failure"
        assert np.all(np.isfinite(res.eigenvalues))


class TestLinearSolverFailure:
    def test_cg_stops_early(self):
        op = _nan_op(16)
        x, res, iters = cg_solve(op, jnp.ones(16, jnp.float64), max_iters=100)
        assert int(iters) < 100  # stopped on non-finite, not budget

    def test_gmres_host_returns_last_finite(self):
        op = _nan_after_op(16, good_steps=0)
        x, rel, cycles = gmres_solve(op, jnp.ones(16, jnp.float64), restart=4, max_restarts=10)
        assert np.all(np.isfinite(np.asarray(x)))

    def test_gmres_jit_keeps_finite_x(self):
        op = _nan_op(16)
        x = gmres_solve_jit(op, jnp.ones(16, jnp.float64), restart=4, cycles=5, tol=1e-10)
        assert np.all(np.isfinite(np.asarray(x)))


class TestGMRESResidualControl:
    """gmres_solve_jit stops on tol, and the cap still bounds work."""

    def test_early_stop_matches_direct_solve(self, rng):
        n = 40
        A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
        b = rng.standard_normal(n)
        op = aslinearoperator(jnp.asarray(A))
        x = gmres_solve_jit(op, jnp.asarray(b), restart=n, cycles=50, tol=1e-12)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-8)

    def test_tol_controls_accuracy(self, rng):
        n = 60
        A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
        b = rng.standard_normal(n)
        op = aslinearoperator(jnp.asarray(A))
        for tol in (1e-2, 1e-6, 1e-10):
            x = gmres_solve_jit(op, jnp.asarray(b), restart=12, cycles=200, tol=tol)
            rel = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
            assert rel <= tol * 5  # small-LS residual tracks the true one
