"""Distributed (shard_map) tests on the 8-virtual-device CPU mesh —
single-device vs sharded comparisons per SURVEY.md §4d-e."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from eigenex_tpu.parallel import (
    DistributedLanczosEigenSolver,
    distributed_lanczos_steps,
    halo_matvec,
    make_mesh,
    pad_bsr_for_mesh,
    split_bsr_halo,
)
from eigenex_tpu.solvers.lanczos import (
    LanczosOptions,
    init_lanczos_state,
    lanczos_steps,
)
from eigenex_tpu.sparse import bsr_from_coo_arrays


def laplacian_bsr(n, bs, dtype=np.float64):
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)]).astype(dtype)
    return bsr_from_coo_arrays(rows, cols, vals, (n, n), (bs, bs))


@pytest.fixture
def mesh():
    return make_mesh(8, devices=jax.devices("cpu"))


class TestDistributedMatvec:
    def test_allgather_matvec_matches_local(self, mesh):
        from eigenex_tpu.parallel.distributed import _local_allgather_matvec

        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        x = jnp.asarray(np.random.default_rng(0).standard_normal(bsr.shape[1]))
        f = shard_map(
            lambda d, c, x: _local_allgather_matvec((d, c), x, axis_name="rows", bn=4),
            mesh=mesh,
            in_specs=(P("rows"), P("rows"), P("rows")),
            out_specs=P("rows"),
        )
        np.testing.assert_allclose(f(bsr.data, bsr.block_cols, x), bsr.matvec(x), atol=1e-12)

    def test_halo_matvec_matches_local(self, mesh):
        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        diag, left, right = split_bsr_halo(bsr, 8)
        x = jnp.asarray(np.random.default_rng(1).standard_normal(bsr.shape[1]))
        f = shard_map(
            lambda dd, dc, ld, lc, rd, rc, x: halo_matvec(
                dd, dc, ld, lc, rd, rc, x, axis_name="rows", bn=4
            ),
            mesh=mesh,
            in_specs=(P("rows"),) * 6 + (P("rows"),),
            out_specs=P("rows"),
        )
        y = f(diag[0], diag[1], left[0], left[1], right[0], right[1], x)
        np.testing.assert_allclose(y, bsr.matvec(x), atol=1e-12)

    def test_split_halo_rejects_nonbanded(self):
        # a dense-ish row reaching shard +2 must be rejected
        n = 32
        rows = np.array([0])
        cols = np.array([16])  # block col 4 with bs=4 → shard 2 of 8 (rows_per=1)
        vals = np.array([1.0])
        bsr = bsr_from_coo_arrays(rows, cols, vals, (n, n), (4, 4))
        from eigenex_tpu.utils.exceptions import EigenexError

        with pytest.raises(EigenexError):
            split_bsr_halo(bsr, 8)


class TestDistributedLanczos:
    def test_steps_match_single_device(self, mesh):
        """Same state in ⇒ bit-comparable state out (the determinism test
        that replaces race detection, SURVEY.md §5)."""
        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        op = bsr.as_linear_operator()
        v0 = np.random.default_rng(2).standard_normal(bsr.shape[1])
        s0 = init_lanczos_state(op, 20, v0=jnp.asarray(v0))
        s_ref = lanczos_steps(op, s0, 12)
        s_dist = distributed_lanczos_steps(bsr, s0, 12, mesh)
        assert int(s_dist.k) == int(s_ref.k) == 12
        np.testing.assert_allclose(s_dist.alpha, s_ref.alpha, atol=1e-12)
        np.testing.assert_allclose(s_dist.beta, s_ref.beta, atol=1e-12)
        np.testing.assert_allclose(s_dist.V, s_ref.V, atol=1e-11)

    def test_distributed_solver_end_to_end(self, mesh):
        n = 64
        bsr = laplacian_bsr(n, 4)
        solver = DistributedLanczosEigenSolver(
            bsr,
            mesh,
            LanczosOptions(max_eigenvalues=3, tolerance=1e-14, max_subspace=n, seed=0),
        )
        res = solver.compute()
        exact = np.array([2 - 2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)])
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-10)

    def test_distributed_with_deflation(self, mesh):
        n = 64
        bsr = laplacian_bsr(n, 4)
        ev, evec = np.linalg.eigh(np.asarray(bsr.to_dense()))
        solver = DistributedLanczosEigenSolver(
            bsr, mesh, LanczosOptions(max_eigenvalues=1, tolerance=1e-14, max_subspace=n, seed=1)
        ).set_orthogonalizing_vectors(jnp.asarray(evec[:, :1].T))
        res = solver.compute()
        np.testing.assert_allclose(res.eigenvalues[0], ev[1], atol=1e-9)


class TestHaloLanczos:
    def test_halo_mode_matches_allgather(self, mesh):
        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        op = bsr.as_linear_operator()
        v0 = np.random.default_rng(5).standard_normal(bsr.shape[1])
        s0 = init_lanczos_state(op, 16, v0=jnp.asarray(v0))
        s_ag = distributed_lanczos_steps(bsr, s0, 10, mesh, matvec_mode="allgather")
        s_halo = distributed_lanczos_steps(bsr, s0, 10, mesh, matvec_mode="halo")
        np.testing.assert_allclose(s_halo.alpha, s_ag.alpha, atol=1e-12)
        np.testing.assert_allclose(s_halo.beta, s_ag.beta, atol=1e-12)
        np.testing.assert_allclose(s_halo.V, s_ag.V, atol=1e-11)

    def test_halo_solver_end_to_end(self, mesh):
        n = 64
        bsr = laplacian_bsr(n, 4)
        solver = DistributedLanczosEigenSolver(
            bsr, mesh,
            LanczosOptions(max_eigenvalues=2, tolerance=1e-14, max_subspace=n, seed=0),
            matvec_mode="halo",
        )
        res = solver.compute()
        exact = np.array([2 - 2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)])
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-10)


class TestDistributedThickRestart:
    def test_matches_single_device_trlm(self, mesh):
        """Distributed TRLM == single-device TRLM eigenvalues (n=256
        Laplacian, 24-dim basis, many restarts)."""
        from eigenex_tpu.parallel.distributed import (
            DistributedThickRestartLanczosEigenSolver,
        )
        from eigenex_tpu.solvers.restart import (
            ThickRestartLanczosEigenSolver,
            ThickRestartOptions,
        )

        n = 256
        bsr = laplacian_bsr(n, 4)
        opts = ThickRestartOptions(
            max_eigenvalues=2, tolerance=1e-12, max_subspace=24, seed=0, max_restarts=200
        )
        exact = np.array([2 - 2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)])
        dist = DistributedThickRestartLanczosEigenSolver(bsr, mesh, opts).compute()
        assert dist.converged, dist.termination
        np.testing.assert_allclose(dist.eigenvalues, exact, atol=1e-9)

    def test_halo_mode(self, mesh):
        from eigenex_tpu.parallel.distributed import (
            DistributedThickRestartLanczosEigenSolver,
        )
        from eigenex_tpu.solvers.restart import ThickRestartOptions

        n = 128
        bsr = laplacian_bsr(n, 4)
        opts = ThickRestartOptions(
            max_eigenvalues=1, tolerance=1e-12, max_subspace=20, seed=1, max_restarts=200
        )
        res = DistributedThickRestartLanczosEigenSolver(
            bsr, mesh, opts, matvec_mode="halo"
        ).compute()
        assert res.converged
        exact = 2 - 2 * np.cos(np.pi / (n + 1))
        np.testing.assert_allclose(res.eigenvalues[0], exact, atol=1e-9)


class TestDistributedShiftInvert:
    def test_shift_invert_lanczos_ground_state(self, mesh):
        """BASELINE config 5 in miniature: row-partitioned operator, halo
        SpMV inside a mesh-parallel CG, shift-invert Lanczos targeting
        the ground state."""
        n = 64
        bsr = pad_bsr_for_mesh(laplacian_bsr(n, 4), 8)
        op = bsr.as_linear_operator()
        exact0 = 2 - 2 * np.cos(np.pi / (n + 1))
        sigma = -0.5  # below the spectrum → (A−σI) positive definite
        s0 = init_lanczos_state(op, 24, seed=0)
        s = distributed_lanczos_steps(
            bsr, s0, 24, mesh,
            matvec_mode="halo",
            shift_invert_sigma=sigma,
            cg_tol=1e-12, cg_max_iters=400,
        )
        k = int(s.k)
        from eigenex_tpu.solvers.lanczos import tridiagonal_eigh

        theta = tridiagonal_eigh(
            np.asarray(s.alpha[:k]), np.asarray(s.beta[:k]), eigvals_only=True
        )
        lam = sigma + 1.0 / theta[-1]  # dominant θ ↔ eigenvalue nearest σ
        np.testing.assert_allclose(lam, exact0, atol=1e-8)


def test_padding_does_not_shadow_smallest_eigenvalue(mesh):
    """Auto-padded rows add spurious eigenvalue 0; the solver's start
    vector must avoid that null space so the TRUE smallest eigenvalue of
    a positive-definite operator is returned (review finding)."""
    n = 60  # 15 block rows of 4 → pads to 16 over 8 shards
    bsr = laplacian_bsr(n, 4)
    assert (bsr.n_block_rows % 8) != 0  # padding will occur
    solver = DistributedLanczosEigenSolver(
        bsr, mesh, LanczosOptions(max_eigenvalues=1, tolerance=1e-14, max_subspace=n, seed=0)
    )
    res = solver.compute()
    exact0 = 2 - 2 * np.cos(np.pi / (n + 1))
    # without the fix this returns ~0 (the padding eigenvalue)
    np.testing.assert_allclose(res.eigenvalues[0], exact0, atol=1e-9)


def test_distributed_krylov_schur(mesh):
    """Distributed Krylov-Schur converges the dominant eigenvalue of a
    nonsymmetric row-partitioned operator."""
    from eigenex_tpu.parallel.distributed import DistributedKrylovSchurArnoldiSolver
    from eigenex_tpu.solvers.krylov_schur import KrylovSchurOptions
    from eigenex_tpu.sparse import bsr_from_coo_arrays

    # near-normal nonsymmetric operator: symmetric tridiagonal + small
    # antisymmetric part (a strongly non-normal Toeplitz would make the
    # true eigenvalues meaningless targets — pseudospectrum effects)
    n = 128
    rng = np.random.default_rng(7)
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    off = -np.ones(n - 1)
    anti = 0.1 * rng.standard_normal(n - 1)
    vals = np.concatenate([2 * np.ones(n) + rng.standard_normal(n), off + anti, off - anti])
    bsr = bsr_from_coo_arrays(rows, cols, vals, (n, n), (4, 4))
    ref = np.linalg.eigvals(np.asarray(bsr.to_dense()))
    ref = ref[np.argsort(-np.abs(ref))]
    res = DistributedKrylovSchurArnoldiSolver(
        bsr, mesh, KrylovSchurOptions(max_eigenvalues=2, tolerance=1e-9, max_subspace=30,
                                      max_restarts=150, seed=0)
    ).compute()
    assert res.converged
    np.testing.assert_allclose(
        np.sort(np.abs(res.eigenvalues)), np.sort(np.abs(ref[:2])), atol=1e-7
    )


# ---------------------------------------------------------------------------
# Round-2: colsplit (psum_scatter) matvec mode; the GPU kernel as the
# sym_halo local SpMV
# (SURVEY.md section 5's reduce_scatter mandate; VERDICT round-1 item 6)
# ---------------------------------------------------------------------------
class TestColsplitMatvec:
    def test_colsplit_matvec_matches_local(self, mesh):
        from eigenex_tpu.parallel.distributed import (
            _local_colsplit_matvec,
            split_bsr_colpanels,
        )

        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        pd, pc = split_bsr_colpanels(bsr, 8)
        x = jnp.asarray(np.random.default_rng(0).standard_normal(bsr.shape[1]))
        f = shard_map(
            lambda d, c, x: _local_colsplit_matvec((d, c), x, axis_name="rows", bn=4),
            mesh=mesh,
            in_specs=(P("rows"), P("rows"), P("rows")),
            out_specs=P("rows"),
        )
        np.testing.assert_allclose(f(pd, pc, x), bsr.matvec(x), atol=1e-12)

    def test_colsplit_dense_random(self, mesh):
        # non-banded sparsity: every panel nontrivial
        from eigenex_tpu.parallel.distributed import (
            _local_colsplit_matvec,
            split_bsr_colpanels,
        )
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        rng = np.random.default_rng(5)
        A = rng.standard_normal((64, 64))
        A[rng.random((64, 64)) > 0.4] = 0
        bsr = pad_bsr_for_mesh(bsr_from_dense(A, (4, 4)), 8)
        pd, pc = split_bsr_colpanels(bsr, 8)
        x = jnp.asarray(rng.standard_normal(bsr.shape[1]))
        f = shard_map(
            lambda d, c, x: _local_colsplit_matvec((d, c), x, axis_name="rows", bn=4),
            mesh=mesh,
            in_specs=(P("rows"), P("rows"), P("rows")),
            out_specs=P("rows"),
        )
        np.testing.assert_allclose(f(pd, pc, x), bsr.matvec(x), atol=1e-12)

    def test_colsplit_lanczos_bitmatches_allgather(self, mesh):
        from eigenex_tpu.parallel.distributed import distributed_lanczos_steps
        from eigenex_tpu.solvers.lanczos import init_lanczos_state

        bsr = pad_bsr_for_mesh(laplacian_bsr(64, 4), 8)
        op = bsr.as_linear_operator()
        s0 = init_lanczos_state(op, 24, seed=3)
        sa = distributed_lanczos_steps(bsr, s0, 24, mesh, matvec_mode="allgather")
        sc = distributed_lanczos_steps(bsr, s0, 24, mesh, matvec_mode="colsplit")
        np.testing.assert_allclose(
            np.asarray(sa.alpha), np.asarray(sc.alpha), atol=1e-12
        )
        np.testing.assert_allclose(np.asarray(sa.beta), np.asarray(sc.beta), atol=1e-12)

    def test_colsplit_solver_converges(self, mesh):
        n = 128
        bsr = laplacian_bsr(n, 4)
        solver = DistributedLanczosEigenSolver(
            bsr, mesh,
            LanczosOptions(max_eigenvalues=2, tolerance=1e-13, max_subspace=n),
            matvec_mode="colsplit",
        )
        res = solver.compute()
        exact = [2 - 2 * np.cos((j + 1) * np.pi / (n + 1)) for j in range(2)]
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-9)


class TestPallasLocalSpMV:
    """The half-traffic GPU kernel (Pallas interpret mode) as the
    shard-local SpMV of the sym_halo mode, under shard_map on the
    8-device mesh, against the XLA local path."""

    @staticmethod
    def _laplacian_f32():
        # 4 block rows of 16x16 per device: the kernel's square
        # power-of-two blocks, and a band that crosses every shard edge
        return pad_bsr_for_mesh(laplacian_bsr(8 * 4 * 16, 16, np.float32), 8)

    def test_pallas_interpret_matches_xla_under_shard_map(self, mesh):
        bsr = self._laplacian_f32()
        s0 = init_lanczos_state(bsr.as_linear_operator(), 8, seed=0)
        kw = dict(matvec_mode="sym_halo")
        sx = distributed_lanczos_steps(bsr, s0, 8, mesh, use_pallas=False, **kw)
        sp = distributed_lanczos_steps(bsr, s0, 8, mesh, use_pallas="interpret", **kw)
        np.testing.assert_allclose(np.asarray(sx.alpha), np.asarray(sp.alpha), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sx.beta), np.asarray(sp.beta), atol=1e-5)

    def test_pallas_interpret_spmm_under_shard_map(self, mesh):
        from eigenex_tpu.parallel import mesh_operator

        bsr = self._laplacian_f32()
        X = jnp.asarray(np.random.default_rng(3).standard_normal((bsr.shape[0], 5)), jnp.float32)
        ox = mesh_operator(bsr, mesh, matvec_mode="sym_halo")
        ok = mesh_operator(bsr, mesh, matvec_mode="sym_halo", use_pallas="interpret")
        np.testing.assert_allclose(np.asarray(ok.matmat(X)), np.asarray(ox.matmat(X)), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(ok.matvec(X[:, 0])), np.asarray(ox.matvec(X[:, 0])), atol=1e-5
        )


# ---------------------------------------------------------------------------
# sym_halo: half-HBM-traffic symmetric storage on the mesh (round 2)
# ---------------------------------------------------------------------------
class TestSymHalo:
    def _sym_banded(self, nbr=64, bm=4, dtype=np.float64, seed=7):
        rng = np.random.default_rng(seed)
        n = nbr * bm
        diag = rng.standard_normal((nbr, bm, bm)).astype(dtype)
        off = rng.standard_normal((nbr - 1, bm, bm)).astype(dtype)
        A = np.zeros((n, n), dtype)
        for r in range(nbr):
            A[r*bm:(r+1)*bm, r*bm:(r+1)*bm] = (diag[r] + diag[r].T) / 2
            if r + 1 < nbr:
                A[r*bm:(r+1)*bm, (r+1)*bm:(r+2)*bm] = off[r]
                A[(r+1)*bm:(r+2)*bm, r*bm:(r+1)*bm] = off[r].T
        from eigenex_tpu.sparse.bsr import bsr_from_dense
        return bsr_from_dense(A, (bm, bm)), A

    def test_lanczos_bit_matches_single_device(self, mesh):
        from eigenex_tpu.parallel.distributed import distributed_lanczos_steps
        from eigenex_tpu.solvers.lanczos import init_lanczos_state, lanczos_steps

        bsr, A = self._sym_banded()
        op = bsr.as_linear_operator()
        m = 20
        s_ref = lanczos_steps(op, init_lanczos_state(op, m, seed=0), m)
        s_dist = distributed_lanczos_steps(
            bsr, init_lanczos_state(op, m, seed=0), m, mesh,
            matvec_mode="sym_halo",
        )
        np.testing.assert_allclose(
            np.asarray(s_dist.alpha), np.asarray(s_ref.alpha), atol=1e-11
        )
        np.testing.assert_allclose(
            np.asarray(s_dist.beta), np.asarray(s_ref.beta), atol=1e-11
        )

    def test_matvec_equality_shardmap(self, mesh):
        from eigenex_tpu.parallel.distributed import (
            split_sym_bsr_halo, sym_halo_matvec,
        )
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

        bsr, A = self._sym_banded(nbr=32, bm=4)
        sym = sym_bsr_from_bsr(bsr, check=True, atol=1e-12)
        diag, inp, right = split_sym_bsr_halo(sym, 8)
        x = np.random.default_rng(1).standard_normal(bsr.shape[0])
        bm = 4

        f = shard_map(
            lambda d, i0, i1, r0, r1, xl: sym_halo_matvec(
                d, i0, i1, r0, r1, xl, axis_name="rows", bn=bm
            ),
            mesh=mesh,
            in_specs=(P("rows"),) * 5 + (P("rows"),),
            out_specs=P("rows"),
        )
        y = f(diag, inp[0], inp[1], right[0], right[1], jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), A @ x, atol=1e-10)

    def test_hermitian_complex(self, mesh):
        from eigenex_tpu.parallel.distributed import (
            split_sym_bsr_halo, sym_halo_matvec,
        )
        from eigenex_tpu.sparse.bsr import bsr_from_dense
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

        rng = np.random.default_rng(3)
        nbr, bm = 16, 4
        n = nbr * bm
        A = np.zeros((n, n), np.complex128)
        for r in range(nbr):
            D = rng.standard_normal((bm, bm)) + 1j * rng.standard_normal((bm, bm))
            A[r*bm:(r+1)*bm, r*bm:(r+1)*bm] = (D + D.conj().T) / 2
            if r + 1 < nbr:
                B = rng.standard_normal((bm, bm)) + 1j * rng.standard_normal((bm, bm))
                A[r*bm:(r+1)*bm, (r+1)*bm:(r+2)*bm] = B
                A[(r+1)*bm:(r+2)*bm, r*bm:(r+1)*bm] = B.conj().T
        sym = sym_bsr_from_bsr(bsr_from_dense(A, (bm, bm)), check=True, atol=1e-12)
        diag, inp, right = split_sym_bsr_halo(sym, 8)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        f = shard_map(
            lambda d, i0, i1, r0, r1, xl: sym_halo_matvec(
                d, i0, i1, r0, r1, xl, axis_name="rows", bn=bm
            ),
            mesh=mesh,
            in_specs=(P("rows"),) * 5 + (P("rows"),),
            out_specs=P("rows"),
        )
        y = f(diag, inp[0], inp[1], right[0], right[1], jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), A @ x, atol=1e-10)

    def test_rejects_wide_band(self):
        from eigenex_tpu.parallel.distributed import split_sym_bsr_halo
        from eigenex_tpu.sparse.bsr import bsr_from_dense
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr
        from eigenex_tpu.utils.exceptions import EigenexError

        n = 32
        A = np.eye(n)
        A[0, 20] = A[20, 0] = 1.0  # reaches shard 5 from shard 0
        sym = sym_bsr_from_bsr(bsr_from_dense(A, (4, 4)))
        with pytest.raises(EigenexError):
            split_sym_bsr_halo(sym, 8)

    def test_sym_operand_driver_and_padding(self, mesh):
        # SymBSRMatrix operand + non-divisible block rows: pad path and
        # eigenvector truncation to the original length
        from eigenex_tpu.parallel.distributed import (
            DistributedThickRestartLanczosEigenSolver,
        )
        from eigenex_tpu.solvers.restart import ThickRestartOptions
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr
        from eigenex_tpu.utils.exceptions import EigenexError

        bsr, A = self._sym_banded(nbr=30, bm=4)  # 30 % 8 != 0
        sym = sym_bsr_from_bsr(bsr)
        res = DistributedThickRestartLanczosEigenSolver(
            sym, mesh,
            ThickRestartOptions(max_eigenvalues=2, tolerance=1e-12,
                                max_subspace=30, max_restarts=60),
            matvec_mode="sym_halo",
        ).compute()
        ref = np.linalg.eigvalsh(A)[:2]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), ref, atol=1e-9)
        assert res.eigenvectors.shape[0] == A.shape[0]  # truncated to orig n
        with pytest.raises(EigenexError):
            DistributedThickRestartLanczosEigenSolver(
                sym, mesh, ThickRestartOptions(max_eigenvalues=2),
                matvec_mode="allgather",
            )


class TestDistributedLOBPCG:
    def test_matches_single_device(self, mesh):
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions, lobpcg

        n, k = 96, 3
        bsr = laplacian_bsr(n, 8)
        dist = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-12), block_size=k
        ).compute()
        single = lobpcg(jnp.asarray(np.asarray(bsr.to_dense())), k, tol=1e-12)
        exact = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
        np.testing.assert_allclose(dist.eigenvalues, exact, atol=1e-9)
        np.testing.assert_allclose(dist.eigenvalues, single.eigenvalues, atol=1e-9)
        assert dist.converged

    def test_padding_and_vector_slicing(self, mesh):
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions

        n, k = 36, 2  # 36/4 = 9 block rows -> pads to 16 over 8 shards
        bsr = laplacian_bsr(n, 4)
        res = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-11), block_size=k
        ).compute()
        exact = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-8)
        assert res.eigenvectors.shape == (n, k)
        # residual in the ORIGINAL (unpadded) problem
        A = np.asarray(bsr.to_dense())[:n, :n]
        X = np.asarray(res.eigenvectors)
        r = A @ X - X * np.asarray(res.eigenvalues)[None, :]
        assert np.linalg.norm(r, axis=0).max() < 1e-7

    def test_row_local_preconditioner(self, mesh):
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions

        n, k = 64, 2
        bsr = laplacian_bsr(n, 8)
        dinv = jnp.full(n, 1 / 2.0)  # Jacobi diag of the Laplacian
        res = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-11), block_size=k,
            preconditioner=lambda R: dinv[:, None] * R,
        ).compute()
        exact = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-8)

    def test_generalized_pencil_matches_single_device(self, mesh):
        """Round-3 lift: A x = lambda B x on the mesh — B-inner products
        are the same psum'd Grams (VERDICT round-2 item 8)."""
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions, lobpcg
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        n, k = 64, 2
        bsr = laplacian_bsr(n, 8)
        # FEM-style mass matrix: tridiagonal, positive definite
        B = (4 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)) / 6.0
        bsrB = bsr_from_dense(B, (8, 8))
        dist = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-12), block_size=k,
            b_operator=bsrB,
        ).compute()
        A = np.asarray(bsr.to_dense())
        from scipy.linalg import eigh as scipy_eigh

        exact = scipy_eigh(A, B, eigvals_only=True)[:k]
        np.testing.assert_allclose(dist.eigenvalues, exact, atol=1e-9)
        single = lobpcg(jnp.asarray(A), k, B=jnp.asarray(B), tol=1e-12)
        np.testing.assert_allclose(dist.eigenvalues, single.eigenvalues, atol=1e-9)

    def test_generalized_pencil_with_padding(self, mesh):
        """Generalized + padding: both operands pad identically and the
        padding-safe start block keeps the degenerate padded pencil
        rows out of the iteration."""
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        n, k = 36, 2  # 9 block rows of 4 -> pads to 16 over 8 shards
        bsr = laplacian_bsr(n, 4)
        B = (4 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)) / 6.0
        res = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-11), block_size=k,
            b_operator=bsr_from_dense(B, (4, 4)),
        ).compute()
        A = np.asarray(bsr.to_dense())[:n, :n]
        from scipy.linalg import eigh as scipy_eigh

        exact = scipy_eigh(A, B, eigvals_only=True)[:k]
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-8)
        assert res.eigenvectors.shape == (n, k)

    def test_container_preconditioner(self, mesh):
        """A block-sparse container preconditioner is meshified and
        applied through the distributed matmat — no row-locality
        restriction (round-3 lift)."""
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        n, k = 64, 2
        bsr = laplacian_bsr(n, 8)
        T = np.diag(np.full(n, 0.5))  # Jacobi as a container
        res = DistributedLOBPCGSolver(
            bsr, mesh, LOBPCGOptions(tolerance=1e-11), block_size=k,
            preconditioner=bsr_from_dense(T, (8, 8)),
        ).compute()
        exact = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-8)

    def test_sym_halo_mode(self, mesh):
        """SymBSRMatrix operand: half-traffic storage through the
        distributed LOBPCG SpMMs."""
        from eigenex_tpu.parallel import DistributedLOBPCGSolver
        from eigenex_tpu.solvers.lobpcg import LOBPCGOptions
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

        n, k = 64, 2
        bsr = laplacian_bsr(n, 8)
        sym = sym_bsr_from_bsr(bsr)
        res = DistributedLOBPCGSolver(
            sym, mesh, LOBPCGOptions(tolerance=1e-11), block_size=k,
        ).compute()
        exact = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
        np.testing.assert_allclose(res.eigenvalues, exact, atol=1e-8)


# ---------------------------------------------------------------------------
# Round 3: global-array mesh operator + distributed SpMM twins
# ---------------------------------------------------------------------------
class TestMeshOperator:
    """mesh_operator(A).matvec/matmat on global arrays must match the
    single-device container bit-for-bit semantics in every mode."""

    def _sym_banded(self, nbr=16, bs=8, seed=7):
        rng = np.random.default_rng(seed)
        n = nbr * bs
        A = np.zeros((n, n))
        for r in range(nbr):
            for c in (r, r + 1):
                if c < nbr:
                    A[r*bs:(r+1)*bs, c*bs:(c+1)*bs] = rng.standard_normal((bs, bs))
        A = (A + A.T) / 2
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        return bsr_from_dense(A, (bs, bs)), A

    @pytest.mark.parametrize("mode", ["allgather", "colsplit", "halo", "sym_halo"])
    def test_matvec_and_matmat_match_single_device(self, mesh, mode):
        from eigenex_tpu.parallel import mesh_operator

        bsr, A = self._sym_banded()
        op = mesh_operator(bsr, mesh, matvec_mode=mode)
        rng = np.random.default_rng(11)
        x = jnp.asarray(rng.standard_normal(bsr.shape[0]))
        X = jnp.asarray(rng.standard_normal((bsr.shape[0], 5)))
        np.testing.assert_allclose(np.asarray(op.matvec(x)), A @ np.asarray(x), atol=1e-11)
        np.testing.assert_allclose(np.asarray(op.matmat(X)), A @ np.asarray(X), atol=1e-11)

    def test_sym_halo_accepts_sym_container(self, mesh):
        from eigenex_tpu.parallel import mesh_operator
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

        bsr, A = self._sym_banded()
        sym = sym_bsr_from_bsr(bsr)
        op = mesh_operator(sym, mesh, matvec_mode="sym_halo")
        X = jnp.asarray(np.random.default_rng(12).standard_normal((bsr.shape[0], 3)))
        np.testing.assert_allclose(np.asarray(op.matmat(X)), A @ np.asarray(X), atol=1e-11)
        # Hermitian: adjoint action available and equal
        x = X[:, 0]
        np.testing.assert_allclose(np.asarray(op.rmatvec(x)), A @ np.asarray(x), atol=1e-11)

    def test_mode_validation(self, mesh):
        from eigenex_tpu.parallel import mesh_operator
        from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr
        from eigenex_tpu.utils.exceptions import EigenexError

        bsr, _ = self._sym_banded()
        with pytest.raises(EigenexError):
            mesh_operator(bsr, mesh, matvec_mode="bogus")
        with pytest.raises(EigenexError):
            mesh_operator(sym_bsr_from_bsr(bsr), mesh, matvec_mode="allgather")

    def test_jit_traceable_operand(self, mesh):
        """The mesh operator is a pytree usable as a traced jit argument
        (the Chebyshev/KPM loops pass it through jitted stages)."""
        from eigenex_tpu.parallel import mesh_operator

        bsr, A = self._sym_banded()
        op = mesh_operator(bsr, mesh, matvec_mode="halo")

        @jax.jit
        def chain(o, v):
            return o.matvec(o.matvec(v))

        x = jnp.asarray(np.random.default_rng(13).standard_normal(bsr.shape[0]))
        np.testing.assert_allclose(
            np.asarray(chain(op, x)), A @ (A @ np.asarray(x)), atol=1e-10
        )


# ---------------------------------------------------------------------------
# Round 3: 2-D mesh operator (R x C panel grid, n/C + n/R wire per matvec)
# ---------------------------------------------------------------------------
class TestMeshOperator2D:
    def _op(self, nbr=16, bs=8, seed=21):
        rng = np.random.default_rng(seed)
        n = nbr * bs
        A = np.zeros((n, n))
        # general (non-banded) sparsity: random block pattern
        for r in range(nbr):
            for c in rng.choice(nbr, size=4, replace=False):
                A[r*bs:(r+1)*bs, c*bs:(c+1)*bs] = rng.standard_normal((bs, bs))
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        return bsr_from_dense(A, (bs, bs)), A

    @pytest.mark.parametrize("shape2d", [(2, 4), (4, 2), (8, 1), (1, 8)])
    def test_matvec_matmat_match_dense(self, shape2d):
        from jax.sharding import Mesh
        from eigenex_tpu.parallel import mesh_operator_2d

        R, C = shape2d
        bsr, A = self._op()
        mesh = Mesh(np.array(jax.devices("cpu")).reshape(R, C), ("r", "c"))
        op = mesh_operator_2d(bsr, mesh)
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.standard_normal(bsr.shape[0]))
        X = jnp.asarray(rng.standard_normal((bsr.shape[0], 3)))
        np.testing.assert_allclose(np.asarray(op.matvec(x)), A @ np.asarray(x), atol=1e-11)
        np.testing.assert_allclose(np.asarray(op.matmat(X)), A @ np.asarray(X), atol=1e-11)

    def test_chained_matvecs_reshard_automatically(self):
        """y comes back P((r,c)); feeding it to the next matvec (which
        consumes P((c,r))) must work — XLA inserts the re-layout."""
        from jax.sharding import Mesh
        from eigenex_tpu.parallel import mesh_operator_2d

        bsr, A = self._op()
        mesh = Mesh(np.array(jax.devices("cpu")).reshape(2, 4), ("r", "c"))
        op = mesh_operator_2d(bsr, mesh)
        x = jnp.asarray(np.random.default_rng(6).standard_normal(bsr.shape[0]))

        @jax.jit
        def twice(o, v):
            return o.matvec(o.matvec(v))

        np.testing.assert_allclose(
            np.asarray(twice(op, x)), A @ (A @ np.asarray(x)), atol=1e-10
        )

    def test_lanczos_through_2d_operator(self):
        """The full single-controller Lanczos driver runs on the 2-D
        operator unchanged (global arrays, sharding propagation)."""
        from jax.sharding import Mesh
        from eigenex_tpu.parallel import mesh_operator_2d
        from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions

        bsr, A = self._op()
        A = (A + A.T) / 2
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        bsr = bsr_from_dense(A, (8, 8))
        mesh = Mesh(np.array(jax.devices("cpu")).reshape(2, 4), ("r", "c"))
        op = mesh_operator_2d(bsr, mesh)
        res = LanczosEigenSolver(
            op, LanczosOptions(max_eigenvalues=2, tolerance=1e-12, max_subspace=64)
        ).compute()
        ref = np.linalg.eigvalsh(A)[:2]
        np.testing.assert_allclose(res.eigenvalues, ref, atol=1e-8)

    def test_split_validation(self):
        from jax.sharding import Mesh
        from eigenex_tpu.parallel import mesh_operator_2d
        from eigenex_tpu.utils.exceptions import EigenexError

        bsr, _ = self._op(nbr=15)  # 15 % 2 != 0
        mesh = Mesh(np.array(jax.devices("cpu")).reshape(2, 4), ("r", "c"))
        with pytest.raises(EigenexError):
            mesh_operator_2d(bsr, mesh)


class TestInitializeMultihost:
    """Argument-contract tests for the multi-host wrapper (the pod-only
    end-to-end path can't run on a 1-host box, so errors must surface at
    the call, not as coordinator hangs on the pod — round-3 hardening of
    the VERDICT 'untested thin wrapper' item)."""

    def test_partial_args_rejected(self):
        from eigenex_tpu.parallel import initialize_multihost

        with pytest.raises(ValueError, match="together"):
            initialize_multihost(coordinator_address="10.0.0.1:1234")
        with pytest.raises(ValueError, match="together"):
            initialize_multihost(num_processes=4, process_id=0)

    def test_process_id_range_checked(self):
        from eigenex_tpu.parallel import initialize_multihost

        with pytest.raises(ValueError, match="outside"):
            initialize_multihost("10.0.0.1:1234", num_processes=4, process_id=4)
        with pytest.raises(ValueError, match="positive"):
            initialize_multihost("10.0.0.1:1234", num_processes=0, process_id=0)

    def test_forwards_exact_kwargs(self, monkeypatch):
        import jax
        from eigenex_tpu.parallel import initialize_multihost

        seen = {}
        monkeypatch.setattr(
            jax.distributed, "initialize", lambda **kw: seen.update(kw)
        )
        mesh = initialize_multihost(
            "10.0.0.1:1234", num_processes=4, process_id=2, make_global_mesh=True
        )
        assert seen == {
            "coordinator_address": "10.0.0.1:1234",
            "num_processes": 4,
            "process_id": 2,
        }
        assert mesh is not None and mesh.axis_names == ("rows",)

    def test_auto_detect_passes_nothing(self, monkeypatch):
        import jax
        from eigenex_tpu.parallel import initialize_multihost

        seen = {"called": False}

        def fake(**kw):
            seen["called"] = True
            assert kw == {}

        monkeypatch.setattr(jax.distributed, "initialize", fake)
        initialize_multihost()
        assert seen["called"]
