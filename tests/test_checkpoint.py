"""Checkpoint/resume tests: interrupted solve restored from disk must
finish identically to an uninterrupted one."""

import jax.numpy as jnp
import numpy as np

from eigenex_tpu.solvers.arnoldi import ArnoldiState, init_arnoldi_state
from eigenex_tpu.solvers.lanczos import (
    LanczosEigenSolver,
    LanczosOptions,
    LanczosState,
    init_lanczos_state,
    lanczos_steps,
)
from eigenex_tpu.core.operators import aslinearoperator
from eigenex_tpu.utils.checkpoint import load_state, save_state
from eigenex_tpu.utils.prng import random_hermitian


def test_lanczos_state_roundtrip(tmp_path, key):
    A = random_hermitian(key, 20, jnp.float64)
    op = aslinearoperator(A)
    s = lanczos_steps(op, init_lanczos_state(op, 10, seed=0), 5)
    p = str(tmp_path / "state.npz")
    save_state(p, s)
    s2 = load_state(p)
    assert isinstance(s2, LanczosState)
    np.testing.assert_array_equal(np.asarray(s.V), np.asarray(s2.V))
    np.testing.assert_array_equal(np.asarray(s.alpha), np.asarray(s2.alpha))
    assert int(s2.k) == 5 and not bool(s2.breakdown)


def test_arnoldi_state_roundtrip(tmp_path, key):
    from eigenex_tpu.utils.prng import random_matrix
    from eigenex_tpu.solvers.arnoldi import arnoldi_steps

    A = random_matrix(key, 16, 16, jnp.float64)
    op = aslinearoperator(A)
    s = arnoldi_steps(op, init_arnoldi_state(op, 8, seed=0), 4)
    p = str(tmp_path / "astate.npz")
    save_state(p, s)
    s2 = load_state(p)
    assert isinstance(s2, ArnoldiState)
    np.testing.assert_array_equal(np.asarray(s.H), np.asarray(s2.H))


def test_resume_from_checkpoint_matches_uninterrupted(tmp_path, key):
    """Kill-and-restore mid-solve ⇒ same eigenvalues as straight-through
    (the preemption-recovery story, SURVEY.md §5 failure detection)."""
    n = 60
    A = random_hermitian(key, n, jnp.float64)
    opts = LanczosOptions(max_eigenvalues=2, tolerance=1e-14, max_subspace=n, seed=3)

    straight = LanczosEigenSolver(A, opts).compute()

    # run half, checkpoint, "crash", restore into a fresh solver, resume
    op = aslinearoperator(A)
    half = lanczos_steps(op, init_lanczos_state(op, n, seed=3), 10)
    p = str(tmp_path / "mid.npz")
    save_state(p, half)

    solver = LanczosEigenSolver(A, opts)
    solver.state = load_state(p)
    resumed = solver.continue_to_compute()
    np.testing.assert_allclose(resumed.eigenvalues, straight.eigenvalues, atol=1e-10)


def test_distributed_resume_matches_straight(tmp_path):
    """Checkpoint/resume ON THE MESH: save a mid-run sharded state, restore
    it re-sharded with ``load_state(mesh=)``, continue distributed — bits
    must match the uninterrupted distributed run (the multi-host
    preemption-recovery story at scale, SURVEY.md §5)."""
    import jax
    from jax.sharding import Mesh
    from eigenex_tpu.parallel import (
        distributed_lanczos_steps,
        make_mesh,
        pad_bsr_for_mesh,
    )
    from eigenex_tpu.sparse.bsr import bsr_from_dense
    from eigenex_tpu.utils.checkpoint import shard_state

    devices = jax.devices("cpu")[:8]
    mesh = make_mesh(8, devices=devices)
    rng = np.random.default_rng(7)
    n = 8 * 4 * 4
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    A[np.abs(A) < 1.2] = 0.0
    np.fill_diagonal(A, np.arange(n, dtype=np.float64))
    bsr = pad_bsr_for_mesh(bsr_from_dense(jnp.asarray(A), (4, 4)), 8)
    op = bsr.as_linear_operator()

    from eigenex_tpu.solvers.lanczos import init_lanczos_state

    s0 = init_lanczos_state(op, 16, seed=1)
    straight = distributed_lanczos_steps(bsr, s0, 8, mesh)

    half = distributed_lanczos_steps(bsr, s0, 4, mesh)
    p = str(tmp_path / "dist.npz")
    save_state(p, half)  # gathers the sharded basis to host
    restored = load_state(p, mesh=mesh)  # re-sharded P(None, rows)
    # the restored basis carries the distributed layout
    assert restored.V.sharding.spec == jax.sharding.PartitionSpec(None, "rows")
    resumed = distributed_lanczos_steps(bsr, restored, 4, mesh)

    np.testing.assert_array_equal(np.asarray(resumed.alpha), np.asarray(straight.alpha))
    np.testing.assert_array_equal(np.asarray(resumed.beta), np.asarray(straight.beta))
    np.testing.assert_array_equal(np.asarray(resumed.V), np.asarray(straight.V))
    assert int(resumed.k) == 8


def test_shard_state_rejects_misaligned_width(tmp_path, key):
    import jax
    from eigenex_tpu.parallel import make_mesh
    from eigenex_tpu.utils.checkpoint import shard_state
    from eigenex_tpu.utils.exceptions import EigenexError
    import pytest

    A = random_hermitian(key, 30, jnp.float64)  # 30 not divisible by 8
    op = aslinearoperator(A)
    s = lanczos_steps(op, init_lanczos_state(op, 10, seed=0), 3)
    mesh = make_mesh(8, devices=jax.devices("cpu")[:8])
    with pytest.raises(EigenexError):
        shard_state(s, mesh)
