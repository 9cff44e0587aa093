"""Subprocess worker for the REAL multi-process jax.distributed tests.

Spawned N times by tests/test_multiprocess.py with a localhost
coordinator.  Each process gets ``devs`` virtual CPU devices; after
``initialize_multihost`` the global mesh spans all N*devs devices and
the requested scenario runs with the operator row-partitioned ACROSS
THE PROCESS BOUNDARY (SURVEY.md §5 comm backend; parallel/mesh.py).

Scenarios (round-5 hardening: the round-4 run exercised only allgather
steps at nproc=2):

- ``allgather_steps``  — raw ``distributed_lanczos_steps``, allgather
  matvec (the round-4 case).
- ``sym_halo_trlm``    — the FULL DistributedThickRestartLanczos driver
  over half-traffic SymBSR storage: the cross-process ppermute ring
  (forward x halo + reverse partial-y halo), restart compression and
  host convergence control all running multi-process.

The worker writes the replicated outputs (alpha/beta or eigenvalues —
fully addressable on every process) as JSON; the parent asserts
bit-equality across processes and oracle agreement.

Usage: python _multiproc_worker.py <coordinator> <nproc> <pid> <out>
       [scenario] [devs_per_process]
"""

import json
import os
import sys


def _laplacian_triplets(n):
    import numpy as np

    r = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    v = np.concatenate([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    return r, c, v


def _banded_sym_triplets(n, bw, seed=7):
    """Symmetric banded operator with off-diagonals past one block — the
    sym_halo boundary blocks then actually cross the process boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 3)
    c = r + rng.integers(1, bw, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    return rows, cols, vals


def scenario_allgather_steps(mesh, nd):
    import numpy as np

    from eigenex_tpu.parallel.distributed import (
        distributed_lanczos_steps,
        pad_bsr_for_mesh,
    )
    from eigenex_tpu.solvers.lanczos import init_lanczos_state
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays

    n = 64
    r, c, v = _laplacian_triplets(n)
    bsr = pad_bsr_for_mesh(bsr_from_coo_arrays(r, c, v, (n, n), (4, 4)), nd)
    op = bsr.as_linear_operator()
    v0 = np.random.default_rng(2).standard_normal(bsr.shape[1])
    s0 = init_lanczos_state(op, 20, v0=v0)
    s = distributed_lanczos_steps(bsr, s0, 12, mesh)
    # alpha/beta/k are replicated -> fully addressable on every process;
    # V is row-sharded across processes and must NOT be pulled here
    return {
        "k": int(s.k),
        "alpha": np.asarray(s.alpha).tolist(),
        "beta": np.asarray(s.beta).tolist(),
    }


def scenario_sym_halo_trlm(mesh, nd):
    import numpy as np

    from eigenex_tpu.parallel.distributed import (
        DistributedThickRestartLanczosEigenSolver,
        pad_bsr_for_mesh,
    )
    from eigenex_tpu.solvers.restart import ThickRestartOptions
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays
    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

    n, bw, bs = 256, 24, 4
    r, c, v = _banded_sym_triplets(n, bw)
    sym = sym_bsr_from_bsr(
        pad_bsr_for_mesh(bsr_from_coo_arrays(r, c, v, (n, n), (bs, bs)), nd)
    )
    solver = DistributedThickRestartLanczosEigenSolver(
        sym,
        mesh,
        ThickRestartOptions(
            max_eigenvalues=4, eigenvalue_indices=(0, 1, 2, 3),
            tolerance=1e-10, max_subspace=24, max_restarts=60, seed=0,
        ),
        axis_name=mesh.axis_names[0],
        matvec_mode="sym_halo",
    )
    res = solver.compute()
    return {
        "k": int(res.iterations),
        "eigenvalues": np.asarray(res.eigenvalues).tolist(),
        "converged": bool(res.converged),
    }


def main():
    coord, nproc, pid, out_path = sys.argv[1:5]
    scenario = sys.argv[5] if len(sys.argv) > 5 else "allgather_steps"
    devs = int(sys.argv[6]) if len(sys.argv) > 6 else 2
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devs}"
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from eigenex_tpu.parallel.mesh import initialize_multihost

    mesh = initialize_multihost(coord, int(nproc), int(pid), make_global_mesh=True)
    assert jax.process_count() == int(nproc), jax.process_count()
    assert len(jax.devices()) == devs * int(nproc), jax.devices()

    nd = devs * int(nproc)
    out = {
        "pid": int(pid),
        "process_count": jax.process_count(),
        "n_global_devices": len(jax.devices()),
        "n_local_devices": len(jax.local_devices()),
        "scenario": scenario,
    }
    out.update(
        {
            "allgather_steps": scenario_allgather_steps,
            "sym_halo_trlm": scenario_sym_halo_trlm,
        }[scenario](mesh, nd)
    )
    with open(f"{out_path}.{pid}", "w") as f:
        json.dump(out, f)
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
