"""The five BASELINE.json configs as asserted integration tests
(VERDICT round-1 item 8).

Each test runs a CI-sized instance of the config end-to-end on the
8-virtual-device CPU mesh (x64) and asserts a MEASURED f64 error —
1e-10-grade where the config's accuracy target applies.  The full-size
on-chip runs live in benchmarks/ and their measured rows in BASELINE.md.

Run just these: ``pytest -m baseline``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.baseline


# ---------------------------------------------------------------------------
# Config 1 — "Lanczos: lowest 5 eigenpairs of a 1D Laplacian tridiagonal
# CSR matrix (n=10^4), full reorthogonalization"
# ---------------------------------------------------------------------------
def test_config1_laplacian_lowest5_1e4():
    """FULL SIZE n=10^4.  The low end is clustered at relative gaps
    ~1e-7 (plain Lanczos needs thousands of iterations), so the device
    route is shift-invert with the EXACT tridiagonal direct solve
    (lax.linalg.tridiagonal_solve) — a handful of outer iterations."""
    from eigenex_tpu.solvers.direct import tridiagonal_shift_invert_operator
    from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions

    n = 10_000
    sigma = -1e-6
    d = np.full(n, 2.0)
    off = np.full(n - 1, -1.0)
    si = tridiagonal_shift_invert_operator(off, d, off, sigma, dtype=jnp.float64)
    res = LanczosEigenSolver(
        si,
        LanczosOptions(
            max_eigenvalues=5,
            eigenvalue_indices=(-5, -4, -3, -2, -1),  # largest theta
            tolerance=1e-14,
            max_subspace=40,
            reorthogonalize_interval=1,  # full reorthogonalization
            compute_eigenvectors=False,
        ),
    ).compute()
    theta = np.sort(np.asarray(res.eigenvalues))[::-1][:5]
    lam = np.sort(sigma + 1.0 / theta)
    exact = 2 - 2 * np.cos(np.arange(1, 6) * np.pi / (n + 1))
    err = np.max(np.abs(lam - exact))
    assert err <= 1e-10, f"config 1 measured error {err:.2e}"


# ---------------------------------------------------------------------------
# Config 2 — "Arnoldi: dominant eigenpairs of a nonsymmetric sparse
# operator (2D convection-diffusion COO)" — CI-sized nx=60 (n=3600);
# the n=10^5 on-chip run is benchmarks/bench_arnoldi.py
# ---------------------------------------------------------------------------
def test_config2_convection_diffusion_dominant():
    import sys

    sys.path.insert(0, ".")
    from benchmarks.bench_arnoldi import convection_diffusion_coo
    from eigenex_tpu.solvers.api import eigs
    from eigenex_tpu.sparse.coo import COOMatrix

    r, c, v, n = convection_diffusion_coo(60)
    coo = COOMatrix(
        jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32)),
        jnp.asarray(v), (n, n),
    )
    res = eigs(coo, k=3, tol=1e-9, max_subspace=80, max_restarts=200, refine=True)
    got = np.asarray(res.eigenvalues)[:3]

    # The upwind convection-diffusion operator is the textbook
    # ill-conditioned-pseudospectrum case (its symmetrizer D A D^-1 has
    # condition ((1+c)/(1-c))^(nx/2) ~ 1e11 here): in exact arithmetic
    # the spectrum is the REAL Kronecker sum
    # lambda_ij = 4 + 2 sqrt(1-c^2)(cos i pi/(nx+1) + cos j pi/(nx+1)),
    # but EVERY f64 method (dense LAPACK, ARPACK, this solver) returns
    # values scattered ~1e-2 around it — the forward eigenvalue problem
    # is ill-posed beyond the pseudospectral radius.  The well-posed
    # 1e-10 certificate for non-normal operators is the BACKWARD error:
    # (lambda, x) must be an exact eigenpair of A + dA, |dA| <= 1e-10|A|.
    from eigenex_tpu.solvers.refine import general_rayleigh_refine

    lam_check, resid = general_rayleigh_refine(coo, np.asarray(res.eigenvectors))
    scale = float(np.max(np.abs(got)))
    backward = float(np.max(resid)) / scale
    assert backward <= 1e-10, f"config 2 measured backward error {backward:.2e}"
    np.testing.assert_allclose(lam_check, got, atol=1e-10 * scale)

    # forward sanity: within the pseudospectral scatter of the true
    # (closed-form, real) spectrum's dominant edge
    cgrid = np.cos(np.arange(1, 61) * np.pi / 61)
    lam_true = 4 + 2 * np.sqrt(1 - 0.4**2) * (cgrid[:, None] + cgrid[None, :])
    top = np.sort(lam_true.ravel())[::-1][:10]
    assert all(np.min(np.abs(top - lam.real)) < 5e-2 for lam in got)


# ---------------------------------------------------------------------------
# Config 3 — "BlockTensor: block-sparse Heisenberg spin-chain Hamiltonian
# matvec + Lanczos ground state (symmetry-sector blocks)" — L=14 through
# the sparse-block BlockTensor path; L=24 on-chip in benchmarks/
# ---------------------------------------------------------------------------
def test_config3_heisenberg_blocktensor_ground_state():
    from eigenex_tpu.block.hamiltonians import (
        heisenberg_block_hamiltonian,
        heisenberg_sector_coo,
    )
    from eigenex_tpu.block.operator import block_operator
    from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions

    L = 14
    bt = heisenberg_block_hamiltonian(L, storage="sparse")
    assert bt.has_sparse_blocks  # never densified
    op = block_operator(bt)
    res = LanczosEigenSolver(
        op,
        LanczosOptions(max_eigenvalues=1, tolerance=1e-13, max_subspace=140,
                       compute_eigenvectors=False),
    ).compute()
    coo = heisenberg_sector_coo(L, L // 2)
    direct = LanczosEigenSolver(
        coo.as_linear_operator(),
        LanczosOptions(max_eigenvalues=1, tolerance=1e-13, max_subspace=140,
                       compute_eigenvectors=False),
    ).compute()
    err = abs(res.eigenvalues[0] - direct.eigenvalues[0])
    assert err <= 1e-10, f"config 3 measured error {err:.2e}"


# ---------------------------------------------------------------------------
# Config 4 — "Tensor SVD + einsum: truncated SVD of a rank-4 tensor via
# Lanczos on the Gram matrix, einsum-built operator"
# ---------------------------------------------------------------------------
def test_config4_truncated_svd_via_gram_lanczos(rng):
    from eigenex_tpu.ops.sparse_svd import truncated_svd_via_lanczos

    t = jnp.asarray(rng.standard_normal((6, 8, 7, 5)))
    out = truncated_svd_via_lanczos(t, left_axes=2, rank=3, tolerance=1e-14)
    ref = np.linalg.svd(np.asarray(t).reshape(48, 35), compute_uv=False)[:3]
    err = np.max(np.abs(np.asarray(out.singular_values) - ref))
    assert err <= 1e-10, f"config 4 measured singular-value error {err:.2e}"
    # reconstruction sanity at the truncated rank (tensor_v stored
    # conjugated, matching the reference convention tensor_svd.hpp:164-167)
    U = np.asarray(out.tensor_u).reshape(48, 3)
    V = np.asarray(out.tensor_v).reshape(35, 3)
    M3 = (U * np.asarray(out.singular_values)) @ V.T
    u_np, s_np, vt_np = np.linalg.svd(np.asarray(t).reshape(48, 35), full_matrices=False)
    ref3 = (u_np[:, :3] * s_np[:3]) @ vt_np[:3]
    assert np.linalg.norm(M3 - ref3) <= 1e-8


# ---------------------------------------------------------------------------
# Config 5 — "Multi-host: BSR Hamiltonian row-partitioned over N>=2
# hosts, halo-overlapped SpMV, shift-invert Lanczos" — virtual-8 CI form
# (the 10^8-row scale is a memory statement, not a CI one; the 8.4M-row
# single-chip form runs in benchmarks/bench_large.py)
# ---------------------------------------------------------------------------
def test_config5_distributed_halo_shift_invert():
    from jax.sharding import Mesh

    from eigenex_tpu.parallel.distributed import (
        distributed_lanczos_steps,
        pad_bsr_for_mesh,
    )
    from eigenex_tpu.solvers.lanczos import init_lanczos_state, tridiagonal_eigh
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays

    n = 512
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    bsr = pad_bsr_for_mesh(bsr_from_coo_arrays(rows, cols, vals, (n, n), (4, 4)), 8)
    mesh = Mesh(np.array(jax.devices("cpu")), ("rows",))
    # sigma just below lambda_1 = 3.76e-5: theta_1/theta_2 well separated
    # (a far-away sigma clusters the thetas and stalls the outer Lanczos)
    sigma = -1e-4
    op = bsr.as_linear_operator()
    state = init_lanczos_state(op, 32, seed=0)
    state = distributed_lanczos_steps(
        bsr, state, 32, mesh,
        matvec_mode="halo",
        shift_invert_sigma=sigma,
        cg_tol=1e-13,
        cg_max_iters=3000,
    )
    k = int(state.k)
    theta = tridiagonal_eigh(
        np.asarray(state.alpha[:k]), np.asarray(state.beta[:k]), eigvals_only=True
    )
    lam_min = sigma + 1.0 / theta[-1]  # largest theta <-> eigenvalue nearest sigma
    exact = 2 - 2 * np.cos(np.pi / (n + 1))
    err = abs(lam_min - exact)
    assert err <= 1e-9, f"config 5 measured error {err:.2e}"


def test_config5_accelerate_mesh_composition():
    """Round-5 form of config 5: the PACKED (RCM + half-traffic sym
    block) operator row-partitioned over the mesh in ONE call — the
    route the 10^8-row north star requires once the packed container
    exceeds one chip's HBM (measured: 8.4 GiB at L=24, ~40 GB at L=26
    vs 16 GB/chip — BASELINE round-5)."""
    import scipy.sparse as sp
    from jax.sharding import Mesh

    from eigenex_tpu.solvers.api import eigsh
    from eigenex_tpu.sparse.accelerate import accelerate

    rng = np.random.default_rng(53)
    n, bw = 1200, 64
    r = np.repeat(np.arange(n), 4)
    c = r + rng.integers(1, bw, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    shuf = rng.permutation(n)
    trip = (shuf[rows], shuf[cols], vals, (n, n))

    acc = accelerate(trip, block=8, dtype=jnp.float64)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
    res = eigsh(acc, k=3, which="SA", tol=1e-10, mesh=mesh)
    dense = sp.coo_matrix((vals, (shuf[rows], shuf[cols])), shape=(n, n)).toarray()
    ev = np.sort(np.linalg.eigvalsh(dense))
    err = np.abs(np.asarray(res.eigenvalues) - ev[:3]).max()
    assert err <= 1e-9 * max(np.abs(ev).max(), 1.0), f"composition error {err:.2e}"
    V = np.asarray(res.eigenvectors)
    assert V.shape == (n, 3)  # restored to ORIGINAL coordinates
