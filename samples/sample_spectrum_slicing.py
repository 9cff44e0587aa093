"""Spectrum slicing without linear solves — single device and mesh.

Demonstrates the round-3 filter stack end-to-end on a 1D Laplacian:

1. Gershgorin bounds straight off the BSR container (the block analog of
   estimateEigenvalueRange, triplets_matrix.hpp:512-540);
2. KPM density of states + eigenvalue counts per interval;
3. `eigsh_window` — all eigenpairs in an interior window by Chebyshev
   bandpass subspace iteration (every device op an SpMM);
4. the same window on an 8-virtual-device mesh (`mesh=`): distributed
   SpMM chain + CholeskyQR2 panel orthonormalization, identical results.

Run: python samples/sample_spectrum_slicing.py (CPU-safe; on a pod the
mesh path row-partitions over real chips unchanged).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from eigenex_tpu import eigsh_window
from eigenex_tpu.solvers.kpm import eigenvalue_count, spectral_density
from eigenex_tpu.sparse.bsr import bsr_from_dense

n = 400
A = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
bsr = bsr_from_dense(A, (4, 4))
exact = 2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))

lo, hi = map(float, bsr.estimate_eigenvalue_range())
print(f"Gershgorin bounds: [{lo:.3f}, {hi:.3f}]  (true spectrum in (0, 4))")

window = (1.9, 2.1)
count = eigenvalue_count(bsr, window, n_moments=200, n_probes=16)
true_count = int(((exact >= window[0]) & (exact <= window[1])).sum())
print(f"KPM count in {window}: {count:.1f}  (true: {true_count})")

lam_grid, rho = spectral_density(bsr, n_moments=160)
print(f"DOS integral ~ n: {np.trapezoid(rho, lam_grid):.1f} (n = {n})")

res = eigsh_window(bsr, window, block_size=true_count + 4, degree=80, tol=1e-11)
want = exact[(exact >= window[0]) & (exact <= window[1])]
err = np.max(np.abs(np.sort(res.eigenvalues) - want))
print(f"eigsh_window: {res.eigenvalues.size} pairs, max |λ−exact| = {err:.2e}")

# the SAME call on a device mesh: the filter's SpMM chain runs
# row-partitioned; results match the single-device run (several cards,
# or virtual CPU devices via XLA_FLAGS=--xla_force_host_platform_device_count=8)
devices = jax.devices()
if len(devices) >= 2:
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devices[: min(len(devices), 8)]), ("rows",))
    res_m = eigsh_window(
        bsr, window, block_size=true_count + 4, degree=80, tol=1e-11,
        mesh=mesh, matvec_mode="halo",
    )
    derr = np.max(np.abs(np.sort(res_m.eigenvalues) - np.sort(res.eigenvalues)))
    print(f"mesh ({mesh.devices.size} devices, halo SpMM): same pairs to {derr:.2e}")

assert err < 1e-9
print("sample_spectrum_slicing OK")
