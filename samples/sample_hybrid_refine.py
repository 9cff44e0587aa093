"""Hybrid-precision pipeline: iterate on the device in f32, refine on
the host in f64 to reference-grade (1e-10) eigenvalues.

The Krylov heavy lifting (SpMV + CGS2, ~all the FLOPs) runs on the
device at f32 bandwidth; the final Rayleigh/inverse-iteration polish
costs a handful of host SpMVs.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import time

import numpy as np

import jax
import jax.numpy as jnp

import eigenex_tpu as ex
from eigenex_tpu.solvers.refine import inverse_iteration_refine, rayleigh_refine

n = 4096
print(f"building sparse symmetric operator (n={n}) ...")
rng = np.random.default_rng(0)
# banded symmetric: diagonal + a few off-diagonals
b = ex.COOBuilder(n, n, np.float64)
diag = rng.standard_normal(n) + 4.0
for i in range(n):
    b.append(i, i, diag[i])
for off in (1, 7, 64):
    vals = rng.standard_normal(n - off) * 0.5
    for i in range(n - off):
        b.append(i, i + off, vals[i])
        b.append(i + off, i, vals[i])
# host-resident f64 triplets (a device array would truncate to f32)
coo64 = b.build(to_device=False)

coo32 = ex.COOMatrix(
    jnp.asarray(coo64.row),
    jnp.asarray(coo64.col),
    jnp.asarray(coo64.val.astype(np.float32)),
    coo64.shape,
)
op32 = coo32.as_linear_operator()

print(f"f32 Lanczos on {jax.default_backend()} ...")
t0 = time.time()
res = ex.LanczosEigenSolver(
    op32,
    ex.LanczosOptions(max_eigenvalues=4, tolerance=1e-8, max_subspace=220, seed=0),
).compute()
t_iter = time.time() - t0
print(f"  {res.iterations} iterations in {t_iter:.1f}s -> f32 eigenvalues {res.eigenvalues}")

print("host f64 refinement ...")
t0 = time.time()
lam_r, resid_r = rayleigh_refine(coo64, res.eigenvectors)
lam_ii, X, resid_ii = inverse_iteration_refine(coo64, res.eigenvectors)
t_ref = time.time() - t0

ref = np.sort(np.linalg.eigvalsh(coo64.to_dense()))[:4]
print(f"  refinement took {t_ref:.1f}s")
print(f"  dense f64 oracle        : {ref}")
print(f"  |err| f32 Lanczos       : {np.abs(np.asarray(res.eigenvalues) - ref)}")
print(f"  |err| Rayleigh refine   : {np.abs(lam_r - ref)}")
print(f"  |err| inverse iteration : {np.abs(lam_ii - ref)}  (residuals {resid_ii})")
assert np.abs(lam_ii - ref).max() < 1e-10, "hybrid pipeline must reach 1e-10"
print("PASS: 1e-10-grade eigenvalues from f32 device iteration + f64 host polish")
