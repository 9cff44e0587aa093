"""Full configuration tour on a complex Hermitian sparse operator.

Mirrors reference sample_lanczos2.cpp:21-86: an n=200 complex operator
(tridiagonal with imaginary antisymmetric off-diagonal), every fluent
setter exercised, convergence log printed."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import jax
import numpy as np

import eigenex_tpu as ex

n = 200
b = ex.COOBuilder(n, n, np.complex128)
for i in range(n):
    b.append(i, i, 2.0)
    if i + 1 < n:
        b.append(i, i + 1, -1.0j)   # H[i, i+1] = -i
        b.append(i + 1, i, +1.0j)   # H[i+1, i] = +i  (Hermitian)
coo = b.build()
op = coo.as_linear_operator()

lo, hi = coo.estimate_eigenvalue_range()
print(f"Gershgorin eigenvalue range: [{float(lo):.3f}, {float(hi):.3f}]")

solver = (
    ex.LanczosEigenSolver(op)
    .set_tolerance(1e-12)                # cf. setTolerance
    .set_min_iterations(10)              # cf. setMinIterations
    .set_max_iterations(ex.UNLIMITED)    # cf. setMaxIterations(unlimited)
    .set_max_subspace(n)
    .set_reorthogonalize_interval(1)     # cf. setReorthogonalizeInterval
    .set_max_eigenvalues(3)              # cf. setMaxEigenvalues
    .set_eigenvalue_shift(0.0)           # cf. setEigenvalueShift
    .set_breakdown_threshold(1e-12)      # cf. setBreakdownThreshold
    .set_check_every(8)
    .set_seed(42)
)
res = solver.compute()

print("eigenvalues:", res.eigenvalues)
ref = np.linalg.eigvalsh(np.asarray(coo.to_dense()))
print("dense oracle:", ref[:3])
print("residuals:", res.residual_norms(op))
print("iterations:", res.iterations, "| converged:", res.converged)
print()
print("convergence log (cf. sample_lanczos2.cpp:76-86):")
print(res.trace)
