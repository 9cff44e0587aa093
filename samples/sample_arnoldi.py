"""Arnoldi on a random nonsymmetric matrix, verifying ‖A·P − P·D‖ ≈ 0.

Mirrors reference sample_arnoldi.cpp:42-52."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import jax
import jax.numpy as jnp
import numpy as np

import eigenex_tpu as ex

n = 50
A = ex.random_matrix(jax.random.PRNGKey(0), n, n, jnp.float64)
op = ex.aslinearoperator(A)

res = ex.ArnoldiEigenSolver(
    op, ex.ArnoldiOptions(max_eigenvalues=5, tolerance=1e-12, max_subspace=n)
).compute()

print("dominant eigenvalues (|λ| desc):")
for lam in res.eigenvalues:
    print(f"  {lam:.10f}  |λ| = {abs(lam):.10f}")

# the acceptance identity of the reference sample (combined on host)
P = np.asarray(res.eigenvectors)
D = np.asarray(res.eigenvalues)
AP = np.asarray(op.matmat(jnp.asarray(P.real, A.dtype))) + 1j * np.asarray(
    op.matmat(jnp.asarray(P.imag, A.dtype))
)
print("‖A·P − P·D‖ =", np.linalg.norm(AP - P * D[None, :]))
print("residuals:", res.residual_norms(op))
