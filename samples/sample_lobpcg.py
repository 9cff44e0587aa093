"""LOBPCG: preconditioned and generalized eigenproblems in one call.

Drives the block preconditioned solver (net-new vs the reference, whose
only Hermitian driver is single-vector Lanczos, lanczos.hpp:469) on the
two problems Krylov methods cannot express directly:

1. a PRECONDITIONED lowest-eigenpair solve of an ill-conditioned
   operator (graded diagonal, condition ~1e5) — the Jacobi
   preconditioner cuts the iteration count by an order of magnitude;
2. a GENERALIZED pencil ``K x = λ M x`` (stiffness/mass form of a
   1-D finite-element Laplacian) solved natively with B-inner products,
   checked against the closed-form FEM eigenvalues.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import eigenex_tpu as ex

# -- 1. preconditioning pays ------------------------------------------------
n, k = 500, 3
rng = np.random.default_rng(0)
d = np.logspace(0, 5, n)
A = np.diag(d) + 1e-3 * (lambda m: (m + m.T) / 2)(rng.standard_normal((n, n)))
coo = ex.coo_from_dense(A)

plain = ex.lobpcg(jnp.asarray(A), k, tol=1e-10, max_iterations=500, seed=1)
prec = ex.lobpcg(
    jnp.asarray(A), k, preconditioner=ex.jacobi_preconditioner(coo),
    tol=1e-10, max_iterations=500, seed=1,
)
ref = np.linalg.eigvalsh(A)[:k]
print(f"plain:          {plain.iterations:4d} iterations, converged={plain.converged}")
print(f"preconditioned: {prec.iterations:4d} iterations, converged={prec.converged}")
print(f"eigenvalues: {prec.eigenvalues}")
assert prec.converged and np.allclose(prec.eigenvalues, ref, atol=1e-6)
assert (not plain.converged) or prec.iterations < plain.iterations

# -- 2. generalized pencil K x = λ M x (P1 finite elements) -----------------
# K = (1/h)·tridiag(-1, 2, -1),  M = (h/6)·tridiag(1, 4, 1); eigenvalues
# λ_j = (6/h²)·(1−cos jπh)/(2+cos jπh) — the FEM approximation of (jπ)².
ne = 200
h = 1.0 / ne
m_int = ne - 1
K = (np.diag(2 * np.ones(m_int)) - np.diag(np.ones(m_int - 1), 1) - np.diag(np.ones(m_int - 1), -1)) / h
M = (np.diag(4 * np.ones(m_int)) + np.diag(np.ones(m_int - 1), 1) + np.diag(np.ones(m_int - 1), -1)) * h / 6

res = ex.eigsh(jnp.asarray(K), 4, M=jnp.asarray(M), tol=1e-12, max_iterations=300)
j = np.arange(1, 5)
lam_exact = 6 / h**2 * (1 - np.cos(j * np.pi * h)) / (2 + np.cos(j * np.pi * h))
print(f"FEM pencil eigenvalues: {res.eigenvalues}")
print(f"closed form:            {lam_exact}")
print(f"(continuum (jπ)²:       {(j * np.pi) ** 2})")
assert np.allclose(res.eigenvalues, lam_exact, rtol=1e-9)

# B-orthonormality of the returned block: Xᵀ M X = I
X = np.asarray(res.eigenvectors)
assert np.allclose(X.T @ M @ X, np.eye(4), atol=1e-8)
print("sample_lobpcg OK")
