"""Matrix Market IO tour: write an operator, load it back, solve it.

The reference has no file IO (operators are only ever assembled in code,
triplets_matrix.hpp:139-178); real workloads exchange operators in the
.mtx interchange format.  This sample writes a symmetric operator in
half (lower-triangle) storage, loads it three ways — expanded COO, raw
triangle, scipy fallback — and cross-checks a ground-state solve."""

import os as _os
import sys as _sys
import tempfile

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import eigenex_tpu as ex

# build a symmetric banded operator and write it in half storage
n = 500
rng = np.random.default_rng(0)
diag = np.arange(n, dtype=np.float64) * 0.1 + 1.0
off = rng.standard_normal(n - 1) * 0.3
D = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
A = ex.coo_from_dense(jnp.asarray(D))

path = _os.path.join(tempfile.mkdtemp(), "operator.mtx")
ex.save_matrix_market(path, A, symmetry="symmetric", comment="banded demo operator")
print(f"wrote {path}: {A.nnz} nnz as symmetric (lower-triangle) storage")

# load back: symmetry expanded to full COO
B = ex.load_matrix_market(path)
print(f"loaded: shape {B.shape}, nnz {B.nnz} (expanded)")
assert np.allclose(np.asarray(B.to_dense()), D)

# raw stored triangle (native parser) — the feed for half-traffic SymBSR
try:
    tri = ex.load_matrix_market(path, expand_symmetry=False)
    print(f"raw triangle: nnz {tri.nnz} (= diagonal + one triangle)")
except ex.EigenexError as e:
    print(f"raw-triangle load unavailable: {e}")

# the loaded operator drives the solvers directly
res = ex.eigsh(B, k=3, which="SA", tol=1e-12)
ref = np.linalg.eigvalsh(D)[:3]
print("lowest 3 eigenvalues:", np.asarray(res.eigenvalues))
print("vs dense eigh:       ", ref)
assert np.allclose(res.eigenvalues, ref, atol=1e-9)
print("OK")
