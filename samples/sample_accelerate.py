"""Scalar-sparse acceleration tour: RCM + block pack + solve + reload.

The reference's SpMV is a serial COO scatter (triplets_matrix.hpp:
314-318).  `sparse.accelerate` turns a "born scalar" operator into dense
128x128 blocks (symmetric: the half-traffic layout the GPU kernel
streams): a reverse Cuthill-McKee reorder concentrates the band, solvers
run in permuted coordinates, eigenvectors come back in the original
ones.  This sample walks the whole surface on a small
Anderson-type chain (real) and a random-phase hopping ring (complex
Hermitian — the sample_lanczos2.cpp operator class), then saves the
packed operator and reloads it (packing is the dominant cost at scale;
production packs once).

Run: python samples/sample_accelerate.py
"""

import os as _os
import sys as _sys
import tempfile

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from eigenex_tpu.solvers.api import eigsh
from eigenex_tpu.sparse.accelerate import AcceleratedOperator, accelerate

# --- a disordered 1-D chain with random long-range shortcuts ----------
n = 2000
rng = np.random.default_rng(0)
rows = [np.arange(n), np.arange(n - 1), np.arange(1, n)]
cols = [np.arange(n), np.arange(1, n), np.arange(n - 1)]
vals = [rng.uniform(-1, 1, n), -np.ones(n - 1), -np.ones(n - 1)]
# shortcuts destroy the natural band — RCM has to earn its keep
sr = rng.integers(0, n, 150)
sc = (sr + rng.integers(5, n // 3, 150)) % n
w = rng.uniform(-0.5, 0.5, 150)
rows += [sr, sc]
cols += [sc, sr]
vals += [w, w]
r, c, v = (np.concatenate(a) for a in (rows, cols, vals))

acc = accelerate((r, c, v, (n, n)))
st = acc.stats
print(
    f"pack: symmetric={acc.symmetric} dtype={st['dtype']} "
    f"bandwidth {st['bandwidth_before']} -> {st['bandwidth_after']} "
    f"fill={st['fill']*100:.2f}%"
)

# one-call solve in permuted space; eigenvectors restored automatically
res = eigsh(acc, k=3, which="SA", tol=1e-10)
lam = np.asarray(res.eigenvalues)
print("lowest eigenvalues:", np.round(lam, 8))

import scipy.sparse as sp

A = sp.csr_matrix((v, (r, c)), shape=(n, n))
V = res.eigenvectors
for j in range(3):
    x = V[:, j] / np.linalg.norm(V[:, j])
    resid = np.linalg.norm(A @ x - lam[j] * x)
    print(f"  residual |A x - lambda x| for pair {j}: {resid:.2e}")

# --- complex Hermitian rides the same pipeline (real embedding) -------
m = 600
phases = np.exp(1j * rng.uniform(0, 2 * np.pi, m))
rc = np.concatenate([np.arange(m), np.arange(m - 1), np.arange(1, m), [0, m - 1]])
cc = np.concatenate([np.arange(m), np.arange(1, m), np.arange(m - 1), [m - 1, 0]])
vv = np.concatenate(
    [rng.standard_normal(m).astype(complex), phases[:-1], np.conj(phases[:-1]),
     [phases[-1], np.conj(phases[-1])]]
)
accz = accelerate((rc, cc, vv, (m, m)))
print(
    f"\ncomplex Hermitian ring: complexified={accz.complexified} "
    f"symmetric={accz.symmetric} (the [[A,-B],[B,A]] embedding is real-symmetric)"
)
resz = eigsh(accz, k=2, which="SA", tol=1e-10)
lamz = np.asarray(resz.eigenvalues)
Z = resz.eigenvectors  # complex, original coordinates
Az = sp.csr_matrix((vv, (rc, cc)), shape=(m, m))
z0 = Z[:, 0] / np.linalg.norm(Z[:, 0])
print("lowest two:", np.round(lamz, 8))
print(f"  complex residual: {np.linalg.norm(Az @ z0 - lamz[0] * z0):.2e}")

# --- pack once, reload forever -----------------------------------------
with tempfile.TemporaryDirectory() as d:
    path = _os.path.join(d, "operator.npz")
    acc.save(path)
    back = AcceleratedOperator.load(path)
    x = rng.standard_normal(n)
    y1 = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(x))))
    y2 = back.restore(np.asarray(back.as_linear_operator().matvec(back.embed(x))))
    print(f"\nsave/load round-trip matvec bitwise equal: {np.array_equal(y1, y2)}")

# --- round 5: the same pack, row-partitioned over a device mesh --------
# eigsh(acc, mesh=...) shards the packed SymBSR container over the
# sym_halo ppermute ring — the path past one card's memory.  With one
# device there is no mesh to show; with several (cards, or virtual CPU
# devices via XLA_FLAGS=--xla_force_host_platform_device_count=8) the
# same code runs over all of them.
from jax.sharding import Mesh

cpus = jax.devices()
if len(cpus) >= 2:
    mesh = Mesh(np.array(cpus[: min(len(cpus), 8)]), ("rows",))
    res_m = eigsh(acc, k=3, which="SA", tol=1e-8, mesh=mesh)
    res_1 = eigsh(acc, k=3, which="SA", tol=1e-8)
    d = np.abs(np.asarray(res_m.eigenvalues) - np.asarray(res_1.eigenvalues)).max()
    print(f"\nmesh({len(mesh.devices)} devices) vs single-device eigenvalues: "
          f"max delta {d:.2e} (restored to original coordinates on both routes)")
