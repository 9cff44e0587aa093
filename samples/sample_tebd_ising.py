"""Tensor-network workflow demo: imaginary-time TEBD (Vidal canonical
form) ground state of the transverse-field Ising chain, built from the
library's tensor stack — ``tensor_svd`` (rank truncation), the
string-labeled ``einsum`` DSL, and ``contract_vector_as_diagonal``.

    H = -J Σ Z_i Z_{i+1} - g Σ X_i      (open chain)

The MPS is kept in Γ–λ canonical form so each two-site SVD truncation is
locally optimal; gates are exp(-τ h_bond) with a decreasing-τ schedule.
Cross-checked against exact diagonalization (L=8 ⇒ 256-dim oracle).

This is the workload the reference's TensorSVD/einsum machinery exists
to serve (tensor-network algorithms); the reference ships no such
driver.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import eigenex_tpu as ex

L, J, G, CHI = 8, 1.0, 1.0, 16

Z = np.diag([1.0, -1.0])
X = np.array([[0.0, 1.0], [1.0, 0.0]])
I2 = np.eye(2)


def h_bond(first, last):
    """Two-site bond term; the transverse field is split half/half onto
    interior bonds, fully onto chain-edge sites."""
    gl = G * (1.0 if first else 0.5)
    gr = G * (1.0 if last else 0.5)
    return -J * np.kron(Z, Z) - gl * np.kron(X, I2) - gr * np.kron(I2, X)


def gate(h, tau):
    w, U = np.linalg.eigh(h)
    return jnp.asarray((U * np.exp(-tau * w)) @ U.T).reshape(2, 2, 2, 2)


# Vidal canonical form: Γ[i] (χl, 2, χr), λ[i] on bond i (i = 0..L-2)
gam = [jnp.asarray(np.random.default_rng(0).standard_normal((1, 2, 1))) for _ in range(L)]
gam = [g / jnp.linalg.norm(g) for g in gam]
lam = [jnp.ones((1,)) for _ in range(L - 1)]


def apply_gate(i, g2):
    """TEBD update of bond i in canonical form, via the library ops."""
    lam_l = lam[i - 1] if i > 0 else jnp.ones((gam[i].shape[0],))
    lam_r = lam[i + 1] if i + 1 < L - 1 else jnp.ones((gam[i + 1].shape[2],))
    a = ex.contract_vector_as_diagonal(gam[i], lam_l, axis=0)
    a = ex.contract_vector_as_diagonal(a, lam[i], axis=2)
    b = ex.contract_vector_as_diagonal(gam[i + 1], lam_r, axis=2)
    theta = ex.einsum(a, b).from_(["l", "p", "m"], ["m", "q", "r"]).to(["l", "p", "q", "r"])
    theta = (
        ex.einsum(g2, theta)
        .from_(["p", "q", "s", "t"], ["l", "s", "t", "r"])
        .to(["l", "p", "q", "r"])
    )
    svd = ex.tensor_svd(theta, left_axes=2)
    chi = min(CHI, int(svd.get_rank(1e-12)))
    tr = svd.truncated(rank=max(chi, 1), pad=False)
    s = tr.singular_values / jnp.linalg.norm(tr.singular_values)
    inv_l = jnp.where(lam_l > 1e-12, 1.0 / jnp.where(lam_l > 1e-12, lam_l, 1.0), 0.0)
    inv_r = jnp.where(lam_r > 1e-12, 1.0 / jnp.where(lam_r > 1e-12, lam_r, 1.0), 0.0)
    gam[i] = ex.contract_vector_as_diagonal(tr.tensor_u, inv_l, axis=0)
    b_new = jnp.transpose(tr.tensor_v, (2, 0, 1))  # (chi, q, r)
    gam[i + 1] = ex.contract_vector_as_diagonal(b_new, inv_r, axis=2)
    lam[i] = s


def sweep(tau):
    for parity in (0, 1):
        for i in range(parity, L - 1, 2):
            apply_gate(i, gate(h_bond(i == 0, i + 2 == L), tau))


def dense_state():
    a = [ex.contract_vector_as_diagonal(gam[i], lam[i], axis=2) if i < L - 1 else gam[i] for i in range(L)]
    psi = a[0]
    for t in a[1:]:
        psi = ex.einsum(psi, t).from_(["l", "a", "m"], ["m", "b", "r"]).to(["l", "a", "b", "r"])
        psi = psi.reshape(psi.shape[0], -1, psi.shape[-1])
    v = np.asarray(psi).reshape(-1)
    return v / np.linalg.norm(v)


def dense_h():
    H = np.zeros((2**L, 2**L))

    def kron_chain(site_ops):
        M = site_ops[0]
        for m in site_ops[1:]:
            M = np.kron(M, m)
        return M

    for i in range(L - 1):
        mats = [I2] * L
        mats[i] = Z
        mats[i + 1] = Z
        H += -J * kron_chain(mats)
    for i in range(L):
        mats = [I2] * L
        mats[i] = X
        H += -G * kron_chain(mats)
    return H


Hd = dense_h()
e_exact = np.linalg.eigvalsh(Hd).min()

print(f"TFIM chain L={L}, J={J}, g={G}, chi={CHI} (Vidal-form TEBD)")
for tau, n_sweeps in ((0.1, 200), (0.02, 500), (0.005, 700), (0.002, 800)):
    for _ in range(n_sweeps):
        sweep(tau)
    v = dense_state()
    e = float(v @ Hd @ v)
    print(f"  tau={tau:<6} E = {e:.10f}   (exact {e_exact:.10f}, err {abs(e-e_exact):.2e})")

assert abs(e - e_exact) < 1e-5, "TEBD must reach the exact ground energy"
print("PASS: canonical TEBD via tensor_svd + einsum DSL matches exact diagonalization")
