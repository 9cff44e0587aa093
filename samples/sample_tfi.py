"""Transverse-field Ising chain: Z2 parity sectors + free-fermion oracle.

The TFI chain H = -J Σ σˣᵢσˣᵢ₊₁ - h Σ σᶻᵢ conserves spin-flip parity
P = Π σᶻ (a Z2 symmetry — the OTHER symmetry class next to the XXZ
chain's U(1) total-S_z).  Each parity sector has dim 2^(L-1); PBC
spectra are exactly solvable by Jordan-Wigner free fermions, giving a
closed-form oracle for the eigensolver (the TFI analog of the 1D
Laplacian's 2-2cos(kπ/(n+1)), SURVEY.md §4c).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

# f64 sector matrix + 1e-10-grade oracle comparison need x64
jax.config.update("jax_enable_x64", True)

import numpy as np

import eigenex_tpu as ex
from eigenex_tpu.block.hamiltonians import (
    tfi_ground_energy_exact,
    tfi_parity_sector_coo,
)

L, J, h = 16, 1.0, 1.0  # the quantum-critical point h = J
print(f"TFI chain: L={L}, J={J}, h={h} (critical), PBC")

for parity, name in ((0, "even"), (1, "odd")):
    coo = tfi_parity_sector_coo(L, J, h, parity=parity)
    res = ex.eigsh(coo, k=2, which="SA", tol=1e-14, max_subspace=140)
    print(f"  {name} sector (dim {coo.shape[0]:,}): "
          f"E0 = {res.eigenvalues[0]:.12f}, E1 = {res.eigenvalues[1]:.12f}")
    if parity == 0:
        exact = tfi_ground_energy_exact(L, J, h)
        err = abs(res.eigenvalues[0] - exact)
        print(f"  free-fermion E0 = {exact:.12f}  (|err| = {err:.2e})")
        assert err < 1e-9, err

print("OK")
