"""Block-sparse tensor demo: symmetry sectors, selection rule, einsum,
and the Heisenberg ground state (BASELINE config 3)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np

import eigenex_tpu as ex
from eigenex_tpu.block.hamiltonians import heisenberg_block_hamiltonian

L = 8
H = heisenberg_block_hamiltonian(L, storage="dense")  # dense blocks: this sample demos block einsum
print("Heisenberg chain L =", L)
print("block structure:", H.structures[0])
print("stored blocks:", sorted(H.block_keys()), "(diagonal only — Sz conservation)")

e, sector, vec, energies = ex.heisenberg_ground_state(L)
print(f"ground energy E0 = {e:.10f} in sector n_up = {sector}")
print("per-sector minima:", {k: round(v, 6) for k, v in energies.items()})

# block einsum with the selection rule
psi = ex.BlockTensor([H.structures[1]], dtype=np.float64)
psi.set_block((sector,), np.asarray(vec)[:, 0])
hpsi = ex.einsum(H, psi).from_(["i", "j"], ["j"]).to(["i"])
print("H|psi> stored sectors:", sorted(hpsi.block_keys()))
ray = float(sum(np.vdot(psi.blocks[k], hpsi.blocks[k]) for k in psi.blocks))
print(f"Rayleigh quotient <psi|H|psi> = {ray:.10f} (== E0)")
