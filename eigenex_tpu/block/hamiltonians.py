"""Spin-chain Hamiltonian builders over symmetry sectors.

The reference's BlockTensor exists to exploit quantum-number
conservation (block_tensor.hpp's sector selection rule); BASELINE.json
config 3 instantiates it: "block-sparse Heisenberg spin-chain
Hamiltonian matvec + Lanczos ground state (symmetry-sector blocks)".
The reference itself ships no Hamiltonian builders (its samples use
ad-hoc operators, sample_lanczos2.cpp:21-40) — this module supplies the
domain builders the capability implies.

The XXZ/Heisenberg chain conserves total S_z, so the Hamiltonian is
block-diagonal over magnetization sectors.  Builders:

- :func:`sz_sector_basis` / :func:`heisenberg_sector_coo` — the basis
  and sparse matrix of one sector (host-side construction, vectorized
  NumPy), feeding the sparse Lanczos path.
- :func:`heisenberg_block_hamiltonian` — the full operator as a rank-2
  :class:`BlockTensor` over the sector structure (block-diagonal by
  conservation).
- :func:`heisenberg_ground_state` — sector-by-sector Lanczos sweep.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.indices import AddIndices
from ..solvers.lanczos import LanczosEigenSolver, LanczosOptions
from ..sparse.coo import COOMatrix
from ..utils.exceptions import EigenexError
from .block_tensor import BlockTensor

__all__ = [
    "sz_sector_basis",
    "parity_sector_basis",
    "tfi_parity_sector_coo",
    "tfi_ground_energy_exact",
    "heisenberg_sector_coo",
    "heisenberg_block_hamiltonian",
    "heisenberg_ground_state",
    "sector_structure",
]


def sz_sector_basis(L: int, n_up: int) -> np.ndarray:
    """All length-L bit states with ``n_up`` up-spins, ascending —
    the basis of one total-S_z sector."""
    states = np.arange(1 << L, dtype=np.int64)
    pop = np.zeros(1 << L, dtype=np.int64)
    for b in range(L):
        pop += (states >> b) & 1
    return states[pop == n_up]


def heisenberg_sector_coo(
    L: int,
    n_up: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    dtype=np.float64,
) -> COOMatrix:
    """XXZ chain H = Σ_b J/2 (S+_i S-_j + S-_i S+_j) + Jz S^z_i S^z_j
    restricted to the total-S_z sector with ``n_up`` up spins, as a COO
    matrix over the sector basis."""
    if Jz is None:
        Jz = J
    if np.dtype(dtype) == np.float64:
        from .. import native

        if native.native_available():
            r, c, v, dim = native.heisenberg_sector(L, n_up, J, Jz, pbc)
            order = np.lexsort((c, r))
            return COOMatrix(
                jnp.asarray(r[order].astype(np.int32)),
                jnp.asarray(c[order].astype(np.int32)),
                jnp.asarray(v[order]),
                (dim, dim),
            )
    states = sz_sector_basis(L, n_up)
    index = {int(s): i for i, s in enumerate(states)}
    dim = len(states)
    bonds = [(i, i + 1) for i in range(L - 1)] + ([(L - 1, 0)] if pbc and L > 2 else [])

    rows, cols, vals = [], [], []
    # diagonal: Jz Σ sz_i sz_j  with sz = ±1/2
    diag = np.zeros(dim, dtype)
    for (i, j) in bonds:
        bi = (states >> i) & 1
        bj = (states >> j) & 1
        diag += Jz * (bi - 0.5) * (bj - 0.5)
    rows.extend(range(dim))
    cols.extend(range(dim))
    vals.extend(diag.tolist())
    # off-diagonal: J/2 spin flips on anti-aligned bonds
    for (i, j) in bonds:
        bi = (states >> i) & 1
        bj = (states >> j) & 1
        flip_mask = (1 << i) | (1 << j)
        movable = bi != bj
        src = states[movable]
        dst = src ^ flip_mask
        for s, d in zip(src.tolist(), dst.tolist()):
            rows.append(index[d])
            cols.append(index[s])
            vals.append(J / 2)
    order = np.lexsort((np.asarray(cols), np.asarray(rows)))
    r = np.asarray(rows, np.int32)[order]
    c = np.asarray(cols, np.int32)[order]
    v = np.asarray(vals, dtype)[order]
    return COOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), (dim, dim))


def sector_structure(L: int) -> AddIndices:
    """Per-axis block structure of the full 2^L space ordered by
    magnetization sector: block k has dim C(L, k)."""
    from math import comb

    return AddIndices([comb(L, k) for k in range(L + 1)])


def heisenberg_block_hamiltonian(
    L: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    dtype=np.float64,
    storage: str = "sparse",
    block_shape: tuple[int, int] | None = None,
) -> BlockTensor:
    """The full-chain Hamiltonian as a rank-2 BlockTensor over the S_z
    sector structure — block-diagonal because H conserves S_z (the
    selection-rule showcase; cf. block_tensor.hpp:2014-2029).

    storage: "sparse" (default) keeps each sector block as its COOMatrix
    — O(nnz) memory, so L=24 (sector dim 2.7M) fits where a dense block
    would need 58 TB; "bsr" packs each sector into the BSR-ELL layout
    (``block_shape`` defaults to (4, 4)); "dense" reproduces the
    reference's dense-per-block design (block_tensor.hpp:1204-1206) for
    small L."""
    if storage not in ("sparse", "bsr", "dense"):
        raise ValueError(f"storage must be sparse|bsr|dense, got {storage!r}")
    s = sector_structure(L)
    bt = BlockTensor([s, s], dtype=dtype)
    for n_up in range(L + 1):
        coo = heisenberg_sector_coo(L, n_up, J, Jz, pbc, dtype)
        if storage == "dense":
            bt.set_block((n_up, n_up), coo.to_dense())
        elif storage == "sparse":
            bt.set_block((n_up, n_up), coo)
        else:
            from ..sparse.bsr import bsr_from_coo_arrays

            bsr = bsr_from_coo_arrays(
                np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.val),
                coo.shape, block_shape or (4, 4),
            )
            bt.set_block((n_up, n_up), bsr)
    return bt


def heisenberg_ground_state(
    L: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    options: LanczosOptions | None = None,
):
    """Ground-state energy/vector by a per-sector Lanczos sweep.

    Returns (energy, sector_n_up, sector_vector, per_sector_energies)."""
    energies = {}
    best = (np.inf, None, None)
    for n_up in range(L + 1):
        coo = heisenberg_sector_coo(L, n_up, J, Jz, pbc)
        dim = coo.shape[0]
        if dim == 1:
            e = float(np.asarray(coo.to_dense())[0, 0])
            vec = jnp.ones((1, 1))
        else:
            opts = options or LanczosOptions(
                max_eigenvalues=1, tolerance=1e-13, max_subspace=min(dim, 200)
            )
            res = LanczosEigenSolver(coo.as_linear_operator(), opts).compute()
            e = float(res.eigenvalues[0])
            vec = res.eigenvectors
        energies[n_up] = e
        if e < best[0]:
            best = (e, n_up, vec)
    return best[0], best[1], best[2], energies


# ---------------------------------------------------------------------------
# Transverse-field Ising chain — the OTHER symmetry class: Z2 spin-flip
# parity P = Π σᶻ (popcount parity) instead of U(1) total-S_z
# ---------------------------------------------------------------------------
def parity_sector_basis(L: int, parity: int) -> np.ndarray:
    """All length-L bit states whose up-spin count has the given parity
    (0 = even, 1 = odd), ascending — the basis of one Z2 sector of any
    parity-conserving Hamiltonian (σˣσˣ bonds flip spins in pairs)."""
    if parity not in (0, 1):
        raise EigenexError("parity must be 0 (even) or 1 (odd)")
    states = np.arange(1 << L, dtype=np.int64)
    pop = np.zeros(1 << L, dtype=np.int64)
    for b in range(L):
        pop += (states >> b) & 1
    return states[(pop & 1) == parity]


def tfi_parity_sector_coo(
    L: int,
    J: float = 1.0,
    h: float = 1.0,
    parity: int = 0,
    pbc: bool = True,
    dtype=np.float64,
) -> COOMatrix:
    """Transverse-field Ising chain H = −J Σ_b σˣ_i σˣ_j − h Σ_i σᶻ_i
    restricted to one Z2 parity sector (dim 2^{L−1}), as a COO matrix.

    The σˣσˣ bond flips two adjacent spins (popcount parity preserved);
    the field term is diagonal.  Ground state lives in the EVEN sector
    (parity=0).  PBC spectra are exactly solvable by Jordan–Wigner free
    fermions — :func:`tfi_ground_energy_exact` is the closed-form oracle
    (the TFI analog of the 1D-Laplacian closed form, SURVEY.md §4c)."""
    states = parity_sector_basis(L, parity)
    index = {int(s): i for i, s in enumerate(states)}
    dim = len(states)
    bonds = [(i, i + 1) for i in range(L - 1)] + ([(L - 1, 0)] if pbc and L > 2 else [])

    rows, cols, vals = [], [], []
    # diagonal: −h Σ σᶻ with σᶻ = +1 for bit 1
    pop = np.zeros(dim, np.int64)
    for b in range(L):
        pop += (states >> b) & 1
    diag = (-h * (2 * pop - L)).astype(dtype)
    rows.extend(range(dim))
    cols.extend(range(dim))
    vals.extend(diag.tolist())
    # off-diagonal: −J σˣ_i σˣ_j flips bits i, j on EVERY state
    for (i, j) in bonds:
        flip_mask = (1 << i) | (1 << j)
        dst = states ^ flip_mask
        for s, d in zip(states.tolist(), dst.tolist()):
            rows.append(index[d])
            cols.append(index[s])
            vals.append(-J)
    order = np.lexsort((np.asarray(cols), np.asarray(rows)))
    r = np.asarray(rows, np.int32)[order]
    c = np.asarray(cols, np.int32)[order]
    v = np.asarray(vals, dtype)[order]
    return COOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), (dim, dim))


def tfi_ground_energy_exact(L: int, J: float = 1.0, h: float = 1.0) -> float:
    """Closed-form PBC ground energy via Jordan–Wigner free fermions:
    E0 = −½ Σ_m ε(k_m), ε(k) = 2√(J² + h² − 2Jh cos k) over the
    antiperiodic (even-parity/Neveu–Schwarz) momenta k_m = (2m+1)π/L.
    Verified against dense diagonalization for L ≤ 12 in the tests."""
    ks = (2 * np.arange(L) + 1) * np.pi / L
    eps = 2.0 * np.sqrt(J * J + h * h - 2.0 * J * h * np.cos(ks))
    return float(-0.5 * np.sum(eps))
