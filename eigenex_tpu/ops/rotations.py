"""Sparse-triplet operators and Givens rotations applied to matrices.

JAX-native re-design of the reference's triplet-application helpers:
``operate_triplets`` (apply a triplet list as a matrix from the left or
right, util.hpp:516-566) and ``rotate_from_left`` /``rotate_from_right``
(Givens rotations expressed as triplet updates, util.hpp:568-626 —
implementing the documented intent; the reference's ``rotate_from_right``
calls an undefined helper, SURVEY.md §2).

Also the row/col/coefficient shuffles ``rowwiseShuffle``/
``colwiseShuffle``/``cwiseShuffle`` (util.hpp:655-709) that the Arnoldi
solver uses to reorder eigenpairs — here simple ``take`` ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.exceptions import EigenexError

__all__ = [
    "operate_triplets_left",
    "operate_triplets_right",
    "givens_rotation_triplets",
    "rotate_from_left",
    "rotate_from_right",
    "rowwise_shuffle",
    "colwise_shuffle",
    "cwise_shuffle",
]


def operate_triplets_left(rows, cols, vals, M, out_rows: int | None = None):
    """``T @ M`` where T is given as COO triplets
    (cf. operate_triplets util.hpp:516-540)."""
    M = jnp.asarray(M)
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    vals = jnp.asarray(vals)
    if out_rows is None:
        out_rows = M.shape[0]
    contrib = vals[:, None] * M[cols]
    return jax.ops.segment_sum(contrib, rows, num_segments=out_rows)


def operate_triplets_right(rows, cols, vals, M, out_cols: int | None = None):
    """``M @ T`` with T as COO triplets (cf. util.hpp:542-566)."""
    M = jnp.asarray(M)
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    vals = jnp.asarray(vals)
    if out_cols is None:
        out_cols = M.shape[1]
    contrib = vals[None, :] * M[:, rows]
    return jax.ops.segment_sum(contrib.T, cols, num_segments=out_cols).T


def givens_rotation_triplets(n: int, i: int, j: int, theta: float, dtype=jnp.float64):
    """Triplets of the n×n Givens rotation G(i, j, θ): identity except
    G[i,i]=G[j,j]=cosθ, G[i,j]=sinθ, G[j,i]=−sinθ
    (the rotation the reference builds at util.hpp:568-581)."""
    if i == j:
        raise EigenexError("Givens rotation requires distinct axes")
    c, s = float(np.cos(theta)), float(np.sin(theta))
    rows, cols, vals = [], [], []
    for k in range(n):
        if k not in (i, j):
            rows.append(k)
            cols.append(k)
            vals.append(1.0)
    rows += [i, j, i, j]
    cols += [i, j, j, i]
    vals += [c, c, s, -s]
    return (
        jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32),
        jnp.asarray(vals, dtype),
    )


def rotate_from_left(M, i: int, j: int, theta: float):
    """G(i,j,θ) @ M — rotate rows i,j (cf. rotate_from_left util.hpp:568-579).
    Applied directly to the two affected rows (O(n), not O(n²))."""
    M = jnp.asarray(M)
    c, s = np.cos(theta), np.sin(theta)
    ri, rj = M[i], M[j]
    return M.at[i].set(c * ri + s * rj).at[j].set(-s * ri + c * rj)


def rotate_from_right(M, i: int, j: int, theta: float):
    """M @ G(i,j,θ)ᵀ-style column rotation (cf. rotate_from_right
    util.hpp:581-626, implementing the documented intent)."""
    M = jnp.asarray(M)
    c, s = np.cos(theta), np.sin(theta)
    ci, cj = M[:, i], M[:, j]
    return M.at[:, i].set(c * ci + s * cj).at[:, j].set(-s * ci + c * cj)


def rowwise_shuffle(M, perm):
    """Reorder rows (cf. rowwiseShuffle util.hpp:655-675)."""
    return jnp.asarray(M)[jnp.asarray(perm, jnp.int32), :]


def colwise_shuffle(M, perm):
    """Reorder columns (cf. colwiseShuffle util.hpp:677-686, implementing
    the documented intent — the reference calls a nonexistent
    ``transepose()``; SURVEY.md §2)."""
    return jnp.asarray(M)[:, jnp.asarray(perm, jnp.int32)]


def cwise_shuffle(v, perm):
    """Reorder vector coefficients (cf. cwiseShuffle util.hpp:688-697)."""
    return jnp.asarray(v)[jnp.asarray(perm, jnp.int32)]
