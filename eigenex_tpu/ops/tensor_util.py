"""Tensor shape/transform utilities.

JAX-native re-design of include/cmpt/eigen_ex/tensor_util.hpp:
``zerowiselyResized`` (slice + zero-pad, :193-256),
``contractVectorAsDiagonal`` (:258-294) and
``transformTensorWithMatrix`` (:296-340).  ``TensorTraits`` (:37-176) is
compile-time C++ introspection with no Python analog needed — ``ndim``/
``shape`` are runtime properties here.

All of these keep **static shapes** (the pad/truncate results have the
shape you ask for), which is exactly what XLA needs; the reference uses
them for rank-truncation with zero-padding in TensorSVD and we do the
same (tensor_svd.hpp:362-402).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..utils.exceptions import EigenexError

__all__ = [
    "zerowisely_resized",
    "contract_vector_as_diagonal",
    "transform_tensor_with_matrix",
]


def zerowisely_resized(t: jax.Array, new_dims: Sequence[int]) -> jax.Array:
    """Resize a tensor to ``new_dims``: overlapping region copied, the
    rest zero-filled (cf. zerowiselyResized tensor_util.hpp:193-256 —
    slice :197-203 then pad).  Works for any rank, grow and shrink mixed
    per axis."""
    t = jnp.asarray(t)
    new_dims = tuple(int(d) for d in new_dims)
    if len(new_dims) != t.ndim:
        raise EigenexError(f"rank mismatch: tensor rank {t.ndim}, new dims {new_dims}")
    slices = tuple(slice(0, min(o, n)) for o, n in zip(t.shape, new_dims))
    cropped = t[slices]
    pad = [(0, n - c) for c, n in zip(cropped.shape, new_dims)]
    return jnp.pad(cropped, pad)


def contract_vector_as_diagonal(t: jax.Array, v: jax.Array, axis: int) -> jax.Array:
    """Contract ``diag(v)`` into axis ``axis`` of ``t`` — elementwise
    scaling along that axis (cf. contractVectorAsDiagonal
    tensor_util.hpp:258-294, whose 3-way reshape loop :273-284 becomes a
    single broadcast multiply)."""
    t = jnp.asarray(t)
    v = jnp.asarray(v)
    axis = axis % t.ndim
    if v.shape[0] != t.shape[axis]:
        raise EigenexError(
            f"vector length {v.shape[0]} does not match axis {axis} dim {t.shape[axis]}"
        )
    shape = [1] * t.ndim
    shape[axis] = v.shape[0]
    return t * v.reshape(shape)


def transform_tensor_with_matrix(t: jax.Array, m: jax.Array, axis: int) -> jax.Array:
    """Apply a matrix to one axis, preserving axis order:
    ``out[..., i, ...] = Σ_j m[i, j] · t[..., j, ...]``
    (cf. transformTensorWithMatrix tensor_util.hpp:296-340, contract +
    shuffle preserving order :304-318 — here tensordot + moveaxis, which
    XLA fuses into one transposed matmul)."""
    t = jnp.asarray(t)
    m = jnp.asarray(m)
    axis = axis % t.ndim
    if m.shape[1] != t.shape[axis]:
        raise EigenexError(
            f"matrix cols {m.shape[1]} do not match axis {axis} dim {t.shape[axis]}"
        )
    out = jnp.tensordot(m, t, axes=([1], [axis]))  # new axis at front
    return jnp.moveaxis(out, 0, axis)
