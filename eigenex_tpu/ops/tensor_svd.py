"""Tensor SVD with rank/threshold truncation.

JAX-native re-design of include/cmpt/eigen_ex/tensor_svd.hpp:
``TensorSVD<TensorT, Urow, Vrow>`` (:172) — SVD of a rank-N tensor split
as (first ``left_axes`` axes) × (remaining axes):

    T ≈ Σ_k  U[..., k] · s[k] · V[..., k]

matching the reference's storage convention where **tensorV holds the
conjugated (not adjointed) right factor** (tensor_svd.hpp:164-167,303),
i.e. reconstruction needs no further conjugation:
``T = einsum(U · diag(s), V) over k``.

Matricization is a pure reshape (the reference maps the flat buffer,
:275 — col-major there, row-major here, consistently on both sides so
the factorization is identical).  The dense SVD is ``jnp.linalg.svd``
(XLA QR-based; the BDCSVD analog :279).  Truncation by threshold or
rank zero-pads to keep static shapes (cf. getTruncatedTensorU/V
:362-402 via zerowiselyResized) and reports the truncation error
√(Σ discarded σ²) (:122-126).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.exceptions import EigenexError
from .tensor_util import zerowisely_resized

__all__ = ["TensorSVDResult", "tensor_svd", "truncated_tensor_svd"]


@dataclasses.dataclass(frozen=True)
class TensorSVDResult:
    """Factors of T = U·S·V (V stored conjugated, tensor_svd.hpp:164-167)."""

    tensor_u: jax.Array  # (left_dims..., k)
    singular_values: jax.Array  # (k,) real, descending
    tensor_v: jax.Array  # (right_dims..., k) — conjugated right factor
    left_dims: tuple
    right_dims: tuple

    @property
    def rank(self) -> int:
        return self.singular_values.shape[0]

    def get_rank(self, threshold: float) -> int:
        """Number of singular values > threshold
        (cf. getRank tensor_svd.hpp:318-330)."""
        return int(np.sum(np.asarray(self.singular_values) > threshold))

    def truncation_error(self, rank: int) -> float:
        """√(Σ_{k≥rank} σ_k²) (cf. tensor_svd.hpp:122-126)."""
        s = np.asarray(self.singular_values, np.float64)
        return float(np.sqrt(np.sum(s[rank:] ** 2)))

    def reconstruct(self) -> jax.Array:
        """T = Σ_k U[...,k] s[k] V[...,k] — no conjugation, per the
        storage convention."""
        nl, nr = len(self.left_dims), len(self.right_dims)
        u = self.tensor_u.reshape(-1, self.rank)
        v = self.tensor_v.reshape(-1, self.rank)
        m = (u * self.singular_values.astype(u.dtype)[None, :]) @ v.T
        return m.reshape(self.left_dims + self.right_dims)

    # -- truncation (static-shape zero-padding, tensor_svd.hpp:362-402) --
    def truncated(self, rank: int | None = None, threshold: float | None = None, pad: bool = True):
        """Return a new result truncated to ``rank`` (or by σ-threshold).
        With ``pad=True`` the arrays keep their original static shapes,
        zero-filled past the truncation rank (the reference's zero-pad
        semantics); with ``pad=False`` they are sliced (host-side use)."""
        if rank is None:
            if threshold is None:
                raise EigenexError("specify rank or threshold")
            rank = self.get_rank(threshold)
        rank = int(rank)
        if pad:
            k = self.rank
            keep = jnp.arange(k) < rank
            return TensorSVDResult(
                tensor_u=self.tensor_u * keep.astype(self.tensor_u.dtype),
                singular_values=self.singular_values * keep.astype(self.singular_values.dtype),
                tensor_v=self.tensor_v * keep.astype(self.tensor_v.dtype),
                left_dims=self.left_dims,
                right_dims=self.right_dims,
            )
        return TensorSVDResult(
            tensor_u=self.tensor_u[..., :rank],
            singular_values=self.singular_values[:rank],
            tensor_v=self.tensor_v[..., :rank],
            left_dims=self.left_dims,
            right_dims=self.right_dims,
        )


def tensor_svd(t: jax.Array, left_axes: int, full_matrices: bool = False) -> TensorSVDResult:
    """SVD of ``t`` split after ``left_axes`` axes
    (cf. TensorSVD::compute tensor_svd.hpp:250-307: row/col products
    :265-272, matrix map :275, BDCSVD :279, reshape :285-303)."""
    t = jnp.asarray(t)
    if not (0 < left_axes < t.ndim):
        raise EigenexError(
            f"left_axes must split the tensor: 0 < {left_axes} < {t.ndim}"
        )
    left_dims = t.shape[:left_axes]
    right_dims = t.shape[left_axes:]
    mrows = int(np.prod(left_dims))
    mcols = int(np.prod(right_dims))
    m = t.reshape(mrows, mcols)
    u, s, vh = jnp.linalg.svd(m, full_matrices=full_matrices)
    # tensorV stores conj(V); with vh = V^H this is exactly vh.T
    # (tensor_svd.hpp:164-167,303)
    return TensorSVDResult(
        tensor_u=u.reshape(left_dims + (u.shape[1],)),
        singular_values=s,
        tensor_v=vh.T.reshape(right_dims + (vh.shape[0],)),
        left_dims=tuple(left_dims),
        right_dims=tuple(right_dims),
    )


def truncated_tensor_svd(
    t: jax.Array, left_axes: int, rank: int | None = None, threshold: float | None = None
) -> TensorSVDResult:
    """One-shot truncated SVD (sliced shapes, host-side convenience)."""
    return tensor_svd(t, left_axes).truncated(rank=rank, threshold=threshold, pad=False)
