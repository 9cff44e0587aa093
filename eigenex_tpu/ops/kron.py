"""Lazy tensor Kronecker (outer) product.

JAX-native re-design of include/cmpt/eigen_ex/tensor_kronecker_product.hpp:
``TensorKroneckerProduct`` (:19) — an O(1)-storage virtual tensor whose
axes are the concatenation of the two factors' axes and whose
coefficients are products of factor coefficients (:81-95), with
``makeDenseTensor`` (:104-116) materialization.

In the reference this "virtual joined tensor" is what the general einsum
gathers over element-by-element (einsum.hpp:892,1000-1018).  Here the
einsum layer never gathers scalars — it plans XLA contractions — so the
lazy product's job is (a) API parity, (b) cheap coefficient peeking, and
(c) a fused dense materialization (one outer-product einsum as matmuls)
when an explicit tensor is wanted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.indices import ProductIndices

__all__ = ["TensorKroneckerProduct", "tensor_kronecker_product"]


class TensorKroneckerProduct:
    """Lazy outer product of two tensors (never materialized unless asked)."""

    def __init__(self, left: jax.Array, right: jax.Array):
        self.left = jnp.asarray(left)
        self.right = jnp.asarray(right)
        #: joined axes = left axes then right axes (tensor_kronecker_product.hpp:54-71)
        self.dims = tuple(self.left.shape) + tuple(self.right.shape)
        self._pi = ProductIndices(self.dims)
        self._pi_l = ProductIndices(self.left.shape)
        self._pi_r = ProductIndices(self.right.shape)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def dtype(self):
        return jnp.promote_types(self.left.dtype, self.right.dtype)

    def coeff_flat(self, flat: int):
        """coeff(flat) = left.flat[i0] * right.flat[i1]
        (tensor_kronecker_product.hpp:81-88)."""
        multi = self._pi.indices(int(flat))
        return self.coeff(multi)

    def coeff(self, multi):
        """coeff(indices) (tensor_kronecker_product.hpp:90-95)."""
        nl = self.left.ndim
        il, ir = tuple(multi[:nl]), tuple(multi[nl:])
        return self.left[il] * self.right[ir]

    def to_dense(self) -> jax.Array:
        """Materialize as one outer-product contraction
        (cf. makeDenseTensor tensor_kronecker_product.hpp:104-116)."""
        return jnp.tensordot(self.left, self.right, axes=0)


def tensor_kronecker_product(left, right) -> TensorKroneckerProduct:
    """Factory (cf. tensorKroneckerProduct tensor_kronecker_product.hpp:119-129)."""
    return TensorKroneckerProduct(left, right)
