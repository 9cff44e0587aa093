"""Dtype-dependent default tolerances.

JAX-native re-design of the reference's ``DefaultTolerance`` trait
(reference: include/cmpt/eigen_ex/lanczos.hpp:63-83), which defaults to
1e-12 for double-precision scalar types and 1e-4 for single precision.
We mirror that behavior keyed on the JAX dtype of the problem, including
the complex dtypes (whose tolerance follows their real component dtype).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "default_tolerance",
    "default_breakdown_threshold",
    "real_dtype_of",
    "is_complex_dtype",
]


def real_dtype_of(dtype) -> np.dtype:
    """The real scalar dtype underlying ``dtype`` (identity for real dtypes)."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.complex64:
        return np.dtype(np.float32)
    if dtype == jnp.complex128:
        return np.dtype(np.float64)
    return np.dtype(dtype)


def is_complex_dtype(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)


def default_tolerance(dtype) -> float:
    """Default convergence tolerance for a scalar dtype.

    Mirrors the reference's dtype dispatch (lanczos.hpp:67-78):
    1e-12 for float64/complex128, 1e-4 for float32/complex64.  bfloat16
    (no reference analog) gets 1e-2.
    """
    rdt = real_dtype_of(dtype)
    if rdt == np.float64:
        return 1e-12
    if rdt == np.float32:
        return 1e-4
    # bfloat16 / float16: ~3 decimal digits
    return 1e-2


def default_breakdown_threshold(dtype) -> float:
    """Threshold below which a Krylov residual norm counts as breakdown.

    The reference uses the same ``DefaultTolerance`` value for its
    breakdown checks (lanczos.hpp:316,433); we follow suit.
    """
    return default_tolerance(dtype)
