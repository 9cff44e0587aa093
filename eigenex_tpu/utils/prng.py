"""Random generation for vectors, matrices and tensors.

JAX-native re-design of the reference's C++11-style distribution objects:
``ComplexUniformDistribution``/``ComplexNormalDistribution`` and the
real/complex dispatch traits (util.hpp:49-158), ``VectorDistribution``
with its ``normalize`` flag (random.hpp:74-112), ``MatrixDistribution``
(random.hpp:29), ``OrthogonalMatrixDistribution`` built by Gram-Schmidt
over random columns (random.hpp:115-158), and ``TensorDistribution``
(tensor_random.hpp:16).

Instead of stateful engines (std::mt19937) we use JAX's splittable
counter-based PRNG: every function takes an explicit ``key``.  Complex
dtypes are handled uniformly: a complex normal sample has independent
N(0, 1/2) real and imaginary parts so that E|z|^2 = 1, matching the
reference's convention (util.hpp:77-106: real and imaginary parts drawn
from the component distribution).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .tolerance import is_complex_dtype, real_dtype_of

__all__ = [
    "random_normal",
    "random_uniform",
    "random_vector",
    "random_matrix",
    "random_tensor",
    "random_orthogonal",
    "random_hermitian",
]


def random_normal(key, shape, dtype=jnp.float32, stddev=1.0, mean=0.0):
    """Normal samples of any real or complex dtype.

    For complex dtypes, real and imaginary parts are independent
    N(mean.real, stddev/sqrt(2)) / N(mean.imag, stddev/sqrt(2)) so that
    E|z - mean|^2 = stddev^2 (cf. util.hpp:77-106).
    """
    dtype = jnp.dtype(dtype)
    if is_complex_dtype(dtype):
        rdt = real_dtype_of(dtype)
        kr, ki = jax.random.split(key)
        scale = jnp.asarray(stddev, rdt) / jnp.sqrt(jnp.asarray(2.0, rdt))
        re = jax.random.normal(kr, shape, rdt) * scale
        im = jax.random.normal(ki, shape, rdt) * scale
        return (re + 1j * im).astype(dtype) + jnp.asarray(mean, dtype)
    return jax.random.normal(key, shape, dtype) * jnp.asarray(stddev, dtype) + jnp.asarray(
        mean, dtype
    )


def random_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
    """Uniform samples; complex dtypes get independent uniform re/im parts
    (cf. ComplexUniformDistribution util.hpp:49-75)."""
    dtype = jnp.dtype(dtype)
    if is_complex_dtype(dtype):
        rdt = real_dtype_of(dtype)
        kr, ki = jax.random.split(key)
        re = jax.random.uniform(kr, shape, rdt, minval, maxval)
        im = jax.random.uniform(ki, shape, rdt, minval, maxval)
        return (re + 1j * im).astype(dtype)
    return jax.random.uniform(key, shape, dtype, minval, maxval)


def random_vector(key, n, dtype=jnp.float32, normalize=True):
    """Random (optionally unit-norm) vector (cf. VectorDistribution
    random.hpp:74-112, normalize flag :83)."""
    v = random_normal(key, (n,), dtype)
    if normalize:
        v = v / jnp.linalg.norm(v)
    return v


def random_matrix(key, rows, cols, dtype=jnp.float32):
    """Random dense matrix (cf. MatrixDistribution random.hpp:29-71)."""
    return random_normal(key, (rows, cols), dtype)


def random_tensor(key, shape, dtype=jnp.float32):
    """Random dense tensor (cf. TensorDistribution tensor_random.hpp:16-52)."""
    return random_normal(key, tuple(shape), dtype)


def random_orthogonal(key, rows, cols=None, dtype=jnp.float32):
    """Random matrix with orthonormal columns (unitary if square).

    The reference builds this by Gram-Schmidt over random columns
    (random.hpp:144-150); here a QR of a random Gaussian matrix is the
    numerically stable, matmul-friendly equivalent, with the sign fix
    (diag(R) made positive) giving the Haar distribution.
    """
    cols = rows if cols is None else cols
    a = random_normal(key, (rows, cols), dtype)
    q, r = jnp.linalg.qr(a)
    d = jnp.diagonal(r)
    phase = jnp.where(jnp.abs(d) > 0, d / jnp.abs(d), jnp.ones_like(d))
    return q * jnp.conj(phase)[None, :]


def random_hermitian(key, n, dtype=jnp.float32):
    """Random Hermitian (symmetric if real) matrix — test-oracle helper."""
    a = random_matrix(key, n, n, dtype)
    return (a + a.conj().T) / 2
