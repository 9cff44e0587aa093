"""Matrix-free linear operators with a composition algebra.

JAX-native re-design of the reference's operator layer:

- The universal operator type in the reference is the raw callable
  ``MatMulFunction = std::function<void(const Scalar*, Scalar*)>``
  (lanczos.hpp:116, arnoldi.hpp:65, vector_map.hpp:43).  Here it becomes
  :class:`LinearOperator`: a **pytree** pairing a jit-able pure function
  ``matvec(params, x) -> y`` with its parameter pytree, so operators can
  be passed through ``jax.jit``/``shard_map`` boundaries without
  retracing per instance.
- ``VectorMap``'s algebra — ``(f+g)(x)=f(x)+g(x)``, ``(f*g)(x)=f(g(x))``,
  scalar multiples with zero short-circuit (vector_map.hpp:33-34,
  77-146, 192-263) — maps to the ``+``, ``@``/``*``, scalar ``*``
  operators below, with the same dimension checking as
  ``setFromComposition`` (vector_map.hpp:100-146).
- ``eigenvalue shift`` (lanczos.hpp:155,390-392) appears as
  :meth:`LinearOperator.shifted`.

``matvec`` operates on whole arrays (never raw pointers) and may be
called under ``jit``/``vmap``/``shard_map``; for batched right-hand
sides use :meth:`matmat`, which ``vmap``s over columns unless the
operator supplies a fused implementation.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..utils.exceptions import OperatorError


def _vjp_rmatvec(op, x):
    # module-level so LinearOperator pytrees stay hashable/jit-cacheable
    return op.rmatvec(x)


def _fwd_matvec(op, x):
    return op.matvec(x)

__all__ = ["LinearOperator", "aslinearoperator", "identity_operator"]


@jax.tree_util.register_pytree_node_class
class LinearOperator:
    """A matrix-free linear operator ``y = A @ x``.

    Parameters
    ----------
    matvec_fn : callable ``(params, x) -> y``; must be pure/jit-able.
    params : pytree of arrays closed over by ``matvec_fn``.
    shape : (m, n) — output/input dimensions.
    dtype : scalar dtype of the operator.
    rmatvec_fn : optional ``(params, x) -> A^H @ x`` (adjoint).
    matmat_fn : optional fused ``(params, X) -> A @ X`` for (n, k) blocks.
    """

    def __init__(
        self,
        matvec_fn: Callable[[Any, jax.Array], jax.Array],
        params: Any,
        shape: tuple[int, int],
        dtype,
        rmatvec_fn: Callable | None = None,
        matmat_fn: Callable | None = None,
    ):
        self._matvec_fn = matvec_fn
        self._params = params
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = jnp.dtype(dtype)
        self._rmatvec_fn = rmatvec_fn
        self._matmat_fn = matmat_fn

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        children = (self._params,)
        aux = (self._matvec_fn, self.shape, self.dtype, self._rmatvec_fn, self._matmat_fn)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        matvec_fn, shape, dtype, rmatvec_fn, matmat_fn = aux
        return cls(matvec_fn, children[0], shape, dtype, rmatvec_fn, matmat_fn)

    # -- application -----------------------------------------------------
    def matvec(self, x: jax.Array) -> jax.Array:
        return self._matvec_fn(self._params, x)

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)

    def rmatvec(self, x: jax.Array) -> jax.Array:
        """Adjoint action A^H @ x.

        Without an explicit ``rmatvec_fn`` the adjoint is derived from
        the (linear, jit-able) ``matvec`` via ``jax.vjp``: JAX's complex
        pullback of a ℂ-linear map computes Aᵀ, so Aᴴx = conj(Aᵀ x̄).
        One extra linearization trace, no user code — every matrix-free
        operator gets a correct adjoint (the reference requires hand
        materialization, triplets_matrix.hpp:386-421)."""
        if self._rmatvec_fn is not None:
            return self._rmatvec_fn(self._params, x)
        zero = jnp.zeros((self.shape[1],), self.dtype)
        _, pullback = jax.vjp(lambda v: self._matvec_fn(self._params, v), zero)
        x = jnp.asarray(x, self.dtype)
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            return jnp.conj(pullback(jnp.conj(x))[0])
        return pullback(x)[0]

    def matmat(self, X: jax.Array) -> jax.Array:
        """Apply to an (n, k) block of column vectors."""
        if self._matmat_fn is not None:
            return self._matmat_fn(self._params, X)
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    @property
    def has_adjoint(self) -> bool:
        return self._rmatvec_fn is not None

    @property
    def H(self) -> "LinearOperator":
        """The adjoint operator (cf. TripletsMatrix::adjoint
        triplets_matrix.hpp:406); uses the vjp-derived adjoint when no
        explicit ``rmatvec_fn`` was given."""
        if self._rmatvec_fn is None:
            return LinearOperator(
                _vjp_rmatvec,
                self,
                (self.shape[1], self.shape[0]),
                self.dtype,
                rmatvec_fn=_fwd_matvec,
            )
        return LinearOperator(
            self._rmatvec_fn,
            self._params,
            (self.shape[1], self.shape[0]),
            self.dtype,
            rmatvec_fn=self._matvec_fn,
        )

    # -- algebra (cf. vector_map.hpp:226-289) ----------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        other = aslinearoperator(other)
        if self.shape != other.shape:
            raise OperatorError(f"shape mismatch in operator sum: {self.shape} vs {other.shape}")
        return LinearOperator(
            _add_matvec,
            (self, other),
            self.shape,
            jnp.promote_types(self.dtype, other.dtype),
            rmatvec_fn=_add_rmatvec if (self.has_adjoint and other.has_adjoint) else None,
        )

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        return self + (-1.0) * aslinearoperator(other)

    def __neg__(self) -> "LinearOperator":
        return (-1.0) * self

    def __matmul__(self, other) -> "LinearOperator":
        """Composition: ``(A @ B)(x) = A(B(x))`` with the dimension check
        of setFromComposition (vector_map.hpp:100-146)."""
        if isinstance(other, LinearOperator) or callable(other):
            other = aslinearoperator(other)
            if self.shape[1] != other.shape[0]:
                raise OperatorError(
                    f"composition dim mismatch: {self.shape} cannot follow {other.shape}"
                )
            return LinearOperator(
                _compose_matvec,
                (self, other),
                (self.shape[0], other.shape[1]),
                jnp.promote_types(self.dtype, other.dtype),
                rmatvec_fn=_compose_rmatvec
                if (self.has_adjoint and other.has_adjoint)
                else None,
            )
        return self.matvec(other)  # A @ x on an array

    def __mul__(self, c) -> "LinearOperator":
        """Scalar multiple, with the zero short-circuit of
        vector_map.hpp:192-203; ``A * B`` on operators composes, matching
        the reference's ``f*g`` (vector_map.hpp:33-34)."""
        if isinstance(c, LinearOperator):
            return self @ c
        return self.scaled(c)

    def __rmul__(self, c) -> "LinearOperator":
        return self.scaled(c)

    def scaled(self, c) -> "LinearOperator":
        if isinstance(c, (int, float, complex)) and c == 0:
            # zero short-circuit: drop the inner operator entirely
            # (cf. VectorMap::scalarMultiple vector_map.hpp:192-203)
            return LinearOperator(
                _zero_matvec, None, self.shape, self.dtype, rmatvec_fn=_zero_rmatvec
            )
        return LinearOperator(
            _scale_matvec,
            (self, jnp.asarray(c, self.dtype)),
            self.shape,
            self.dtype,
            rmatvec_fn=_scale_rmatvec if self.has_adjoint else None,
        )

    def shifted(self, sigma) -> "LinearOperator":
        """``A + sigma * I`` — the eigenvalue shift the Krylov solvers
        apply per matvec (cf. lanczos.hpp:390-392)."""
        if self.shape[0] != self.shape[1]:
            raise OperatorError("shift requires a square operator")
        return LinearOperator(
            _shift_matvec,
            (self, jnp.asarray(sigma, self.dtype)),
            self.shape,
            self.dtype,
            rmatvec_fn=_shift_rmatvec if self.has_adjoint else None,
        )


# Combinator matvec bodies live at module scope so that jit caches by
# function identity rather than per-closure.
def _add_matvec(params, x):
    a, b = params
    return a.matvec(x) + b.matvec(x)


def _add_rmatvec(params, x):
    a, b = params
    return a.rmatvec(x) + b.rmatvec(x)


def _compose_matvec(params, x):
    a, b = params
    return a.matvec(b.matvec(x))


def _compose_rmatvec(params, x):
    a, b = params
    return b.rmatvec(a.rmatvec(x))


def _zero_matvec(_, x):
    return jnp.zeros_like(x)


_zero_rmatvec = _zero_matvec


def _scale_matvec(params, x):
    a, c = params
    return c * a.matvec(x)


def _scale_rmatvec(params, x):
    a, c = params
    return jnp.conj(c) * a.rmatvec(x)


def _shift_matvec(params, x):
    a, s = params
    return a.matvec(x) + s * x


def _shift_rmatvec(params, x):
    a, s = params
    return a.rmatvec(x) + jnp.conj(s) * x


def _dense_matvec(m, x):
    return jnp.matmul(m, x, precision="highest")


def _dense_rmatvec(m, x):
    return jnp.matmul(m.conj().T, x, precision="highest")


def _dense_matmat(m, x):
    return jnp.matmul(m, x, precision="highest")


def aslinearoperator(a, shape=None, dtype=None) -> LinearOperator:
    """Coerce a dense matrix, callable, or LinearOperator into a
    LinearOperator (cf. VectorMap::setFromMatrix vector_map.hpp:153-163
    and setFromFunction :65-75)."""
    if isinstance(a, LinearOperator):
        return a
    if callable(a):
        if shape is None or dtype is None:
            raise OperatorError("wrapping a callable requires explicit shape and dtype")
        return LinearOperator(lambda _, x: a(x), None, shape, dtype)
    a = jnp.asarray(a)
    if a.ndim != 2:
        raise OperatorError(f"expected a 2-D matrix, got shape {a.shape}")
    return LinearOperator(
        _dense_matvec, a, a.shape, a.dtype, rmatvec_fn=_dense_rmatvec, matmat_fn=_dense_matmat
    )


def _id_matvec(_, x):
    return x


def identity_operator(n: int, dtype=jnp.float32) -> LinearOperator:
    return LinearOperator(_id_matvec, None, (n, n), dtype, rmatvec_fn=_id_matvec)
