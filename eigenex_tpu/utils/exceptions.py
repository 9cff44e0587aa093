"""Exception hierarchy.

The reference defines ``RuntimeException`` (util.hpp:161),
``LanczosException`` (lanczos.hpp:90, aliased as ``ArnoldiException``
arnoldi.hpp:45) and ``VectorMapException`` (vector_map.hpp:18).  Under
jit, exceptions are raised only at trace time (shape/config
validation); in-kernel numerical failures (breakdown, non-convergence)
are carried as status flags in the solver state and surfaced in results,
because data-dependent control flow cannot raise from inside ``jit``.
"""

from __future__ import annotations

__all__ = [
    "EigenexError",
    "LanczosError",
    "ArnoldiError",
    "OperatorError",
    "BlockTensorError",
    "EinsumError",
]


class EigenexError(RuntimeError):
    """Base class for all eigenex_tpu errors (cf. util.hpp:161)."""


class LanczosError(EigenexError):
    """Lanczos configuration/validation error (cf. lanczos.hpp:90)."""


# The reference aliases ArnoldiException = LanczosException (arnoldi.hpp:45).
ArnoldiError = LanczosError


class OperatorError(EigenexError):
    """Linear-operator composition error (cf. vector_map.hpp:18)."""


class BlockTensorError(EigenexError):
    """Block-sparse tensor structure error (cf. block_tensor.hpp throw sites)."""


class EinsumError(EigenexError):
    """Einsum label/shape validation error (cf. einsum.hpp:186-214)."""
