"""Blocked orthogonalization primitives.

JAX-native re-design of the reference's Gram-Schmidt machinery:
``schmidt_orthogonalize`` (util.hpp:400-417), ``OrthogonalSpace``
(util.hpp:419-471), the per-step selective reorthogonalization loop of
Lanczos (lanczos.hpp:411-426) and the full modified-GS of Arnoldi
(arnoldi.hpp:380-383).

The reference performs k sequential dot-products per reorthogonalization
pass; on an accelerator that serializes the matrix units.  Here every projection is a pair
of matmuls — classical Gram-Schmidt, applied **twice** (CGS2,
"twice is enough": Giraud et al.) which is the hardware-friendly,
numerically equivalent-or-better replacement for modified GS.  All
functions accept an optional ``axis_name`` so the same code runs inside
``shard_map`` with the basis row-sharded: local partial inner products
are completed with ``lax.psum`` over the mesh axis (the distributed-GS
design of SURVEY.md §5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "project_coefficients",
    "project_out",
    "cgs2",
    "gram_schmidt",
    "orthonormal_columns",
    "orthogonal_complement",
    "orthogonal_complement_debug",
    "norm_psum",
]


def _psum_if(x, axis_name):
    return lax.psum(x, axis_name) if axis_name is not None else x


def norm_psum(v, axis_name=None):
    """2-norm of a (possibly row-sharded) vector."""
    sq = jnp.sum(jnp.real(v) ** 2 + (jnp.imag(v) ** 2 if jnp.iscomplexobj(v) else 0.0))
    return jnp.sqrt(_psum_if(sq, axis_name))


def project_coefficients(V, v, axis_name=None, mask=None):
    """Inner products ``c_j = <V_j, v>`` for all basis rows at once.

    V: (k, n[_local]) basis rows; v: (n[_local],).  One matvec instead
    of k sequential dots (replaces lanczos.hpp:414-416).
    ``mask`` (k,) zeroes out coefficients of inactive basis rows — used
    by fixed-shape solver loops where only rows < k are valid.

    Precision note: every projection runs at ``Precision.HIGHEST``.  At
    DEFAULT a GPU runs f32 matmuls in TF32 (10-bit mantissa); the
    projections then leave the basis orthogonal only to ~1e-3, and the
    L=24 Heisenberg solve needs thousands of iterations instead of 160
    and stops outside its tolerance (PERF.md).
    """
    c = _psum_if(jnp.matmul(V.conj(), v, precision=lax.Precision.HIGHEST), axis_name)
    if mask is not None:
        c = jnp.where(mask, c, jnp.zeros_like(c))
    return c


def _combine(c, V):
    """``sum_j c_j V_j``, at HIGHEST like the projections."""
    return jnp.matmul(c, V, precision=lax.Precision.HIGHEST)


def project_out(V, v, axis_name=None, mask=None):
    """One classical-GS pass: ``v - sum_j <V_j, v> V_j``."""
    c = project_coefficients(V, v, axis_name, mask)
    return v - _combine(c, V)


def cgs2(V, v, axis_name=None, mask=None):
    """Two classical-GS passes ("twice is enough") — the stable blocked
    replacement for the reference's selective reorthogonalization
    (lanczos.hpp:411-426) and Arnoldi's full MGS (arnoldi.hpp:380-383).

    Returns ``(v_orth, c)`` where ``c`` is the **total** projection
    coefficient vector (sum of both passes) — Arnoldi consumes it as the
    Hessenberg column.
    """
    c1 = project_coefficients(V, v, axis_name, mask)
    v = v - _combine(c1, V)
    c2 = project_coefficients(V, v, axis_name, mask)
    v = v - _combine(c2, V)
    return v, c1 + c2


def gram_schmidt(vectors, normalize=True):
    """Orthonormalize a stack of row vectors in order
    (cf. schmidt_orthogonalize util.hpp:400-417).

    Implemented as thin QR of the transposed stack — mathematically the
    same span/ordering, numerically stabler and batched.
    Returns the orthonormalized rows (k, n).
    """
    V = jnp.asarray(vectors)
    q, r = jnp.linalg.qr(V.T)  # (n, k), (k, k)
    if normalize:
        # sign-fix so each output vector has positive real diagonal in R,
        # making the result deterministic and GS-compatible
        d = jnp.diagonal(r)
        phase = jnp.where(jnp.abs(d) > 0, d / jnp.abs(d), jnp.ones_like(d))
        q = q * jnp.conj(phase)[None, :]
    return q.T


def orthonormal_columns(A):
    """Orthonormal basis (columns) for the column space of A via QR."""
    q, _ = jnp.linalg.qr(A)
    return q


def orthogonal_complement(V, n=None):
    """Orthonormal basis rows spanning the orthogonal complement of the
    span of the rows of V in C^n (cf. OrthogonalSpace util.hpp:419-471).

    V: (k, n) rows.  Returns (n - k, n) orthonormal rows r with
    ``r @ V.conj().T == 0``.
    """
    V = jnp.asarray(V)
    k, nv = V.shape
    if n is None:
        n = nv
    # full QR of the (n, k) matrix of columns; trailing columns span the
    # complement — the batched replacement for the reference's
    # vector-at-a-time projection loop (util.hpp:437-462)
    q, _ = jnp.linalg.qr(V.conj().T, mode="complete")  # (n, n)
    return q[:, k:].conj().T


def orthogonal_complement_debug(V, n=None):
    """Debug twin of :func:`orthogonal_complement` (cf.
    ``OrthogonalSpaceDebug`` util.hpp:473-514, which recomputes and
    prints the projection residuals): returns
    ``(complement_rows, diagnostics)`` where diagnostics is a dict of the
    invariants the debug class checked —

    - ``max_overlap``: max |⟨r_i, V_j⟩| (must be ~0: complement ⊥ span V)
    - ``orthonormality``: ‖R Rᴴ − I‖_max over the returned rows
    - ``completeness``: ‖[Vq; R][Vq; R]ᴴ − I‖_max with Vq an orthonormal
      basis of span V — the two spaces together fill C^n
    """
    R = orthogonal_complement(V, n)
    V = jnp.asarray(V)
    Vq = gram_schmidt(V)
    k = R.shape[0]
    overlap = jnp.max(jnp.abs(R @ V.conj().T)) if V.size and k else jnp.zeros(())
    gram = R @ R.conj().T
    orth = jnp.max(jnp.abs(gram - jnp.eye(k, dtype=gram.dtype))) if k else jnp.zeros(())
    full = jnp.concatenate([Vq, R], axis=0)
    gf = full @ full.conj().T
    comp = jnp.max(jnp.abs(gf - jnp.eye(gf.shape[0], dtype=gf.dtype)))
    return R, {
        "max_overlap": overlap,
        "orthonormality": orth,
        "completeness": comp,
    }
