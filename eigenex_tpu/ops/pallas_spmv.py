"""Half-traffic symmetric block SpMV/SpMM kernel for NVIDIA GPUs (Pallas
through Triton).

:class:`~eigenex_tpu.sparse.sym_bsr.SymBSRMatrix` stores the diagonal
blocks plus the strictly-upper block triangle.  Its XLA formulation
(``SymBSRMatrix._xla_matvec``) runs one einsum for ``y[r] += B·x[c]`` and
another for ``y[c] += Bᵀ·x[r]``, so every upper block is read from device
memory twice — the byte count of full storage.  This kernel reads each
block once and applies it twice:

- one program per block row ``r`` loads its diagonal block and its
  ``ku`` upper blocks;
- ``B·x[c]`` accumulates into the program's own y tile, added to
  ``y[r]`` at the end;
- ``Bᵀ·x[r]`` is added into ``y[c]`` with ``atomic_add`` (other programs
  write the same rows, in no fixed order).

Blocks are upcast in registers and every sum is taken in f32.  The
matvec is an elementwise multiply and reduce (no tensor cores, so no
TF32).  The multi-RHS product uses the tensor cores only at f32 accuracy:
X is split into three bf16 parts (hi/mid/lo), f32 blocks likewise, and
the significant products of parts accumulate in f32.  Atomics add in a varying order, so results
differ in the last bits from run to run.

Padding slots (column 0, zero data) are skipped: a real upper block has
``c > r``.  The output is a zeroed input aliased to the result, which is
also what makes interpret mode (``interpret=True``, the CPU tests) start
from zero.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["kernel_supports", "sym_bsr_matvec_pallas", "sym_bsr_matmat_pallas"]

#: storage dtypes the kernel takes; f64 and complex run on XLA on purpose
KERNEL_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))

#: RHS columns per program in the SpMM: wider panels re-read the blocks
#: once per column group instead of exhausting the registers
_MAX_COLS = 32

#: warps per program, from a sweep on the H100 (PERF.md): 4 for the
#: matvec, 8 for the SpMM's tensor-core tiles
_MATVEC_PARAMS = pltriton.CompilerParams(num_warps=4, num_stages=2)
_MATMAT_PARAMS = pltriton.CompilerParams(num_warps=8, num_stages=2)


def kernel_supports(sym) -> bool:
    """Whether ``sym``'s storage fits the kernel: f32 or bf16 blocks,
    square, a power of two and at least 16 wide (the tensor-core operand
    minimum of the SpMM)."""
    bm, bn = sym.block_shape
    return (
        jnp.dtype(sym.dtype) in KERNEL_DTYPES
        and bm == bn
        and bm >= 16
        and bm & (bm - 1) == 0
    )


def _out_struct(shape, *arrays):
    """Output aval; under ``shard_map`` it carries the mesh axes it varies
    over (y varies wherever the block data or x does)."""
    for a in arrays:
        vma = getattr(jax.typeof(a), "vma", None)
        if vma:
            return jax.ShapeDtypeStruct(shape, jnp.float32, vma=vma)
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _matvec_kernel(cols_ref, diag_ref, upper_ref, x_ref, y0_ref, y_ref):
    del y0_ref  # aliased to y_ref: zero on entry
    r = pl.program_id(0)
    bm = diag_ref.shape[1]
    xr = x_ref[pl.ds(r * bm, bm)]
    acc = jnp.sum(diag_ref[r].astype(jnp.float32) * xr[None, :], axis=1)

    def slot(k, acc):
        c = cols_ref[r, k]

        def apply():
            B = upper_ref[r, k].astype(jnp.float32)
            xc = x_ref[pl.ds(c * bm, bm)]
            pltriton.atomic_add(
                y_ref, pl.ds(c * bm, bm), jnp.sum(B * xr[:, None], axis=0)
            )
            return acc + jnp.sum(B * xc[None, :], axis=1)

        return lax.cond(c > r, apply, lambda: acc)

    acc = lax.fori_loop(0, upper_ref.shape[1], slot, acc)
    pltriton.atomic_add(y_ref, pl.ds(r * bm, bm), acc)


@partial(jax.jit, static_argnames=("interpret",))
def sym_bsr_matvec_pallas(sym, x: jax.Array, interpret: bool = False) -> jax.Array:
    """y = A @ x (f32) for a :class:`SymBSRMatrix` whose storage
    :func:`kernel_supports`."""
    nbr, ku, bm, _ = sym.upper_data.shape
    n = sym.shape[0]
    x = x.astype(jnp.float32)
    itemsize = sym.upper_data.dtype.itemsize
    return pl.pallas_call(
        _matvec_kernel,
        out_shape=_out_struct((n,), sym.upper_data, x),
        grid=(nbr,),
        input_output_aliases={4: 0},
        interpret=interpret,
        compiler_params=_MATVEC_PARAMS,
        name="sym_bsr_spmv",
        cost_estimate=pl.CostEstimate(
            flops=2 * (sym.diag_data.size + 2 * sym.upper_data.size),
            bytes_accessed=(sym.diag_data.size + sym.upper_data.size) * itemsize
            + 4 * (n * (ku + 1) + 2 * n),
            transcendentals=0,
        ),
    )(sym.upper_cols, sym.diag_data, sym.upper_data, x, jnp.zeros((n,), jnp.float32))


def _bf16_parts(A, n: int):
    """``n`` bf16 parts whose f32 sum is ``A`` (to 8n bits of mantissa):
    one for bf16 input, three recover an f32 value exactly."""
    if A.dtype == jnp.bfloat16:
        return [A]
    parts = []
    for _ in range(n):
        part = A.astype(jnp.bfloat16)
        A = A - part.astype(jnp.float32)
        parts.append(part)
    return parts


def _block_dot(B, X, trans: bool):
    """``B @ X`` (``Bᵀ @ X`` when ``trans``) at f32 accuracy on the tensor
    cores: both operands split into bf16 parts (bf16 blocks are one part
    already), and the products of parts whose weights exceed 2⁻²⁴ summed
    in f32 — three bf16 products for bf16 blocks, six for f32 blocks."""
    dims = (((0 if trans else 1,), (0,)), ((), ()))
    out = None
    for i, b in enumerate(_bf16_parts(B, 3)):
        for j, x in enumerate(_bf16_parts(X, 3)[: 3 - i]):
            d = lax.dot_general(
                b, x, dims, precision=lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            out = d if out is None else out + d
    return out


def _matmat_kernel(pw, cols_ref, diag_ref, upper_ref, x_ref, y0_ref, y_ref):
    del y0_ref  # aliased to y_ref: zero on entry
    r = pl.program_id(0)
    bm = diag_ref.shape[1]
    cs = pl.ds(pl.program_id(1) * pw, pw)
    Xr = x_ref[pl.ds(r * bm, bm), cs]
    acc = _block_dot(diag_ref[r], Xr, trans=False)

    def slot(k, acc):
        c = cols_ref[r, k]

        def apply():
            B = upper_ref[r, k]
            Xc = x_ref[pl.ds(c * bm, bm), cs]
            pltriton.atomic_add(
                y_ref, (pl.ds(c * bm, bm), cs), _block_dot(B, Xr, trans=True)
            )
            return acc + _block_dot(B, Xc, trans=False)

        return lax.cond(c > r, apply, lambda: acc)

    acc = lax.fori_loop(0, upper_ref.shape[1], slot, acc)
    pltriton.atomic_add(y_ref, (pl.ds(r * bm, bm), cs), acc)


@partial(jax.jit, static_argnames=("interpret",))
def sym_bsr_matmat_pallas(sym, X: jax.Array, interpret: bool = False) -> jax.Array:
    """Y = A @ X (f32) for a :class:`SymBSRMatrix` whose storage
    :func:`kernel_supports` and a dense (n, p) X.  p is padded to a power
    of two of at least 16 (Triton block shapes, tensor-core minimum) and
    the pad columns sliced off."""
    nbr, ku, bm, _ = sym.upper_data.shape
    n, p_in = X.shape
    p = max(16, 1 << (p_in - 1).bit_length())
    X = X.astype(jnp.float32)
    if p != p_in:
        X = jnp.pad(X, ((0, 0), (0, p - p_in)))
    itemsize = sym.upper_data.dtype.itemsize
    pw = min(p, _MAX_COLS)
    groups = p // pw
    Y = pl.pallas_call(
        partial(_matmat_kernel, pw),
        out_shape=_out_struct((n, p), sym.upper_data, X),
        grid=(nbr, groups),
        input_output_aliases={4: 0},
        interpret=interpret,
        compiler_params=_MATMAT_PARAMS,
        name="sym_bsr_spmm",
        cost_estimate=pl.CostEstimate(
            flops=2 * (sym.diag_data.size + 2 * sym.upper_data.size) * p,
            bytes_accessed=groups * (sym.diag_data.size + sym.upper_data.size) * itemsize
            + 4 * p * (n * (ku + 1) + 2 * n),
            transcendentals=0,
        ),
    )(sym.upper_cols, sym.diag_data, sym.upper_data, X, jnp.zeros((n, p), jnp.float32))
    return Y[:, :p_in] if p != p_in else Y
