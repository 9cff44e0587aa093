"""Row-partitioned distributed SpMV and distributed Lanczos.

Net-new subsystem (the reference is strictly serial; SURVEY.md §2):
implements BASELINE.json's north star — the operator's block rows are
sharded over a 1-D device mesh, vectors and the Krylov basis shard over
the same axis, Gram-Schmidt inner products complete with ``lax.psum``,
and each matvec reconstitutes the needed x segments with collectives
lowered by XLA onto the device interconnect.

Four matvec strategies:

- **all-gather** (general sparsity, row-partitioned): ``lax.all_gather``
  the x shards, then local BSR-ELL SpMV.  Correctness baseline;
  bandwidth n per device per matvec (collective BEFORE compute).
- **column-split** (general sparsity, column-partitioned): each device
  holds the block-column panel matching its own x shard, computes a
  full-length partial product with NO input collective, then reduces
  with ``lax.psum_scatter`` — the reduce_scatter dual of all-gather
  (same wire volume, but the collective comes AFTER the local SpMV, so
  XLA can overlap the reduction of early output tiles with the tail of
  the compute; also the layout of choice when x shards are produced
  locally by a previous sharded op).  SURVEY.md §5's
  ``reduce_scatter``-fused mandate.
- **neighbor halo** (:func:`halo_matvec`, for operators whose column
  blocks only reach the adjacent shards — banded/PDE/chain
  Hamiltonians): exchange only the boundary block segments via
  ``lax.ppermute`` ring shifts, overlapped by XLA with the local
  diagonal-part SpMV (SURVEY.md §5's ring-attention analog).
- **symmetric halo** (:func:`sym_halo_matvec`): the half-HBM-traffic
  diag+upper storage of :class:`~eigenex_tpu.sparse.sym_bsr.SymBSRMatrix`
  on the mesh — forward x halo plus a REVERSE halo of Bᴴx partial-y
  contributions, same wire volume as "halo" but each off-diagonal
  boundary block is read once and applied to both triangles (the ~1.4×
  single-chip kernel win carried into weak scaling; no shard ever
  stores the global lower triangle).

The shard-local symmetric SpMV of the sym_halo mode can run through the
half-traffic GPU kernel (``use_pallas=True``; "interpret" for CPU-mesh
tests) instead of the XLA scatter-add path.  The other modes read each
block once already and run on XLA.

The distributed Lanczos reuses the *identical* step body as the
single-device solver (``_lanczos_chunk_body`` with ``axis_name`` set) —
one code path, so single-vs-sharded bit-comparison tests are meaningful
(SURVEY.md §4e).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.operators import LinearOperator
from ..solvers.arnoldi import ArnoldiState, _arnoldi_chunk_body
from ..solvers.lanczos import (
    LanczosEigenSolver,
    LanczosOptions,
    LanczosState,
    _lanczos_chunk_body,
)
from ..solvers.krylov_schur import KrylovSchurArnoldiSolver
from ..solvers.lobpcg import LOBPCGSolver
from ..solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from ..sparse.bsr import BSRMatrix
from ..utils.exceptions import EigenexError
from ..utils.tolerance import default_breakdown_threshold, real_dtype_of
from .mesh import ROWS, make_mesh

__all__ = [
    "pad_bsr_for_mesh",
    "pad_bsr_rect",
    "distributed_lanczos_steps",
    "distributed_arnoldi_steps",
    "DistributedLanczosEigenSolver",
    "DistributedShiftInvertLanczosEigenSolver",
    "DistributedThickRestartLanczosEigenSolver",
    "DistributedKrylovSchurArnoldiSolver",
    "halo_matvec",
    "halo_matmat",
    "sym_halo_matvec",
    "sym_halo_matmat",
    "mesh_operator",
    "mesh_operator_2d",
    "split_bsr_grid",
    "split_bsr_halo",
    "split_sym_bsr_halo",
    "split_bsr_colpanels",
]


def _padding_safe_v0(orig_n: int, padded_n: int, dtype, seed: int):
    """Random start vector supported on the ORIGINAL coordinates only.

    Structurally-zero padding rows add a spurious eigenvalue 0 of
    multiplicity (padded_n - orig_n); a start vector with no component in
    that exactly-invariant subspace keeps Krylov iterates out of it, so
    the padded operator's Ritz values are those of the original."""
    from ..utils.prng import random_vector

    v = random_vector(jax.random.PRNGKey(seed), orig_n, dtype, normalize=False)
    return jnp.zeros((padded_n,), dtype).at[:orig_n].set(v)


def prepare_packed_mesh(mat, mesh, matvec_mode: str):
    """(mesh, matvec_mode) normalization shared by every front end that
    row-partitions a PACKED (accelerate()) container:

    - multi-axis meshes flatten to one row axis (the halo/sym_halo rings
      are 1-axis row partitions; a second axis adds nothing a panel grid
      does not already cover on full storage);
    - SymBSR half-traffic storage has exactly one mesh mode (sym_halo);
    - the packed band must fit ONE mesh panel — the ring exchanges with
      the immediate neighbor only, so a wider band is rejected up front
      with the shard-count remedy instead of a split-internals error."""
    from jax.sharding import Mesh as _Mesh

    from ..sparse.sym_bsr import SymBSRMatrix as _Sym

    if len(mesh.axis_names) >= 2:
        mesh = _Mesh(mesh.devices.reshape(-1), ("rows",))
    if isinstance(mat, _Sym):
        if matvec_mode == "allgather":
            matvec_mode = "sym_halo"
        elif matvec_mode != "sym_halo":
            raise EigenexError(
                "an accelerated (SymBSR) operand supports matvec_mode='sym_halo' only"
            )
        nd = mesh.shape[mesh.axis_names[0]]
        nbr_pad = -(-mat.n_block_rows // nd) * nd
        if mat.band_reach > nbr_pad // nd:
            raise EigenexError(
                f"the packed band reach ({mat.band_reach} block rows) exceeds "
                f"one mesh panel ({nbr_pad // nd} block rows at {nd} shards) — "
                "the sym_halo ring exchanges with the immediate neighbor only; "
                "use fewer shards so each panel covers the band, or repack "
                "with a stronger reordering"
            )
    return mesh, matvec_mode


def pad_bsr_for_mesh(bsr, n_shards: int):
    """Zero-pad block rows/cols so the row count divides evenly over the
    mesh.  Accepts a :class:`BSRMatrix` or a :class:`SymBSRMatrix`.

    The padding rows are structurally zero, which adds eigenvalue 0 with
    multiplicity = padding size to the padded operator — when targeting
    eigenvalues that 0 could shadow (e.g. the smallest of a
    positive-definite operator), start the iteration from a vector with
    no padding support (the distributed solvers do this automatically;
    see :func:`_padding_safe_v0`)."""
    from ..sparse.sym_bsr import SymBSRMatrix

    if isinstance(bsr, SymBSRMatrix):
        nbr = bsr.n_block_rows
        if nbr % n_shards == 0:
            return bsr
        pad = n_shards - nbr % n_shards
        bm, bn = bsr.block_shape
        ku = bsr.upper_cols.shape[1]
        diag = jnp.concatenate(
            [bsr.diag_data, jnp.zeros((pad, bm, bn), bsr.diag_data.dtype)]
        )
        ud = jnp.concatenate([bsr.upper_data, jnp.zeros((pad, ku, bm, bn), bsr.dtype)])
        uc = jnp.concatenate([bsr.upper_cols, jnp.zeros((pad, ku), jnp.int32)])
        m = bsr.shape[0] + pad * bm
        return SymBSRMatrix(diag, ud, uc, (m, m), bsr.band_reach)
    nbr = bsr.n_block_rows
    if nbr % n_shards == 0:
        return bsr
    pad = n_shards - nbr % n_shards
    bm, bn = bsr.block_shape
    data = jnp.concatenate(
        [bsr.data, jnp.zeros((pad, bsr.k_max, bm, bn), bsr.dtype)], axis=0
    )
    cols = jnp.concatenate(
        [bsr.block_cols, jnp.zeros((pad, bsr.k_max), jnp.int32)], axis=0
    )
    m = bsr.shape[0] + pad * bm
    n = max(bsr.shape[1], m) if bsr.shape[0] == bsr.shape[1] else bsr.shape[1]
    return BSRMatrix(data, cols, (m, n))


def pad_bsr_rect(bsr: BSRMatrix, n_shards: int) -> BSRMatrix:
    """Rectangular twin of :func:`pad_bsr_for_mesh`: zero-pad block ROWS
    and block COLS independently to multiples of ``n_shards`` — the svds
    Gram pipeline needs both A and Aᴴ row-partitionable.  Column padding
    is a pure shape extension (the padded block columns hold no data)."""
    nbr = bsr.n_block_rows
    nbc = bsr.n_block_cols
    bm, bn = bsr.block_shape
    padr = (-nbr) % n_shards
    padc = (-nbc) % n_shards
    data, cols = bsr.data, bsr.block_cols
    if padr:
        data = jnp.concatenate(
            [data, jnp.zeros((padr, bsr.k_max, bm, bn), bsr.dtype)], axis=0
        )
        cols = jnp.concatenate(
            [cols, jnp.zeros((padr, bsr.k_max), jnp.int32)], axis=0
        )
    if not padr and not padc:
        return bsr
    return BSRMatrix(data, cols, ((nbr + padr) * bm, (nbc + padc) * bn))


def _acc_dtype_of(dtype):
    """Accumulate low-precision storage in f32 (the BSRMatrix._acc_dtype
    policy, applied to the distributed matvec paths too)."""
    return jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) else dtype


def _local_ell_spmv(data, cols, x):
    """Shard-local BSR-ELL SpMV: XLA gather+einsum."""
    bn = data.shape[3]
    xb = x.reshape(-1, bn)[cols]
    acc = _acc_dtype_of(data.dtype)
    # x stays at the ACCUMULATION dtype: casting to bf16 storage dtype
    # injects ~2e-3 relative noise per matvec (round-4 finding; the
    # mixed bf16 x f32 einsum promotes in-registers)
    y = jnp.einsum(
        "rkij,rkj->ri", data, xb.astype(acc), preferred_element_type=acc,
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(-1).astype(acc)


def _local_allgather_matvec(params, x_local, *, axis_name, bn):
    """Local-shard matvec: gather all x shards, apply the local block
    rows.  Runs inside shard_map."""
    data, cols = params
    x = lax.all_gather(x_local, axis_name, tiled=True)  # (n,)
    return _local_ell_spmv(data, cols, x)


def _local_colsplit_matvec(params, x_local, *, axis_name, bn):
    """Column-panel matvec: the local panel consumes only the OWN x shard
    (its block-column ids are panel-local), produces a full-length
    partial y, and ``lax.psum_scatter`` both sums the partials across the
    mesh and leaves each device its own y shard — all_gather's
    reduce_scatter dual.  Runs inside shard_map."""
    data, cols = params
    y_partial = _local_ell_spmv(data, cols, x_local)
    return lax.psum_scatter(y_partial, axis_name, scatter_dimension=0, tiled=True)


# cache of compiled distributed chunk runners, keyed by static config
_DIST_CHUNK_CACHE: dict = {}


def _build_local_operator(
    mode, op_arrays, axis_name, bn, n_total, dtype, use_pallas=False
):
    """Local-shard matvec operator from the sharded BSR arrays."""
    if mode == "allgather":
        data, cols = op_arrays
        nbr_local, _, bm, _ = data.shape
        return LinearOperator(
            partial(_local_allgather_matvec, axis_name=axis_name, bn=bn),
            (data, cols),
            (nbr_local * bm, n_total),
            dtype,
        )
    if mode == "colsplit":
        data, cols = op_arrays
        nbr_full, _, bm, _ = data.shape  # ALL block rows (panel has full height)
        return LinearOperator(
            partial(_local_colsplit_matvec, axis_name=axis_name, bn=bn),
            (data, cols),
            (n_total, n_total),
            dtype,
        )
    if mode == "sym_halo":
        diag, ind, inc, rd, rc = op_arrays
        nbr_local, bm, _ = diag.shape
        return LinearOperator(
            partial(_sym_halo_mv, axis_name=axis_name, bn=bn, use_pallas=use_pallas),
            (diag, ind, inc, rd, rc),
            (nbr_local * bm, n_total),
            dtype,
        )
    dd, dc, ld, lc, rd, rc = op_arrays
    nbr_local, _, bm, _ = dd.shape
    return LinearOperator(
        lambda p, x: halo_matvec(*p, x, axis_name=axis_name, bn=bn),
        (dd, dc, ld, lc, rd, rc),
        (nbr_local * bm, n_total),
        dtype,
    )


def _get_dist_chunk(
    mesh, axis_name, num_steps, reorth, has_deflate, bn, mode, si_cg_iters=None,
    use_pallas=False,
):
    key = (
        mesh, axis_name, num_steps, reorth, has_deflate, bn, mode, si_cg_iters,
        use_pallas,
    )
    fn = _DIST_CHUNK_CACHE.get(key)
    if fn is not None:
        return fn

    n_op_args = {"halo": 6, "sym_halo": 5}.get(mode, 2)

    def body(*args):
        op_arrays = args[:n_op_args]
        if si_cg_iters is None:
            V, alpha, beta, k, breakdown, failed, shift, bd, deflate = args[n_op_args:]
        else:
            (
                V, alpha, beta, k, breakdown, failed, shift, bd, deflate, sigma, cg_tol,
            ) = args[n_op_args:]
        op_local = _build_local_operator(
            mode, op_arrays, axis_name, bn, V.shape[1], V.dtype, use_pallas
        )
        if si_cg_iters is not None:
            # shift-invert: each Lanczos matvec is a mesh-parallel CG solve
            # of (A − σI) y = x, inner products psum-completed — the
            # BASELINE config-5 operator
            from ..solvers.cg import _cg_loop, _minres_loop

            base = op_local

            def si_matvec(p, x):
                shifted = LinearOperator(
                    lambda pp, v: pp[0].matvec(v) - pp[1] * v,
                    (p[0], p[1]),
                    p[0].shape,
                    p[0].dtype,
                    # Hermitian operator, real shift: self-adjoint — gives
                    # the MINRES/CGLS rescue its A^H without a second codepath
                    rmatvec_fn=lambda pp, v: pp[0].matvec(v) - pp[1] * v,
                )
                y, _, _ = _cg_loop(
                    shifted,
                    x,
                    jnp.zeros_like(x),
                    p[2],
                    max_iters=si_cg_iters,
                    axis_name=axis_name,
                )
                # CG is only guaranteed for a DEFINITE shift; an interior σ
                # makes (A − σI) indefinite and CG can stagnate/diverge
                # silently, poisoning every outer Ritz value.  Check the
                # true residual (psum-completed, so the predicate is
                # replicated across shards) and rescue with mesh-parallel
                # MINRES — the Hermitian-indefinite minimum-residual
                # solver, axis-aware like the CG it replaces.
                r = x - shifted.matvec(y)
                rel2 = jnp.real(lax.psum(jnp.vdot(r, r), axis_name)) / jnp.maximum(
                    jnp.real(lax.psum(jnp.vdot(x, x), axis_name)), 1e-300
                )
                tol2 = (p[2] * p[2]).astype(rel2.dtype)
                # every predicate below must be REPLICATED across shards
                # (shard-local isfinite would branch-diverge the cond and
                # deadlock its collectives) — psum makes them so
                n_bad = lax.psum(
                    (~jnp.all(jnp.isfinite(y))).astype(jnp.float32), axis_name
                )
                y_safe = jnp.where(n_bad == 0, y, jnp.zeros_like(y))
                return jax.lax.cond(
                    jnp.isfinite(rel2) & (rel2 <= tol2),
                    lambda: y,
                    lambda: _minres_loop(
                        shifted, x, y_safe, p[2],
                        max_iters=si_cg_iters, axis_name=axis_name,
                    )[0],
                )

            op_local = LinearOperator(
                si_matvec, (base, sigma.astype(V.dtype), cg_tol), base.shape, base.dtype
            )
        state = LanczosState(
            V=V, alpha=alpha, beta=beta, k=k, breakdown=breakdown, failed=failed
        )
        out = _lanczos_chunk_body(
            op_local,
            state,
            shift,
            bd,
            deflate,
            num_steps=num_steps,
            reorthogonalize_interval=reorth,
            has_deflate=has_deflate,
            axis_name=axis_name,
        )
        return out.V, out.alpha, out.beta, out.k, out.breakdown, out.failed

    state_specs = (
        P(None, axis_name),  # V: basis columns (vector entries) sharded
        P(),  # alpha (replicated)
        P(),  # beta
        P(),  # k
        P(),  # breakdown
        P(),  # failed
        P(),  # shift
        P(),  # breakdown threshold
        P(None, axis_name),  # deflation rows
    )
    if si_cg_iters is not None:
        state_specs = state_specs + (P(), P())  # sigma, cg_tol
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name),) * n_op_args + state_specs,
        out_specs=(P(None, axis_name), P(), P(), P(), P(), P()),
        # the Pallas kernel trips JAX's vma checker on in-kernel
        # dynamic_slice (jax-ml/jax suggested workaround)
        check_vma=not use_pallas,
    )
    fn = jax.jit(sharded)
    _DIST_CHUNK_CACHE[key] = fn
    return fn


def distributed_lanczos_steps(
    bsr: BSRMatrix,
    state: LanczosState,
    num_steps: int,
    mesh: Mesh,
    *,
    axis_name: str = ROWS,
    shift=0.0,
    breakdown_threshold: float | None = None,
    reorthogonalize_interval: int = 1,
    deflate: jax.Array | None = None,
    matvec_mode: str = "allgather",
    halo_parts=None,
    shift_invert_sigma=None,
    cg_tol: float = 1e-8,
    cg_max_iters: int = 500,
    use_pallas: bool | str = False,
) -> LanczosState:
    """Run Lanczos steps with the operator row-partitioned over ``mesh``.

    ``shift_invert_sigma``: when set, each Lanczos matvec becomes a
    mesh-parallel CG solve of (A − σI) y = x (inner products
    psum-completed over the same axis) — distributed shift-invert
    Lanczos, the BASELINE config-5 pipeline.  The Ritz values θ of the
    returned state then estimate eigenvalues of (A − σI)⁻¹: λ ≈ σ + 1/θ.

    Same semantics as :func:`eigenex_tpu.solvers.lanczos.lanczos_steps`;
    the basis is sharded ``P(None, rows)``, α/β/k replicated.

    ``matvec_mode``: "allgather" (general sparsity), "colsplit" (general
    sparsity, column panels + ``psum_scatter`` — the reduce_scatter
    dual), "halo" (neighbor-banded operators: ppermute boundary
    exchange overlapped with the local diagonal SpMV — BASELINE config
    5's halo-overlapped SpMV) or "sym_halo" (neighbor-banded SYMMETRIC
    operators in half-HBM-traffic diag+upper storage: forward x halo +
    reverse Bᴴx-contribution halo, same wire volume as "halo"; pass a
    ``SymBSRMatrix`` or let the BSR be packed automatically).  Halo
    modes require the operator's column blocks to reach only the
    adjacent shards (checked at split time).

    ``use_pallas``: run the sym_halo shard-local SpMV through the GPU
    kernel ("interpret" for CPU-mesh tests); the other modes run on XLA.
    """
    nd = mesh.shape[axis_name]
    if bsr.n_block_rows % nd:
        raise EigenexError(
            f"{bsr.n_block_rows} block rows not divisible by {nd} shards — "
            "use pad_bsr_for_mesh first"
        )
    if bsr.shape[0] != bsr.shape[1]:
        raise EigenexError("Lanczos requires a square operator")
    if matvec_mode not in ("allgather", "colsplit", "halo", "sym_halo"):
        raise EigenexError(f"unknown matvec_mode {matvec_mode!r}")
    rdt = real_dtype_of(bsr.dtype)
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(bsr.dtype)
    has_deflate = deflate is not None
    if not has_deflate:
        deflate = jnp.zeros((0, bsr.shape[1]), bsr.dtype)
    si_iters = None if shift_invert_sigma is None else int(cg_max_iters)
    if matvec_mode == "halo":
        diag, left, right = halo_parts if halo_parts is not None else split_bsr_halo(bsr, nd)
        op_arrays = (diag[0], diag[1], left[0], left[1], right[0], right[1])
    elif matvec_mode == "sym_halo":
        if halo_parts is not None:
            diag, inp, right = halo_parts
        else:
            from ..sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr

            sym = bsr if isinstance(bsr, SymBSRMatrix) else sym_bsr_from_bsr(bsr)
            diag, inp, right = split_sym_bsr_halo(sym, nd)
        op_arrays = (diag, inp[0], inp[1], right[0], right[1])
    elif matvec_mode == "colsplit":
        pd, pc = halo_parts if halo_parts is not None else split_bsr_colpanels(bsr, nd)
        op_arrays = (pd, pc)
    else:
        op_arrays = (bsr.data, bsr.block_cols)
    fn = _get_dist_chunk(
        mesh, axis_name, int(num_steps), int(reorthogonalize_interval), has_deflate,
        bsr.block_shape[1], matvec_mode, si_iters, use_pallas,
    )
    extra = ()
    if shift_invert_sigma is not None:
        extra = (jnp.asarray(shift_invert_sigma, rdt), jnp.asarray(cg_tol, rdt))
    V, alpha, beta, k, brk, failed = fn(
        *op_arrays,
        state.V,
        state.alpha,
        state.beta,
        state.k,
        state.breakdown,
        state.failed,
        jnp.asarray(shift),
        jnp.asarray(breakdown_threshold, rdt),
        jnp.asarray(deflate, bsr.dtype),
        *extra,
    )
    return LanczosState(V=V, alpha=alpha, beta=beta, k=k, breakdown=brk, failed=failed)


class _DistributedBSRSolverMixin:
    """Shared plumbing of the distributed solver drivers: mesh defaulting,
    row padding (with a null-space-safe start vector), halo pre-split, and
    the distributed Arnoldi chunk override used by the restarted solvers.

    Subclasses call ``_init_distributed`` after their base ``__init__``."""

    def _init_distributed(self, bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas=False):
        self.bsr = bsr
        self.mesh = mesh
        self.axis_name = axis_name
        self.matvec_mode = matvec_mode
        self._dist_orig_n = orig_n
        nd = mesh.shape[axis_name]
        from ..sparse.sym_bsr import SymBSRMatrix, kernel_route, sym_bsr_from_bsr

        if isinstance(bsr, SymBSRMatrix) and matvec_mode != "sym_halo":
            raise EigenexError(
                "a SymBSRMatrix operand requires matvec_mode='sym_halo' — "
                "the other modes need full-storage block rows"
            )
        if matvec_mode == "halo":
            self._halo_parts = split_bsr_halo(bsr, nd)
        elif matvec_mode == "sym_halo":
            sym = bsr if isinstance(bsr, SymBSRMatrix) else sym_bsr_from_bsr(bsr)
            self._halo_parts = split_sym_bsr_halo(sym, nd)
            if use_pallas is None:
                # the backend rule, applied while the container is concrete
                use_pallas = kernel_route(sym)
        elif matvec_mode == "colsplit":
            self._halo_parts = split_bsr_colpanels(bsr, nd)
        else:
            self._halo_parts = None
        self.use_pallas = use_pallas or False
        if self._halo_parts is not None:
            # each device keeps its own row shard for the whole solve;
            # left on one device, the parts would be resharded per chunk
            rows = jax.sharding.NamedSharding(mesh, P(axis_name))
            self._halo_parts = jax.device_put(self._halo_parts, rows)
        if bsr.shape[0] != orig_n:
            self._initial_vector = _padding_safe_v0(
                orig_n, bsr.shape[0], bsr.dtype, self.options.seed
            )

    def compute(self, *args, **kwargs):
        """Run the base solver, then slice Ritz vectors back to the
        caller's ORIGINAL length — pad_bsr_for_mesh may have zero-padded
        rows, and the padding coordinates of every Krylov iterate are
        exactly zero (padding-safe start vector + structurally-zero
        rows), so truncation loses nothing."""
        res = super().compute(*args, **kwargs)
        n = getattr(self, "_dist_orig_n", None)
        ev = getattr(res, "eigenvectors", None)
        if n is not None and ev is not None and ev.shape[0] != n:
            res.eigenvectors = ev[:n]
        return res

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        if num_steps <= 0:
            return state
        # fixed chunk length (= m): steps past the subspace no-op inside
        # the loop, and the compiled shard_map program is reused across
        # restarts regardless of how many Ritz/Schur vectors were kept
        return distributed_arnoldi_steps(
            self.bsr,
            state,
            state.H.shape[1],
            self.mesh,
            axis_name=self.axis_name,
            shift=self.options.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
            matvec_mode=self.matvec_mode,
            halo_parts=self._halo_parts,
            use_pallas=self.use_pallas,
        )


class DistributedLanczosEigenSolver(_DistributedBSRSolverMixin, LanczosEigenSolver):
    """Mesh-parallel Lanczos driver: same host control loop, convergence
    machinery and result surface as :class:`LanczosEigenSolver`, with the
    iteration chunk running under ``shard_map`` on a row-partitioned
    BSR operator."""

    def __init__(
        self,
        bsr: BSRMatrix,
        mesh: Mesh | None = None,
        options: LanczosOptions | None = None,
        axis_name: str = ROWS,
        matvec_mode: str = "allgather",
        use_pallas: bool | str = False,
    ):
        mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)

    def _run_chunk(self, op, state, num_steps, breakdown_threshold):
        o = self.options
        return distributed_lanczos_steps(
            self.bsr,
            state,
            num_steps,
            self.mesh,
            axis_name=self.axis_name,
            shift=o.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval,
            deflate=self._deflate,
            matvec_mode=self.matvec_mode,
            halo_parts=self._halo_parts,
            use_pallas=self.use_pallas,
        )


class DistributedShiftInvertLanczosEigenSolver(DistributedLanczosEigenSolver):
    """Mesh-parallel SHIFT-INVERT Lanczos: each outer Lanczos matvec is a
    mesh-parallel CG solve of (A − σI) y = x (inner products
    psum-completed over the row axis) — the BASELINE config-5 pipeline as
    a driver with the full convergence machinery, reachable from
    ``eigsh(A, k, sigma=σ, mesh=mesh)``.

    The Ritz values this driver returns are the θ of (A − σI)⁻¹; its
    :meth:`compute` back-transforms them to λ = σ + 1/θ (eigenvectors are
    shared between the two operators, so they pass through unchanged).
    The inner solve is CG, so σ should sit outside or at the edge of the
    spectrum (the definite-shift regime — e.g. below the ground state);
    interior σ makes (A − σI) indefinite, where the single-device
    GMRES-backed ``eigsh(sigma=...)`` route is the right tool.

    ``cg_tol`` is the ``inner_tol`` knob of the one-call API: the outer
    eigenvalue error tracks the inner residual target (reference shift
    semantics: lanczos.hpp:155,390-392)."""

    def __init__(
        self,
        bsr: BSRMatrix,
        mesh: Mesh | None = None,
        options: LanczosOptions | None = None,
        axis_name: str = ROWS,
        matvec_mode: str = "allgather",
        use_pallas: bool | str = False,
        *,
        sigma: float,
        cg_tol: float = 1e-10,
        cg_max_iters: int = 5000,
    ):
        super().__init__(bsr, mesh, options, axis_name, matvec_mode, use_pallas)
        self.sigma = float(sigma)
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)

    def _run_chunk(self, op, state, num_steps, breakdown_threshold):
        o = self.options
        return distributed_lanczos_steps(
            self.bsr,
            state,
            num_steps,
            self.mesh,
            axis_name=self.axis_name,
            shift=o.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval,
            deflate=self._deflate,
            matvec_mode=self.matvec_mode,
            halo_parts=self._halo_parts,
            use_pallas=self.use_pallas,
            shift_invert_sigma=self.sigma,
            cg_tol=self.cg_tol,
            cg_max_iters=self.cg_max_iters,
        )

    def compute(self, *args, **kwargs):
        res = super().compute(*args, **kwargs)  # mixin slices padding rows
        theta = np.asarray(res.eigenvalues)
        nonzero = np.abs(theta) > 0
        res.eigenvalues = np.where(
            nonzero, self.sigma + 1.0 / np.where(nonzero, theta, 1.0), np.inf
        )
        return res


# ---------------------------------------------------------------------------
# Distributed Arnoldi chunk + distributed thick-restart Lanczos
# ---------------------------------------------------------------------------
_DIST_ARNOLDI_CACHE: dict = {}


def _get_dist_arnoldi_chunk(
    mesh, axis_name, num_steps, bn, mode, use_pallas=False
):
    key = (mesh, axis_name, num_steps, bn, mode, use_pallas)
    fn = _DIST_ARNOLDI_CACHE.get(key)
    if fn is not None:
        return fn
    n_op_args = {"halo": 6, "sym_halo": 5}.get(mode, 2)

    def body(*args):
        op_arrays = args[:n_op_args]
        V, H, k, breakdown, residue, failed, shift, bd = args[n_op_args:]
        op_local = _build_local_operator(
            mode, op_arrays, axis_name, bn, V.shape[1], V.dtype, use_pallas
        )
        state = ArnoldiState(
            V=V, H=H, k=k, breakdown=breakdown, residue=residue, failed=failed
        )
        deflate = jnp.zeros((0, V.shape[1]), V.dtype)
        out = _arnoldi_chunk_body(
            op_local,
            state,
            shift,
            bd,
            deflate,
            num_steps=num_steps,
            has_deflate=False,
            axis_name=axis_name,
        )
        return out.V, out.H, out.k, out.breakdown, out.residue, out.failed

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name),) * n_op_args
        + (
            P(None, axis_name),  # V
            P(),  # H (small, replicated)
            P(),  # k
            P(),  # breakdown
            P(),  # residue
            P(),  # failed
            P(),  # shift
            P(),  # breakdown threshold
        ),
        out_specs=(P(None, axis_name), P(), P(), P(), P(), P()),
        check_vma=not use_pallas,
    )
    fn = jax.jit(sharded)
    _DIST_ARNOLDI_CACHE[key] = fn
    return fn


def distributed_arnoldi_steps(
    bsr: BSRMatrix,
    state: ArnoldiState,
    num_steps: int,
    mesh: Mesh,
    *,
    axis_name: str = ROWS,
    shift=0.0,
    breakdown_threshold: float | None = None,
    matvec_mode: str = "allgather",
    halo_parts=None,
    use_pallas: bool | str = False,
) -> ArnoldiState:
    """Arnoldi basis/Hessenberg build with the operator row-partitioned
    over ``mesh`` — powers the distributed thick-restart solver and
    distributed GMRES-style uses."""
    nd = mesh.shape[axis_name]
    if bsr.n_block_rows % nd:
        raise EigenexError("pad_bsr_for_mesh before distributed_arnoldi_steps")
    rdt = real_dtype_of(bsr.dtype)
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(bsr.dtype)
    if matvec_mode == "halo":
        diag, left, right = halo_parts if halo_parts is not None else split_bsr_halo(bsr, nd)
        op_arrays = (diag[0], diag[1], left[0], left[1], right[0], right[1])
    elif matvec_mode == "sym_halo":
        if halo_parts is not None:
            diag, inp, right = halo_parts
        else:
            from ..sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr

            sym = bsr if isinstance(bsr, SymBSRMatrix) else sym_bsr_from_bsr(bsr)
            diag, inp, right = split_sym_bsr_halo(sym, nd)
        op_arrays = (diag, inp[0], inp[1], right[0], right[1])
    elif matvec_mode == "colsplit":
        pd, pc = halo_parts if halo_parts is not None else split_bsr_colpanels(bsr, nd)
        op_arrays = (pd, pc)
    else:
        op_arrays = (bsr.data, bsr.block_cols)
    fn = _get_dist_arnoldi_chunk(
        mesh, axis_name, int(num_steps), bsr.block_shape[1], matvec_mode, use_pallas,
    )
    V, H, k, brk, res, failed = fn(
        *op_arrays,
        state.V,
        state.H,
        state.k,
        state.breakdown,
        state.residue,
        state.failed,
        jnp.asarray(shift),
        jnp.asarray(breakdown_threshold, rdt),
    )
    return ArnoldiState(V=V, H=H, k=k, breakdown=brk, residue=res, failed=failed)


class DistributedThickRestartLanczosEigenSolver(
    _DistributedBSRSolverMixin, ThickRestartLanczosEigenSolver
):
    """Thick-restart Lanczos with the iteration chunk row-partitioned over
    a device mesh — the memory-bounded solver for operators whose Krylov
    basis cannot be held at full subspace size (the 10^8-row regime:
    small ``max_subspace``, many restarts, basis sharded over the mesh).

    The restart compression (one (p, m) × (m, n) matmul) runs as a plain
    jitted op on the sharded global arrays — XLA's sharding propagation
    distributes it."""

    def __init__(
        self,
        bsr: BSRMatrix,
        mesh: Mesh | None = None,
        options: ThickRestartOptions | None = None,
        axis_name: str = ROWS,
        matvec_mode: str = "allgather",
        use_pallas: bool | str = False,
    ):
        mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)


# ---------------------------------------------------------------------------
# Neighbor-halo SpMV (banded operators)
# ---------------------------------------------------------------------------
def halo_matvec(
    diag_data,
    diag_cols,
    left_data,
    left_cols,
    right_data,
    right_cols,
    x_local,
    *,
    axis_name: str = ROWS,
    bn: int,
):
    """Halo-exchange SpMV for operators whose off-shard column blocks lie
    only in the adjacent shards (banded matrices, chain Hamiltonians).

    The local rows are split at build time (:func:`split_bsr_halo`) into
    a diagonal part (columns within the own shard, *local* block-column
    ids) and left/right parts (columns in the neighbor shards, block-col
    ids local to that neighbor).  Per matvec, two ``lax.ppermute`` ring
    shifts move whole x shards one step each way; XLA overlaps these
    transfers with the local diagonal SpMV that needs no remote data.
    Bandwidth: 2·n_local per device (vs n for all-gather).
    """
    n_dev = lax.psum(1, axis_name)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    # x from the left neighbor arrives by shifting right, and vice versa
    x_from_left = lax.ppermute(x_local, axis_name, right_perm)
    x_from_right = lax.ppermute(x_local, axis_name, left_perm)

    def ell(data, cols, x):
        xb = x.reshape(-1, bn)[cols]
        acc = _acc_dtype_of(data.dtype)
        return (
            jnp.einsum(
                "rkij,rkj->ri", data, xb.astype(acc), preferred_element_type=acc,
                precision=lax.Precision.HIGHEST,
            )
            .reshape(-1)
            .astype(acc)
        )

    # the named scope tags the diag compute in HLO metadata so
    # tests/test_hlo_overlap.py can find it in the compiled graph next to
    # the collective-permute pair
    with jax.named_scope("halo_diag_spmv"):
        y = ell(diag_data, diag_cols, x_local)
    y = y + ell(left_data, left_cols, x_from_left)
    y = y + ell(right_data, right_cols, x_from_right)
    return y


def split_bsr_halo(bsr: BSRMatrix, n_shards: int):
    """Host-side split of a row-partitioned BSR matrix into
    (diagonal, left-halo, right-halo) BSR-ELL parts with *shard-local*
    block-column ids.  Raises if any block reaches beyond the adjacent
    shards (use the all-gather path then).
    """
    nbr = bsr.n_block_rows
    if nbr % n_shards:
        raise EigenexError("pad_bsr_for_mesh before split_bsr_halo")
    rows_per = nbr // n_shards
    data = np.asarray(bsr.data)
    cols = np.asarray(bsr.block_cols)
    kmax = bsr.k_max
    bm, bn = bsr.block_shape

    parts = {"diag": [], "left": [], "right": []}
    kused = {"diag": 0, "left": 0, "right": 0}
    per_row = {p: [] for p in parts}
    for r in range(nbr):
        shard = r // rows_per
        buckets = {"diag": [], "left": [], "right": []}
        for k in range(kmax):
            c = int(cols[r, k])
            blk = data[r, k]
            if not np.any(blk):
                continue
            src = c // rows_per
            local_c = c % rows_per
            if src == shard:
                buckets["diag"].append((local_c, blk))
            elif (src - shard) % n_shards == n_shards - 1:
                buckets["left"].append((local_c, blk))
            elif (src - shard) % n_shards == 1:
                buckets["right"].append((local_c, blk))
            else:
                raise EigenexError(
                    f"block row {r} reaches shard {src} (own {shard}) — "
                    "not neighbor-banded; use the all-gather matvec"
                )
        for p in parts:
            per_row[p].append(buckets[p])
            kused[p] = max(kused[p], len(buckets[p]))

    out = {}
    for p in parts:
        kk = max(kused[p], 1)
        d = np.zeros((nbr, kk, bm, bn), data.dtype)
        c = np.zeros((nbr, kk), np.int32)
        for r, bucket in enumerate(per_row[p]):
            for slot, (lc, blk) in enumerate(bucket):
                d[r, slot] = blk
                c[r, slot] = lc
        out[p] = (jnp.asarray(d), jnp.asarray(c))
    return out["diag"], out["left"], out["right"]


def _local_sym_matvec(diag, ud, uc, x, use_pallas):
    """Shard-local SYMMETRIC matvec (diag + in-panel upper applied on
    both triangles) — XLA scatter-add path or, with ``use_pallas``, the
    half-traffic GPU kernel ("interpret" in tests).  Runs inside
    shard_map."""
    from ..sparse.sym_bsr import SymBSRMatrix

    n_local = diag.shape[0] * diag.shape[1]
    sym_local = SymBSRMatrix(diag, ud, uc, (n_local, n_local))
    if use_pallas:
        from ..ops.pallas_spmv import sym_bsr_matvec_pallas

        return sym_bsr_matvec_pallas(
            sym_local, x, interpret=use_pallas == "interpret"
        )
    return sym_local._xla_matvec(x)


def sym_halo_matvec(
    diag, ud, uc, rd, rc, x_local, *, axis_name: str = ROWS, bn: int,
    use_pallas=False,
):
    """Symmetric halo-exchange SpMV: the half-HBM-traffic layout of
    :class:`~eigenex_tpu.sparse.sym_bsr.SymBSRMatrix` carried into the
    row-partitioned mesh.

    Each shard stores its diagonal blocks, the in-panel strictly-upper
    blocks, and the boundary upper blocks reaching the RIGHT neighbor
    (``split_sym_bsr_halo``).  A boundary block B at (r local, c in the
    next panel) contributes twice from one HBM read:

    - ``y[r] += B·x_next[c]`` — needs the right neighbor's x shard
      (forward ppermute, as in :func:`halo_matvec`);
    - ``y_next[c] += Bᴴ·x[r]`` — computed HERE from local x, then
      shipped one step right (REVERSE ppermute of the partial-y
      segment) and added by the owner.

    Wire volume per matvec is 2·n_local per device — identical to the
    full-storage halo mode — and with ``use_pallas`` the local block
    traffic is halved (the XLA local path reads each block twice).  The
    lower triangle of the global matrix is never stored anywhere on the
    mesh.  Runs inside shard_map.
    """
    n_dev = lax.psum(1, axis_name)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    # x of the right neighbor arrives by shifting every shard one left
    x_from_right = lax.ppermute(x_local, axis_name, left_perm)
    acc = _acc_dtype_of(diag.dtype)

    # in-panel symmetric part: needs no remote data, so XLA may overlap
    # the ppermutes above/below with this compute
    with jax.named_scope("sym_halo_local_spmv"):
        y = _local_sym_matvec(diag, ud, uc, x_local, use_pallas)

    # boundary: y[r] += B x_next[c]
    y = y + _local_ell_spmv(rd, rc, x_from_right)

    # reverse contribution y_next[c] += Bᴴ x[r]; padding slots (col 0,
    # zero blocks) scatter zeros — harmless
    xb = x_local.reshape(-1, bn)
    rdh = jnp.conj(rd) if jnp.issubdtype(rd.dtype, jnp.complexfloating) else rd
    contrib = jnp.einsum(
        "rkij,ri->rkj", rdh, xb.astype(acc), preferred_element_type=acc,
        precision=lax.Precision.HIGHEST,
    )
    nbc_next = x_from_right.shape[0] // bn
    yc = jnp.zeros((nbc_next, bn), acc).at[rc].add(contrib.astype(acc)).reshape(-1)
    y = y + lax.ppermute(yc, axis_name, right_perm)
    return y


def _sym_halo_mv(p, x, *, axis_name, bn, use_pallas=False):
    return sym_halo_matvec(*p, x, axis_name=axis_name, bn=bn, use_pallas=use_pallas)


def split_sym_bsr_halo(sym, n_shards: int):
    """Host-side split of a :class:`SymBSRMatrix` for the sym_halo mode:
    (diag_data, (in_data, in_cols), (right_data, right_cols)) with
    shard-local block-column ids.  Upper blocks must lie in the own or
    the immediately-right panel (c > r always holds for upper storage),
    otherwise raises — use all-gather then."""
    nbr = sym.n_block_rows
    if nbr % n_shards:
        raise EigenexError("pad the operator before split_sym_bsr_halo")
    rows_per = nbr // n_shards
    ud = np.asarray(sym.upper_data)
    uc = np.asarray(sym.upper_cols)
    ku = uc.shape[1]
    bm, bn = sym.block_shape
    nz = ud.reshape(nbr, ku, -1).any(axis=2)
    in_rows: list[list[tuple]] = [[] for _ in range(nbr)]
    right_rows: list[list[tuple]] = [[] for _ in range(nbr)]
    for r, k in zip(*np.where(nz)):
        c = int(uc[r, k])
        shard, src = r // rows_per, c // rows_per
        if src == shard:
            in_rows[r].append((c % rows_per, ud[r, k]))
        elif src == shard + 1:
            right_rows[r].append((c % rows_per, ud[r, k]))
        else:
            raise EigenexError(
                f"upper block ({int(r)}, {c}) reaches shard {src} (own "
                f"{shard}) — not neighbor-banded; use the all-gather matvec"
            )

    def pack(rows_list):
        kk = max(max((len(b) for b in rows_list), default=0), 1)
        d = np.zeros((nbr, kk, bm, bn), ud.dtype)
        c = np.zeros((nbr, kk), np.int32)
        for r, bucket in enumerate(rows_list):
            for slot, (lc, blk) in enumerate(bucket):
                d[r, slot] = blk
                c[r, slot] = lc
        return jnp.asarray(d), jnp.asarray(c)

    return sym.diag_data, pack(in_rows), pack(right_rows)


def split_bsr_colpanels(bsr: BSRMatrix, n_shards: int):
    """Host-side split of a BSR matrix into block-COLUMN panels with
    *panel-local* block-column ids, stacked so ``P(axis)`` sharding hands
    each device its own panel (the colsplit/psum_scatter matvec layout).

    Returns (data (nd·nbr, kmax_p, bm, bn), cols (nd·nbr, kmax_p)) where
    panel d occupies rows [d·nbr, (d+1)·nbr)."""
    nbr = bsr.n_block_rows
    nbc = bsr.n_block_cols
    if nbc % n_shards:
        raise EigenexError("pad_bsr_for_mesh before split_bsr_colpanels")
    cols_per = nbc // n_shards
    data = np.asarray(bsr.data)
    cols = np.asarray(bsr.block_cols)
    kmax = bsr.k_max
    bm, bn = bsr.block_shape

    buckets: list[list[list[tuple]]] = [
        [[] for _ in range(nbr)] for _ in range(n_shards)
    ]
    for r in range(nbr):
        for k in range(kmax):
            c = int(cols[r, k])
            blk = data[r, k]
            if not np.any(blk):
                continue
            d = c // cols_per
            buckets[d][r].append((c % cols_per, blk))
    kmax_p = max(
        (len(b) for panel in buckets for b in panel), default=0
    )
    kmax_p = max(kmax_p, 1)
    out_d = np.zeros((n_shards, nbr, kmax_p, bm, bn), data.dtype)
    out_c = np.zeros((n_shards, nbr, kmax_p), np.int32)
    for d in range(n_shards):
        for r in range(nbr):
            for slot, (lc, blk) in enumerate(buckets[d][r]):
                out_d[d, r, slot] = blk
                out_c[d, r, slot] = lc
    return (
        jnp.asarray(out_d.reshape(n_shards * nbr, kmax_p, bm, bn)),
        jnp.asarray(out_c.reshape(n_shards * nbr, kmax_p)),
    )


# ---------------------------------------------------------------------------
# Distributed SpMM (matmat) twins of the four matvec modes + the
# global-array mesh operator that powers mesh-aware Chebyshev/KPM/LOBPCG
# ---------------------------------------------------------------------------
def _local_allgather_matmat(params, X_local, *, axis_name, bn):
    """Multi-RHS twin of :func:`_local_allgather_matvec`: gather all X
    row shards, apply the local block rows.  Runs inside shard_map."""
    data, cols = params
    X = lax.all_gather(X_local, axis_name, tiled=True)  # (n, p)
    return _local_ell_spmm(data, cols, X)


def _local_colsplit_matmat(params, X_local, *, axis_name, bn):
    """Column-panel SpMM + ``psum_scatter`` along the row axis — the
    reduce_scatter dual, multi-RHS.  Runs inside shard_map."""
    data, cols = params
    Y_partial = _local_ell_spmm(data, cols, X_local)  # (n, p) partial
    return lax.psum_scatter(Y_partial, axis_name, scatter_dimension=0, tiled=True)


def halo_matmat(
    diag_data, diag_cols, left_data, left_cols, right_data, right_cols,
    X_local, *, axis_name: str = ROWS, bn: int,
):
    """Multi-RHS twin of :func:`halo_matvec`: two ppermute ring shifts
    move whole X row-shard PANELS; the diagonal-part SpMM needs no remote
    data and overlaps the transfers (same schedule argument as the
    matvec, tests/test_hlo_overlap.py).  Runs inside shard_map."""
    n_dev = lax.psum(1, axis_name)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    X_from_left = lax.ppermute(X_local, axis_name, right_perm)
    X_from_right = lax.ppermute(X_local, axis_name, left_perm)
    with jax.named_scope("halo_diag_spmm"):
        Y = _local_ell_spmm(diag_data, diag_cols, X_local)
    Y = Y + _local_ell_spmm(left_data, left_cols, X_from_left)
    Y = Y + _local_ell_spmm(right_data, right_cols, X_from_right)
    return Y


def _local_sym_matmat(diag, ud, uc, X, use_pallas):
    from ..sparse.sym_bsr import SymBSRMatrix

    n_local = diag.shape[0] * diag.shape[1]
    sym_local = SymBSRMatrix(diag, ud, uc, (n_local, n_local))
    if use_pallas:
        from ..ops.pallas_spmv import sym_bsr_matmat_pallas

        return sym_bsr_matmat_pallas(sym_local, X, interpret=use_pallas == "interpret")
    return sym_local._xla_matmat(X)


def sym_halo_matmat(
    diag, ud, uc, rd, rc, X_local, *, axis_name: str = ROWS, bn: int,
    use_pallas=False,
):
    """Multi-RHS twin of :func:`sym_halo_matvec`: forward X-panel halo +
    reverse halo of the BᴴX partial-Y panel — half-HBM-traffic symmetric
    storage on the mesh for the block-filter solvers (Chebyshev/KPM/
    LOBPCG feed).  Runs inside shard_map."""
    n_dev = lax.psum(1, axis_name)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    X_from_right = lax.ppermute(X_local, axis_name, left_perm)
    acc = _acc_dtype_of(diag.dtype)
    p = X_local.shape[1]

    with jax.named_scope("sym_halo_local_spmm"):
        Y = _local_sym_matmat(diag, ud, uc, X_local, use_pallas)

    # boundary: Y[r] += B X_next[c]
    Y = Y + _local_ell_spmm(rd, rc, X_from_right)

    # reverse contribution Y_next[c] += Bᴴ X[r]
    Xb = X_local.reshape(-1, bn, p)
    rdh = jnp.conj(rd) if jnp.issubdtype(rd.dtype, jnp.complexfloating) else rd
    contrib = jnp.einsum(
        "rkij,rip->rkjp", rdh, Xb.astype(acc), preferred_element_type=acc,
        precision=lax.Precision.HIGHEST,
    )  # (nbr_local, k, bn, p)
    nbc_next = X_from_right.shape[0] // bn
    YC = (
        jnp.zeros((nbc_next, bn, p), acc)
        .at[rc]
        .add(contrib.astype(acc))
        .reshape(-1, p)
    )
    Y = Y + lax.ppermute(YC, axis_name, right_perm)
    return Y


def split_bsr_grid(bsr: BSRMatrix, n_row_shards: int, n_col_shards: int):
    """Host-side split of a BSR matrix into an R×C grid of panels with
    *panel-local* block-column ids, stacked rows-major (panel (r, c) at
    index r·C + c) so ``P(("rows", "cols"))`` sharding hands each device
    of a 2-D mesh its own panel — the 2-D SpMV layout (SURVEY.md §7's
    "1D/2D device mesh").

    Returns (data (R·C·nbr_l, kmax_p, bm, bn), cols (R·C·nbr_l, kmax_p))
    where nbr_l = nbr / R."""
    nbr, nbc = bsr.n_block_rows, bsr.n_block_cols
    if nbr % n_row_shards or nbc % n_col_shards:
        raise EigenexError(
            f"grid split needs {n_row_shards} | {nbr} block rows and "
            f"{n_col_shards} | {nbc} block cols — pad_bsr_for_mesh first"
        )
    rows_per = nbr // n_row_shards
    cols_per = nbc // n_col_shards
    data = np.asarray(bsr.data)
    cols = np.asarray(bsr.block_cols)
    kmax = bsr.k_max
    bm, bn = bsr.block_shape

    buckets: dict[tuple, list] = {}
    kmax_p = 1
    for r in range(nbr):
        for k in range(kmax):
            blk = data[r, k]
            if not np.any(blk):
                continue
            c = int(cols[r, k])
            key = (r // rows_per, c // cols_per, r % rows_per)
            buckets.setdefault(key, []).append((c % cols_per, blk))
            kmax_p = max(kmax_p, len(buckets[key]))
    R, C = n_row_shards, n_col_shards
    out_d = np.zeros((R * C * rows_per, kmax_p, bm, bn), data.dtype)
    out_c = np.zeros((R * C * rows_per, kmax_p), np.int32)
    for (rg, cg, lr), bucket in buckets.items():
        base = (rg * C + cg) * rows_per + lr
        for slot, (lc, blk) in enumerate(bucket):
            out_d[base, slot] = blk
            out_c[base, slot] = lc
    return jnp.asarray(out_d), jnp.asarray(out_c)


def _local_grid2d_matvec(params, x_local, *, row_axis, col_axis, bn):
    """2-D-partitioned SpMV body (runs inside shard_map over BOTH axes).

    Device (r, c) holds operator panel (r, c) and an x shard laid out
    ``P((cols, rows))`` — gathering along the ROW axis therefore
    reconstitutes exactly the n/C column panel this device multiplies
    (natural global ordering throughout, no host-side permutation).  The
    partial n/R result reduces with ``psum_scatter`` along the COLUMN
    axis into a ``P((rows, cols))`` y shard.  Wire per device per
    matvec: n/C (gather) + n/R (reduce-scatter) — vs n for the 1-D
    all-gather — and the y→x re-layout between chained matvecs is a
    plain resharding XLA inserts automatically."""
    data, cols = params
    x_panel = lax.all_gather(x_local, row_axis, tiled=True)  # (n/C,)
    y_partial = _local_ell_spmv(data, cols, x_panel)  # (n/R,)
    return lax.psum_scatter(y_partial, col_axis, scatter_dimension=0, tiled=True)


def _local_grid2d_matmat(params, X_local, *, row_axis, col_axis, bn):
    """Multi-RHS twin of :func:`_local_grid2d_matvec`."""
    data, cols = params
    X_panel = lax.all_gather(X_local, row_axis, tiled=True)  # (n/C, p)
    Y_partial = _local_ell_spmm(data, cols, X_panel)  # (n/R, p)
    return lax.psum_scatter(Y_partial, col_axis, scatter_dimension=0, tiled=True)


_GRID2D_CACHE: dict = {}


def _get_grid2d_apply(mesh, row_axis, col_axis, bn, matmat: bool):
    key = (mesh, row_axis, col_axis, bn, matmat)
    fn = _GRID2D_CACHE.get(key)
    if fn is not None:
        return fn
    body = _local_grid2d_matmat if matmat else _local_grid2d_matvec
    tail = (None,) if matmat else ()
    x_spec = P((col_axis, row_axis), *tail)
    y_spec = P((row_axis, col_axis), *tail)
    sharded = shard_map(
        partial(body, row_axis=row_axis, col_axis=col_axis, bn=bn),
        mesh=mesh,
        in_specs=((P((row_axis, col_axis)), P((row_axis, col_axis))), x_spec),
        out_specs=y_spec,
    )
    fn = jax.jit(sharded)
    _GRID2D_CACHE[key] = fn
    return fn


def mesh_operator_2d(
    A: BSRMatrix,
    mesh: Mesh,
    *,
    row_axis: str | None = None,
    col_axis: str | None = None,
) -> LinearOperator:
    """Global-array operator over a 2-D device mesh: the operator splits
    into an R×C panel grid, x shards over (cols, rows), y over
    (rows, cols), and each matvec/matmat costs n/C + n/R wire per device
    instead of the 1-D all-gather's n — the general-sparsity scaling
    layout for pods (SURVEY.md §7).  Chained applications reshard y→x
    automatically (one small device-permute XLA inserts)."""
    if len(mesh.axis_names) < 2:
        raise EigenexError("mesh_operator_2d needs a 2-axis mesh")
    row_axis = row_axis or mesh.axis_names[0]
    col_axis = col_axis or mesh.axis_names[1]
    R, C = mesh.shape[row_axis], mesh.shape[col_axis]
    if A.shape[0] != A.shape[1]:
        raise EigenexError("mesh_operator_2d requires a square operator")
    data, cols = split_bsr_grid(A, R, C)
    bn = A.block_shape[1]
    mv = partial(
        _call_mesh_fn, _get_grid2d_apply(mesh, row_axis, col_axis, bn, False)
    )
    mm = partial(
        _call_mesh_fn, _get_grid2d_apply(mesh, row_axis, col_axis, bn, True)
    )
    return LinearOperator(
        mv, ((data, cols),), A.shape, _acc_dtype_of(A.dtype), matmat_fn=mm
    )


_MESH_OP_CACHE: dict = {}


def _get_mesh_apply(
    mesh, axis_name, mode, bn, use_pallas, n_op_args, matmat: bool
):
    key = (mesh, axis_name, mode, bn, use_pallas, matmat)
    fn = _MESH_OP_CACHE.get(key)
    if fn is not None:
        return fn

    def body(*args):
        op_arrays, x_local = args[:-1], args[-1]
        if mode == "allgather":
            f = _local_allgather_matmat if matmat else _local_allgather_matvec
            return f(op_arrays, x_local, axis_name=axis_name, bn=bn)
        if mode == "colsplit":
            f = _local_colsplit_matmat if matmat else _local_colsplit_matvec
            return f(op_arrays, x_local, axis_name=axis_name, bn=bn)
        if mode == "halo":
            f = halo_matmat if matmat else halo_matvec
            return f(*op_arrays, x_local, axis_name=axis_name, bn=bn)
        f = sym_halo_matmat if matmat else sym_halo_matvec
        return f(*op_arrays, x_local, axis_name=axis_name, bn=bn, use_pallas=use_pallas)

    x_spec = P(axis_name, None) if matmat else P(axis_name)
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name),) * n_op_args + (x_spec,),
        out_specs=x_spec,
        check_vma=not use_pallas,
    )
    fn = jax.jit(sharded)
    _MESH_OP_CACHE[key] = fn
    return fn


def _call_mesh_fn(fn, op_arrays, x):
    # fn is bound via functools.partial so it rides in the operator's
    # STATIC aux (params stay a pure array pytree — jit-safe)
    return fn(*op_arrays, x)


def _split_for_mode(bsr, matvec_mode, nd):
    """(op_arrays, bn) — the host-side split shared by the chunk runners
    and :func:`mesh_operator`."""
    from ..sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr

    if matvec_mode == "halo":
        d, l, r = split_bsr_halo(bsr, nd)
        return (d[0], d[1], l[0], l[1], r[0], r[1]), bsr.block_shape[1]
    if matvec_mode == "sym_halo":
        sym = bsr if isinstance(bsr, SymBSRMatrix) else sym_bsr_from_bsr(bsr)
        dg, inp, rt = split_sym_bsr_halo(sym, nd)
        return (dg, inp[0], inp[1], rt[0], rt[1]), sym.block_shape[1]
    if matvec_mode == "colsplit":
        pd, pc = split_bsr_colpanels(bsr, nd)
        return (pd, pc), bsr.block_shape[1]
    return (bsr.data, bsr.block_cols), bsr.block_shape[1]


def mesh_operator(
    A,
    mesh: Mesh | None = None,
    *,
    axis_name: str = ROWS,
    matvec_mode: str = "allgather",
    use_pallas: bool | str = False,
) -> LinearOperator:
    """A global-array :class:`LinearOperator` whose ``matvec`` AND
    ``matmat`` run shard_map'd over ``mesh`` (row-partitioned operator,
    row-sharded vectors/panels) — the operand that makes every
    matvec/matmat-driven solver in the library mesh-parallel without
    code changes: Chebyshev window filtering, KPM moments, subspace
    iteration, user code.

    ``A``: a :class:`BSRMatrix` (any mode) or :class:`SymBSRMatrix`
    (``matvec_mode='sym_halo'``) whose block rows divide the mesh — use
    :func:`pad_bsr_for_mesh` first (and a padding-supported start block;
    the mesh-aware front ends in :mod:`eigenex_tpu.solvers.chebyshev` /
    ``kpm`` handle both automatically)."""
    from ..sparse.sym_bsr import SymBSRMatrix

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    nd = mesh.shape[axis_name]
    if matvec_mode not in ("allgather", "colsplit", "halo", "sym_halo"):
        raise EigenexError(f"unknown matvec_mode {matvec_mode!r}")
    if isinstance(A, SymBSRMatrix) and matvec_mode != "sym_halo":
        raise EigenexError("a SymBSRMatrix operand requires matvec_mode='sym_halo'")
    if A.n_block_rows % nd:
        raise EigenexError(
            f"{A.n_block_rows} block rows not divisible by {nd} shards — "
            "use pad_bsr_for_mesh first"
        )
    op_arrays, bn = _split_for_mode(A, matvec_mode, nd)
    n_op_args = len(op_arrays)
    mv = partial(
        _call_mesh_fn,
        _get_mesh_apply(mesh, axis_name, matvec_mode, bn, use_pallas, n_op_args, False),
    )
    mm = partial(
        _call_mesh_fn,
        _get_mesh_apply(mesh, axis_name, matvec_mode, bn, use_pallas, n_op_args, True),
    )
    dtype = _acc_dtype_of(A.dtype)
    return LinearOperator(
        mv,
        op_arrays,
        A.shape,
        dtype,
        rmatvec_fn=mv if isinstance(A, SymBSRMatrix) else None,
        matmat_fn=mm,
    )


class DistributedKrylovSchurArnoldiSolver(_DistributedBSRSolverMixin, KrylovSchurArnoldiSolver):
    """Krylov-Schur restarted Arnoldi with the iteration chunk
    row-partitioned over a device mesh — the general-operator counterpart
    of :class:`DistributedThickRestartLanczosEigenSolver`."""

    def __init__(
        self,
        bsr: BSRMatrix,
        mesh: Mesh | None = None,
        options=None,
        axis_name: str = ROWS,
        matvec_mode: str = "allgather",
        use_pallas: bool | str = False,
    ):
        mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)


# ---------------------------------------------------------------------------
# Distributed LOBPCG (row-partitioned block iteration)
# ---------------------------------------------------------------------------
def _local_ell_spmm(data, cols, X):
    """Shard-local BSR-ELL SpMM (multi-RHS): gather + batched einsum —
    the matmat twin of :func:`_local_ell_spmv`."""
    bn = data.shape[3]
    Xb = X.reshape(-1, bn, X.shape[1])[cols]  # (nbr, k, bn, p)
    acc = _acc_dtype_of(data.dtype)
    Y = jnp.einsum(
        "rkij,rkjb->rib", data, Xb.astype(acc), preferred_element_type=acc,
        precision=lax.Precision.HIGHEST,
    )
    return Y.reshape(-1, X.shape[1]).astype(acc)


class DistributedLOBPCGSolver(LOBPCGSolver):
    """LOBPCG with the operator row-partitioned over a device mesh via
    :func:`mesh_operator`: every heavy op — the A·S / B·S SpMMs (any
    matvec_mode, including the half-traffic ``sym_halo``) and the tall
    Grams (XLA sharding propagation turns Sᴴ·AS into local partials +
    all-reduce) — runs mesh-parallel; only the 3b×3b projected pencil
    solve visits the host, as in the single-device driver.

    Round-3 lift of the round-2 restrictions: GENERALIZED pencils
    ``A x = λ B x`` (pass ``b_operator`` as a block-sparse container —
    B-inner products are the same psum'd Grams) and ARBITRARY
    preconditioners — a block-sparse container (meshified automatically),
    a LinearOperator, or any callable acting on the global (padded)
    residual block; a row-local action keeps it communication-free but
    is no longer required for correctness.
    """

    def __init__(
        self,
        bsr: BSRMatrix,
        mesh: Mesh | None = None,
        options=None,
        *,
        block_size: int = 4,
        axis_name: str = ROWS,
        preconditioner=None,
        b_operator=None,
        matvec_mode: str = "allgather",
        use_pallas: bool | str = False,
    ):
        from ..sparse.sym_bsr import SymBSRMatrix
        from ..utils.prng import random_matrix

        mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        nd = mesh.shape[axis_name]
        orig_n = bsr.shape[0]
        if isinstance(bsr, SymBSRMatrix):
            matvec_mode = "sym_halo"
        bsr = pad_bsr_for_mesh(bsr, nd)
        opA = mesh_operator(
            bsr, mesh, axis_name=axis_name, matvec_mode=matvec_mode,
            use_pallas=use_pallas,
        )

        def meshify(C, what):
            if not isinstance(C, (BSRMatrix, SymBSRMatrix)):
                return C  # LinearOperator / callable: applied globally
            if C.shape[0] != orig_n:
                raise EigenexError(
                    f"{what} shape {C.shape} does not match A ({orig_n})"
                )
            mode = "sym_halo" if isinstance(C, SymBSRMatrix) else "allgather"
            return mesh_operator(
                pad_bsr_for_mesh(C, nd), mesh, axis_name=axis_name,
                matvec_mode=mode, use_pallas=use_pallas,
            )

        opB = meshify(b_operator, "b_operator") if b_operator is not None else None
        precond = meshify(preconditioner, "preconditioner") if preconditioner is not None else None
        super().__init__(
            opA,
            options,
            block_size=block_size,
            b_operator=opB,
            preconditioner=precond,
        )
        self.bsr = bsr
        self.mesh = mesh
        self.axis_name = axis_name
        self._dist_orig_n = orig_n
        if bsr.shape[0] != orig_n:
            # padding-safe start block: zero rows beyond the true n keep
            # every iterate exactly zero in the padding coordinates
            seed = (options.seed if options is not None else 0)
            X0 = random_matrix(
                jax.random.PRNGKey(seed), block_size, orig_n, opA.dtype
            ).T
            self._initial_block = jnp.zeros(
                (bsr.shape[0], block_size), opA.dtype
            ).at[:orig_n].set(X0)

    def compute(self, operator=None):
        res = super().compute(operator)
        res = super().compute(operator)
        n = self._dist_orig_n
        if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
            res.eigenvectors = res.eigenvectors[:n]
        return res
