"""Scalar-sparse acceleration: band-reducing reorder + dense-block packing.

The reference's only sparse operator is the scalar COO scatter
(triplets_matrix.hpp:314-318); its translation here (gather +
``segment_sum``) is dtype-general.  This module is the bridge from "born
scalar" to the dense-block containers and the symmetric block kernel
(:mod:`eigenex_tpu.ops.pallas_spmv`).  Whether the pack still pays on a
GPU, where scalar gathers are cheap, is an open measurement (ROADMAP).

1. **Reorder** — a reverse Cuthill-McKee permutation over the
   (symmetrized) pattern concentrates entries near the diagonal
   (Heisenberg L=20: bandwidth 48,620 → 5,573 = 0.03·n).
2. **Pack** — the permuted triplets densify into 128x128 (symmetric:
   diagonal + strictly-upper) or 32x128 (general) BSR-ELL blocks.  Block
   fill is low (~0.4-1%), so effective throughput is the block-streaming
   rate times fill.  bf16 storage is auto-selected only when *lossless*
   (every value round-trips bf16 exactly — dyadic couplings do), and
   every product accumulates the f32 x vector in f32, so bf16 storage
   never degrades Krylov convergence.
3. **Solve in permuted space** — the permutation is applied once to the
   operator on host; solvers run entirely in permuted coordinates
   (no per-matvec gather), and eigenvectors are unpermuted at the end
   (:meth:`AcceleratedOperator.restore`).

Padding rows/cols (to the block multiple) are structurally zero: with a
zero-padded start vector the Krylov space never leaves the embedded
subspace, so no spurious eigenvalues enter the computed spectrum
(:meth:`AcceleratedOperator.embed` builds such vectors).

Complex operators ride the same pipeline through the real embedding
[[A,−B],[B,A]] (:mod:`eigenex_tpu.sparse.realify`): for Hermitian H the
embedding is real-symmetric, so complex Hermitian operators reach the
half-traffic symmetric kernel — the at-scale path for the reference's
flagship complex sample (sample_lanczos2.cpp:13-57).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.exceptions import EigenexError
from ..core.operators import LinearOperator
from .coo import COOMatrix
from .bsr import BSRMatrix, bsr_from_coo_arrays
from .sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from .realify import realify_coo

__all__ = ["AcceleratedOperator", "accelerate", "band_permutation"]


def _as_host_triplets(A) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """(rows, cols, vals, shape) host arrays from any accepted operand."""
    if isinstance(A, COOMatrix):
        return (
            np.asarray(A.row, np.int64),
            np.asarray(A.col, np.int64),
            np.asarray(A.val),
            A.shape,
        )
    if hasattr(A, "tocoo"):  # scipy sparse
        coo = A.tocoo()
        return (
            coo.row.astype(np.int64),
            coo.col.astype(np.int64),
            coo.data,
            coo.shape,
        )
    if isinstance(A, tuple) and len(A) == 4:
        r, c, v, shape = A
        return (
            np.asarray(r, np.int64),
            np.asarray(c, np.int64),
            np.asarray(v),
            (int(shape[0]), int(shape[1])),
        )
    raise EigenexError(
        "accelerate() expects a COOMatrix, a scipy sparse matrix, or a "
        "(rows, cols, vals, shape) tuple"
    )


def _merged(r, c, v, shape):
    """Row-major sorted, duplicate-merged triplets (full canonical
    form)."""
    key = r * np.int64(shape[1]) + c
    order = np.argsort(key, kind="stable")
    key, v = key[order], v[order]
    uniq, start = np.unique(key, return_index=True)
    if len(uniq) != len(key):
        sums = np.add.reduceat(v, start)
        key, v = uniq, sums
    return key // shape[1], key % shape[1], v


def _canonicalize(r, c, v, shape):
    """Duplicate-free triplets, NOT necessarily sorted.

    Merging duplicates requires an O(nnz log nnz) sort with O(nnz)
    gathers — at 35M nnz that single stage cost more than the rest of
    the pack combined (round-5 profile).  But duplicates are rare in
    practice (builders emit canonical triplets), and every downstream
    stage now handles unsorted input (the packers run their own cheap
    block-level sort; the RCM adjacency builds by native histogram
    scatter; the Hermiticity probe gathers only the sampled rows).  So:
    detect duplicates with a payload-free ``np.sort`` of the flat keys
    (~2 s at 35M — numpy's integer radix) and pay for the full merge
    only when they exist."""
    key = np.sort(r * np.int64(shape[1]) + c)
    if len(key) > 1 and bool(np.any(key[1:] == key[:-1])):
        return _merged(r, c, v, shape)
    return r, c, v


def _is_hermitian(r, c, v, shape) -> bool:
    """Exact A == Aᴴ on duplicate-free triplets (any order)."""
    if shape[0] != shape[1]:
        return False
    key = r * np.int64(shape[1]) + c
    tkey = c * np.int64(shape[1]) + r
    korder = np.argsort(key, kind="stable")
    torder = np.argsort(tkey, kind="stable")
    if not np.array_equal(key[korder], tkey[torder]):
        return False
    return np.array_equal(v[korder], np.conj(v[torder]))


def _sampled_hermitian_check(r, c, v, shape, *, sample: int = 2048, seed: int = 0):
    """Cheap sanity check behind ``symmetric=True``: O(nnz) vectorized
    pattern counts + a sampled mirror-value probe, instead of the full
    O(nnz log nnz) transpose comparison the flag exists to skip.  Works
    on UNSORTED duplicate-free triplets: the probe gathers only the
    entries living on the sampled mirror ROWS (one boolean pass) and
    sorts that small subset.

    Raises :class:`EigenexError` on any detected asymmetry.  This cannot
    PROVE Hermiticity (only the full check can), but it catches the
    realistic misuses — a general operator passed by mistake, a
    triangle-only store, sign errors — rather than silently symmetrizing
    them into a wrong answer."""
    n_lo = int(np.count_nonzero(c < r))
    n_up = int(np.count_nonzero(c > r))
    if n_lo != n_up:
        raise EigenexError(
            f"symmetric=True, but the pattern has {n_lo} strictly-lower vs "
            f"{n_up} strictly-upper entries — the operator is not Hermitian "
            "(a triangle-only store must be expanded first)"
        )
    off = np.nonzero(r != c)[0]
    if off.size == 0:
        return
    rng = np.random.default_rng(seed)
    pick = off if off.size <= sample else rng.choice(off, size=sample, replace=False)
    # entries on the sampled MIRROR rows only — small subset, own sort
    is_mrow = np.zeros(shape[0], bool)
    is_mrow[c[pick]] = True
    sel = np.nonzero(is_mrow[r])[0]
    skey = r[sel] * np.int64(shape[1]) + c[sel]
    so = np.argsort(skey, kind="stable")
    skey, sval = skey[so], v[sel][so]
    tkey = c[pick] * np.int64(shape[1]) + r[pick]
    pos = np.searchsorted(skey, tkey)
    pos = np.minimum(pos, max(len(skey) - 1, 0))
    found = skey[pos] == tkey if len(skey) else np.zeros(len(tkey), bool)
    if not np.all(found):
        i = int(pick[np.nonzero(~found)[0][0]])
        raise EigenexError(
            f"symmetric=True, but entry ({int(r[i])}, {int(c[i])}) has no "
            "mirror entry — the operator is not Hermitian"
        )
    if not np.array_equal(sval[pos], np.conj(v[pick])):
        bad = int(pick[np.nonzero(sval[pos] != np.conj(v[pick]))[0][0]])
        raise EigenexError(
            f"symmetric=True, but entry ({int(r[bad])}, {int(c[bad])}) does "
            "not equal the conjugate of its mirror — the operator is not "
            "Hermitian"
        )


def band_permutation(rows, cols, n: int, *, assume_symmetric: bool = False) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the SYMMETRIZED pattern of the
    triplets — perm[i] = original index at new position i, so
    ``A[perm][:, perm]`` is banded (scipy's convention).

    Native C++ BFS (``rcm_permutation`` in native/src/builders.cpp) when
    the toolchain is available, scipy's ``reverse_cuthill_mckee``
    otherwise — the two orderings differ only in tie-breaks; tests assert
    comparable bandwidth.

    ``assume_symmetric``: the triplet pattern is already symmetric, so
    the CSR adjacency builds directly from the triplets (any order) with
    one native histogram+scatter pass — no scipy transpose/add pass and
    no sort (those were most of the round-4 pack wall time at 35M
    nnz)."""
    from .. import native

    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if assume_symmetric and native.native_available() and len(rows):
        rowptr, colidx = native.build_csr(rows, cols, n)
        return native.rcm_permutation(rowptr, colidx)

    import scipy.sparse as sp

    pattern = sp.csr_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)
    )
    pattern = pattern + pattern.T  # symmetrize for the general case

    if native.native_available():
        return native.rcm_permutation(
            pattern.indptr.astype(np.int64), pattern.indices.astype(np.int64)
        )
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return reverse_cuthill_mckee(pattern, symmetric_mode=True).astype(np.int64)


def bipartite_band_permutation(rows, cols, m: int, n: int):
    """(row_perm, col_perm) banding a RECTANGULAR pattern: RCM runs on
    the bipartite augmented graph [[0, A], [Aᵀ, 0]] (row node i, col
    node m+j per entry (i, j)); the mixed ordering is split back into
    its row and column subsequences.  Connected rows/cols land at nearby
    band positions, so ``A[row_perm][:, col_perm]`` is banded — the
    standard augmented-matrix RCM of sparse direct solvers, O(nnz)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    import scipy.sparse as sp

    br = np.concatenate([rows, cols + m])
    bc = np.concatenate([cols + m, rows])
    pattern = sp.csr_matrix(
        (np.ones(len(br), np.int8), (br, bc)), shape=(m + n, m + n)
    )
    from .. import native

    if native.native_available():
        perm_all = native.rcm_permutation(
            pattern.indptr.astype(np.int64), pattern.indices.astype(np.int64)
        )
    else:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm_all = reverse_cuthill_mckee(pattern, symmetric_mode=True).astype(np.int64)
    row_perm = perm_all[perm_all < m]
    col_perm = perm_all[perm_all >= m] - m
    return row_perm, col_perm


def _bf16_lossless(values: np.ndarray) -> bool:
    """True iff every value round-trips bfloat16 exactly (then bf16
    storage halves SpMV traffic at ZERO accuracy cost — e.g. the dyadic
    ±J/2, ±Jz/4 couplings of spin Hamiltonians)."""
    import ml_dtypes

    v32 = values.astype(np.float32)
    return bool(np.array_equal(v32.astype(ml_dtypes.bfloat16).astype(np.float32), v32))


def _host_cast(a: np.ndarray, dtype):
    """Cast packed block data ON HOST before the device put — uploading
    f32 and casting on device would transiently hold BOTH copies in HBM
    (measured: the 8.4 GiB bf16 L=24 Heisenberg operator OOMed a 16 GB
    chip because its 16.7 GiB f32 precursor was device-resident)."""
    import ml_dtypes

    np_dtype = np.dtype(jnp.dtype(dtype).name) if jnp.dtype(dtype) != jnp.bfloat16 else ml_dtypes.bfloat16
    return jnp.asarray(np.asarray(a).astype(np_dtype))


def _pack_symmetric(r, c, v, n_pad, block, use_native, dtype, stage=None):
    """(SymBSRMatrix, skipped) — ``skipped`` is the count of strictly-
    lower-BLOCK triplets the pack dropped (mirrors reconstruct them);
    the caller cross-checks it against the pattern (native path only;
    the numpy fallback path packs both triangles and drops none)."""
    stage = stage or (lambda name, t: time.time())
    nbr = n_pad // block
    ts = time.time()
    if use_native:
        from .. import native

        order, _kmax, ku, reach = native.blk_widths(r, c, block, block, nbr)
        ts = stage("blk_sort", ts)
        if jnp.dtype(dtype) == jnp.bfloat16:
            # direct-bf16 threaded pack: no f32 staging buffer, no host
            # ml_dtypes astype (which measured ~19M el/s and dominated
            # the round-4 pack)
            diag, upper, ucols, skipped = native.sym_bsr_pack_bf16(
                r, c, v.astype(np.float64), order, nbr, block, ku
            )
            ts = stage("pack_scatter", ts)
            mat = SymBSRMatrix(
                jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(ucols),
                (n_pad, n_pad), int(reach),
            )
            stage("device_put", ts)
            return mat, skipped
        diag, upper, ucols, skipped = native.sym_bsr_pack_f32(
            r, c, v.astype(np.float64), order, nbr, block, ku
        )
        ts = stage("pack_scatter", ts)
        mat = SymBSRMatrix(
            _host_cast(diag, dtype), _host_cast(upper, dtype), jnp.asarray(ucols),
            (n_pad, n_pad), int(reach),
        )
        stage("device_put", ts)
        return mat, skipped
    bsr = bsr_from_coo_arrays(r, c, v.astype(np.float32), (n_pad, n_pad), (block, block))
    sym = sym_bsr_from_bsr(bsr)
    stage("pack_scatter", ts)
    return (sym.astype(dtype) if sym.dtype != jnp.dtype(dtype) else sym), None


def _pack_general(r, c, v, m_pad, n_pad, bm, bn, use_native, dtype, stage=None):
    stage = stage or (lambda name, t: time.time())
    nbr, nbc = m_pad // bm, n_pad // bn
    ts = time.time()
    if use_native:
        from .. import native

        order, kmax, _ku, _reach = native.blk_widths(r, c, bm, bn, nbc)
        ts = stage("blk_sort", ts)
        if jnp.dtype(dtype) == jnp.bfloat16:
            data, bcols = native.bsr_pack_bf16(
                r, c, v.astype(np.float64), order, nbr, nbc, bm, bn, kmax
            )
            ts = stage("pack_scatter", ts)
            mat = BSRMatrix(jnp.asarray(data), jnp.asarray(bcols), (m_pad, n_pad))
            stage("device_put", ts)
            return mat
        data, bcols = native.bsr_pack_f32(
            r, c, v.astype(np.float64), order, nbr, nbc, bm, bn, kmax
        )
        ts = stage("pack_scatter", ts)
        mat = BSRMatrix(_host_cast(data, dtype), jnp.asarray(bcols), (m_pad, n_pad))
        stage("device_put", ts)
        return mat
    bsr = bsr_from_coo_arrays(r, c, v.astype(np.float32), (m_pad, n_pad), (bm, bn))
    stage("pack_scatter", ts)
    return bsr.astype(dtype) if bsr.dtype != jnp.dtype(dtype) else bsr


@dataclasses.dataclass(frozen=True)
class AcceleratedOperator:
    """A scalar-sparse operator repacked into dense-block storage.

    Lives in PERMUTED + PADDED coordinates: ``matrix`` is
    ``P·A·Pᵀ`` (zero-padded to the block multiple), where P is the
    band-reducing permutation.  Solvers run here; :meth:`embed` carries
    original-space vectors in and :meth:`restore` carries results back
    (one host-side permutation each — never a per-matvec gather)."""

    matrix: Any  # SymBSRMatrix | BSRMatrix, permuted + padded
    perm: np.ndarray  # (n_work,) original COLUMN index at permuted position i
    orig_shape: tuple[int, int]  # user-facing shape (pre-embedding)
    symmetric: bool
    complexified: bool  # True: ``matrix`` is the real embedding (dim 2n)
    stats: dict
    #: rectangular operators carry a separate ROW permutation (bipartite
    #: RCM); None for square operators, where ``perm`` applies to both
    #: sides (P·A·Pᵀ)
    row_perm: np.ndarray | None = None
    #: PERMUTED host triplets, retained for GENERAL packs only — lets
    #: :meth:`adjoint_matrix` pack Aᴴ with its own lane-native (bm, 128)
    #: blocks instead of transposing into (128, bm) blocks whose 32-wide
    #: columns gather poorly (measured: the Gram pipeline's Aᴴ side).
    #: Not serialized by :meth:`save` (load falls back to block
    #: transpose).
    host_triplets: Any = None

    @property
    def shape(self) -> tuple[int, int]:
        """Padded working shape (what the solvers see)."""
        return self.matrix.shape

    @property
    def n_work(self) -> int:
        """Unpadded working COLUMN dimension (2n for complexified)."""
        return len(self.perm)

    @property
    def m_work(self) -> int:
        """Unpadded working ROW dimension (= :attr:`n_work` for square)."""
        return len(self.row_perm) if self.row_perm is not None else len(self.perm)

    def as_linear_operator(self) -> LinearOperator:
        return self.matrix.as_linear_operator()

    def embed(self, v) -> jax.Array:
        """Original COLUMN-space (n,) or (n, k) vector(s) → permuted,
        zero-padded device array over the operator's input side.  Complex
        inputs realify to [Re v; Im v] first when the operator was
        complexified."""
        v = np.asarray(v)
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        if v.shape[0] != self.orig_shape[1]:
            raise EigenexError(
                f"embed expects length {self.orig_shape[1]}, got {v.shape[0]}"
            )
        if self.complexified:
            v = np.concatenate([v.real, v.imag], axis=0)
        elif np.iscomplexobj(v):
            raise EigenexError("complex vector for a real operator")
        out = np.zeros((self.shape[1], v.shape[1]), self._embed_dtype)
        out[: self.n_work] = v[self.perm]
        if squeeze:
            out = out[:, 0]
        return jnp.asarray(out)

    @property
    def _embed_dtype(self):
        """Host dtype for embedded vectors: the container's ACCUMULATION
        dtype (f64 containers must not truncate inputs to f32)."""
        return np.float64 if jnp.dtype(self.matrix.dtype) == jnp.float64 else np.float32

    def restore(self, V) -> np.ndarray:
        """Permuted-padded ROW-space (m_pad,) or (m_pad, k) result(s) →
        original row space (host array; complex when the operator was
        complexified).  For square operators rows and columns share one
        permutation, so this inverts :meth:`embed`."""
        V = np.asarray(V)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        if V.shape[0] != self.shape[0]:
            raise EigenexError(
                f"restore expects length {self.shape[0]}, got {V.shape[0]}"
            )
        rp = self.row_perm if self.row_perm is not None else self.perm
        out = np.zeros((len(rp), V.shape[1]), V.dtype)
        out[rp] = V[: len(rp)]
        if self.complexified:
            n = self.orig_shape[0]
            out = out[:n] + 1j * out[n:]
        if squeeze:
            out = out[:, 0]
        return out

    def embed_left(self, v) -> jax.Array:
        """Original ROW-space vector(s) → permuted, zero-padded array
        over the operator's OUTPUT side — the input side of Aᴴ in the
        svds Gram pipeline (rectangular analog of :meth:`embed`)."""
        v = np.asarray(v)
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        if v.shape[0] != self.orig_shape[0]:
            raise EigenexError(
                f"embed_left expects length {self.orig_shape[0]}, got {v.shape[0]}"
            )
        if np.iscomplexobj(v):
            raise EigenexError("complex vector for a real operator")
        rp = self.row_perm if self.row_perm is not None else self.perm
        out = np.zeros((self.shape[0], v.shape[1]), self._embed_dtype)
        out[: len(rp)] = v[rp]
        if squeeze:
            out = out[:, 0]
        return jnp.asarray(out)

    def restore_right(self, V) -> np.ndarray:
        """Permuted-padded COLUMN-space result(s) → original column
        space — right singular vectors in the svds pipeline (rectangular
        analog of :meth:`restore`)."""
        V = np.asarray(V)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        if V.shape[0] != self.shape[1]:
            raise EigenexError(
                f"restore_right expects length {self.shape[1]}, got {V.shape[0]}"
            )
        out = np.zeros((self.n_work, V.shape[1]), V.dtype)
        out[self.perm] = V[: self.n_work]
        if squeeze:
            out = out[:, 0]
        return out

    def adjoint_matrix(self):
        """Aᴴ of the packed container with ITS OWN lane-native block
        layout — the svds Gram pipeline's second matvec.

        ``BSRMatrix.adjoint()`` transposes blocks in place, turning an
        (bm, 128) pack into (128, bm): its bm-wide columns gather at a
        fraction of lane speed (round-5 sweep).  When the permuted host
        triplets were retained (general packs), Aᴴ is instead PACKED
        from the swapped triplets at the same (bm, 128) shape; the
        result is cached.  Falls back to the block transpose otherwise
        (symmetric containers are self-adjoint and never call this)."""
        cached = getattr(self, "_adjoint_cache", None)
        if cached is not None:
            return cached
        if isinstance(self.matrix, SymBSRMatrix):
            return self.matrix
        if self.host_triplets is None:
            adj = self.matrix.adjoint()
        else:
            r, c, v = self.host_triplets
            bm, bn = self.matrix.block_shape
            m_pad, n_pad = self.matrix.shape
            from .. import native

            use_native = native.native_available() and np.isrealobj(v)
            vv = np.conj(v) if np.iscomplexobj(v) else v
            # swapped triplets: rows of Aᴴ are columns of A — pad sizes
            # swap with them, block shape stays lane-native
            adj = _pack_general(
                c, r, vv, n_pad, m_pad, bm, bn, use_native,
                self.matrix.dtype,
            )
        object.__setattr__(self, "_adjoint_cache", adj)
        return adj

    # -- persistence ------------------------------------------------------
    def save(self, path) -> None:
        """Persist the packed operator (blocks, permutation, metadata) as
        a ``.npz`` — the pack (RCM + block fill, minutes at 10^7-nnz
        scale) is the dominant cost of the pipeline and is fully
        deterministic, so production runs pack once and reload.
        bfloat16 block data is stored as a uint16 view (npz has no bf16)."""
        import json as _json

        def host(a):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                return a.view(np.uint16)
            return a

        meta = dict(
            orig_shape=list(self.orig_shape),
            symmetric=self.symmetric,
            complexified=self.complexified,
            stats=self.stats,
            kind="sym" if isinstance(self.matrix, SymBSRMatrix) else "gen",
            dtype=str(jnp.dtype(self.matrix.dtype)),
            shape=list(self.matrix.shape),
            band_reach=getattr(self.matrix, "band_reach", -1),
        )
        arrays = dict(perm=self.perm, meta=np.frombuffer(
            _json.dumps(meta).encode(), dtype=np.uint8
        ))
        if self.row_perm is not None:
            arrays["row_perm"] = self.row_perm
        if isinstance(self.matrix, SymBSRMatrix):
            arrays.update(
                diag=host(self.matrix.diag_data),
                upper=host(self.matrix.upper_data),
                ucols=np.asarray(self.matrix.upper_cols),
            )
        else:
            arrays.update(
                data=host(self.matrix.data),
                bcols=np.asarray(self.matrix.block_cols),
            )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path) -> "AcceleratedOperator":
        """Reload a :meth:`save`'d operator (device arrays restored at
        the stored dtype)."""
        import json as _json

        with np.load(path) as z:
            meta = _json.loads(bytes(z["meta"]).decode())
            target = jnp.dtype(meta["dtype"])

            def dev(a):
                if str(target) == "bfloat16" and a.dtype == np.uint16:
                    import ml_dtypes

                    return jnp.asarray(a.view(ml_dtypes.bfloat16))
                return jnp.asarray(a)

            shape = tuple(meta["shape"])
            if meta["kind"] == "sym":
                mat = SymBSRMatrix(
                    dev(z["diag"]), dev(z["upper"]), jnp.asarray(z["ucols"]),
                    shape, int(meta["band_reach"]),
                )
            else:
                mat = BSRMatrix(dev(z["data"]), jnp.asarray(z["bcols"]), shape)
            return cls(
                matrix=mat,
                perm=np.asarray(z["perm"]),
                orig_shape=tuple(meta["orig_shape"]),
                symmetric=bool(meta["symmetric"]),
                complexified=bool(meta["complexified"]),
                stats=meta["stats"],
                row_perm=np.asarray(z["row_perm"]) if "row_perm" in z else None,
            )


def dedup_embedded_pairs(lam, vecs, keep_max: int | None = None):
    """Indices to KEEP from a RESTORED doubled-spectrum result.

    Eigenvalues of a complexified (real-embedded) Hermitian operator
    appear up to twice; a clean Krylov space may hold only ONE vector
    per 2-D embedded eigenspace, so dedup goes by value-closeness AND
    vector overlap, never by blind pairing.  ``vecs`` are the restored
    complex eigenvectors (columns, any normalization); eigenvalues are
    assumed sorted the way the caller wants them kept."""
    lam = np.asarray(lam)
    spread = float(np.abs(lam).max()) if lam.size else 1.0
    close = max(spread, 1.0) * 1e-3
    unit = None
    if vecs is not None:
        norms = np.linalg.norm(vecs, axis=0)
        unit = vecs / np.maximum(norms, 1e-300)
    keep: list[int] = []
    for i in range(len(lam)):
        dup = False
        for j in keep:
            if abs(lam[i] - lam[j]) > close:
                continue
            if unit is None or abs(np.vdot(unit[:, j], unit[:, i])) > 0.9:
                dup = True
                break
        if not dup:
            keep.append(i)
        if keep_max is not None and len(keep) >= keep_max:
            break
    return keep


def _accelerate_rectangular(
    r, c, v, shape, *, dtype, general_block, reorder, merge_duplicates,
    t0, stages, stage,
):
    """Rectangular pack: bipartite RCM (two-sided permutation) + general
    BSR-ELL with independent row/col padding — the at-scale path for the
    svds Gram pipeline (reference class: tensor_svd.hpp:172 at the
    BASELINE config-4 scale), where both Gram matvecs otherwise ride the
    scalar COO path."""
    m, n = shape
    ts = time.time()
    if merge_duplicates:
        r, c, v = _canonicalize(r, c, v, shape)
    ts = stage("merge", ts)
    if reorder and len(r):
        row_perm, col_perm = bipartite_band_permutation(r, c, m, n)
        ts = stage("rcm", ts)
        ipr = np.empty(m, np.int64)
        ipr[row_perm] = np.arange(m)
        ipc = np.empty(n, np.int64)
        ipc[col_perm] = np.arange(n)
        r, c = ipr[r], ipc[c]
        ts = stage("permute", ts)
    else:
        row_perm = np.arange(m, dtype=np.int64)
        col_perm = np.arange(n, dtype=np.int64)

    from .. import native

    use_native = native.native_available()
    if dtype == "auto":
        target = jnp.bfloat16 if _bf16_lossless(v) else jnp.float32
    else:
        target = dtype
    bm, bn = general_block
    # BOTH sides pad to lcm(bm, bn) so the adjoint pack (rows/cols and
    # block dims swapped) tiles the same padded shape exactly — the
    # Gram pipeline chains A then Aᴴ without re-padding
    mult = int(np.lcm(bm, bn))
    m_pad = -(-m // mult) * mult
    n_pad = -(-n // mult) * mult
    mat = _pack_general(r, c, v, m_pad, n_pad, bm, bn, use_native, target, stage=stage)
    slots = mat.data.size
    itemsize = jnp.dtype(target).itemsize
    # normalized cross bandwidth: how far an entry sits from the matched
    # band diagonal after the two-sided permutation (row positions scaled
    # onto the column axis)
    bw = int(np.abs(r * (n / max(m, 1)) - c).max()) if len(r) else 0
    stats = dict(
        nnz=len(v),
        slots=int(slots),
        fill=float(len(v) / max(slots, 1)),
        bytes=int(slots * itemsize),
        dtype=str(jnp.dtype(target)),
        bandwidth_before=-1,
        bandwidth_after=bw,
        symmetric=False,
        complexified=False,
        pack_seconds=time.time() - t0,
        pack_stages={k: round(s, 4) for k, s in stages.items()},
        kmax=mat.k_max,
    )
    return AcceleratedOperator(
        matrix=mat,
        perm=col_perm,
        orig_shape=(m, n),
        symmetric=False,
        complexified=False,
        stats=stats,
        row_perm=row_perm,
        host_triplets=(r, c, v),
    )


def accelerate(
    A,
    *,
    symmetric: bool | None = None,
    symmetric_check: bool = True,
    dtype: Any = "auto",
    block: int = 128,
    general_block: tuple[int, int] = (32, 128),
    reorder: bool = True,
    merge_duplicates: bool | None = None,
) -> AcceleratedOperator:
    """Repack a scalar sparse operator into dense-block storage.

    Parameters
    ----------
    A : COOMatrix | scipy sparse | (rows, cols, vals, shape)
        The operator, in any host/device scalar-sparse form.  Complex
        operators are embedded as [[A,−B],[B,A]] automatically (Hermitian
        → real-symmetric → the half-traffic kernel).  RECTANGULAR
        operators take the two-sided route: bipartite RCM + general
        BSR-ELL with independent row/col padding (the svds Gram path);
        their embed/restore split into
        :meth:`AcceleratedOperator.embed`/:meth:`~AcceleratedOperator.embed_left`
        and :meth:`~AcceleratedOperator.restore`/:meth:`~AcceleratedOperator.restore_right`.
    symmetric : bool | None
        None (default) detects A == Aᴴ exactly on the triplets.  Passing
        True skips the full check; a cheap sampled probe (pattern counts
        + mirror-value sample, see ``symmetric_check``) still guards the
        claim, because the pack drops lower-triangle blocks and
        reconstructs them as mirrors — on a non-Hermitian operator that
        silently computes the wrong spectrum.
    symmetric_check : bool
        Set False to skip even the sampled probe behind
        ``symmetric=True`` (trusted production re-packs only).
    dtype : "auto" | jnp dtype
        "auto" stores bf16 when every value round-trips bf16 exactly
        (lossless; halves traffic), else f32.  An explicit dtype forces.
    block : int
        Symmetric block size (square; the GPU kernel takes power-of-two
        sizes of at least 16).
    general_block : (bm, bn)
        Block shape for non-symmetric operators.  Both defaults are
        carried over untuned; re-tuning them on the card is open
        (ROADMAP).
    reorder : bool
        Apply the RCM band-reducing permutation (disable only for
        operators already ordered, e.g. tridiagonal).
    merge_duplicates : bool | None
        None (default) canonicalizes every operand: a cheap payload-free
        radix sort detects duplicates and the full merge runs only when
        they exist.  False skips even the detection (trusted canonical
        triplets only — the Hermiticity checks assume duplicate-free
        input).

    Returns an :class:`AcceleratedOperator`; ``.stats`` records fill,
    slot counts, bytes, bandwidth before/after, and pack time.
    """
    t0 = time.time()
    stages: dict[str, float] = {}

    def _stage(name, t_start):
        now = time.time()
        stages[name] = stages.get(name, 0.0) + (now - t_start)
        return now

    r, c, v, shape = _as_host_triplets(A)
    if shape[0] != shape[1]:
        if symmetric:
            raise EigenexError("a rectangular operator cannot be symmetric")
        if np.iscomplexobj(v):
            raise EigenexError(
                "complex rectangular acceleration is not supported — "
                "realify by hand or use the COO Gram path"
            )
        return _accelerate_rectangular(
            r, c, v, shape, dtype=dtype, general_block=general_block,
            reorder=reorder,
            merge_duplicates=(
                merge_duplicates if merge_duplicates is not None else True
            ),
            t0=t0, stages=stages, stage=_stage,
        )
    if merge_duplicates is None:
        # detect-then-merge for EVERY operand: detection is a cheap
        # payload-free radix sort, and both Hermiticity checks assume
        # duplicate-free triplets (a user-assembled COOMatrix with split
        # entries was falsely rejected when this skipped COOMatrix)
        merge_duplicates = True
    ts = time.time()
    if merge_duplicates:
        # the full merge runs only when duplicates actually exist —
        # downstream stages all accept unsorted triplets (_canonicalize)
        r, c, v = _canonicalize(r, c, v, shape)
    ts = _stage("merge", ts)

    complexified = bool(np.iscomplexobj(v))
    if symmetric is None:
        symmetric = _is_hermitian(r, c, v, shape)
    elif symmetric and symmetric_check:
        # the flag skips the full O(nnz log nnz) transpose comparison;
        # this cheap probe still turns a misuse (general operator passed
        # as symmetric) into an error instead of a silently-symmetrized
        # wrong answer
        _sampled_hermitian_check(r, c, v, shape)
    ts = _stage("symmetry_check", ts)
    if complexified:
        emb = realify_coo(
            COOMatrix(r.astype(np.int32), c.astype(np.int32), v, shape)
        )
        r = np.asarray(emb.row, np.int64)
        c = np.asarray(emb.col, np.int64)
        v = np.asarray(emb.val)
        work_shape = emb.shape
        ts = _stage("realify", ts)
    else:
        work_shape = shape
    n_work = work_shape[0]

    bw_before = int(np.abs(r - c).max()) if len(r) else 0
    if reorder and work_shape[0] == work_shape[1] and len(r):
        perm = band_permutation(r, c, n_work, assume_symmetric=bool(symmetric))
        ts = _stage("rcm", ts)
        ip = np.empty(n_work, np.int64)
        ip[perm] = np.arange(n_work)
        r, c = ip[r], ip[c]
        ts = _stage("permute", ts)
    else:
        perm = np.arange(n_work, dtype=np.int64)
    bw_after = int(np.abs(r - c).max()) if len(r) else 0

    from .. import native

    use_native = native.native_available() and np.isrealobj(v)
    nnz = len(v)
    if dtype == "auto":
        target = jnp.bfloat16 if _bf16_lossless(v) else jnp.float32
    else:
        target = dtype

    if symmetric:
        # pad to 32 BLOCK rows so the streaming/ring kernels always have
        # a dividing strip (21127 block rows is prime-ish; the pad adds
        # at most 31 empty block rows of slots)
        n_pad = -(-n_work // (32 * block)) * (32 * block)
        mat, skipped = _pack_symmetric(
            r, c, v, n_pad, block, use_native, target, stage=_stage
        )
        if skipped is not None:
            # the native pack reports how many strictly-lower-BLOCK
            # triplets it dropped; that count is fully determined by the
            # pattern, so a mismatch means a packer defect — check it
            # instead of discarding it
            expect = int(np.count_nonzero(c // block < r // block))
            if skipped != expect:
                raise EigenexError(
                    f"sym pack dropped {skipped} lower-block triplets but the "
                    f"pattern holds {expect} — packer inconsistency"
                )
        slots = mat.diag_data.size + mat.upper_data.size
        applied = mat.diag_data.size + 2 * mat.upper_data.size
        widths = dict(ku=mat.upper_cols.shape[1], band_reach=mat.band_reach)
    else:
        bm, bn = general_block
        if work_shape[0] == work_shape[1]:
            # square stays square (eigs needs it): pad both to lcm(bm, bn)
            mult = int(np.lcm(bm, bn))
            m_pad = n_pad = -(-n_work // mult) * mult
        else:
            m_pad = -(-work_shape[0] // bm) * bm
            n_pad = -(-work_shape[1] // bn) * bn
        mat = _pack_general(
            r, c, v, m_pad, n_pad, bm, bn, use_native, target, stage=_stage
        )
        slots = mat.data.size
        applied = slots
        widths = dict(kmax=mat.k_max)

    itemsize = jnp.dtype(target).itemsize
    stats = dict(
        nnz=nnz,
        slots=int(slots),
        fill=float(nnz / max(applied, 1)),
        bytes=int(slots * itemsize),
        dtype=str(jnp.dtype(target)),
        bandwidth_before=bw_before,
        bandwidth_after=bw_after,
        symmetric=bool(symmetric),
        complexified=complexified,
        pack_seconds=time.time() - t0,
        pack_stages={k: round(s, 4) for k, s in stages.items()},
        **widths,
    )
    return AcceleratedOperator(
        matrix=mat,
        perm=perm,
        orig_shape=shape,
        symmetric=bool(symmetric),
        complexified=complexified,
        stats=stats,
        # general packs retain the permuted triplets so adjoint_matrix()
        # can pack Aᴴ lane-natively (the svds Gram second matvec);
        # symmetric containers are self-adjoint and keep memory flat
        host_triplets=None if symmetric else (r, c, v),
    )
