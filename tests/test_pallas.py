"""Block-sparse SpMV/SpMM: the symmetric GPU kernel in Pallas interpret
mode against the XLA formulation and the dense matrix, the backend rule
that picks between them, and the general BSR XLA path across block
shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eigenex_tpu.ops.pallas_spmv import sym_bsr_matmat_pallas, sym_bsr_matvec_pallas
from eigenex_tpu.sparse import bsr_from_coo_arrays
from eigenex_tpu.sparse.sym_bsr import SymBSRMatrix, kernel_route, sym_bsr_from_bsr


def banded_bsr(nbr, bm, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(nbr):
        for c in (r - 1, r, r + 1):
            if 0 <= c < nbr:
                blk = rng.standard_normal((bm, bm)).astype(dtype)
                rr, cc = np.meshgrid(np.arange(bm), np.arange(bm), indexing="ij")
                rows.append(r * bm + rr.ravel())
                cols.append(c * bm + cc.ravel())
                vals.append(blk.ravel())
    n = nbr * bm
    return bsr_from_coo_arrays(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n), (bm, bm)
    )


def sym_banded_bsr(nbr, bm, dtype=np.float32, seed=0):
    from eigenex_tpu.sparse.bsr import BSRMatrix

    rng = np.random.default_rng(seed)
    kmax = 3
    data = np.zeros((nbr, kmax, bm, bm), dtype)
    cols = np.zeros((nbr, kmax), np.int32)
    diag = rng.standard_normal((nbr, bm, bm)).astype(dtype)
    off = rng.standard_normal((nbr - 1, bm, bm)).astype(dtype)
    for r in range(nbr):
        data[r, 0] = (diag[r] + diag[r].T) / 2
        cols[r, 0] = r
        slot = 1
        if r > 0:
            data[r, slot] = off[r - 1].T
            cols[r, slot] = r - 1
            slot += 1
        if r + 1 < nbr:
            data[r, slot] = off[r]
            cols[r, slot] = r + 1
    n = nbr * bm
    return BSRMatrix(jnp.asarray(data), jnp.asarray(cols), (n, n))


class TestSymBSR:
    def test_pack_and_dense_roundtrip(self):
        bsr = sym_banded_bsr(6, 8)
        sym = sym_bsr_from_bsr(bsr, check=True)
        np.testing.assert_allclose(
            np.asarray(sym.to_dense()), np.asarray(bsr.to_dense()), atol=1e-6
        )

    def test_xla_matvec_matches_full(self):
        bsr = sym_banded_bsr(6, 8)
        sym = sym_bsr_from_bsr(bsr)
        x = jnp.asarray(np.random.default_rng(1).standard_normal(bsr.shape[1]).astype(np.float32))
        np.testing.assert_allclose(
            sym._xla_matvec(x), bsr.matvec(x), rtol=2e-5, atol=1e-4
        )

    def test_matmat_matches_full(self):
        bsr = sym_banded_bsr(6, 8)
        sym = sym_bsr_from_bsr(bsr)
        X = jnp.asarray(np.random.default_rng(2).standard_normal((bsr.shape[1], 5)).astype(np.float32))
        np.testing.assert_allclose(sym.matmat(X), bsr.matmat(X), rtol=2e-5, atol=1e-4)

    def test_hermitian_complex_xla(self):
        rng = np.random.default_rng(4)
        n = 24
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A = (A + A.conj().T) / 2
        from eigenex_tpu.sparse.bsr import bsr_from_dense

        bsr = bsr_from_dense(A, (4, 4))
        sym = sym_bsr_from_bsr(bsr.astype(jnp.complex128), check=True, atol=1e-12)
        x = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
        np.testing.assert_allclose(sym._xla_matvec(x), A @ np.asarray(x), atol=1e-10)

    def test_check_rejects_asymmetric(self):
        from eigenex_tpu.sparse.bsr import bsr_from_dense
        from eigenex_tpu.utils.exceptions import EigenexError

        A = np.triu(np.ones((8, 8)))
        bsr = bsr_from_dense(A, (4, 4))
        with pytest.raises(EigenexError):
            sym_bsr_from_bsr(bsr, check=True)

    def test_lanczos_through_sym_operator(self):
        bsr = sym_banded_bsr(4, 8, dtype=np.float64)
        sym = sym_bsr_from_bsr(bsr)
        from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions

        res = LanczosEigenSolver(
            sym.as_linear_operator(),
            LanczosOptions(max_eigenvalues=2, tolerance=1e-13, max_subspace=32),
        ).compute()
        ref = np.linalg.eigvalsh(np.asarray(bsr.to_dense()))
        np.testing.assert_allclose(res.eigenvalues, ref[:2], atol=1e-9)

    def test_check_rejects_lower_only_storage(self):
        from eigenex_tpu.sparse.bsr import bsr_from_dense
        from eigenex_tpu.utils.exceptions import EigenexError

        S = np.ones((8, 8)) + 7 * np.eye(8)
        low = np.tril(S)  # symmetric matrix stored lower-triangle-only
        bsr = bsr_from_dense(low, (4, 4))
        with pytest.raises(EigenexError):
            sym_bsr_from_bsr(bsr, check=True)

class TestSymStreamKernel:
    """Band-reach metadata carried through the pack (the mesh split reads
    it)."""

    def test_band_reach_metadata(self):
        sym = sym_bsr_from_bsr(sym_banded_bsr(6, 8))
        assert sym.band_reach == 1  # block-tridiagonal: upper reach 1
        assert sym.astype(jnp.bfloat16).band_reach == 1


def far_reach_sym(nbr, bm, reach, seed=0):
    """Symmetric matrix whose upper blocks sit at distance `reach` plus
    a near band; the last `reach` block rows hold padding slots."""
    rng = np.random.default_rng(seed)
    n = nbr * bm
    rows, cols, vals = [], [], []
    # block-diagonal + near band + far couplings at `reach`
    for br in range(nbr):
        r0 = br * bm
        d = rng.standard_normal((bm, bm))
        d = (d + d.T) / 2
        rr, cc = np.nonzero(np.abs(d) > 1.2)  # sparse-ish blocks
        rows.append(r0 + rr); cols.append(r0 + cc); vals.append(d[rr, cc])
        for dist in (1, reach):
            if br + dist < nbr:
                o = rng.standard_normal((bm, bm))
                rr, cc = np.nonzero(np.abs(o) > 1.4)
                rows.append(r0 + rr); cols.append(r0 + dist * bm + cc)
                vals.append(o[rr, cc])
                rows.append(r0 + dist * bm + cc); cols.append(r0 + rr)
                vals.append(o[rr, cc])
    r = np.concatenate(rows); c = np.concatenate(cols); v = np.concatenate(vals)
    # merge duplicate symmetric diag entries
    key = r.astype(np.int64) * n + c
    order = np.argsort(key)
    key, v = key[order], v[order]
    uniq, start = np.unique(key, return_index=True)
    v = np.add.reduceat(v, start)
    r, c = (uniq // n).astype(np.int64), (uniq % n).astype(np.int64)
    bsr = bsr_from_coo_arrays(r, c, v.astype(np.float32), (n, n), (bm, bm))
    return sym_bsr_from_bsr(bsr)


def _dense(sym):
    return np.asarray(sym.astype(jnp.float32).to_dense(), np.float64)


#: (name, factory) of the kernel test operators, all with 16×16 blocks:
#: a near band with no padding slots, and far couplings at block
#: distance 3 and 7 whose rows hold padding slots; 13 and 32 block rows
_KERNEL_OPS = {
    "near": lambda: sym_bsr_from_bsr(sym_banded_bsr(13, 16)),
    "far3": lambda: far_reach_sym(32, 16, 3),
    "far7": lambda: far_reach_sym(32, 16, 7, seed=3),
}


class TestSymKernelInterpret:
    """The half-traffic Pallas/Triton kernel in interpret mode against
    the XLA formulation and the dense matrix."""

    @pytest.mark.parametrize("p", [None, 1, 5, 8, 64])
    @pytest.mark.parametrize("op", sorted(_KERNEL_OPS))
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_matches_xla_and_dense(self, dtype, op, p):
        sym = _KERNEL_OPS[op]().astype(dtype)
        n = sym.shape[0]
        rng = np.random.default_rng(11)
        x = rng.standard_normal(n if p is None else (n, p)).astype(np.float32)
        if p is None:
            got = sym_bsr_matvec_pallas(sym, jnp.asarray(x), interpret=True)
            xla = sym._xla_matvec(jnp.asarray(x))
        else:
            got = sym_bsr_matmat_pallas(sym, jnp.asarray(x), interpret=True)
            xla = sym._xla_matmat(jnp.asarray(x))
        assert got.shape == x.shape and got.dtype == jnp.float32
        want = _dense(sym) @ x.astype(np.float64)
        scale = np.abs(want).max()
        np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(np.asarray(got), np.asarray(xla), rtol=0, atol=1e-5 * scale)

    def test_padding_slots_are_skipped_not_applied(self):
        """A padding slot points at column 0 with zero data; the kernel
        skips it (c <= r), so even garbage there changes nothing."""
        sym = far_reach_sym(32, 16, 3)
        uc = np.asarray(sym.upper_cols)
        pad = uc <= np.arange(uc.shape[0])[:, None]
        assert pad.any()
        ud = np.asarray(sym.upper_data).copy()
        ud[pad] = 1e3
        dirty = SymBSRMatrix(
            sym.diag_data, jnp.asarray(ud), sym.upper_cols, sym.shape, sym.band_reach
        )
        x = jnp.asarray(np.random.default_rng(2).standard_normal(sym.shape[0]), jnp.float32)
        np.testing.assert_allclose(
            sym_bsr_matvec_pallas(dirty, x, interpret=True),
            sym_bsr_matvec_pallas(sym, x, interpret=True),
            rtol=1e-6, atol=1e-5,
        )


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


class _FakeArray:
    def __init__(self, platform):
        self._platform = platform

    def devices(self):
        return {_FakeDevice(self._platform)}


class _FakeSym:
    """Just what the backend rule reads: the blocks' devices, dtype and
    block shape."""

    def __init__(self, platform, dtype, bm):
        self.upper_data = _FakeArray(platform)
        self.dtype = jnp.dtype(dtype)
        self.block_shape = (bm, bm)


class TestBackendRule:
    """:func:`kernel_route`: the GPU kernel for f32/bf16 storage committed
    to a CUDA device, XLA for every other operand — by choice, not as a
    fallback."""

    @pytest.mark.parametrize(
        "platform,dtype,bm,want",
        [
            ("gpu", jnp.float32, 128, True),
            ("gpu", jnp.bfloat16, 128, True),
            ("gpu", jnp.float32, 16, True),
            ("gpu", jnp.float64, 128, False),
            ("gpu", jnp.complex64, 128, False),
            ("gpu", jnp.float32, 8, False),
            ("gpu", jnp.float32, 24, False),
            ("cpu", jnp.float32, 128, False),
            ("cpu", jnp.bfloat16, 128, False),
        ],
    )
    def test_route(self, platform, dtype, bm, want):
        assert kernel_route(_FakeSym(platform, dtype, bm)) is want

    def test_cpu_container_routes_xla(self):
        sym = sym_bsr_from_bsr(sym_banded_bsr(4, 16))
        assert not kernel_route(sym)
        op = sym.as_linear_operator()
        x = jnp.asarray(np.random.default_rng(5).standard_normal(sym.shape[0]), jnp.float32)
        np.testing.assert_array_equal(op.matvec(x), sym._xla_matvec(x))

    def test_traced_container_routes_xla(self):
        """Traced, the route is staged; lowered for the CPU it is XLA's."""
        sym = sym_bsr_from_bsr(sym_banded_bsr(4, 16))
        seen = []
        jax.jit(lambda s: seen.append(kernel_route(s)) or s.diag_data.sum())(sym)
        assert seen == [None]
        x = jnp.asarray(np.random.default_rng(5).standard_normal(sym.shape[0]), jnp.float32)
        f = jax.jit(lambda s, x: s.matvec(x))
        np.testing.assert_array_equal(f(sym, x), sym._xla_matvec(x))
        assert "sym_bsr_spmv" not in f.lower(sym, x).as_text()

    @pytest.mark.parametrize(
        "method,kernel", [("matvec", "sym_bsr_spmv"), ("matmat", "sym_bsr_spmm")]
    )
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float64])
    def test_jitted_spmv_lowers_kernel_for_cuda(self, method, kernel, dtype):
        """``A @ x`` inside a user's jit compiles the kernel when lowered
        for CUDA — f32/bf16 storage only — and not XLA's scatter-add."""
        sym = sym_bsr_from_bsr(sym_banded_bsr(4, 16)).astype(dtype)
        n = sym.shape[0]
        x = jnp.ones((n,) if method == "matvec" else (n, 3), jnp.float32)
        f = jax.jit(lambda s, x: getattr(s, method)(x))
        text = f.trace(sym, x).lower(lowering_platforms=("cuda",)).as_text()
        fits = dtype != jnp.float64
        assert (kernel in text) is fits
        assert ("stablehlo.scatter" in text) is not fits

    @pytest.mark.parametrize("method", ["matvec", "matmat"])
    def test_interpret_operator_runs_kernel(self, method):
        sym = sym_bsr_from_bsr(sym_banded_bsr(6, 16)).astype(jnp.bfloat16)
        op = sym.as_linear_operator(use_pallas="interpret")
        rng = np.random.default_rng(6)
        x = jnp.asarray(
            rng.standard_normal((sym.shape[0],) if method == "matvec" else (sym.shape[0], 3)),
            jnp.float32,
        )
        got = getattr(op, method)(x)
        want = _dense(sym) @ np.asarray(x, np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


class TestBSRXlaPath:
    """General BSR-ELL runs on XLA on every backend: gather + einsum
    against the dense matrix across block shapes."""

    @pytest.mark.parametrize("p", [None, 7])
    @pytest.mark.parametrize("block", [(4, 4), (8, 8), (16, 16), (8, 128), (32, 128), (3, 5)])
    def test_matches_dense(self, block, p):
        rng = np.random.default_rng(sum(block))
        n = 200
        A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.03)
        A = A.astype(np.float32)
        r, c = np.nonzero(A)
        bsr = bsr_from_coo_arrays(r, c, A[r, c], (n, n), block)
        Ad = np.zeros(bsr.shape, np.float64)
        Ad[:n, :n] = A
        x = rng.standard_normal(bsr.shape[1] if p is None else (bsr.shape[1], p))
        x = x.astype(np.float32)
        got = bsr.matvec(jnp.asarray(x)) if p is None else bsr.matmat(jnp.asarray(x))
        want = Ad @ x.astype(np.float64)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
