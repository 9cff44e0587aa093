"""Tests for the scalar-sparse acceleration pipeline
(:mod:`eigenex_tpu.sparse.accelerate`): RCM reorder + block pack must be
an EXACT relayout — matvecs match the COO oracle, solvers run in
permuted space and restore to original coordinates, complex Hermitian
operators ride the real embedding onto the symmetric path.

Reference anchor: the serial COO scatter this pipeline replaces at scale
(triplets_matrix.hpp:314-318); the complex operator class is
sample_lanczos2.cpp:13-57.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from eigenex_tpu.sparse.accelerate import AcceleratedOperator, accelerate, band_permutation
from eigenex_tpu.sparse.coo import COOMatrix, coo_from_dense
from eigenex_tpu.utils.exceptions import EigenexError


def _random_symmetric_coo(n, density, seed, complex_=False):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=density, random_state=seed)
    if complex_:
        m = m + 1j * sp.random(n, n, density=density, random_state=seed + 1)
        m = m + m.conj().T + sp.eye(n) * 2.0
    else:
        m = m + m.T + sp.eye(n) * 2.0
    coo = m.tocoo()
    return coo


def test_band_permutation_reduces_bandwidth():
    # 2-D grid Laplacian: natural order bandwidth ~ side, random shuffle
    # destroys it, RCM must restore O(side)
    side = 24
    n = side * side
    g = sp.eye(n) * 4
    for d in (1, side):
        g = g - sp.eye(n, k=d) - sp.eye(n, k=-d)
    g = g.tocoo()
    shuf = np.random.default_rng(0).permutation(n)
    r, c = shuf[g.row], shuf[g.col]
    perm = band_permutation(r, c, n)
    ip = np.empty(n, np.int64)
    ip[perm] = np.arange(n)
    bw = np.abs(ip[r] - ip[c]).max()
    assert bw <= 4 * side  # shuffled bandwidth is ~n; RCM restores O(side)


@pytest.mark.parametrize("symmetric", [True, False])
def test_accelerate_matvec_matches_coo(symmetric):
    n = 300
    if symmetric:
        coo = _random_symmetric_coo(n, 0.02, 0)
    else:
        coo = sp.random(n, n, density=0.02, random_state=1).tocoo()
        coo = (sp.eye(n) + coo).tocoo()  # keep it square, irreducible-ish
    acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
    assert acc.symmetric == symmetric
    assert acc.stats["fill"] > 0
    x = np.random.default_rng(2).standard_normal(n)
    y_ref = coo @ x
    xe = acc.embed(x)
    y = acc.restore(np.asarray(acc.as_linear_operator().matvec(xe)))
    assert np.abs(y - y_ref).max() < 1e-4 * np.abs(y_ref).max()


def test_accelerate_detects_symmetry_and_respects_override():
    n = 200
    coo = _random_symmetric_coo(n, 0.03, 3)
    acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
    assert acc.symmetric
    acc_gen = accelerate((coo.row, coo.col, coo.data, coo.shape), symmetric=False)
    assert not acc_gen.symmetric
    x = np.random.default_rng(0).standard_normal(n)
    y1 = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(x))))
    y2 = acc_gen.restore(np.asarray(acc_gen.as_linear_operator().matvec(acc_gen.embed(x))))
    assert np.abs(y1 - y2).max() < 1e-4 * max(np.abs(y1).max(), 1e-30)


def test_accelerate_complex_hermitian_rides_symmetric_path():
    n = 120
    coo = _random_symmetric_coo(n, 0.03, 5, complex_=True)
    acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
    assert acc.complexified and acc.symmetric
    assert acc.shape[0] >= 2 * n  # real embedding, padded
    z = np.random.default_rng(1).standard_normal(n) + 1j * np.random.default_rng(2).standard_normal(n)
    y_ref = coo @ z
    y = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(z))))
    assert np.iscomplexobj(y)
    assert np.abs(y - y_ref).max() < 1e-4 * np.abs(y_ref).max()


def test_accelerate_bf16_auto_is_lossless_only():
    n = 128
    # dyadic values: exactly representable in bf16
    rng = np.random.default_rng(7)
    m = sp.random(n, n, density=0.05, random_state=7)
    m.data = np.round(m.data * 4) / 4 + 2.0
    m = (m + m.T).tocoo()
    acc = accelerate((m.row, m.col, m.data, m.shape))
    assert acc.stats["dtype"] == "bfloat16"
    # generic values: must stay f32
    m2 = _random_symmetric_coo(n, 0.05, 8)
    acc2 = accelerate((m2.row, m2.col, m2.data, m2.shape))
    assert acc2.stats["dtype"] == "float32"
    # explicit dtype wins
    acc3 = accelerate((m2.row, m2.col, m2.data, m2.shape), dtype=jnp.bfloat16)
    assert acc3.stats["dtype"] == "bfloat16"


def test_accelerate_duplicate_triplets_merge():
    n = 64
    r = np.array([0, 0, 1, 5, 5])
    c = np.array([1, 1, 0, 5, 5])
    v = np.array([2.0, 3.0, 5.0, 1.0, 1.0])
    acc = accelerate((r, c, v, (n, n)))
    x = np.zeros(n)
    x[1] = 1.0
    y = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(x))))
    assert abs(y[0] - 5.0) < 1e-5


def test_accelerate_eigsh_end_to_end_restores_eigenvectors():
    from eigenex_tpu.solvers.lanczos import LanczosEigenSolver, LanczosOptions

    n = 400
    coo = _random_symmetric_coo(n, 0.02, 11)
    dense = coo.toarray()
    evals_ref = np.linalg.eigvalsh(dense)
    acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
    res = (
        LanczosEigenSolver(
            acc.as_linear_operator(),
            LanczosOptions(max_eigenvalues=3, tolerance=1e-10, max_subspace=120),
        )
        .set_initial_vector(acc.embed(np.random.default_rng(0).standard_normal(n)))
        .compute()
    )
    lam = np.sort(np.asarray(res.eigenvalues))[:3]
    assert np.abs(lam - evals_ref[:3]).max() < 1e-6
    V = acc.restore(np.asarray(res.eigenvectors))
    for j in range(V.shape[1]):
        v = V[:, j] / np.linalg.norm(V[:, j])
        lam_j = float(v @ dense @ v)
        assert np.linalg.norm(dense @ v - lam_j * v) < 1e-5


def test_embed_restore_roundtrip_and_validation():
    n = 100
    coo = _random_symmetric_coo(n, 0.05, 13)
    acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
    X = np.random.default_rng(3).standard_normal((n, 4))
    back = acc.restore(np.asarray(acc.embed(X)))
    assert np.abs(back - X).max() < 1e-6
    with pytest.raises(EigenexError):
        acc.embed(np.zeros(n + 1))
    with pytest.raises(EigenexError):
        acc.restore(np.zeros(acc.shape[0] + 1))


def test_accelerate_rejects_bad_input():
    with pytest.raises(EigenexError):
        accelerate(np.zeros((4, 4)))  # dense array is not an accepted operand


def test_accelerate_numpy_fallback_matches_native(monkeypatch):
    n = 250
    coo = _random_symmetric_coo(n, 0.03, 17)
    acc_native = accelerate((coo.row, coo.col, coo.data, coo.shape))
    import eigenex_tpu.native as native

    monkeypatch.setattr(native, "NATIVE", None)
    acc_np = accelerate((coo.row, coo.col, coo.data, coo.shape))
    x = np.random.default_rng(0).standard_normal(n)
    y1 = acc_native.restore(np.asarray(acc_native.as_linear_operator().matvec(acc_native.embed(x))))
    y2 = acc_np.restore(np.asarray(acc_np.as_linear_operator().matvec(acc_np.embed(x))))
    assert np.abs(y1 - y2).max() < 1e-4 * np.abs(y1).max()


class TestEigshAccelerate:
    """eigsh(..., accelerate=True) — the front-end route (api.py)."""

    def test_real_symmetric_matches_plain(self):
        from eigenex_tpu.solvers.api import eigsh
        from eigenex_tpu.sparse.coo import COOMatrix
        import jax.numpy as jnp

        n = 350
        coo_sp = _random_symmetric_coo(n, 0.02, 21)
        coo = COOMatrix(
            jnp.asarray(coo_sp.row.astype(np.int32)),
            jnp.asarray(coo_sp.col.astype(np.int32)),
            jnp.asarray(coo_sp.data),
            (n, n),
        )
        ref = np.sort(np.linalg.eigvalsh(coo_sp.toarray()))
        res = eigsh(coo, k=3, which="SA", accelerate=True, tol=1e-10)
        lam = np.asarray(res.eigenvalues)
        assert np.abs(lam - ref[:3]).max() < 1e-5
        V = res.eigenvectors
        assert V.shape == (n, 3)
        dense = coo_sp.toarray()
        for j in range(3):
            v = V[:, j] / np.linalg.norm(V[:, j])
            assert np.linalg.norm(dense @ v - lam[j] * v) < 1e-4

    def test_complex_hermitian_collapses_doubling(self):
        from eigenex_tpu.solvers.api import eigsh

        n = 150
        coo_sp = _random_symmetric_coo(n, 0.04, 23, complex_=True)
        dense = coo_sp.toarray()
        ref = np.sort(np.linalg.eigvalsh(dense))
        res = eigsh(
            (coo_sp.row, coo_sp.col, coo_sp.data, coo_sp.shape),
            k=3, which="SA", accelerate=True, tol=1e-10,
        )
        lam = np.asarray(res.eigenvalues)
        assert len(lam) == 3
        # the three SMALLEST DISTINCT eigenvalues of H, not doubled copies
        assert np.abs(lam - ref[:3]).max() < 1e-4
        V = res.eigenvectors
        assert np.iscomplexobj(V)
        for j in range(3):
            v = V[:, j] / np.linalg.norm(V[:, j])
            assert np.linalg.norm(dense @ v - lam[j] * v) < 2e-4

    def test_sigma_targeting_through_accelerate(self):
        from eigenex_tpu.solvers.api import eigsh

        n = 200
        coo_sp = _random_symmetric_coo(n, 0.03, 29)
        ref = np.sort(np.linalg.eigvalsh(coo_sp.toarray()))
        target = float((ref[6] + ref[7]) / 2)
        res = eigsh(
            (coo_sp.row, coo_sp.col, coo_sp.data, coo_sp.shape),
            k=2, sigma=target, accelerate=True, tol=1e-8,
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        want = np.sort(ref[np.argsort(np.abs(ref - target))[:2]])
        assert np.abs(lam - want).max() < 1e-4

    def test_v0_is_honored_in_original_space(self):
        from eigenex_tpu.solvers.api import eigsh

        n = 120
        coo_sp = _random_symmetric_coo(n, 0.05, 31)
        v0 = np.random.default_rng(0).standard_normal(n)
        res = eigsh(
            (coo_sp.row, coo_sp.col, coo_sp.data, coo_sp.shape),
            k=2, which="SA", accelerate=True, v0=v0, tol=1e-10,
        )
        ref = np.sort(np.linalg.eigvalsh(coo_sp.toarray()))[:2]
        assert np.abs(np.asarray(res.eigenvalues) - ref).max() < 1e-5

    def test_accelerate_with_lobpcg_args_raises(self):
        # round 5 composed accelerate= with mesh= (TestAccelerateMesh-
        # Composition); the remaining exclusions are the LOBPCG knobs
        from eigenex_tpu.solvers.api import eigsh

        coo_sp = _random_symmetric_coo(64, 0.1, 37)
        with pytest.raises(EigenexError, match="M=/preconditioner="):
            eigsh(
                (coo_sp.row, coo_sp.col, coo_sp.data, coo_sp.shape),
                k=1, accelerate=True, M=np.eye(64),
            )

    def test_mesh_panel_narrower_than_band_raises_clearly(self):
        # a dense-ish operator packs to a band wider than one mesh panel;
        # the sym_halo ring reaches one neighbor only, so the composition
        # must fail with actionable advice, not a split internals error
        from eigenex_tpu.solvers.api import eigsh
        import jax
        from jax.sharding import Mesh

        coo_sp = _random_symmetric_coo(512, 0.2, 38)
        acc = accelerate((coo_sp.row, coo_sp.col, coo_sp.data, coo_sp.shape), block=8)
        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
        assert acc.stats["band_reach"] > acc.matrix.n_block_rows // 8
        with pytest.raises(EigenexError, match="fewer shards"):
            eigsh(acc, k=1, mesh=mesh)

    def test_refine_restores_then_polishes_on_original(self):
        from eigenex_tpu.solvers.api import eigsh
        from eigenex_tpu.sparse.coo import COOBuilder

        n = 180
        coo_sp = _random_symmetric_coo(n, 0.03, 41)
        b = COOBuilder(n, n)
        b.extend(coo_sp.row, coo_sp.col, coo_sp.data)
        coo = b.build()
        ref = np.sort(np.linalg.eigvalsh(coo_sp.toarray()))[:2]
        res = eigsh(coo, k=2, which="SA", accelerate=True, refine=True, tol=1e-8)
        assert np.abs(np.asarray(res.eigenvalues) - ref).max() < 1e-9


class TestEigsAccelerate:
    """eigs(..., accelerate=True) — the general-operator front-end route."""

    def test_real_general_matches_plain(self):
        from eigenex_tpu.solvers.api import eigs

        n = 200
        m = sp.random(n, n, density=0.04, random_state=51).tocoo()
        dense = m.toarray()
        lam_ref = np.linalg.eigvals(dense)
        lam_ref = lam_ref[np.argsort(-np.abs(lam_ref))][:2]
        res = eigs((m.row, m.col, m.data, m.shape), k=2, tol=1e-10, accelerate=True)
        lam = np.asarray(res.eigenvalues)
        assert res.eigenvectors.shape[0] == n
        # k can cut into a conjugate pair whose member choice is
        # arbitrary — compare conjugation-insensitively
        key = lambda a: np.sort_complex(a.real + 1j * np.abs(a.imag))
        np.testing.assert_allclose(key(lam), key(lam_ref), atol=2e-5)
        for j in range(2):
            z = res.eigenvectors[:, j]
            z = z / np.linalg.norm(z)
            assert np.linalg.norm(dense @ z - lam[j] * z) < 1e-4

    def test_complex_general_rides_block_path(self):
        # VERDICT r4 item 5: the real embedding of a general complex
        # operator is a real general operator — eigs(accelerate) packs it
        # onto the block kernels and reconstructs {λ} from {λ}∪{λ̄}
        from eigenex_tpu.solvers.api import eigs

        n = 400
        m = sp.random(n, n, density=0.03, random_state=5)
        m = (m + 1j * sp.random(n, n, density=0.03, random_state=6)
             + sp.eye(n) * (1 + 0.5j)).tocoo()
        ev = np.linalg.eigvals(m.toarray())
        acc = accelerate((m.row, m.col, m.data, m.shape), dtype=jnp.float64)
        assert acc.complexified and not acc.symmetric
        res = eigs(acc, k=4, which="LM", tol=1e-10)
        lam = np.asarray(res.eigenvalues)
        want = ev[np.argsort(-np.abs(ev))[:4]]
        np.testing.assert_allclose(
            np.sort(np.abs(lam)), np.sort(np.abs(want)), rtol=1e-8
        )
        A = m.tocsr()
        V = res.eigenvectors
        scale = float(np.abs(lam).max())
        for j in range(4):
            r = np.linalg.norm(A @ V[:, j] - lam[j] * V[:, j])
            assert r < 1e-6 * scale, r
        # refine polishes to f64-grade on the original COO
        from eigenex_tpu.sparse.coo import COOMatrix

        coo = COOMatrix(
            jnp.asarray(m.row.astype(np.int32)), jnp.asarray(m.col.astype(np.int32)),
            jnp.asarray(m.data), m.shape,
        )
        res2 = eigs(coo, k=4, which="LM", tol=1e-10, accelerate=True, refine=True)
        lam2 = np.asarray(res2.eigenvalues)
        V2 = np.asarray(res2.eigenvectors)
        for j in range(4):
            r = np.linalg.norm(A @ V2[:, j] - lam2[j] * V2[:, j])
            assert r < 1e-10 * scale, r

    def test_complex_general_one_call(self):
        # raw complex triplets + accelerate=True in one call (round 4
        # rejected this outright, api.py:606-610 then)
        from eigenex_tpu.solvers.api import eigs

        n = 60
        m = (sp.random(n, n, density=0.1, random_state=3) + sp.eye(n)).tocoo()
        vals = m.data + 0.5j * m.data
        ev = np.linalg.eigvals(
            sp.coo_matrix((vals, (m.row, m.col)), shape=m.shape).toarray()
        )
        res = eigs((m.row, m.col, vals, m.shape), k=2, accelerate=True, tol=1e-8)
        want = ev[np.argsort(-np.abs(ev))[:2]]
        np.testing.assert_allclose(
            np.sort(np.abs(np.asarray(res.eigenvalues))), np.sort(np.abs(want)),
            rtol=1e-5,
        )

    def test_complex_sigma_rejected_on_accelerated_route(self):
        from eigenex_tpu.solvers.api import eigs

        n = 40
        m = (sp.random(n, n, density=0.1, random_state=4) + sp.eye(n)).tocoo()
        acc = accelerate((m.row, m.col, m.data + 1j * m.data, m.shape))
        with pytest.raises(EigenexError, match="REAL sigma"):
            eigs(acc, k=2, sigma=1.0 + 1.0j)

    def test_eigs_v0_plain_route(self):
        from eigenex_tpu.solvers.api import eigs

        n = 60
        m = sp.random(n, n, density=0.08, random_state=9).tocoo()
        dense = np.asarray(m.toarray())
        lam_ref = np.linalg.eigvals(dense)
        lam_ref = np.sort_complex(lam_ref[np.argsort(-np.abs(lam_ref))][:2])
        v0 = np.random.default_rng(1).standard_normal(n)
        res = eigs(dense, k=2, tol=1e-12, v0=v0)
        key = lambda a: np.sort_complex(a.real + 1j * np.abs(a.imag))
        np.testing.assert_allclose(key(np.asarray(res.eigenvalues)), key(lam_ref), atol=1e-8)


class TestSaveLoad:
    """Pack-once persistence: the RCM+pack is minutes at 10^7 nnz and
    deterministic, so production reloads instead of repacking."""

    @pytest.mark.parametrize("complex_", [False, True])
    def test_roundtrip(self, tmp_path, complex_):
        n = 180
        coo = _random_symmetric_coo(n, 0.04, 61, complex_=complex_)
        acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
        p = tmp_path / "op.npz"
        acc.save(p)
        back = AcceleratedOperator.load(p)
        assert back.symmetric == acc.symmetric
        assert back.complexified == acc.complexified
        assert back.orig_shape == acc.orig_shape
        assert back.stats["dtype"] == acc.stats["dtype"]
        z = (
            np.random.default_rng(0).standard_normal(n)
            + (1j * np.random.default_rng(1).standard_normal(n) if complex_ else 0)
        )
        y1 = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(z))))
        y2 = back.restore(np.asarray(back.as_linear_operator().matvec(back.embed(z))))
        np.testing.assert_array_equal(y1, y2)

    def test_bf16_blocks_survive_npz(self, tmp_path):
        import scipy.sparse as sp

        n = 96
        m = sp.random(n, n, density=0.06, random_state=7)
        m.data = np.round(m.data * 4) / 4 + 1.0  # dyadic -> bf16 lossless
        m = (m + m.T).tocoo()
        acc = accelerate((m.row, m.col, m.data, m.shape))
        assert acc.stats["dtype"] == "bfloat16"
        p = tmp_path / "op16.npz"
        acc.save(p)
        back = AcceleratedOperator.load(p)
        assert str(back.matrix.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(back.matrix.diag_data.astype(jnp.float32)),
            np.asarray(acc.matrix.diag_data.astype(jnp.float32)),
        )


class TestFilterFrontEndsOnAccelerated:
    """eigsh_window / eigsh_range accept AcceleratedOperator: permuted-
    space filtering, padding-safe starts, restored (deduped) vectors."""

    def test_window_real(self):
        from eigenex_tpu.solvers.chebyshev import eigsh_window

        n = 300
        coo = _random_symmetric_coo(n, 0.03, 71)
        dense = coo.toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        # an interior window holding 3 eigenvalues
        w = (float((ev[10] + ev[9]) / 2), float((ev[13] + ev[12]) / 2))
        inside = ev[(ev > w[0]) & (ev < w[1])]
        acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
        # f32 container => f32-reachable tol; tight bounds + a higher
        # degree (Gershgorin is far too wide on random operators and
        # would need degree >> 100 to select a 1%-wide window)
        res = eigsh_window(
            acc, w, block_size=max(6, len(inside) + 3), tol=3e-5,
            degree=60, spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        assert len(lam) == len(inside)
        np.testing.assert_allclose(lam, inside, atol=1e-4)
        V = res.eigenvectors
        assert V.shape[0] == n
        for j in range(V.shape[1]):
            x = V[:, j] / np.linalg.norm(V[:, j])
            lj = float(x @ dense @ x)
            assert np.linalg.norm(dense @ x - lj * x) < 5e-4  # f32 filter

    def test_window_complex_dedups(self):
        from eigenex_tpu.solvers.chebyshev import eigsh_window

        n = 140
        coo = _random_symmetric_coo(n, 0.04, 73, complex_=True)
        dense = coo.toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        w = (float((ev[7] + ev[6]) / 2), float((ev[10] + ev[9]) / 2))
        inside = ev[(ev > w[0]) & (ev < w[1])]
        acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
        assert acc.complexified
        res = eigsh_window(
            acc, w, block_size=len(inside) + 3, tol=3e-5,
            degree=60, spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        assert len(lam) == len(inside)  # doubled spectrum collapsed
        np.testing.assert_allclose(lam, inside, atol=1e-4)
        V = res.eigenvectors
        assert np.iscomplexobj(V) and V.shape[0] == n

    def test_range_real(self):
        from eigenex_tpu.solvers.kpm import eigsh_range

        n = 260
        coo = _random_symmetric_coo(n, 0.04, 79)
        dense = coo.toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        # midpoint edges: an eigenvalue 1e-6 from the boundary sits in
        # the filter's transition band and is legitimately missable
        a, b = float((ev[3] + ev[4]) / 2), float((ev[12] + ev[13]) / 2)
        inside = ev[(ev >= a) & (ev <= b)]
        acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
        res = eigsh_range(
            acc, (a, b), block_size=8, tol=3e-5, degree=80,
            spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        np.testing.assert_allclose(lam, inside, atol=1e-4)

    def test_range_complex_dedups(self):
        # window/range parity: the KPM count over the real embedding is
        # halved for slice sizing and the per-slice windows dedup, so a
        # complexified operator returns each eigenvalue ONCE
        from eigenex_tpu.solvers.kpm import eigsh_range

        n = 140
        coo = _random_symmetric_coo(n, 0.04, 81, complex_=True)
        dense = coo.toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        a, b = float((ev[3] + ev[4]) / 2), float((ev[10] + ev[11]) / 2)
        inside = ev[(ev >= a) & (ev <= b)]
        acc = accelerate((coo.row, coo.col, coo.data, coo.shape))
        assert acc.complexified
        res = eigsh_range(
            acc, (a, b), block_size=8, tol=3e-5, degree=80,
            spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        np.testing.assert_allclose(lam, inside, atol=1e-4)
        V = res.eigenvectors
        assert np.iscomplexobj(np.asarray(V)) and V.shape[0] == n


class TestAccelerateMeshComposition:
    """The two flagship capabilities in ONE call:
    ``eigsh(A, accelerate=True/AcceleratedOperator, mesh=...)`` packs
    (RCM + half-traffic sym blocks) and row-partitions the packed
    container over the mesh via the sym_halo ppermute ring — the bridge
    to operators that exceed one chip's HBM (BASELINE config 5)."""

    def _mesh8(self, shape=(8,)):
        import jax
        from jax.sharding import Mesh

        devs = np.array(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape)
        names = ("rows",) if len(shape) == 1 else ("r", "c")
        return Mesh(devs, names)

    def _far_reach_triplets(self, n=2000, bw=100, per_row=6, seed=33):
        """Shuffled banded symmetric operator with DYADIC values (exact
        in f32 storage and f64 iteration).  At block=8 the recovered
        band reach is ~bw/8 ≈ 19 block rows — a far reach like the
        packed Heisenberg sectors' — while fitting one virtual-8 mesh
        panel."""
        rng = np.random.default_rng(seed)
        r = np.repeat(np.arange(n), per_row)
        c = r + rng.integers(1, bw, size=len(r))
        keep = c < n
        r, c = r[keep], c[keep]
        v = np.round(rng.standard_normal(len(r)) * 8) / 8
        rows = np.concatenate([r, c, np.arange(n)])
        cols = np.concatenate([c, r, np.arange(n)])
        vals = np.concatenate([v, v, np.full(n, 4.0)])
        shuf = rng.permutation(n)
        return shuf[rows], shuf[cols], vals, (n, n)

    def test_far_reach_composition_matches_single_device(self):
        from eigenex_tpu.solvers.api import eigsh

        trip = self._far_reach_triplets()
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        # far-reach shape: packed reach past 8 block rows, but within one
        # 8-shard mesh panel
        nbr = acc.matrix.n_block_rows
        assert 8 < acc.stats["band_reach"] <= nbr // 8
        assert acc.shape[0] > acc.n_work  # block padding present
        res1 = eigsh(acc, k=4, tol=1e-11)
        res2 = eigsh(acc, k=4, tol=1e-11, mesh=self._mesh8())
        scale = float(np.abs(res1.eigenvalues).max())
        np.testing.assert_allclose(
            np.asarray(res2.eigenvalues), np.asarray(res1.eigenvalues),
            atol=1e-10 * scale,
        )
        # the restored eigenvectors solve the ORIGINAL problem
        rr, cc, vv, shape = trip
        A = sp.coo_matrix((vv, (rr, cc)), shape=shape).tocsr()
        V = np.asarray(res2.eigenvectors)
        assert V.shape[0] == shape[0]
        for j in range(V.shape[1]):
            lam = res2.eigenvalues[j]
            assert np.linalg.norm(A @ V[:, j] - lam * V[:, j]) < 1e-8 * scale

    def test_one_call_from_triplets(self):
        from eigenex_tpu.solvers.api import eigsh

        trip = self._far_reach_triplets(n=1200, bw=70)
        res = eigsh(trip, k=3, accelerate=True, mesh=self._mesh8(), tol=1e-8)
        rr, cc, vv, shape = trip
        dense = sp.coo_matrix((vv, (rr, cc)), shape=shape).toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        np.testing.assert_allclose(
            np.asarray(res.eigenvalues), ev[:3], atol=1e-6 * np.abs(ev).max()
        )

    def test_sigma_composition(self):
        from eigenex_tpu.solvers.api import eigsh

        trip = self._far_reach_triplets(n=1200, bw=70, seed=35)
        rr, cc, vv, shape = trip
        dense = sp.coo_matrix((vv, (rr, cc)), shape=shape).toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        sigma = float(ev[0]) - 0.5  # definite shift: CG inner solves
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        res = eigsh(acc, k=2, sigma=sigma, mesh=self._mesh8(), tol=1e-9)
        np.testing.assert_allclose(
            np.asarray(res.eigenvalues), ev[:2], atol=1e-7 * np.abs(ev).max()
        )

    def test_complex_hermitian_composition_dedups(self):
        from eigenex_tpu.solvers.api import eigsh

        # banded complex Hermitian: the real embedding + RCM recovers a
        # band narrow enough for one mesh panel
        n, bw = 600, 40
        rng = np.random.default_rng(37)
        r = np.repeat(np.arange(n), 4)
        c = r + rng.integers(1, bw, size=len(r))
        keep = c < n
        r, c = r[keep], c[keep]
        v = (np.round(rng.standard_normal(len(r)) * 8) / 8
             + 1j * np.round(rng.standard_normal(len(r)) * 8) / 8)
        rows = np.concatenate([r, c, np.arange(n)])
        cols = np.concatenate([c, r, np.arange(n)])
        vals = np.concatenate([v, np.conj(v), np.full(n, 3.0 + 0j)])
        dense = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        acc = accelerate((rows, cols, vals, (n, n)), block=8, dtype=jnp.float64)
        assert acc.complexified and acc.symmetric
        res = eigsh(acc, k=3, mesh=self._mesh8(), tol=1e-10)
        lam = np.asarray(res.eigenvalues)
        np.testing.assert_allclose(lam, ev[:3], atol=1e-8 * np.abs(ev).max())
        V = np.asarray(res.eigenvectors)
        assert np.iscomplexobj(V) and V.shape == (n, 3)
        for j in range(3):
            assert np.linalg.norm(dense @ V[:, j] - lam[j] * V[:, j]) < 1e-7

    def test_multi_axis_mesh_flattens(self):
        from eigenex_tpu.solvers.api import eigsh

        trip = self._far_reach_triplets(n=1200, bw=80, seed=39)
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        res1 = eigsh(acc, k=2, tol=1e-9)
        res2 = eigsh(acc, k=2, tol=1e-9, mesh=self._mesh8(shape=(4, 2)))
        np.testing.assert_allclose(
            np.asarray(res2.eigenvalues), np.asarray(res1.eigenvalues), atol=1e-9
        )

    def test_eigs_general_composition(self):
        # a packed GENERAL (nonsymmetric) operator rides the distributed
        # Krylov-Schur driver under the mesh
        from eigenex_tpu.solvers.api import eigs

        n = 800
        rng = np.random.default_rng(47)
        m = (sp.eye(n) * 2 + sp.random(n, n, density=0.01, random_state=47)).tocoo()
        acc = accelerate(
            (m.row, m.col, m.data, m.shape), symmetric=False,
            general_block=(8, 8), dtype=jnp.float64,
        )
        assert not acc.symmetric
        res1 = eigs(acc, k=3, which="LM", tol=1e-10)
        res2 = eigs(acc, k=3, which="LM", tol=1e-10, mesh=self._mesh8())
        # k can cut a conjugate pair in half; which member survives is
        # route-dependent, so compare conj-agnostically (|λ| and Re λ)
        for key in (np.abs, np.real):
            np.testing.assert_allclose(
                np.sort(key(np.asarray(res2.eigenvalues))),
                np.sort(key(np.asarray(res1.eigenvalues))),
                atol=1e-8,
            )
        A = m.tocsr()
        V = np.asarray(res2.eigenvectors)
        assert V.shape[0] == n
        lam = np.asarray(res2.eigenvalues)
        for j in range(3):
            assert np.linalg.norm(A @ V[:, j] - lam[j] * V[:, j]) < 1e-7

    def test_window_composition(self):
        # the filter path composes too: eigsh_window over a packed
        # container row-partitioned via the sym_halo ring
        from eigenex_tpu.solvers.chebyshev import eigsh_window

        trip = self._far_reach_triplets(n=1200, bw=70, seed=43)
        rr, cc, vv, shape = trip
        dense = sp.coo_matrix((vv, (rr, cc)), shape=shape).toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        w = (float((ev[9] + ev[8]) / 2), float((ev[12] + ev[11]) / 2))
        inside = ev[(ev > w[0]) & (ev < w[1])]
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        res = eigsh_window(
            acc, w, block_size=len(inside) + 3, tol=1e-8, degree=60,
            spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
            mesh=self._mesh8(),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        assert len(lam) == len(inside)
        np.testing.assert_allclose(lam, inside, atol=1e-7 * np.abs(ev).max())
        assert res.eigenvectors.shape[0] == shape[0]

    def test_range_composition(self):
        from eigenex_tpu.solvers.kpm import eigsh_range

        trip = self._far_reach_triplets(n=1200, bw=70, seed=45)
        rr, cc, vv, shape = trip
        dense = sp.coo_matrix((vv, (rr, cc)), shape=shape).toarray()
        ev = np.sort(np.linalg.eigvalsh(dense))
        a, b = float((ev[3] + ev[4]) / 2), float((ev[10] + ev[11]) / 2)
        inside = ev[(ev >= a) & (ev <= b)]
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        res = eigsh_range(
            acc, (a, b), block_size=8, tol=1e-8, degree=80,
            spectral_bounds=(float(ev[0]) - 0.1, float(ev[-1]) + 0.1),
            mesh=self._mesh8(),
        )
        lam = np.sort(np.asarray(res.eigenvalues))
        np.testing.assert_allclose(lam, inside, atol=1e-7 * np.abs(ev).max())

    def test_v0_accepted_under_mesh(self):
        from eigenex_tpu.solvers.api import eigsh

        trip = self._far_reach_triplets(n=1200, bw=80, seed=41)
        acc = accelerate(trip, block=8, dtype=jnp.float64)
        v0 = np.random.default_rng(5).standard_normal(1200)
        res = eigsh(acc, k=2, v0=v0, mesh=self._mesh8(), tol=1e-9)
        res1 = eigsh(acc, k=2, tol=1e-9)
        np.testing.assert_allclose(
            np.asarray(res.eigenvalues), np.asarray(res1.eigenvalues), atol=1e-9
        )


class TestSymmetricClaimGuard:
    """symmetric=True skips the full Hermiticity scan but a sampled
    probe (pattern counts + mirror values) still rejects misuse — the
    pack would otherwise silently symmetrize a general operator."""

    def test_nonsymmetric_pattern_raises(self):
        n = 96
        m = (sp.eye(n) + sp.random(n, n, density=0.04, random_state=11)).tocoo()
        with pytest.raises(EigenexError, match="not Hermitian"):
            accelerate((m.row, m.col, m.data, m.shape), symmetric=True)

    def test_value_asymmetry_raises(self):
        # symmetric pattern, one mirrored VALUE perturbed: the count
        # check passes, the sampled mirror-value probe must catch it
        # (sample covers all off-diagonals at this size)
        n = 64
        m = _random_symmetric_coo(n, 0.05, 12).tocsr().tocoo()
        off = np.nonzero(m.row != m.col)[0]
        m.data[off[0]] += 0.5
        with pytest.raises(EigenexError, match="not Hermitian"):
            accelerate((m.row, m.col, m.data, m.shape), symmetric=True)

    def test_eigsh_accelerate_misuse_raises(self):
        from eigenex_tpu.solvers.api import eigsh

        n = 96
        m = (sp.eye(n) * 2 + sp.random(n, n, density=0.04, random_state=13)).tocoo()
        with pytest.raises(EigenexError, match="not Hermitian"):
            eigsh((m.row, m.col, m.data, m.shape), k=2, accelerate=True)

    def test_check_can_be_disabled(self):
        n = 96
        m = (sp.eye(n) + sp.random(n, n, density=0.04, random_state=14)).tocoo()
        acc = accelerate(
            (m.row, m.col, m.data, m.shape), symmetric=True, symmetric_check=False
        )
        assert acc.symmetric  # trusted: packs without complaint

    def test_duplicate_triplet_coomatrix_not_falsely_rejected(self):
        # round-5 review finding: a user-assembled COOMatrix with SPLIT
        # entries (FEM-style duplicates) is Hermitian after summing; the
        # probe must canonicalize before counting, not reject
        import jax.numpy as jnp_
        from eigenex_tpu.sparse.coo import COOMatrix

        n = 80
        m = _random_symmetric_coo(n, 0.05, 16).tocsr().tocoo()
        # split some UPPER entries w -> w/2 + w/2 (two triplets): the
        # summed operator is unchanged and exactly symmetric, but the
        # RAW triangle counts now disagree (the review's repro)
        up = np.nonzero(m.col > m.row)[0][:10]
        v2 = m.data.copy()
        v2[up] /= 2
        r2 = np.concatenate([m.row, m.row[up]])
        c2 = np.concatenate([m.col, m.col[up]])
        v2 = np.concatenate([v2, v2[up]])
        coo = COOMatrix(
            jnp_.asarray(r2.astype(np.int32)), jnp_.asarray(c2.astype(np.int32)),
            jnp_.asarray(v2), (n, n),
        )
        acc = accelerate(coo, symmetric=True)  # must NOT raise
        dense = sp.coo_matrix((v2, (r2, c2)), shape=(n, n)).toarray()
        assert np.abs(dense - dense.T).max() < 1e-14
        x = np.random.default_rng(1).standard_normal(n)
        y = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(x))))
        np.testing.assert_allclose(y, dense @ x, atol=1e-5)

    def test_symmetric_claim_on_valid_operator_packs_identically(self):
        n = 128
        m = _random_symmetric_coo(n, 0.04, 15)
        a1 = accelerate((m.row, m.col, m.data, m.shape))  # detected
        a2 = accelerate((m.row, m.col, m.data, m.shape), symmetric=True)
        x = np.random.default_rng(0).standard_normal(n)
        y1 = a1.restore(np.asarray(a1.as_linear_operator().matvec(a1.embed(x))))
        y2 = a2.restore(np.asarray(a2.as_linear_operator().matvec(a2.embed(x))))
        np.testing.assert_allclose(y1, y2, atol=0)


class TestRectangularAcceleration:
    """Rectangular operators (VERDICT r4 item 3): bipartite RCM two-sided
    permutation + general BSR-ELL with independent row/col padding; svds
    Gram matvecs ride the dense-block kernels."""

    def _banded_rect(self, m=700, n=500, bw=60, seed=51):
        rng = np.random.default_rng(seed)
        r = np.repeat(np.arange(m), 4)
        # entries near the matched diagonal j ~ i*n/m, then shuffled
        ctr = (r * n) // m
        c = ctr + rng.integers(-bw, bw, size=len(r))
        keep = (c >= 0) & (c < n)
        r, c = r[keep], c[keep]
        v = np.round(rng.standard_normal(len(r)) * 8) / 8
        pr, pc = rng.permutation(m), rng.permutation(n)
        return pr[r], pc[c], v, (m, n)

    def test_matvec_matches_scipy_both_sides(self):
        rr, cc, vv, shape = self._banded_rect()
        A = sp.coo_matrix((vv, (rr, cc)), shape=shape).tocsr()
        acc = accelerate((rr, cc, vv, shape), dtype=jnp.float64)
        assert acc.row_perm is not None and len(acc.row_perm) == shape[0]
        x = np.random.default_rng(0).standard_normal(shape[1])
        y = acc.restore(np.asarray(acc.matrix.as_linear_operator().matvec(acc.embed(x))))
        np.testing.assert_allclose(y, A @ x, atol=1e-10)
        # adjoint side through embed_left / restore_right
        u = np.random.default_rng(1).standard_normal(shape[0])
        z = acc.restore_right(
            np.asarray(acc.matrix.adjoint().as_linear_operator().matvec(acc.embed_left(u)))
        )
        np.testing.assert_allclose(z, A.T @ u, atol=1e-10)

    def test_svds_accelerated_matches_scipy(self):
        from eigenex_tpu.solvers.api import svds

        rr, cc, vv, shape = self._banded_rect()
        A = sp.coo_matrix((vv, (rr, cc)), shape=shape)
        s_ref = np.linalg.svd(A.toarray(), compute_uv=False)[:4]
        # one-call route (auto dtype -> bf16 storage, f32 Gram accumulate)
        s_auto = svds(
            (rr, cc, vv, shape), k=4, accelerate=True, tol=1e-8,
            return_singular_vectors=False,
        )
        np.testing.assert_allclose(s_auto, s_ref, rtol=1e-5)
        # pre-packed f64 container: full-precision contract
        acc = accelerate((rr, cc, vv, shape), dtype=jnp.float64)
        U, s, Vh = svds(acc, k=4, tol=1e-11)
        np.testing.assert_allclose(s, s_ref, rtol=1e-8)
        # singular triplets solve the ORIGINAL problem
        for j in range(4):
            np.testing.assert_allclose(
                A @ np.conj(Vh[j]), s[j] * U[:, j], atol=1e-7 * s[0]
            )
        # orthonormality of the returned factors
        np.testing.assert_allclose(U.T @ U, np.eye(4), atol=1e-8)
        np.testing.assert_allclose(Vh @ Vh.T.conj(), np.eye(4), atol=1e-8)

    def test_svds_complex_general(self):
        # round-5 review finding: sigma(A) != |lambda(A)| for non-normal
        # complex A — svds must not redirect those to eigsh.  The real
        # embedding has each sigma of A twice; dedup restores k triplets.
        from eigenex_tpu.solvers.api import svds

        n = 120
        m = (sp.random(n, n, density=0.06, random_state=55)
             + 1j * sp.random(n, n, density=0.06, random_state=56)
             + sp.eye(n)).tocoo()
        dense = m.toarray()
        s_ref = np.linalg.svd(dense, compute_uv=False)[:3]
        acc = accelerate((m.row, m.col, m.data, m.shape), dtype=jnp.float64)
        assert acc.complexified and not acc.symmetric
        U, s, Vh = svds(acc, k=3, tol=1e-11)
        np.testing.assert_allclose(s, s_ref, rtol=1e-7)
        for j in range(3):
            np.testing.assert_allclose(
                dense @ np.conj(Vh[j]), s[j] * U[:, j], atol=1e-6 * s_ref[0]
            )
        # values-only route
        s2 = svds(acc, k=3, tol=1e-11, return_singular_vectors=False)
        np.testing.assert_allclose(s2, s_ref, rtol=1e-7)

    def test_svds_accelerated_mesh_composition(self):
        # the SVD path composes too: both Gram matvecs (A and its
        # lane-native adjoint pack) row-partitioned over the virtual mesh
        import jax
        from jax.sharding import Mesh

        from eigenex_tpu.solvers.api import svds

        rr, cc, vv, shape = self._banded_rect()
        A = sp.coo_matrix((vv, (rr, cc)), shape=shape)
        s_ref = np.linalg.svd(A.toarray(), compute_uv=False)[:3]
        acc = accelerate((rr, cc, vv, shape), dtype=jnp.float64)
        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
        U, s, Vh = svds(acc, k=3, tol=1e-11, mesh=mesh)
        np.testing.assert_allclose(s, s_ref, rtol=1e-8)
        for j in range(3):
            np.testing.assert_allclose(
                A @ np.conj(Vh[j]), s[j] * U[:, j], atol=1e-7 * s[0]
            )

    def test_save_load_roundtrip_rectangular(self, tmp_path):
        rr, cc, vv, shape = self._banded_rect(m=300, n=200, bw=30)
        acc = accelerate((rr, cc, vv, shape), dtype=jnp.float64)
        p = tmp_path / "rect.npz"
        acc.save(p)
        acc2 = AcceleratedOperator.load(p)
        assert np.array_equal(acc.row_perm, acc2.row_perm)
        x = np.random.default_rng(2).standard_normal(shape[1])
        y1 = acc.restore(np.asarray(acc.matrix.as_linear_operator().matvec(acc.embed(x))))
        y2 = acc2.restore(np.asarray(acc2.matrix.as_linear_operator().matvec(acc2.embed(x))))
        np.testing.assert_allclose(y1, y2, atol=0)

    def test_rectangular_rejects_symmetric_claim_and_complex(self):
        r = np.array([0, 1]); c = np.array([1, 2]); v = np.array([1.0, 2.0])
        with pytest.raises(EigenexError, match="rectangular"):
            accelerate((r, c, v, (4, 6)), symmetric=True)
        with pytest.raises(EigenexError, match="complex rectangular"):
            accelerate((r, c, v + 1j, (4, 6)))


@pytest.mark.parametrize("which", ["LA", "BE", "LM"])
def test_eigsh_accelerate_which_modes(which):
    from eigenex_tpu.solvers.api import eigsh

    n = 220
    coo = _random_symmetric_coo(n, 0.03, 91)
    ev = np.sort(np.linalg.eigvalsh(coo.toarray()))
    res = eigsh(
        (coo.row, coo.col, coo.data, coo.shape), k=4, which=which,
        accelerate=True, tol=1e-10,
    )
    lam = np.asarray(res.eigenvalues)
    if which == "LA":
        want = ev[-4:]
    elif which == "BE":
        want = np.concatenate([ev[:2], ev[-2:]])
    else:  # LM
        want = np.sort(ev[np.argsort(-np.abs(ev))[:4]])
    np.testing.assert_allclose(lam, want, atol=1e-5)
