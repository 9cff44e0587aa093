"""Small-surface coverage: profiling utilities, Arnoldi warm resume,
COOBuilder.extend, misc operator edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eigenex_tpu import COOBuilder, aslinearoperator
from eigenex_tpu.solvers.arnoldi import ArnoldiEigenSolver, ArnoldiOptions
from eigenex_tpu.utils.profiling import PhaseTimer, annotate
from eigenex_tpu.utils.prng import random_matrix


def test_phase_timer():
    t = PhaseTimer()
    with t("a"):
        pass
    with t("a"):
        pass
    with t("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    s = t.summary()
    assert "a" in s and "ms/call" in s


def test_annotate_context():
    with annotate("region"):
        x = jnp.ones(4) + 1
    assert float(x.sum()) == 8.0


def test_arnoldi_continue_to_compute(key):
    """Warm resume retains the basis/Hessenberg (arnoldi.hpp:720-736)."""
    n = 60
    A = random_matrix(key, n, n, jnp.float64)
    solver = ArnoldiEigenSolver(
        A, ArnoldiOptions(max_eigenvalues=2, tolerance=1e-13, max_subspace=8, seed=0)
    )
    r1 = solver.compute()
    assert r1.termination == "max_iterations"
    solver.set_max_subspace(n)
    r2 = solver.continue_to_compute()
    assert r2.iterations > r1.iterations
    ref = np.linalg.eigvals(np.asarray(A))
    ref = ref[np.argsort(-np.abs(ref))]
    np.testing.assert_allclose(
        np.sort(np.abs(r2.eigenvalues)), np.sort(np.abs(ref[:2])), atol=1e-7
    )


def test_coo_builder_extend():
    b = COOBuilder(4, 4)
    b.extend([0, 1, 1], [1, 2, 2], [1.0, 2.0, 3.0])  # duplicate (1,2) merges
    coo = b.build()
    d = np.asarray(coo.to_dense())
    assert d[0, 1] == 1.0 and d[1, 2] == 5.0
    from eigenex_tpu.utils.exceptions import EigenexError

    with pytest.raises(EigenexError):
        b.extend([9], [0], [1.0])


def test_operator_call_and_matmul_array(key):
    A = random_matrix(key, 5, 5, jnp.float64)
    op = aslinearoperator(A)
    x = jnp.ones(5)
    np.testing.assert_allclose(op @ x, A @ x)  # __matmul__ on an array


class TestBenchtime:
    """The shared benchmark helpers (utils/benchtime.py): the peak table,
    the device report, block_until_ready timing, and the compile-cache
    placement."""

    def test_peak_table_known_kind(self):
        from eigenex_tpu.utils.benchtime import device_peaks

        pk = device_peaks("NVIDIA H100 80GB HBM3")
        assert pk["hbm_bytes_per_s"] == 3.35e12 and pk["bf16_flops_per_s"] == 989e12
        assert pk["source"]

    def test_peak_table_unknown_kind_is_an_error(self):
        from eigenex_tpu.utils.benchtime import device_peaks

        with pytest.raises(KeyError):
            device_peaks("cpu")

    def test_device_report_refuses_cpu(self):
        from eigenex_tpu.utils.benchtime import device_report

        with pytest.raises(RuntimeError, match="no GPU"):
            device_report()

    def test_timed_median_blocks_and_counts(self):
        import jax.numpy as jnp

        from eigenex_tpu.utils.benchtime import timed_median

        calls = []
        med, ts = timed_median(lambda: calls.append(1) or jnp.ones(8) * 2, reps=4, warmup=2)
        assert len(calls) == 6 and len(ts) == 4 and med > 0

    def test_compile_cache_from_environment(self, monkeypatch, tmp_path):
        import jax

        from eigenex_tpu.utils.benchtime import configure_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        assert configure_compile_cache(str(tmp_path)) == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == before  # nothing set in code

    def test_compile_cache_default_under_root(self, monkeypatch, tmp_path):
        import jax

        from eigenex_tpu.utils.benchtime import configure_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = configure_compile_cache(str(tmp_path))
            assert path == str(tmp_path / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
