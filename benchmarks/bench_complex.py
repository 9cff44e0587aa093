"""Complex Hermitian at scale: the sample_lanczos2 operator class at n >= 1M.

The reference's flagship complex sample is an n=200 Hermitian operator
with imaginary off-diagonals driven through the full solver surface
(/root/reference/src/samples/sample_lanczos2.cpp:13-57).  This bench
runs that operator CLASS at n = 2^20: a complex Hermitian hopping chain
(random-phase nearest + next-nearest hops, real on-site terms) through

  realify -> RCM -> 128x128 symmetric diag+upper pack -> the
  symmetric GPU kernel  (all via sparse.accelerate)

and measures (a) the on-device complex SpMV rate, (b) the SAME-STRUCTURE
real operator for the "within 2x of the real sym path" criterion
(round-3 verdict item 2), and (c) a ground-state eigsh solve with f64
Rayleigh certification on host.

Usage: python benchmarks/bench_complex.py [--n 1048576] [--reps 5]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_complex_hopping(n, seed=0):
    """Complex Hermitian hopping chain: H[i,i] real; H[i,i+1], H[i,i+2]
    random-phase unit hops (conjugate mirrors implied).  Returns the full
    (both-triangle) triplets."""
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal(n)
    t1 = np.exp(1j * rng.uniform(0, 2 * np.pi, n - 1))
    t2 = 0.5 * np.exp(1j * rng.uniform(0, 2 * np.pi, n - 2))
    rows = [np.arange(n), np.arange(n - 1), np.arange(1, n), np.arange(n - 2), np.arange(2, n)]
    cols = [np.arange(n), np.arange(1, n), np.arange(n - 1), np.arange(2, n), np.arange(n - 2)]
    vals = [diag.astype(complex), t1, np.conj(t1), t2, np.conj(t2)]
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
    )


def chain_rate(op, nnz, reps, label):
    """(seconds per matvec, Gnnz/s) of ``op`` from jitted chains."""
    import jax.numpy as jnp

    from eigenex_tpu.utils.benchtime import chain_seconds

    x = jnp.asarray(np.random.default_rng(0).standard_normal(op.shape[1]), jnp.float32)
    per = chain_seconds(op._matvec_fn, op._params, x, k=64, reps=reps)
    rate = nnz / per / 1e9
    print(f"# {label}: {per*1e3:.3f} ms/matvec = {rate:.2f} Gnnz/s", file=sys.stderr)
    return per, rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--solve", action="store_true", help="also run eigsh ground state")
    args = ap.parse_args()
    n = args.n

    sys.path.insert(0, ROOT)
    from eigenex_tpu.sparse.accelerate import accelerate
    from eigenex_tpu.utils.benchtime import configure_compile_cache, device_report

    configure_compile_cache(ROOT)
    device = device_report()

    r, c, v = build_complex_hopping(n)
    cnnz = len(v)
    print(f"# complex Hermitian hopping chain: n={n:,} complex nnz={cnnz:,}", file=sys.stderr)

    t0 = time.time()
    acc = accelerate((r, c, v, (n, n)), symmetric=True)
    st = acc.stats
    print(
        f"# complex accelerate: pack {st['pack_seconds']:.1f}s dtype={st['dtype']} "
        f"fill={st['fill']*100:.2f}% ({st['bytes']/2**30:.2f} GiB) "
        f"bw {st['bandwidth_before']:,} -> {st['bandwidth_after']:,} "
        f"ku={st.get('ku')} reach={st.get('band_reach')}",
        file=sys.stderr,
    )
    assert acc.complexified and acc.symmetric

    # same-structure REAL operator: |values| on the same pattern
    r2, c2, v2 = r, c, np.where(r == c, v.real, np.abs(v))
    accR = accelerate((r2, c2, v2.astype(np.float64), (n, n)), symmetric=True)
    stR = accR.stats
    print(
        f"# real twin accelerate: dtype={stR['dtype']} fill={stR['fill']*100:.2f}% "
        f"({stR['bytes']/2**30:.2f} GiB)",
        file=sys.stderr,
    )

    per_c, rate_c = chain_rate(
        acc.as_linear_operator(), cnnz, args.reps, "complex (realified sym route)"
    )
    per_r, rate_r = chain_rate(
        accR.as_linear_operator(), cnnz, args.reps, "real same-structure"
    )
    print(
        f"# complex/real time ratio: {per_c/per_r:.2f}x "
        f"(criterion: within 2x of the real sym path)",
        file=sys.stderr,
    )

    solve = {}
    if args.solve:
        from eigenex_tpu.solvers.api import eigsh
        from eigenex_tpu.sparse.coo import COOMatrix

        t0 = time.time()
        res = eigsh(acc, k=1, which="SA", tol=1e-7, max_subspace=128)
        t_cold = time.time() - t0
        t0 = time.time()
        res = eigsh(acc, k=1, which="SA", tol=1e-7, max_subspace=128)
        t_warm = time.time() - t0
        zvec = res.eigenvectors[:, 0]
        lam = float(np.real(res.eigenvalues[0]))
        # f64 certification on host (scipy SpMV of the original operator)
        import scipy.sparse as sp

        A = sp.csr_matrix((v, (r, c)), shape=(n, n))
        z = zvec / np.linalg.norm(zvec)
        lam64 = float(np.real(np.vdot(z, A @ z)))
        resid = float(np.linalg.norm(A @ z - lam64 * z))
        print(
            f"# eigsh ground state: warm {t_warm:.1f}s (cold {t_cold:.1f}s), "
            f"{res.iterations} iters, E0={lam64:.10f}, f64 residual {resid:.2e}",
            file=sys.stderr,
        )
        solve = dict(
            iterations=int(res.iterations),
            solve_seconds=t_warm,
            solve_seconds_cold=t_cold,
            energy_f64=lam64,
            residual=resid,
        )

    print(
        json.dumps(
            {
                "metric": "complex_hermitian_spmv",
                "n": n,
                "complex_nnz": cnnz,
                "complex_gnnz_per_s": rate_c,
                "real_twin_gnnz_per_s": rate_r,
                "time_ratio_vs_real": per_c / per_r,
                "device": device,
                **solve,
            }
        )
    )


if __name__ == "__main__":
    main()
