"""BASELINE config 3 at scale: Heisenberg spin-chain ground state.

Builds the total-Sz=0 sector of an L-site XXZ chain with the native C++
enumerator (dim C(L, L/2); L=24 → 2.7M states, ~35M nonzeros), then runs
f32 Lanczos on the GPU and polishes the energy on host in f64.

The device operator rides the ACCELERATED path by default — RCM reorder
+ 128x128 symmetric (diag+upper) block pack + the symmetric GPU kernel
(sparse/accelerate.py).  The couplings (±J/2, ±Jz/4) are dyadic, so
bf16 block storage is bitwise lossless and is auto-selected.
``--no-accelerate`` runs the scalar COO path for comparison;
``--spmv-reps`` also times the SpMV alone (median of N jitted chains,
waited for with ``block_until_ready``).

For L ≤ 14 the energy is cross-checked against dense diagonalization;
at larger L correctness is certified by the f64 residual of the refined
pair.

Usage: python benchmarks/bench_heisenberg.py [--L 24] [--no-accelerate]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=24)
    ap.add_argument("--no-accelerate", action="store_true")
    ap.add_argument("--spmv-reps", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()
    L = args.L

    import jax

    sys.path.insert(0, ROOT)
    from eigenex_tpu.utils.benchtime import configure_compile_cache, device_report

    configure_compile_cache(ROOT)
    device = device_report()
    from eigenex_tpu import native
    from eigenex_tpu.solvers.api import eigsh
    from eigenex_tpu.solvers.refine import rayleigh_refine
    from eigenex_tpu.sparse.coo import COOMatrix

    t0 = time.time()
    r, c, v, dim = native.heisenberg_sector(L, L // 2, 1.0, 1.0, False)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    t_build = time.time() - t0
    print(
        f"# L={L} sector dim={dim:,} nnz={len(v):,} built in {t_build:.1f}s (native)",
        file=sys.stderr,
    )

    # f64 triplets stay on host for refinement
    coo64 = COOMatrix(r.astype(np.int32), c.astype(np.int32), v, (dim, dim))

    spmv_rate = None
    if args.no_accelerate:
        import jax.numpy as jnp

        coo32 = COOMatrix(
            jnp.asarray(r.astype(np.int32)),
            jnp.asarray(c.astype(np.int32)),
            jnp.asarray(v.astype(np.float32)),
            (dim, dim),
        )
        operand = coo32
        op_for_spmv = coo32.as_linear_operator()
        mode = "coo_segment_sum"
    else:
        from eigenex_tpu.sparse.accelerate import accelerate

        t0 = time.time()
        operand = accelerate((r, c, v, (dim, dim)), symmetric=True)
        st = operand.stats
        print(
            f"# accelerate: pack {st['pack_seconds']:.1f}s dtype={st['dtype']} "
            f"fill={st['fill']*100:.2f}% slots={st['slots']/1e6:.0f}M "
            f"({st['bytes']/2**30:.2f} GiB) bw {st['bandwidth_before']:,} -> "
            f"{st['bandwidth_after']:,} ku={st.get('ku')} reach={st.get('band_reach')}",
            file=sys.stderr,
        )
        op_for_spmv = operand.as_linear_operator()
        mode = f"accelerated_sym_{st['dtype']}"

    if args.spmv_reps:
        import jax.numpy as jnp

        from eigenex_tpu.utils.benchtime import chain_seconds

        x = jnp.asarray(np.random.default_rng(0).standard_normal(dim), jnp.float32)
        if op_for_spmv.shape[1] != dim:
            x = operand.embed(np.asarray(x))
        per = chain_seconds(op_for_spmv._matvec_fn, op_for_spmv._params, x, k=64, reps=args.spmv_reps)
        spmv_rate = len(v) / per / 1e9
        print(
            f"# device SpMV ({mode}): {per*1e3:.3f} ms/matvec = {spmv_rate:.2f} Gnnz/s "
            f"(median of {args.spmv_reps} chains of 64)",
            file=sys.stderr,
        )

    t0 = time.time()
    res = eigsh(operand, k=1, which="SA", tol=args.tol, max_subspace=160)
    t_cold = time.time() - t0
    print(
        f"# f32 Lanczos on {jax.default_backend()} (cold, incl. compile): "
        f"{res.iterations} iters in {t_cold:.1f}s ({res.termination})",
        file=sys.stderr,
    )
    t0 = time.time()
    res = eigsh(operand, k=1, which="SA", tol=args.tol, max_subspace=160)
    t_solve = time.time() - t0
    e32 = float(res.eigenvalues[0])
    print(
        f"# f32 Lanczos on {jax.default_backend()} (warm): {res.iterations} iters in "
        f"{t_solve:.1f}s -> E0={e32:.8f} ({res.termination})",
        file=sys.stderr,
    )

    t0 = time.time()
    vecs = np.asarray(res.eigenvectors)
    lam, resid = rayleigh_refine(coo64, vecs)
    t_ref = time.time() - t0
    print(
        f"# f64 Rayleigh: E0={lam[0]:.12f} (residual {resid[0]:.2e}) in {t_ref:.1f}s",
        file=sys.stderr,
    )

    if L <= 14:
        ref = float(np.linalg.eigvalsh(coo64.to_dense()).min())
        print(f"# dense oracle: {ref:.12f} |err|={abs(lam[0]-ref):.2e}", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "heisenberg_ground_state",
                "L": L,
                "sector_dim": dim,
                "nnz": len(v),
                "mode": mode,
                "energy_f64": lam[0],
                "residual": float(resid[0]),
                "iterations": res.iterations,
                "solve_seconds": t_solve,
                "solve_seconds_cold": t_cold,
                "iters_per_s": res.iterations / t_solve,
                "spmv_gnnz_per_s": spmv_rate,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
