"""Large-scale single-card run: multi-GB block-sparse operators.

Validates the device-memory-scale regime of BASELINE config 5 on one
card: an n ≈ 8.4M-row block-tridiagonal operator (~3.2G padded nonzeros,
6.4 GB bf16) on the general BSR route, and a 16.8M-row symmetric
half-traffic operator in the same footprint on the symmetric route, each
timed as SpMV, SpMM (p=8) and full Lanczos steps.  A time is the median
of a jitted chain of applications, waited for with ``block_until_ready``.
The same operators row-partition over several cards via
eigenex_tpu.parallel.

Prints one JSON line naming the device.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lanczos_ms(op, steps: int = 10) -> float:
    from eigenex_tpu.solvers.lanczos import init_lanczos_state, lanczos_steps
    from eigenex_tpu.utils.benchtime import timed_median

    s0 = init_lanczos_state(op, 32, seed=0)
    t, _ = timed_median(lambda: lanczos_steps(op, s0, steps).V, reps=3)
    return t / steps * 1e3


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from eigenex_tpu.sparse.bsr import BSRMatrix
    from eigenex_tpu.sparse.sym_bsr import SymBSRMatrix
    from eigenex_tpu.utils.benchtime import (
        chain_seconds,
        configure_compile_cache,
        device_report,
    )

    configure_compile_cache(ROOT)
    device = device_report()
    out = {"metric": "large_scale_spmv_nnz_per_s", "unit": "nnz/s", "device": device}

    nbr, bm, kmax = 65536, 128, 3
    n = nbr * bm
    # built on device directly to avoid a 12 GB host array
    data = jax.random.normal(jax.random.PRNGKey(0), (nbr, kmax, bm, bm), jnp.bfloat16)
    r = jnp.arange(nbr, dtype=jnp.int32)
    cols = jnp.stack([r, jnp.maximum(r - 1, 0), jnp.minimum(r + 1, nbr - 1)], axis=1)
    bsr = BSRMatrix(data, cols, (n, n))
    nnz = nbr * kmax * bm * bm
    x = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
    per = chain_seconds(lambda b, v: b.matvec(v), bsr, x, k=20)
    out.update(value=nnz / per, n_rows=n, device_gb=nnz * 2 / 1e9)
    out["lanczos_iter_ms"] = lanczos_ms(bsr.as_linear_operator())
    print(
        f"# BSR SpMV n={n:,}: {per * 1e3:.2f} ms ({nnz / per / 1e9:.1f} Gnnz/s, "
        f"{nnz * 2 / per / 1e9:.0f} GB/s); Lanczos {out['lanczos_iter_ms']:.2f} ms/iter",
        file=sys.stderr,
    )
    del bsr, data, cols

    # symmetric storage: 2x the rows in the same footprint (diag + one
    # upper off-diagonal per block row; each upper block applies to both
    # triangles)
    nbr_s = 2 * nbr
    n_s = nbr_s * bm
    diag = jax.random.normal(jax.random.PRNGKey(2), (nbr_s, bm, bm), jnp.bfloat16)
    upper = jax.random.normal(jax.random.PRNGKey(3), (nbr_s, 1, bm, bm), jnp.bfloat16)
    upper = upper.at[-1].set(0)  # last block row: padding slot (col 0)
    ucols = jnp.concatenate([jnp.arange(1, nbr_s, dtype=jnp.int32), jnp.zeros(1, jnp.int32)])
    sym = SymBSRMatrix(diag, upper, ucols[:, None], (n_s, n_s), band_reach=1)
    nnz_eff = sym.nnz_applied
    op = sym.as_linear_operator()
    xs = jax.random.normal(jax.random.PRNGKey(4), (n_s,), jnp.float32)
    per_s = chain_seconds(op._matvec_fn, sym, xs, k=20)
    Xs = jax.random.normal(jax.random.PRNGKey(5), (n_s, 8), jnp.float32)
    per_mm = chain_seconds(op._matmat_fn, sym, Xs, k=8)
    out.update(
        sym_n_rows=n_s,
        sym_effective_nnz_per_s=nnz_eff / per_s,
        sym_spmm_p8_eff_nnz_per_s=nnz_eff / per_mm,
        sym_lanczos_iter_ms=lanczos_ms(op),
    )
    print(
        f"# sym SpMV n={n_s:,}: {per_s * 1e3:.2f} ms ({nnz_eff / per_s / 1e9:.1f} effective "
        f"Gnnz/s); SpMM p=8: {per_mm * 1e3:.2f} ms; Lanczos "
        f"{out['sym_lanczos_iter_ms']:.2f} ms/iter; {device['nvidia_smi']}",
        file=sys.stderr,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
