"""SpMM (multi-RHS) benchmark on one GPU — the block-Lanczos feed.

At p≈8 RHS columns the matmat is still bound by block bytes, so the
symmetric half-traffic layout can win up to 2× — but only through the
GPU kernel, which reads each stored block once; the XLA formulation of
symmetric storage reads every upper block twice and scatter-adds.

Routes timed (same operator; Gnnz/s = full applied nnz / s):
  - bsr xla bf16/f32: BSRMatrix.matmat gather + einsum
  - sym xla bf16:     SymBSRMatrix._xla_matmat
  - sym kernel bf16/f32: sym_bsr_matmat_pallas

A time is the median of a jitted chain of normalized matmats, waited for
with ``block_until_ready``.  Prints one JSON line naming the device.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = 16


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from bench import banded_block_bsr
    from eigenex_tpu.ops.pallas_spmv import sym_bsr_matmat_pallas
    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr
    from eigenex_tpu.utils.benchtime import (
        configure_compile_cache,
        device_report,
        timed_median,
    )

    configure_compile_cache(ROOT)
    device = device_report()
    nbr, bm, p = 1536, 128, 8
    bsr = banded_block_bsr(nbr, bm)
    nnz = int(np.count_nonzero(np.asarray(bsr.data)))
    sym = sym_bsr_from_bsr(bsr)
    bsr16, sym16 = bsr.astype(jnp.bfloat16), sym.astype(jnp.bfloat16)
    X = jnp.asarray(np.random.default_rng(0).standard_normal((bsr.shape[0], p)), jnp.float32)

    routes = {
        "sym kernel bf16": (sym_bsr_matmat_pallas, sym16),
        "sym kernel f32": (sym_bsr_matmat_pallas, sym),
        "bsr xla bf16": (lambda b, v: b.matmat(v), bsr16),
        "bsr xla f32": (lambda b, v: b.matmat(v), bsr),
        "sym xla bf16": (lambda s, v: s._xla_matmat(v), sym16),
    }
    ref = np.asarray(bsr16.astype(jnp.float32).matmat(X))
    rates = {}
    for label, (fn, A) in routes.items():
        got = np.asarray(fn(A, X))
        want = ref if "bf16" in label else np.asarray(bsr.matmat(X))
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        if err > 1e-5:
            raise AssertionError(f"{label}: rel err {err:.2e}")

        @jax.jit
        def chain(A, V, fn=fn):
            def body(_, V):
                Y = fn(A, V)
                return Y / jnp.linalg.norm(Y)

            return jax.lax.fori_loop(0, CHAIN, body, V)

        t, _ = timed_median(lambda: chain(A, X), reps=5)
        rates[label] = nnz / (t / CHAIN)
        print(f"# {label}: {rates[label] / 1e9:.1f} Gnnz/s", file=sys.stderr, flush=True)

    best = max(rates, key=rates.get)
    print(
        json.dumps(
            {
                "metric": "spmm_nnz_per_s",
                "value": rates[best],
                "unit": "nnz/s",
                "p": p,
                "n": bsr.shape[0],
                "best_route": best,
                "vs_bsr_xla": rates[best] / rates["bsr xla bf16"],
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
