"""General BSR block-shape sweep on the BASELINE config-2 operator —
the measurement that sets the GENERAL (nonsymmetric) BSR-ELL default
block shape; also records a host scipy/ARPACK wall clock as a
competitive baseline.

For each block shape: pack fill, slot bytes, and the device SpMV rate
(median of jitted chains, utils/benchtime).  Output names the device.

Usage: python benchmarks/sweep_general_block.py [--nx 316] [--reps 5]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

from bench_arnoldi import convection_diffusion_coo


SHAPES = [(4, 128), (8, 128), (16, 128), (32, 128), (8, 256), (16, 256)]


def parse_shapes(s: str):
    return [tuple(int(x) for x in p.split("x")) for p in s.split(",")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=316)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-scipy", action="store_true")
    ap.add_argument("--shapes", type=str, default=None,
                    help="e.g. 8x128,16x128 (default: the full sweep)")
    args = ap.parse_args()
    shapes = parse_shapes(args.shapes) if args.shapes else SHAPES

    import jax.numpy as jnp

    from eigenex_tpu.sparse.accelerate import accelerate
    from eigenex_tpu.utils.benchtime import (
        chain_seconds,
        configure_compile_cache,
        device_report,
    )

    configure_compile_cache(ROOT)
    device = device_report()

    r, c, v, n = convection_diffusion_coo(args.nx)
    nnz = len(v)
    print(f"# config-2 operator: n={n:,} nnz={nnz:,}", file=sys.stderr)

    rows = []
    for bm, bn in shapes:
        acc = accelerate(
            (r, c, v, (n, n)), symmetric=False, general_block=(bm, bn),
            dtype=jnp.float32,
        )
        st = acc.stats
        mat = acc.matrix
        op = mat.as_linear_operator()
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal(mat.shape[1]).astype(np.float32)
        )
        per = chain_seconds(lambda p, vv: p.matvec(vv), op, x, reps=args.reps)
        row = dict(
            block=[bm, bn], kmax=st["kmax"], fill=round(st["fill"], 5),
            mbytes=round(st["bytes"] / 2**20, 1),
            gnnz_per_s=round(nnz / per / 1e9, 3),
        )
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)

    if not args.skip_scipy:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        A = sp.csr_matrix((v, (r, c)), shape=(n, n))
        t0 = time.time()
        w = spla.eigs(A, k=5, which="LM", tol=1e-8, return_eigenvectors=False)
        t_scipy = time.time() - t0
        print(
            json.dumps(dict(scipy_arpack_eigs_k5_s=round(t_scipy, 2),
                            lam_max_abs=float(np.abs(w).max()))),
            file=sys.stderr,
        )

    best = max((r_ for r_ in rows if r_["gnnz_per_s"]), key=lambda r_: r_["gnnz_per_s"])
    print(json.dumps(dict(sweep=rows, best=best, device=device)))


if __name__ == "__main__":
    main()
