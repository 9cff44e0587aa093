"""Rectangular accelerated svds vs the scalar COO Gram path (VERDICT r4
item 3's measurement): on a rectangular sparse operator, time one Gram
application G x = Aᴴ(A x) through

  (a) the COO segment-sum path (the scalar route svds used before), and
  (b) the bipartite-RCM + general-BSR packed container
      (``accelerate()`` → ``svds(accelerate=True)``'s operator),

each timed as the median of jitted chains of Gram applications.  Prints
one JSON line naming the device.

Usage: python benchmarks/bench_svds_rect.py [--m 400000] [--n 200000]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def banded_rect_triplets(m, n, bw, per_row, seed=0):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per_row)
    ctr = (r * n) // m
    c = ctr + rng.integers(-bw, bw, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    # shuffle so the bipartite RCM has to earn the band back
    pr, pc = rng.permutation(m), rng.permutation(n)
    return pr[r], pc[c], v, (m, n)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=400_000)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--bw", type=int, default=600)
    ap.add_argument("--per-row", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax.numpy as jnp

    from eigenex_tpu.sparse.accelerate import accelerate
    from eigenex_tpu.sparse.coo import COOMatrix
    from eigenex_tpu.utils.benchtime import (
        chain_seconds,
        configure_compile_cache,
        device_report,
    )

    configure_compile_cache(ROOT)
    device = device_report()

    r, c, v, shape = banded_rect_triplets(args.m, args.n, args.bw, args.per_row)
    nnz = len(v)
    print(f"# rectangular operator {shape[0]:,} x {shape[1]:,}, nnz {nnz:,}",
          file=sys.stderr)

    # (a) scalar COO Gram path
    coo = COOMatrix(
        jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32)),
        jnp.asarray(v.astype(np.float32)), shape,
    )
    op = coo.as_linear_operator()

    def gram_coo(p, x):
        return p.rmatvec(p.matvec(x))

    x = jnp.asarray(np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32))
    per_coo = chain_seconds(gram_coo, op, x, k=16, reps=args.reps)
    rate_coo = 2 * nnz / per_coo / 1e9
    print(f"# COO Gram: {rate_coo and round(rate_coo, 4)} Gnnz/s "
          f"(both matvecs counted)", file=sys.stderr)

    # (b) packed container (the svds(accelerate=True) operator)
    acc = accelerate((r, c, v, shape), dtype=jnp.float32)
    st = acc.stats
    print(f"# pack: {st['pack_seconds']:.1f}s fill={st['fill']*100:.2f}% "
          f"kmax={st['kmax']} bytes={st['bytes']/2**20:.0f}MB", file=sys.stderr)
    mat = acc.matrix
    opA = mat.as_linear_operator()
    opH = acc.adjoint_matrix().as_linear_operator()

    def gram_acc(p, x):
        a, h = p
        return h.matvec(a.matvec(x))

    xe = jnp.asarray(
        np.random.default_rng(2).standard_normal(mat.shape[1]).astype(np.float32)
    )
    per_acc = chain_seconds(gram_acc, (opA, opH), xe, reps=args.reps)
    rate_acc = 2 * nnz / per_acc / 1e9
    print(f"# accelerated Gram: {rate_acc and round(rate_acc, 4)} Gnnz/s",
          file=sys.stderr)

    out = dict(
        metric="rect_gram_spmv_gnnz_per_s",
        m=shape[0], n=shape[1], nnz=nnz,
        coo_gnnz_per_s=rate_coo and round(rate_coo, 4),
        accelerated_gnnz_per_s=rate_acc and round(rate_acc, 4),
        speedup=(round(rate_acc / rate_coo, 1) if rate_coo and rate_acc else None),
        fill=round(st["fill"], 5),
        device=device,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
