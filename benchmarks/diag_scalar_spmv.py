"""Diagnostic: how fast is the config-3 COO path, and which scalar-sparse
formulation is fastest on the device it runs on?

Candidates, all computing y = A @ x for the Heisenberg sector operator:
  coo_segsum   : val * x[col] gather + sorted segment_sum   (current path)
  ell_gather   : (n, kmax) ELL - per-slot gathers + sum over k
  ell_onego    : x[cols] one (n*kmax,) gather, reshape, sum
  csr_scipy    : host scipy CSR (sanity/oracle + host roofline)

Timing protocol: jit + block_until_ready, 1 warmup, median of N reps,
plus a fori_loop-of-8 variant to separate dispatch latency from compute.

Usage: python benchmarks/diag_scalar_spmv.py [--L 20] [--reps 5]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timeit(fn, reps):
    fn()  # warmup/compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from eigenex_tpu import native

    t0 = time.time()
    r, c, v, dim = native.heisenberg_sector(args.L, args.L // 2, 1.0, 1.0, False)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    nnz = len(v)
    print(f"# L={args.L} dim={dim:,} nnz={nnz:,} built in {time.time()-t0:.1f}s",
          file=sys.stderr)
    deg = np.bincount(r, minlength=dim)
    print(f"# row degree: min={deg.min()} max={deg.max()} mean={deg.mean():.1f}",
          file=sys.stderr)
    # column span per 8-row strip (RCM-free): how banded is the raw order?
    span8 = []
    idx = np.searchsorted(r, np.arange(0, dim, 8))
    for i in range(len(idx) - 1):
        lo, hi = idx[i], idx[i + 1]
        if hi > lo:
            cs = c[lo:hi]
            span8.append(cs.max() - cs.min())
    span8 = np.array(span8)
    print(f"# per-8-row col span: median={np.median(span8):,.0f} "
          f"p90={np.percentile(span8, 90):,.0f} max={span8.max():,} (n={dim:,})",
          file=sys.stderr)

    x = np.random.default_rng(0).standard_normal(dim).astype(np.float32)
    xd = jnp.asarray(x)
    v32 = v.astype(np.float32)

    # oracle
    import scipy.sparse as sp
    A = sp.csr_matrix((v32, (r, c)), shape=(dim, dim))
    t0 = time.perf_counter()
    y_ref = A @ x
    t_scipy = time.perf_counter() - t0
    print(f"# scipy CSR host: {t_scipy*1e3:.1f} ms = {nnz/t_scipy/1e9:.2f} Gnnz/s",
          file=sys.stderr)

    rows_d = jnp.asarray(r.astype(np.int32))
    cols_d = jnp.asarray(c.astype(np.int32))
    vals_d = jnp.asarray(v32)

    @jax.jit
    def coo_segsum(x):
        contrib = vals_d * x[cols_d]
        return jax.ops.segment_sum(contrib, rows_d, num_segments=dim,
                                   indices_are_sorted=True)

    # ELL pack
    kmax = int(deg.max())
    ell_cols = np.zeros((dim, kmax), np.int32)
    ell_vals = np.zeros((dim, kmax), np.float32)
    slot = np.zeros(dim, np.int64)
    # r is sorted; position within row = index - row start
    row_start = np.searchsorted(r, np.arange(dim))
    pos = np.arange(nnz) - row_start[r]
    ell_cols[r, pos] = c
    ell_vals[r, pos] = v32
    ell_cols_d = jnp.asarray(ell_cols)
    ell_vals_d = jnp.asarray(ell_vals)

    @jax.jit
    def ell_gather(x):
        acc = jnp.zeros(dim, jnp.float32)
        for k in range(kmax):
            acc = acc + ell_vals_d[:, k] * x[ell_cols_d[:, k]]
        return acc

    @jax.jit
    def ell_onego(x):
        return jnp.sum(ell_vals_d * x[ell_cols_d], axis=1)

    def loop8(mv):
        @jax.jit
        def f(x):
            def body(i, acc):
                return mv(acc) * (1.0 / 16.0)  # keep finite
            return jax.lax.fori_loop(0, 8, body, x)
        return f

    results = {}
    for name, fn in [("coo_segsum", coo_segsum), ("ell_gather", ell_gather),
                     ("ell_onego", ell_onego)]:
        y = np.asarray(fn(xd))
        err = np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30)
        med, ts = timeit(lambda: fn(xd).block_until_ready(), args.reps)
        l8 = loop8(fn)
        med8, _ = timeit(lambda: l8(xd).block_until_ready(), args.reps)
        per = med8 / 8
        results[name] = (med, per)
        print(f"{name:12s}: single {med*1e3:8.2f} ms ({nnz/med/1e9:6.2f} Gnnz/s) | "
              f"loop8/8 {per*1e3:8.2f} ms ({nnz/per/1e9:6.2f} Gnnz/s) | relerr {err:.1e}")


if __name__ == "__main__":
    main()
