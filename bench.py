"""Benchmark: block-sparse SpMV throughput (nnz/s) on one GPU.

Prints ONE JSON line:
  {"metric": "spmv_nnz_per_s", "value": N, "unit": "nnz/s", "vs_baseline": N,
   "route": ..., "roofline_frac": F, "device": {...}}

- Matrix: symmetric block-tridiagonal BSR with dense 128x128 blocks
  (the block-sparse Hamiltonian shape of BASELINE.json), bf16 storage.
- Routes timed: the half-traffic symmetric kernel and the general BSR
  XLA gather + einsum (``--full`` adds f32 storage); the best sustained
  rate is reported.  A time is the median over repeated chains of
  normalized matvecs in one jitted call, waited for with
  ``block_until_ready``.
- roofline_frac: bytes the route must move per matvec over the time,
  divided by the device's published HBM bandwidth
  (:data:`eigenex_tpu.utils.benchtime.PEAKS`; an unknown device is an
  error).
- vs_baseline: ratio against the reference algorithm's cost model — a
  serial COO scatter SpMV (triplets_matrix.hpp:314-318), measured here
  with the same semantics (np.add.at scatter loop) on this host's CPU
  and scaled to the benchmark nnz.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def banded_block_bsr(nbr: int, bm: int, dtype=np.float32, seed: int = 0):
    import jax.numpy as jnp

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


def serial_scatter_baseline(nnz_sample: int = 2_000_000) -> float:
    """Reference cost model: serial COO scatter out[row] += in[col]*v
    (triplets_matrix.hpp:314-318) on the host CPU.  Returns nnz/s."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    rows = rng.integers(0, n, nnz_sample).astype(np.int64)
    cols = rng.integers(0, n, nnz_sample).astype(np.int64)
    vals = rng.standard_normal(nnz_sample)
    x = rng.standard_normal(n)
    out = np.zeros(n)
    t0 = time.perf_counter()
    np.add.at(out, rows, vals * x[cols])
    dt = time.perf_counter() - t0
    return nnz_sample / dt


def main():
    full = "--full" in sys.argv
    sys.path.insert(0, ROOT)
    from eigenex_tpu.utils.benchtime import (
        chain_seconds,
        configure_compile_cache,
        device_peaks,
        device_report,
    )

    configure_compile_cache(ROOT)
    device = device_report()
    peak_bw = device_peaks(device["kind"])["hbm_bytes_per_s"]

    import jax.numpy as jnp

    from eigenex_tpu.ops.pallas_spmv import sym_bsr_matvec_pallas
    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

    # ~100M true nonzeros: 2048 block rows x ~3 dense 128x128 blocks
    # (symmetric block-tridiagonal — the Hermitian Lanczos matvec case)
    nbr, bm = 2048, 128
    bsr = banded_block_bsr(nbr, bm)
    nnz = int(np.count_nonzero(np.asarray(bsr.data)))
    n = bsr.shape[0]
    x = jnp.asarray(np.random.default_rng(1).standard_normal(n).astype(np.float32))

    dtypes = (jnp.bfloat16, jnp.float32) if full else (jnp.bfloat16,)
    rates, path_bytes = {}, {}
    for dt in dtypes:
        name = jnp.dtype(dt).name
        b = bsr.astype(dt)
        sym = sym_bsr_from_bsr(bsr).astype(dt)
        # the symmetric kernel reads each stored block once; the general
        # route reads every block of full storage once
        routes = {
            f"sym kernel {name}": (
                sym_bsr_matvec_pallas, sym,
                (sym.diag_data.size + sym.upper_data.size) * sym.upper_data.dtype.itemsize,
            ),
            f"bsr xla {name}": (
                lambda b, v: b.matvec(v), b, b.data.size * b.data.dtype.itemsize,
            ),
        }
        ref = np.asarray(b.astype(jnp.float32).matvec(x))
        for route, (fn, op, block_bytes) in routes.items():
            y = np.asarray(fn(op, x))
            err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
            if err > 1e-5:
                raise AssertionError(f"{route}: rel err {err:.2e} against the f32 XLA matvec")
            rates[route] = nnz / chain_seconds(fn, op, x)
            path_bytes[route] = block_bytes + 2 * n * 4

    best = max(rates, key=rates.get)
    baseline = serial_scatter_baseline()

    def roofline(route):
        return path_bytes[route] * rates[route] / nnz / peak_bw

    print(
        "# "
        + ", ".join(
            f"{k}: {v / 1e9:.2f} Gnnz/s ({roofline(k) * 100:.0f}% of HBM peak)"
            for k, v in rates.items()
        )
        + f"; serial-scatter baseline: {baseline / 1e6:.1f} Mnnz/s; {device['nvidia_smi']}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "spmv_nnz_per_s",
                "value": rates[best],
                "unit": "nnz/s",
                "vs_baseline": rates[best] / baseline,
                "route": best,
                "roofline_frac": round(roofline(best), 3),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
