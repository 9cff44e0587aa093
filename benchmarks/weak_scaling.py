"""Weak-scaling harness: distributed Lanczos nnz/s vs device count.

BASELINE.json north star: ">70% weak-scaling nnz/s efficiency on a
10^8-row block-sparse Hamiltonian".  Per-device problem size is held
constant while the mesh grows; efficiency = (nnz/s at d devices) /
(d × nnz/s at 1 device).  One process drives every device of the host
(four cards: ``--devices 1 2 4``).  A time is the median of jitted
chunks of Lanczos steps, waited for with ``block_until_ready``; every
output line names the device.

Usage:  python benchmarks/weak_scaling.py [--devices 1 2 4]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--block-rows-per-device", type=int, default=256)
    ap.add_argument("--bm", type=int, default=128)
    ap.add_argument("--mode", choices=["allgather", "halo", "colsplit", "sym_halo"], default="halo")
    args = ap.parse_args()

    import numpy as np
    import jax

    sys.path.insert(0, ROOT)
    from bench import banded_block_bsr
    from eigenex_tpu.parallel import make_mesh, pad_bsr_for_mesh
    from eigenex_tpu.parallel.distributed import distributed_lanczos_steps
    from eigenex_tpu.solvers.lanczos import init_lanczos_state
    from eigenex_tpu.utils.benchtime import (
        configure_compile_cache,
        device_report,
        timed_median,
    )

    configure_compile_cache(ROOT)
    device = device_report()
    devices = jax.devices()
    counts = args.devices or sorted({d for d in (1, 2, 4, 8) if d <= len(devices)})
    m, steps = 32, 16  # Krylov subspace and steps per timed chunk
    results = {}
    for d in counts:
        nbr = args.block_rows_per_device * d
        bsr = pad_bsr_for_mesh(banded_block_bsr(nbr, args.bm), d)
        nnz = int(np.count_nonzero(np.asarray(bsr.data)))
        mesh = make_mesh(d, devices=devices[:d])
        s0 = init_lanczos_state(bsr.as_linear_operator(), m, seed=0)
        t, _ = timed_median(
            lambda: distributed_lanczos_steps(bsr, s0, steps, mesh, matvec_mode=args.mode).V,
            reps=5,
        )
        per_iter = t / steps
        results[d] = nnz / per_iter
        eff = results[d] / (d * results[counts[0]] / counts[0])
        print(
            json.dumps(
                {
                    "devices": d,
                    "n": bsr.shape[0],
                    "nnz": nnz,
                    "lanczos_iter_ms": per_iter * 1e3,
                    "nnz_per_s": results[d],
                    "weak_scaling_efficiency": eff,
                    "mode": args.mode,
                    "device": device,
                }
            )
        )


if __name__ == "__main__":
    main()
