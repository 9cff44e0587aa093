"""Lanczos iteration-rate benchmark on one GPU.

Second headline metric of BASELINE.json ("Lanczos iterations/sec").
Measures full Lanczos steps — SpMV + three-term recurrence + masked-CGS2
full reorthogonalization against the whole preallocated basis — as the
median time of a jitted chunk of steps, waited for with
``block_until_ready``.

Prints one JSON line {"metric": "lanczos_iters_per_s", ...} naming the
device.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from bench import banded_block_bsr
    from eigenex_tpu.solvers.lanczos import init_lanczos_state, lanczos_steps
    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr
    from eigenex_tpu.utils.benchtime import (
        configure_compile_cache,
        device_report,
        timed_median,
    )

    configure_compile_cache(ROOT)
    device = device_report()
    nbr, bm, m, steps = 2048, 128, 64, 40  # n = 262144, 64-dim subspace
    bsr = banded_block_bsr(nbr, bm)
    ops = {
        "bsr_xla_f32": bsr.as_linear_operator(),
        # symmetric half-traffic storage, bf16: the GPU kernel's route
        "sym_bf16": sym_bsr_from_bsr(bsr).astype(jnp.bfloat16).as_linear_operator(),
    }

    results = {}
    for op_label, op in ops.items():
        s0 = init_lanczos_state(op, m, seed=0)
        for reorth, label in ((1, "full_reorth"), (0, "no_reorth")):
            t, _ = timed_median(
                lambda: lanczos_steps(op, s0, steps, reorthogonalize_interval=reorth).V,
                reps=5,
            )
            results[f"{op_label}/{label}"] = steps / t
            print(f"# {op_label}/{label}: {steps / t:.1f} iters/s", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "lanczos_iters_per_s",
                "value": max(results["bsr_xla_f32/full_reorth"], results["sym_bf16/full_reorth"]),
                "unit": "iters/s",
                "detail": results,
                "n": bsr.shape[0],
                "subspace": m,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
