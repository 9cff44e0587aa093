"""Benchmark measurement helpers shared by ``chip_smoke.py``,
``bench.py`` and ``benchmarks/*``.

- :data:`PEAKS`: published peaks keyed by JAX's ``device_kind``, with
  their source.  A device missing from the table is an error, never a
  default (:func:`device_peaks`).
- :func:`device_report`: what every benchmark output names — platform,
  device kind, device count, and the card's name and power limit as
  ``nvidia-smi`` reports them (read by a child process that stays off
  JAX).  A run that finds no accelerator fails here.
- :func:`timed_median`: host clock around calls that end in
  ``block_until_ready``; :func:`chain_seconds`: seconds per operator
  application from a jitted chain of them.
- :func:`configure_compile_cache`: where the persistent compile cache
  lives.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np

__all__ = [
    "PEAKS",
    "chain_seconds",
    "configure_compile_cache",
    "device_peaks",
    "device_report",
    "timed_median",
]

#: device_kind → published peaks (dense rates, no sparsity).  H100 SXM:
#: NVIDIA H100 Tensor Core GPU data sheet, at the 700 W power limit — a
#: card set below it cannot hold these rates under load, so every report
#: carries the card's power limit beside its numbers.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_bytes_per_s=3.35e12,
        bf16_flops_per_s=989e12,
        source="NVIDIA H100 SXM data sheet",
    ),
}


def device_peaks(kind: str | None = None) -> dict:
    """Peaks of ``kind`` (default: the first JAX device's kind)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; add it to PEAKS")
    return PEAKS[kind]


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_report() -> dict:
    """Platform, kind and count of the JAX devices plus ``nvidia-smi``'s
    name and power limit.  Raises unless JAX's default devices are GPUs
    of a kind in :data:`PEAKS`: a measurement that finds no accelerator
    does not fall back to the CPU, and one on an unknown card assumes no
    peaks."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devices[0].platform!r}"
        )
    device_peaks(devices[0].device_kind)
    return dict(
        platform=devices[0].platform,
        kind=devices[0].device_kind,
        count=len(devices),
        nvidia_smi=_nvidia_smi(),
    )


def timed_median(fn, reps: int = 10, warmup: int = 1):
    """(median_seconds, all_samples) of ``fn()``, each call waited for
    with ``block_until_ready`` on its result."""
    import jax

    for _ in range(int(warmup)):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(int(reps)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def chain_seconds(apply, params, x, k: int = 32, reps: int = 5) -> float:
    """Median seconds per ``apply(params, v)`` over ``reps`` jitted chains
    of ``k`` normalized applications (the Krylov access pattern: one
    dispatch, each application consuming the last)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(p, v):
        def body(_, v):
            y = apply(p, v)
            return (y / jnp.linalg.norm(y)).astype(v.dtype)

        return jax.lax.fori_loop(0, k, body, v)

    t, _ = timed_median(lambda: chain(params, x), reps=reps)
    return t / k


def configure_compile_cache(root: str) -> str:
    """Persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when it is
    set (JAX reads it; nothing else is set here), else the fixed
    ``<root>/.jax_cache``, which ``.gitignore`` lists.  Returns the
    directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
