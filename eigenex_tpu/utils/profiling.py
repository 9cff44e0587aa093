"""Profiling hooks.

The reference has no tracing/profiling at all (SURVEY.md §5); this
library hooks into ``jax.profiler``: :func:`profile_trace` wraps a code
region in a TensorBoard-compatible device trace, :func:`annotate` names
host regions so they line up with the XLA timeline (the solver chunk
bodies carry ``jax.named_scope`` labels: ``lanczos/matvec``,
``lanczos/reorth`` …), and :class:`PhaseTimer` gives cheap host-side
per-phase wall-clock accounting for the convergence loop.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

__all__ = ["profile_trace", "annotate", "PhaseTimer"]


@contextlib.contextmanager
def profile_trace(log_dir: str, host_tracer_level: int = 2):
    """Capture a device+host profile into ``log_dir`` (view with
    TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in profiler timelines; usable as context
    manager or decorator."""
    return jax.profiler.TraceAnnotation(name)


class PhaseTimer:
    """Accumulate wall-clock per named phase (host side).

    >>> t = PhaseTimer()
    >>> with t("matvec"): ...
    >>> t.summary()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> str:
        lines = []
        for phase in sorted(self.totals, key=lambda p: -self.totals[p]):
            tot, n = self.totals[phase], self.counts[phase]
            lines.append(f"{phase:24s} {tot:9.4f}s  x{n:<6d} {tot/max(n,1)*1e3:9.3f} ms/call")
        return "\n".join(lines)
