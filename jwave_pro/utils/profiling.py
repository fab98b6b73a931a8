"""Profiling helpers (SURVEY §5.1 — the reference only prints nanoTime
tables from perf tests; here: samples/s measurement by chained iterations,
plus a ``jax.profiler`` trace context)."""
from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp

__all__ = ["time_chain", "measure_samples_per_sec", "trace"]


def time_chain(step, x, k_short=4, k_long=24, repeats=5):
    """Seconds per application of ``step`` (a shape-preserving fn of x).

    Times by differencing two chained-iteration lengths inside one jit: the
    chain serializes iterations through a data dependence and the
    (k_long − k_short) difference cancels dispatch and fetch overhead (the
    reference's ``System.nanoTime`` pattern,
    ``MODWTFFTPerformanceTest.java:47-152``, would measure dispatch, not
    compute, on an accelerator).  ``lax.fori_loop`` keeps compile cost
    independent of chain length.

    The per-repeat estimate is the difference of two wall timings, so a
    host stall during the SHORT run drives it toward zero (reporting an
    impossibly high throughput) — a min-over-repeats estimator latches onto
    exactly those corrupted repeats.  Robust aggregation instead: median of
    the positive per-repeat differences.
    """
    def chain(v, k):
        v = jax.lax.fori_loop(0, k, lambda i, u: step(u), v)
        return jnp.sum(v.ravel()[:16])

    short = jax.jit(lambda v: chain(v, k_short))
    long = jax.jit(lambda v: chain(v, k_long))
    float(short(x))  # compile
    float(long(x))
    diffs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(short(x))
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(long(x))
        t_l = time.perf_counter() - t0
        diffs.append((t_l - t_s) / (k_long - k_short))
    pos = sorted(d for d in diffs if d > 0)
    if not pos:  # every repeat corrupted by timing noise
        return 1e-9
    return max(pos[len(pos) // 2], 1e-9)


def measure_samples_per_sec(step, x, k_short=4, k_long=24, repeats=3):
    """Throughput of ``step`` (shape-preserving fn) in samples/s.

    Thin wrapper over :func:`time_chain` (the one chained-timing
    implementation; ``bench.py`` uses the same).
    """
    return x.size / time_chain(step, x, k_short, k_long, repeats)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/jax-trace"):
    """``jax.profiler`` trace context (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
