"""Profiling helpers.

The reference has no profiling at all (SURVEY.md section 5).  Here:

- ``trace(path)``: context manager around jax.profiler for XProf traces of
  the jitted sim step (view with tensorboard / xprof); by default written
  to ``<checkout>/chiprun_out/trace`` (git-ignored).
- ``slope_time(f, x)``: per-call device time of a jitted function measured
  by chaining K calls inside one jit and fetching a scalar, so fixed
  per-dispatch and transfer costs cancel out of the slope.
"""
from __future__ import annotations

import contextlib
import os
import time
from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_TRACE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "chiprun_out", "trace")
)


@contextlib.contextmanager
def trace(path: str = DEFAULT_TRACE_DIR):
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


def slope_time(f, x, k_lo: int = 2, k_hi: int = 18, reps: int = 5) -> float:
    """Per-call seconds of ``f(x)`` (f must map an array to a pytree)."""

    def chained(x, k):
        def body(i, acc):
            y = f(x + acc * 1e-30)
            leaf = jax.tree_util.tree_leaves(y)[0]
            return acc + jnp.sum(leaf).astype(jnp.float32) * 1e-30

        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    lo = jax.jit(partial(chained, k=k_lo))
    hi = jax.jit(partial(chained, k=k_hi))
    float(lo(x))
    float(hi(x))  # compile both

    def best(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(x))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return (best(hi) - best(lo)) / (k_hi - k_lo)
