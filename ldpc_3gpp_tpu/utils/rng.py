"""PRNG helpers for Monte-Carlo throughput.

JAX's default threefry2x32 generator is bit-reproducible across backends but
is a long chain of integer ops per output word.  Monte-Carlo noise only needs
statistical quality, not cross-backend bit-reproducibility, so the sweep
drivers and the benchmark draw from the hardware-friendly ``rbg``
implementation (XLA RngBitGenerator, Philox-based) instead.

Runs remain deterministic for a fixed (seed, device count, batch size) — the
reference's reproducibility contract (plot_BLER_vs_SNR.m:45 ``rng(seed)``) —
they just produce a different (equally valid) sample stream than threefry.
Pass an ordinary ``jax.random.PRNGKey`` anywhere instead to get the slower
bit-portable stream; every kernel is impl-agnostic.
"""
from __future__ import annotations

import jax


def fast_key(seed: int) -> jax.Array:
    """Monte-Carlo PRNG key: hardware ``rbg`` stream seeded by ``seed``."""
    return jax.random.key(seed, impl="rbg")
