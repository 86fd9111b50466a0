"""Complex AWGN channel.

Batched JAX replacement for comm.AWGNChannel in SNR mode with unit signal
power (plot_BLER_vs_SNR.m:50,105): total complex noise variance
sigma^2 = 10^(-EsN0_dB/10), split evenly between I and Q.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def esn0_to_variance(esn0_db) -> jax.Array:
    """Total complex noise variance for a given Es/N0 in dB
    (plot_BLER_vs_SNR.m:106: Variance = 1/10^(EsN0/10))."""
    return 10.0 ** (-jnp.asarray(esn0_db, jnp.float32) / 10.0)


def awgn(key: jax.Array, tx: jax.Array, noise_var) -> jax.Array:
    """Add circular complex Gaussian noise with the given total variance."""
    kr, ki = jax.random.split(key)
    std = jnp.sqrt(jnp.asarray(noise_var, jnp.float32) / 2.0)
    n = jax.random.normal(kr, tx.shape) + 1j * jax.random.normal(ki, tx.shape)
    return tx + std.astype(jnp.complex64) * n.astype(jnp.complex64)
