"""Batched GF(2) CRC attach/check as matrix products.

The reference delegates CRC to closed-source comm.CRCGenerator /
comm.CRCDetector System objects (NRLDPCEncoder.m:45-48, NRLDPCDecoder.m:113-115).
CRC over GF(2) is linear in the message, so for a fixed message length A the
checksum is ``p = (a @ T) mod 2`` with a precomputed (A, L) generator matrix
T[k] = x^(A-1-k+L) mod g(x).  That turns per-message bit-serial division into
one batched (batch, A) x (A, L) matmul — the large, batched shape an
accelerator's matrix units want.

Bit convention matches TS38.212 Section 5.1: parity bits are appended
highest-degree coefficient first, zero initial shift-register state.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.tables import CRC_LENGTHS, crc_poly_bits

# bf16 inputs are exact here: 0/1 operands are bf16-representable, products
# are 0/1, and the product accumulates in f32 (exact up to 2^24 > 8448+24).
# (Precision.HIGHEST with f32 inputs forces a 6-pass decomposition that is
# ~1000x slower for these skinny shapes.)
_IN_DTYPE = jnp.bfloat16


@functools.lru_cache(maxsize=None)
def _remainder_table(crc: str, length: int, shifted: bool) -> np.ndarray:
    """(length, L) bit matrix of x^(length-1-k+L*shifted) mod g(x).

    ``shifted=True``  -> generator matrix (message is multiplied by x^L).
    ``shifted=False`` -> detector matrix (raw remainder of the received word).
    Row k holds the remainder's coefficients [x^(L-1), ..., x^0].
    """
    L = CRC_LENGTHS[crc]
    g = crc_poly_bits(crc)  # [x^L, ..., x^0], g[0] == 1
    assert g[0] == 1
    g_low = g[1:]  # remainder feedback taps, length L

    # Iterate r_k = x^(k) mod g upward from x^0.
    max_pow = (length - 1) + (L if shifted else 0)
    powers = np.zeros((max_pow + 1, L), dtype=np.int64)  # [x^(L-1)..x^0]
    if L == 0:
        return np.zeros((length, 0), dtype=np.int64)
    powers[0, L - 1] = 1  # x^0
    for p in range(1, max_pow + 1):
        prev = powers[p - 1]
        carry = prev[0]  # coefficient of x^(L-1) about to become x^L
        shifted_bits = np.concatenate([prev[1:], [0]])
        powers[p] = (shifted_bits + carry * g_low) % 2

    offset = L if shifted else 0
    # Row k corresponds to message bit k -> power (length-1-k) + offset.
    idx = (length - 1 - np.arange(length)) + offset
    return powers[idx]


@functools.lru_cache(maxsize=None)
def _gen_matrix(crc: str, A: int) -> np.ndarray:
    # numpy on purpose: jit traces embed it as a constant (caching jnp arrays
    # created inside a trace would leak tracers).
    return _remainder_table(crc, A, shifted=True).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _det_matrix(crc: str, B: int) -> np.ndarray:
    return _remainder_table(crc, B, shifted=False).astype(np.float32)


def crc_attach(a: jax.Array, crc: str) -> jax.Array:
    """Append the TS38.212 Section 5.1 CRC to each message in the batch.

    a: (..., A) 0/1 bits -> (..., A+L).
    Replaces comm.CRCGenerator (NRLDPCEncoder.m:80-81).
    """
    L = CRC_LENGTHS[crc]
    if L == 0:
        return a
    A = a.shape[-1]
    T = jnp.asarray(_gen_matrix(crc, A), _IN_DTYPE)
    acc = jnp.matmul(a.astype(_IN_DTYPE), T, preferred_element_type=jnp.float32)
    p = jnp.mod(acc, 2.0).astype(a.dtype)
    return jnp.concatenate([a, p], axis=-1)


def crc_check(b: jax.Array, crc: str) -> jax.Array:
    """True where the CRC of each (..., B) word fails.

    Replaces comm.CRCDetector (NRLDPCDecoder.m:300, :336): returns the
    per-word error flag (remainder != 0).
    """
    L = CRC_LENGTHS[crc]
    if L == 0:
        return jnp.zeros(b.shape[:-1], dtype=bool)
    B = b.shape[-1]
    D = jnp.asarray(_det_matrix(crc, B), _IN_DTYPE)
    acc = jnp.matmul(b.astype(_IN_DTYPE), D, preferred_element_type=jnp.float32)
    rem = jnp.mod(acc, 2.0)
    return jnp.any(rem > 0.5, axis=-1)


def crc_numpy(a: np.ndarray, crc: str) -> np.ndarray:
    """Bit-serial oracle for tests: long division per TS38.212 Section 5.1."""
    L = CRC_LENGTHS[crc]
    if L == 0:
        return np.zeros(0, dtype=np.int64)
    g = crc_poly_bits(crc)
    buf = np.concatenate([np.asarray(a, dtype=np.int64), np.zeros(L, np.int64)])
    for i in range(len(a)):
        if buf[i]:
            buf[i : i + L + 1] ^= g
    return buf[-L:]
