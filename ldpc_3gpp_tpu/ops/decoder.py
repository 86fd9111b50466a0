"""Flooding belief-propagation LDPC decoder over lifted circulant blocks.

Batched JAX replacement for comm.LDPCDecoder (NRLDPCDecoder.m:120, :265):
sum-product or normalized/offset min-sum, flooding schedule, with
parity-check-satisfied early termination.  This is the batched jax.numpy
reference implementation — the correctness oracle for the fast decoders.

Message layout: everything stays in the BASE-GRAPH edge domain.  An edge
(r, c, s) of the base graph carries a (batch, Z) block of messages; check
(r, z) connects to variable (c, (z+s) mod Z).  Per-edge rotations become two
precomputed gather index tables (variable->check and check->variable
coordinates); per-check reductions (min / sign / phi-sum) are segment ops
over the static edge->row map.

LLR convention: positive LLR => bit 0 (MATLAB comm convention; fillers are
pinned to +inf by the caller, NRLDPCDecoder.m:264).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.params import LDPCParams

_INF = 1e30
_PHI_MIN = 1e-9
_PHI_MAX = 38.0


class DecodeResult(NamedTuple):
    bits: jax.Array  # (..., num_cols*Z) hard decisions
    parity_ok: jax.Array  # (...,) True if H x = 0 at termination
    iterations: jax.Array  # (...,) iterations actually used per codeword


@functools.lru_cache(maxsize=None)
def _edge_maps(params: LDPCParams):
    """Static gather/segment tables for the edge-domain message passing."""
    rows, cols, shifts = params.edges
    Z = params.Z_c
    E = len(rows)
    z = np.arange(Z)
    # variable -> check coordinates: check (r, z) sees variable (c, (z+s)%Z)
    fwd = (z[None, :] + shifts[:, None]) % Z  # (E, Z)
    # check -> variable coordinates: variable (c, j) hears check (r, (j-s)%Z)
    bwd = (z[None, :] - shifts[:, None]) % Z  # (E, Z)
    # Flat gather index into total (..., num_cols*Z) for the forward pass.
    flat_fwd = cols[:, None] * Z + fwd
    # Pure numpy: jit traces treat these as embedded constants (caching jnp
    # arrays here would leak tracers across traces).
    return (
        rows.astype(np.int32),
        cols.astype(np.int32),
        flat_fwd.astype(np.int32),
        bwd.astype(np.int32),
        E,
    )


def _phi(x: jax.Array) -> jax.Array:
    """phi(x) = -log(tanh(x/2)), self-inverse, clamped for stability."""
    x = jnp.clip(x, _PHI_MIN, _PHI_MAX)
    return -jnp.log(jnp.tanh(x / 2.0))


def _check_update(
    v2c: jax.Array,
    row_ids: jax.Array,
    num_rows: int,
    algorithm: str,
    alpha: float,
    beta: float,
) -> jax.Array:
    """Per-check extrinsic messages. v2c: (E, ..., Z) in check coordinates."""
    sign_bit = (v2c < 0).astype(jnp.float32)  # 1 = negative
    mag = jnp.abs(v2c)

    par = jax.ops.segment_sum(sign_bit, row_ids, num_segments=num_rows)
    excl_sign_bit = jnp.mod(par[row_ids] - sign_bit, 2.0)
    sign = 1.0 - 2.0 * excl_sign_bit

    if algorithm == "sum-product":
        t = _phi(mag)
        T = jax.ops.segment_sum(t, row_ids, num_segments=num_rows)
        excl = jnp.maximum(T[row_ids] - t, _PHI_MIN)
        out_mag = _phi(excl)
    elif algorithm in ("min-sum", "offset-min-sum"):
        m1 = jax.ops.segment_min(mag, row_ids, num_segments=num_rows)
        is_min = mag <= m1[row_ids]
        cnt = jax.ops.segment_sum(
            is_min.astype(jnp.float32), row_ids, num_segments=num_rows
        )
        m2 = jax.ops.segment_min(
            jnp.where(is_min, _INF, mag), row_ids, num_segments=num_rows
        )
        # Exclusive min: the unique minimum edge sees the second-best.
        excl = jnp.where(
            is_min & (cnt[row_ids] <= 1.0), m2[row_ids], m1[row_ids]
        )
        if algorithm == "min-sum":
            out_mag = alpha * excl
        else:
            out_mag = jnp.maximum(excl - beta, 0.0)
    else:
        raise ValueError(f"unsupported algorithm {algorithm}")

    return sign * out_mag


def decode(
    params: LDPCParams,
    llr: jax.Array,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
) -> DecodeResult:
    """Decode (..., num_cols*Z) channel LLRs.

    Matches comm.LDPCDecoder semantics: flooding schedule, at most
    ``iterations`` iterations, stopping early per-codeword once the hard
    decisions satisfy every parity check (NRLDPCDecoder.m:120).  Terminated
    codewords are frozen while the rest of the batch continues (masked
    termination — shapes never change under jit).
    """
    row_ids, col_ids, flat_fwd, bwd, E = _edge_maps(params)
    Z = params.Z_c
    num_rows = params.num_rows
    ncZ = params.num_cols * Z
    assert llr.shape[-1] == ncZ

    batch_shape = llr.shape[:-1]
    llr = llr.astype(jnp.float32)

    def gather_fwd(total):
        # total: (..., ncZ) -> v2c input (E, ..., Z) in check coordinates
        g = total[..., flat_fwd]  # (..., E, Z)
        return jnp.moveaxis(g, -2, 0)

    def syndrome_ok(total):
        bits = (total < 0).astype(jnp.float32)
        b = gather_fwd(bits)
        par = jax.ops.segment_sum(b, row_ids, num_segments=num_rows)
        return jnp.all(jnp.mod(par, 2.0) < 0.5, axis=(0, -1))  # (...,)

    def vn_update(c2v):
        # c2v: (E, ..., Z) check coords -> variable coords, scatter-add by col
        c2v_var = jnp.take_along_axis(
            c2v, jnp.broadcast_to(bwd.reshape((E,) + (1,) * len(batch_shape) + (Z,)), c2v.shape), axis=-1
        )
        acc = jax.ops.segment_sum(c2v_var, col_ids, num_segments=params.num_cols)
        # (num_cols, ..., Z) -> (..., ncZ)
        acc = jnp.moveaxis(acc, 0, -2).reshape(batch_shape + (ncZ,))
        return llr + acc

    # Initial carries are derived from llr (not bare constants) so that under
    # shard_map they inherit llr's varying mesh axes — otherwise while_loop
    # rejects the carry (unvarying input vs varying output).
    zero_like_batch = llr[..., 0] * 0.0  # (...,) zeros, data-dependent
    c2v0 = jnp.zeros((E,) + batch_shape + (Z,), jnp.float32) + zero_like_batch[..., None]
    total0 = llr
    if early_termination:
        done0 = syndrome_ok(total0)
    else:
        done0 = zero_like_batch > 1.0  # all-False, varying like llr
    iters0 = zero_like_batch.astype(jnp.int32)

    def cond(state):
        it, _, _, done, _ = state
        return (it < iterations) & ~jnp.all(done)

    def body(state):
        it, c2v, total, done, used = state
        v2c = gather_fwd(total) - c2v
        c2v_new = _check_update(
            v2c, row_ids, num_rows, algorithm, alpha, beta
        )
        total_new = vn_update(c2v_new)

        keep = done.reshape((1,) + batch_shape + (1,))
        c2v = jnp.where(keep, c2v, c2v_new)
        total = jnp.where(done[..., None], total, total_new)
        used = jnp.where(done, used, it + 1)
        if early_termination:
            done = done | syndrome_ok(total)
        return (it + 1, c2v, total, done, used)

    _, _, total, done, used = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), c2v0, total0, done0, iters0)
    )

    if early_termination:
        parity_ok = done
    else:
        parity_ok = syndrome_ok(total)
    bits = (total < 0).astype(jnp.int8)
    return DecodeResult(bits=bits, parity_ok=parity_ok, iterations=used)
