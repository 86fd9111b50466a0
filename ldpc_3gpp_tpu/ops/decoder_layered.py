"""Layered-schedule BP decoder in plain XLA — the production layered path.

The layered schedule updates the posterior totals in place after every
check row, which roughly halves the iterations needed for a given BLER
versus flooding.  This module implements it with ordinary jax.numpy
operations (static ``jnp.roll`` rotations, unrolled per-row scans,
``lax.while_loop`` early termination), so it runs on every backend.

Semantics, sweep by sweep: per-row syndrome of the current
totals accumulates during the sweep; a codeword whose every row passed
freezes (its totals and messages stop updating) and reports the sweep index
at which it passed; the final permitted sweep (it == iterations) only
checks, never updates (max ``iterations`` update sweeps, matching
comm.LDPCDecoder counting — NRLDPCDecoder.m:120).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..spec.params import LDPCParams
from .decoder import DecodeResult, _PHI_MIN, _phi
from .decoder_fast import _resolve_layer_order, _row_plan


def _sign(x):
    s = jnp.sign(x)
    return jnp.where(s == 0, 1.0, s)


def _check_messages(v, algorithm, alpha, beta):
    """Extrinsic messages for one check row."""
    if algorithm in ("min-sum", "offset-min-sum"):
        m1 = jnp.abs(v[0])
        m2 = jnp.full_like(m1, jnp.inf)
        idx = jnp.zeros_like(m1, jnp.int32)
        sprod = _sign(v[0])
        for i in range(1, len(v)):
            av = jnp.abs(v[i])
            better = av < m1
            m2 = jnp.where(better, m1, jnp.minimum(m2, av))
            m1 = jnp.where(better, av, m1)
            idx = jnp.where(better, i, idx)
            sprod = sprod * _sign(v[i])
        if algorithm == "min-sum":
            m1 = alpha * m1
            m2 = alpha * m2
        else:
            m1 = jnp.maximum(m1 - beta, 0.0)
            m2 = jnp.maximum(m2 - beta, 0.0)
        return [
            sprod * _sign(ve) * jnp.where(idx == i, m2, m1)
            for i, ve in enumerate(v)
        ]
    elif algorithm == "sum-product":
        phis = [_phi(jnp.abs(ve)) for ve in v]
        T = phis[0]
        for p in phis[1:]:
            T = T + p
        sprod = _sign(v[0])
        for ve in v[1:]:
            sprod = sprod * _sign(ve)
        return [
            sprod * _sign(ve) * _phi(jnp.maximum(T - p, _PHI_MIN))
            for ve, p in zip(v, phis)
        ]
    raise ValueError(f"unsupported algorithm {algorithm}")


def decode(
    params: LDPCParams,
    llr: jax.Array,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    layer_order="reversed",
    alpha_schedule=None,
) -> DecodeResult:
    """Layered BP decode of (..., num_cols*Z) LLRs (XLA, any backend).

    ``layer_order`` ('reversed' default / 'natural' / explicit tuple) is the
    row processing order — see ops/decoder_fast.py::_resolve_layer_order
    for the measured rationale.

    ``alpha_schedule=(alpha0, n0)`` (min-sum only): normalization alpha0
    for the first n0 update sweeps, the standard ``alpha`` after.
    """
    if alpha_schedule is not None and algorithm != "min-sum":
        raise ValueError("alpha_schedule applies to min-sum only")

    def _alpha_at(it):
        if alpha_schedule is None:
            return alpha
        a0, n0 = alpha_schedule
        return jnp.where(it < n0, jnp.float32(a0), jnp.float32(alpha))

    row_seq = _resolve_layer_order(params, layer_order)
    Z = params.Z_c
    nc, nr = params.num_cols, params.num_rows
    assert llr.shape[-1] == nc * Z
    batch_shape = llr.shape[:-1]
    totals0 = jnp.moveaxis(
        llr.astype(jnp.float32).reshape(batch_shape + (nc, Z)), -2, 0
    )  # (nc, ..., Z)
    by_row, _ = _row_plan(params)
    E = len(params.edges[0])

    zero_b = totals0[0, ..., 0] * 0.0  # (...,) varying zeros

    def sweep(state):
        it, totals, c2v_arr, done, used = state
        keep = (done | (it >= iterations))[..., None]  # (..., 1)
        sweep_ok = zero_b > -1.0  # all True
        for r in row_seq:
            edges = by_row[r]
            t = [jnp.roll(totals[c], -s, axis=-1) for (_, c, s) in edges]
            par = None
            for te in t:
                bit = te < 0
                par = bit if par is None else par ^ bit
            sweep_ok = sweep_ok & jnp.all(~par, axis=-1)
            v = [te - c2v_arr[e] for te, (e, _, _) in zip(t, edges)]
            nm = _check_messages(v, algorithm, _alpha_at(it), beta)
            for i, (ve, (e, c, s)) in enumerate(zip(v, edges)):
                c2v_arr = c2v_arr.at[e].set(jnp.where(keep, c2v_arr[e], nm[i]))
                tn = jnp.roll(jnp.where(keep, t[i], ve + nm[i]), s, axis=-1)
                totals = totals.at[c].set(tn)
        newly = sweep_ok & ~done
        used = jnp.where(newly, it, used)
        done = done | sweep_ok
        return it + 1, totals, c2v_arr, done, used

    def cond(state):
        it, _, _, done, _ = state
        return (it <= iterations) & ~jnp.all(done)

    c2v0 = jnp.zeros((E,) + batch_shape + (Z,), jnp.float32) + zero_b[..., None]

    if early_termination:
        done0 = zero_b > 1.0
        used0 = zero_b.astype(jnp.int32)
        it, totals, _, done, used = jax.lax.while_loop(
            cond, sweep, (jnp.asarray(0, jnp.int32), totals0, c2v0, done0, used0)
        )
        used = jnp.where(done, used, iterations)
    else:
        # Run-to-budget semantics (matches ops/decoder_fast with
        # early_termination=False): exactly `iterations` update
        # sweeps with no freezing, bits from the final totals, parity flag
        # = the clean syndrome of that settled final state.
        def sweep_full(state):
            it, totals, c2v_arr = state
            for r in row_seq:
                edges = by_row[r]
                t = [jnp.roll(totals[c], -s, axis=-1) for (_, c, s) in edges]
                v = [te - c2v_arr[e] for te, (e, _, _) in zip(t, edges)]
                nm = _check_messages(v, algorithm, _alpha_at(it), beta)
                for i, (ve, (e, c, s)) in enumerate(zip(v, edges)):
                    c2v_arr = c2v_arr.at[e].set(nm[i])
                    totals = totals.at[c].set(jnp.roll(ve + nm[i], s, axis=-1))
            return it + 1, totals, c2v_arr

        _, totals, _ = jax.lax.while_loop(
            lambda s: s[0] < iterations, sweep_full,
            (jnp.asarray(0, jnp.int32), totals0, c2v0),
        )
        done = zero_b > -1.0  # all True
        for r in row_seq:
            par = None
            for (_, c, s) in by_row[r]:
                bit = jnp.roll(totals[c], -s, axis=-1) < 0
                par = bit if par is None else par ^ bit
            done = done & jnp.all(~par, axis=-1)
        used = jnp.full(batch_shape, iterations, jnp.int32)

    bits = (jnp.moveaxis(totals, 0, -2) < 0).reshape(batch_shape + (nc * Z,))
    return DecodeResult(bits=bits.astype(jnp.int8), parity_ok=done, iterations=used)
