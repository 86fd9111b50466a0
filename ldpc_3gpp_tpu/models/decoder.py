"""Transport-block decoder: the inverse TS38.212 chain with HARQ state.

Batched, functional replacement for NRLDPCDecoder (NRLDPCDecoder.m:133-356).
HARQ state is an explicit pytree carried by the caller (the reference's
DiscreteState buffers, NRLDPCDecoder.m:64-95); ``reset`` is simply creating a
fresh state.  The chain:

    g~ --split/deinterleave--> e~ --scatter-add (Chase combining) + HARQ
    accumulate--> d~ --prepend punctured 2Z zeros, pin fillers--> BP decode
    --> c^ --CB CRC gate + b^ buffer--> b^ --TB CRC--> a^, tb_ok

Where the reference returns ``[]`` on failure (NRLDPCDecoder.m:337-339), this
returns the decoded bits plus a per-codeword ``tb_ok`` flag — the natural
batched equivalent.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.crc import crc_check
from ..ops.decoder import decode as bp_decode_ref
from ..ops.decoder_fast import decode as bp_decode_fast
from ..ops.decoder_layered import decode as bp_decode_layered
from ..ops.rate_match import accumulate_llrs, deinterleave
from ..spec.params import LDPCParams


def _drop_schedule(fn, layered_fn=None):
    """Adapter for XLA backends: dispatch on `schedule`, drop the kwarg."""

    def wrapped(params, llr, *, schedule="flooding", **kw):
        if schedule == "flooding":
            return fn(params, llr, **kw)
        if schedule == "layered" and layered_fn is not None:
            return layered_fn(params, llr, **kw)
        raise ValueError(f"backend does not implement schedule {schedule!r}")

    return wrapped


_bp_decode_xla = _drop_schedule(bp_decode_fast, bp_decode_layered)

# BP decoder implementations:
#   'auto'      — the production path for the schedule, on every platform:
#                 ops/decoder_layered.py (layered) or ops/decoder_fast.py
#                 (flooding)
#   'fast'      — the same static-roll XLA paths, under their original name
#   'reference' — flooding, segment-op oracle (ops/decoder.py)
DECODE_BACKENDS = {
    "auto": _bp_decode_xla,
    "fast": _bp_decode_xla,
    "reference": _drop_schedule(bp_decode_ref),
}

# Large finite stand-in for the reference's +inf filler LLRs
# (NRLDPCDecoder.m:264).  Finite so that inf - inf NaNs can never appear in
# message passing; far above any channel LLR magnitude.
FILLER_LLR = 1e20


class HARQState(NamedTuple):
    """Per-transport-block soft/hard buffers (NRLDPCDecoder.m:64-95)."""

    d_buf: jax.Array  # (..., C, N_cb) accumulated channel LLRs
    b_buf: jax.Array  # (..., B) best-so-far decoded bits
    cb_ok: jax.Array  # (..., C) latched per-code-block CRC pass flags


class TBDecodeResult(NamedTuple):
    a_hat: jax.Array  # (..., A) decoded info bits
    tb_ok: jax.Array  # (...,) transport block decoded successfully
    state: HARQState  # updated HARQ buffers
    cb_crc_ok: jax.Array  # (..., C) this transmission's CB CRC results
    parity_ok: jax.Array  # (..., C) LDPC parity satisfied per code block
    iterations: jax.Array  # (..., C) BP iterations used per code block


def init_harq_state(params: LDPCParams, batch_shape=()) -> HARQState:
    """Fresh buffers — the reference's reset() (NRLDPCDecoder.m:343-356)."""
    return HARQState(
        d_buf=jnp.zeros(batch_shape + (params.C, params.N_cb), jnp.float32),
        b_buf=jnp.zeros(batch_shape + (params.B,), jnp.int8),
        cb_ok=jnp.zeros(batch_shape + (params.C,), bool),
    )


def split_rate_matched(params: LDPCParams, g_tilde: jax.Array) -> jax.Array:
    """Sections 5.5 + 5.4.2.2 + 5.4.2.1 inverse: (..., G) -> (..., C, N).

    Splits per code block, deinterleaves, and scatter-adds into the
    N-length circular buffer (repeated positions Chase-combine,
    NRLDPCDecoder.m:143-234).  Excluded code blocks (E_r == 0) produce an
    all-zero LLR row.
    """
    assert g_tilde.shape[-1] == params.G, (
        f"expected {params.G} rate-matched LLRs, got {g_tilde.shape[-1]}"
    )
    rows = []
    off = 0
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            rows.append(jnp.zeros(g_tilde.shape[:-1] + (params.N,), jnp.float32))
            continue
        f = g_tilde[..., off : off + E].astype(jnp.float32)
        off += E
        e = deinterleave(f, params.Q_m)
        rows.append(accumulate_llrs(params, e, E))
    return jnp.stack(rows, axis=-2)


def split_rate_matched_symbols(
    params: LDPCParams,
    y: jax.Array,
    modulation: str,
    noise_var,
    method: str = "exact",
) -> jax.Array:
    """``split_rate_matched(demodulate(y))`` with the Section 5.4.2.2
    deinterleaver's element-shuffle fused away: (..., G/Q_m) received
    symbols -> (..., C, N) circular-buffer LLRs.

    ops/modulation.demodulate_planes emits each code block's LLRs directly
    as deinterleaved planes (plane i = stream i), so the per-element
    (S, Q_m) transpose of the full stream never materializes.  Bit-exact
    vs the composition (pinned by tests/test_chain.py).
    """
    from ..ops.modulation import Q_M, demodulate_planes

    qm = Q_M[modulation]
    assert y.shape[-1] * qm == params.G, (
        f"expected {params.G // qm} symbols, got {y.shape[-1]}"
    )
    rows = []
    soff = 0
    for r in range(params.C):
        E = params.E_r[r]
        if E == 0:
            rows.append(jnp.zeros(y.shape[:-1] + (params.N,), jnp.float32))
            continue
        S = E // qm
        planes = demodulate_planes(
            y[..., soff : soff + S], modulation, noise_var, method
        )  # (..., qm, S)
        soff += S
        e = planes.reshape(planes.shape[:-2] + (E,)).astype(jnp.float32)
        rows.append(accumulate_llrs(params, e, E))
    return jnp.stack(rows, axis=-2)


def decode_transport_block(
    params: LDPCParams,
    g_tilde: jax.Array,
    state: Optional[HARQState] = None,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    backend: str = "fast",
    schedule: str = "flooding",
    alpha_schedule=None,
) -> TBDecodeResult:
    """Full decode chain for one (re)transmission of (..., G) channel LLRs.

    ``state=None`` decodes standalone (I_HARQ = 0); passing the previous
    TBDecodeResult.state accumulates LLRs and latched code blocks across
    retransmissions (I_HARQ = 1, NRLDPCDecoder.m:236-239, 286-314).
    """
    d_tilde = split_rate_matched(params, g_tilde)  # (..., C, N)
    return decode_transport_block_d(
        params, d_tilde, state,
        iterations=iterations, algorithm=algorithm, alpha=alpha, beta=beta,
        early_termination=early_termination, backend=backend,
        schedule=schedule, alpha_schedule=alpha_schedule,
    )


def decode_transport_block_d(
    params: LDPCParams,
    d_tilde: jax.Array,
    state: Optional[HARQState] = None,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    backend: str = "fast",
    schedule: str = "flooding",
    alpha_schedule=None,
) -> TBDecodeResult:
    """``decode_transport_block`` from the (..., C, N) circular-buffer LLRs.

    Entry point for callers that produced d~ without materializing the
    rate-matched stream (the simulation chain's fused symbol path,
    ``split_rate_matched_symbols``).  Semantics identical from d~ onward.
    """
    C, Z, K, Kp, N_cb = params.C, params.Z_c, params.K, params.K_prime, params.N_cb
    L = params.cb_crc_len
    payload = Kp - L
    batch_shape = d_tilde.shape[:-2]
    harq = state is not None
    if state is None:
        state = init_harq_state(params, batch_shape)

    if harq:
        d_tilde = d_tilde.at[..., :N_cb].add(state.d_buf)
    d_buf = d_tilde[..., :N_cb]

    if backend not in DECODE_BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; "
            f"expected one of {sorted(DECODE_BACKENDS)}"
        )
    extra = {}
    if alpha_schedule is not None:
        # iteration-dependent NMS normalization: implemented by the XLA
        # layered path only (flooding is the bit-exact MATLAB-semantics mode)
        if schedule != "layered" or backend == "reference":
            raise ValueError(
                "alpha_schedule requires the layered schedule "
                "(schedule='layered', backend 'auto' or 'fast')"
            )
        extra["alpha_schedule"] = (
            float(alpha_schedule[0]), int(alpha_schedule[1])
        )

    # Rebuild the full codeword LLRs: 2Z punctured zeros + d, fillers pinned
    # to +FILLER_LLR (known zero bits; NRLDPCDecoder.m:262-264).
    zeros2z = jnp.zeros(batch_shape + (C, 2 * Z), jnp.float32)
    dec_llr = jnp.concatenate([zeros2z, d_tilde], axis=-1)
    if Kp < K:
        dec_llr = dec_llr.at[..., Kp:K].set(FILLER_LLR)

    res = DECODE_BACKENDS[backend](
        params,
        dec_llr,
        iterations=iterations,
        algorithm=algorithm,
        alpha=alpha,
        beta=beta,
        early_termination=early_termination,
        schedule=schedule,
        **extra,
    )
    c_hat = res.bits  # (..., C, num_cols*Z)

    # Section 5.2.2 inverse: CB CRC gate (only exists when C > 1,
    # NRLDPCDecoder.m:298-301) and scheduled-code-block masking.
    if C > 1:
        cb_crc_ok = ~crc_check(c_hat[..., :Kp], params.cb_crc)
    else:
        cb_crc_ok = jnp.ones(batch_shape + (C,), bool)
    scheduled = jnp.asarray(params.CBGTI_flags, bool)
    accept = cb_crc_ok & scheduled  # (..., C)

    new_bits = c_hat[..., :payload].astype(jnp.int8)  # (..., C, K'-L)
    old_bits = state.b_buf.reshape(batch_shape + (C, payload))
    b_blocks = jnp.where(accept[..., None], new_bits, old_bits)
    b_hat = b_blocks.reshape(batch_shape + (params.B,))
    cb_ok = state.cb_ok | accept

    # Section 5.1 inverse: TB CRC + all-code-blocks-latched gate
    # (NRLDPCDecoder.m:336-339).
    tb_ok = ~crc_check(b_hat, params.tb_crc) & jnp.all(cb_ok, axis=-1)
    a_hat = b_hat[..., : params.A]

    new_state = HARQState(d_buf=d_buf, b_buf=b_hat, cb_ok=cb_ok)
    return TBDecodeResult(
        a_hat=a_hat,
        tb_ok=tb_ok,
        state=new_state,
        cb_crc_ok=cb_crc_ok,
        parity_ok=res.parity_ok,
        iterations=res.iterations,
    )
