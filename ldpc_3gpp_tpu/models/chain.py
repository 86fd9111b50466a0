"""End-to-end link chain: the jittable Monte-Carlo simulation step.

One ``simulate_batch`` call reproduces the inner loop of the reference's
sweep drivers (plot_BLER_vs_SNR.m:116-162) for a whole batch of transport
blocks at once: random info bits -> encode -> modulate -> AWGN -> soft
demodulate -> decode, iterating the HARQ redundancy-version sequence with
LLR accumulation, and returning error counters.

Everything here is pure and shape-static: it jits once per
(config, batch size) and is the unit of work sharded across devices by
ldpc_3gpp_tpu.parallel.montecarlo.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.channel import awgn, esn0_to_variance
from ..ops.modulation import Q_M
from ..spec.params import LDPCParams
from .decoder import (
    DECODE_BACKENDS,
    decode_transport_block_d,
    init_harq_state,
    split_rate_matched_symbols,
)
from .encoder import encode_to_symbols


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of one simulated link (one BLER curve point set).

    Mirrors the reference driver's arguments (plot_BLER_vs_SNR.m:30-42).
    """

    params: LDPCParams
    modulation: str = "QPSK"
    rv_sequence: Tuple[int, ...] = (0,)
    iterations: int = 50
    algorithm: str = "sum-product"
    alpha: float = 0.8125
    beta: float = 0.15
    demod_method: str = "exact"
    early_termination: bool = True
    # BP decoder implementation (models.decoder.DECODE_BACKENDS).  'auto'
    # picks the production XLA path for the schedule on every platform.
    backend: str = "auto"
    schedule: str = "flooding"  # BP schedule ('layered': backend auto/fast)
    # iteration-dependent NMS normalization (alpha0, n0): alpha0 for the
    # first n0 sweeps, then `alpha`.  None = constant alpha (bit-exact
    # baseline).  Measured a dead end at the bench point (DESIGN.md
    # section 8) but exposed for other operating points.
    alpha_schedule: Optional[Tuple[float, int]] = None
    # Per-stage CBGTI: cbgti_sequence[i] is the CBGTI tuple for rv stage i,
    # overriding params.CBGTI — the reference's tunable-between-steps CBGTI
    # (NRLDPC.m:71-85), where a retransmission reschedules only failed code
    # blocks.  None = params.CBGTI for every stage.  G redistributes over
    # the scheduled blocks per stage (E_r, NRLDPC.m:485-507); excluded
    # blocks decode from the HARQ buffer and keep their latched b_hat
    # (NRLDPCDecoder.m:286-318).
    cbgti_sequence: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        if self.backend not in DECODE_BACKENDS:
            raise ValueError(
                f"unknown decode backend {self.backend!r}; "
                f"expected one of {sorted(DECODE_BACKENDS)}"
            )
        assert Q_M[self.modulation] == self.params.Q_m, (
            f"modulation {self.modulation} has Q_m={Q_M[self.modulation]} but "
            f"params.Q_m={self.params.Q_m}"
        )
        if self.cbgti_sequence is not None:
            seq = tuple(tuple(c) for c in self.cbgti_sequence)
            object.__setattr__(self, "cbgti_sequence", seq)
            assert len(seq) == len(self.rv_sequence), (
                f"cbgti_sequence has {len(seq)} stages but rv_sequence has "
                f"{len(self.rv_sequence)}"
            )
            for c in seq:  # every stage must keep >= 1 scheduled block
                self.params.with_tx(CBGTI=c).E_r


class BatchResult(NamedTuple):
    blocks: jax.Array  # () number of transport blocks simulated
    block_errors: jax.Array  # () blocks where a_hat != a (or never decoded)
    # info bit errors; a block that never decoded counts all A bits as wrong
    # (matches the reference, whose failed decodes return [] — no bits at all)
    bit_errors: jax.Array  # ()
    # total BP iterations spent, reference protocol: a block that decoded at
    # an earlier rv stage stops retransmitting (plot_BLER_vs_SNR.m:124-137),
    # so its SIMD re-decodes at later stages are excluded
    iterations: jax.Array  # ()
    # (iterations+1,) histogram of per-code-block BP iteration counts over
    # every (block, CB, rv stage) decode of a not-yet-decoded block — the
    # early-termination mix, same stop-on-success protocol as `iterations`
    iteration_hist: jax.Array
    tb_ok: jax.Array  # (batch,) per-block success (for found-start logic)


def simulate_batch(
    cfg: ChainConfig, key: jax.Array, esn0_db, batch: int
) -> BatchResult:
    """Simulate ``batch`` independent transport blocks at Es/N0 ``esn0_db``.

    Each block runs the HARQ loop of plot_BLER_vs_SNR.m:124-137: encode and
    transmit rv_sequence[0], then accumulate retransmissions until the TB
    decodes.  Already-decoded blocks are frozen while the batch continues.
    """
    p0 = cfg.params
    noise_var = esn0_to_variance(esn0_db)

    key_a, key_ch = jax.random.split(key)
    a = jax.random.bernoulli(key_a, 0.5, (batch, p0.A)).astype(jnp.int8)

    state = init_harq_state(p0, (batch,))
    success = jnp.zeros((batch,), bool)
    a_hat = jnp.zeros_like(a)
    total_iters = jnp.zeros((), jnp.int32)
    iter_hist = jnp.zeros((cfg.iterations + 1,), jnp.int32)

    for stage, rv in enumerate(cfg.rv_sequence):
        p = p0.with_tx(
            rv_id=rv,
            CBGTI=(None if cfg.cbgti_sequence is None
                   else cfg.cbgti_sequence[stage]),
        )
        # Fused symbol path: the Section 5.4.2.2 (de)interleaver shuffles
        # compose away against the modulator's bit-plane structure, so the
        # interleaved bit/LLR streams g and g~ never materialize.  Values
        # (symbols, LLRs, counters) are bit-exact vs the composition
        # modulate(encode(...)) / split(demod(...)) — pinned by
        # tests/test_chain.py::test_fused_symbol_path_matches_composition.
        tx = encode_to_symbols(p, a, cfg.modulation)
        rx = awgn(jax.random.fold_in(key_ch, stage), tx, noise_var)
        d_tilde = split_rate_matched_symbols(
            p, rx, cfg.modulation, noise_var, cfg.demod_method
        )
        res = decode_transport_block_d(
            p,
            d_tilde,
            state,
            iterations=cfg.iterations,
            algorithm=cfg.algorithm,
            alpha=cfg.alpha,
            beta=cfg.beta,
            early_termination=cfg.early_termination,
            backend=cfg.backend,
            schedule=cfg.schedule,
            alpha_schedule=cfg.alpha_schedule,
        )
        state = res.state
        newly = res.tb_ok & ~success
        a_hat = jnp.where(newly[:, None], res.a_hat, a_hat)
        # Iteration accounting follows the reference's stop-on-success HARQ
        # protocol (plot_BLER_vs_SNR.m:124-137: `while isempty(a_hat)`): the
        # SIMD batch necessarily re-decodes already-successful blocks at
        # later rv stages, but those decodes would never happen in the
        # reference, so they are excluded from both observables.
        active = ~success  # blocks still undecoded BEFORE this stage
        stage_iters = res.iterations * active[:, None].astype(
            res.iterations.dtype
        )
        success = success | res.tb_ok
        total_iters = total_iters + jnp.sum(stage_iters).astype(jnp.int32)
        iter_hist = iter_hist + jnp.sum(
            jax.nn.one_hot(res.iterations, cfg.iterations + 1, dtype=jnp.int32)
            * active[:, None, None],
            axis=(0, 1),
        )

    bits_equal = jnp.all(a_hat == a, axis=-1)
    tb_ok = success & bits_equal  # undetected CRC errors still count as errors
    bit_errs = jnp.sum(
        jnp.where(success[:, None], a_hat != a, jnp.ones_like(a, bool))
    )

    return BatchResult(
        blocks=jnp.asarray(batch, jnp.int32),
        block_errors=jnp.sum(~tb_ok).astype(jnp.int32),
        bit_errors=bit_errs.astype(jnp.int32),
        iterations=total_iters,
        iteration_hist=iter_hist,
        tb_ok=tb_ok,
    )
