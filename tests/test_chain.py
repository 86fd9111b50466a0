"""Full TS38.212 chain: encode->channel->decode roundtrips, HARQ, multi-CB."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_3gpp_tpu.models.chain import ChainConfig, simulate_batch
from ldpc_3gpp_tpu.models.decoder import decode_transport_block, init_harq_state
from ldpc_3gpp_tpu.models.encoder import encode_transport_block
from ldpc_3gpp_tpu.ops.channel import awgn, esn0_to_variance
from ldpc_3gpp_tpu.ops.modulation import demodulate, modulate
from ldpc_3gpp_tpu.spec.params import LDPCParams

RNG = np.random.default_rng(9)

# Per-test jax.clear_caches() is repo-level now: tests/conftest.py's autouse
# fixture releases compiled executables after EVERY test (these chain tests
# are the compile-heaviest in the suite and motivated the round-4 per-module
# mitigation this replaced).


def _roundtrip(p, modulation, esn0, batch=4, iterations=20, state=None, key=0):
    a = jnp.asarray(RNG.integers(0, 2, size=(batch, p.A)).astype(np.int8))
    g = encode_transport_block(p, a)
    assert g.shape == (batch, p.G)
    tx = modulate(g, modulation)
    var = esn0_to_variance(esn0)
    rx = awgn(jax.random.PRNGKey(key), tx, var)
    llr = demodulate(rx, modulation, var, "exact")
    res = decode_transport_block(p, llr, state, iterations=iterations)
    return a, res


@pytest.mark.parametrize(
    "bg,A,rate,modulation",
    [
        (2, 100, 1 / 2, "QPSK"),
        pytest.param(1, 1000, 1 / 3, "QPSK", marks=pytest.mark.slow),
        (2, 50, 1 / 4, "BPSK"),
        pytest.param(1, 2000, 1 / 2, "16QAM", marks=pytest.mark.slow),
        pytest.param(1, 3000, 2 / 3, "64QAM", marks=pytest.mark.slow),
        # 256QAM roundtrip is slow-tier: the quick tier still covers 256QAM
        # via the fused symbol path (test_fused_symbol_path_matches_
        # composition) and the mod/demod oracle fuzz (test_modulation_oracle)
        pytest.param(2, 300, 1 / 3, "256QAM", marks=pytest.mark.slow),
    ],
)
def test_roundtrip_high_snr(bg, A, rate, modulation):
    from ldpc_3gpp_tpu.ops.modulation import Q_M

    qm = Q_M[modulation]
    G = round(A / rate / qm) * qm
    p = LDPCParams(BG=bg, A=A, G=G, Q_m=qm)
    a, res = _roundtrip(p, modulation, esn0=30.0)
    assert np.asarray(res.tb_ok).all()
    np.testing.assert_array_equal(np.asarray(res.a_hat), np.asarray(a))


@pytest.mark.slow
def test_multi_code_block_roundtrip():
    # A=8448 BG1 -> C=2 with CB CRCs; A=20004 -> C=3
    for A in (8448, 20004):
        G = 3 * A
        p = LDPCParams(BG=1, A=A, G=G, Q_m=2)
        assert p.C > 1
        a, res = _roundtrip(p, "QPSK", esn0=20.0, batch=2)
        assert np.asarray(res.tb_ok).all()
        np.testing.assert_array_equal(np.asarray(res.a_hat), np.asarray(a))
        assert np.asarray(res.cb_crc_ok).all()


def test_failure_flags_at_low_snr():
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    a, res = _roundtrip(p, "QPSK", esn0=-15.0, iterations=5)
    assert not np.asarray(res.tb_ok).any()


@pytest.mark.slow
def test_harq_chase_combining_gain():
    """A block undecodable in one shot decodes after LLR accumulation."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    batch = 16
    a = jnp.asarray(RNG.integers(0, 2, size=(batch, p.A)).astype(np.int8))
    esn0 = -1.5  # too low for single-shot rate 1/3ish
    var = esn0_to_variance(esn0)
    g = encode_transport_block(p, a)
    state = init_harq_state(p, (batch,))
    successes = []
    for t in range(4):  # 4 chase retransmissions of rv 0
        tx = modulate(g, "QPSK")
        rx = awgn(jax.random.PRNGKey(100 + t), tx, var)
        llr = demodulate(rx, "QPSK", var, "exact")
        res = decode_transport_block(p, llr, state, iterations=20)
        state = res.state
        successes.append(int(np.asarray(res.tb_ok).sum()))
    assert successes[-1] > successes[0], successes
    assert successes[-1] >= batch * 3 // 4, successes


@pytest.mark.slow
def test_harq_incremental_redundancy():
    """rv 0 then rv 2 provides new parity and decodes a punctured block."""
    A, Qm = 1000, 2
    G = 1600  # high rate: rv0 alone fails at this SNR
    p0 = LDPCParams(BG=1, A=A, G=G, Q_m=Qm, rv_id=0)
    batch = 8
    a = jnp.asarray(RNG.integers(0, 2, size=(batch, A)).astype(np.int8))
    esn0 = 2.0
    var = esn0_to_variance(esn0)
    state = init_harq_state(p0, (batch,))
    succ = []
    for t, rv in enumerate((0, 2)):
        p = p0.with_rv(rv)
        g = encode_transport_block(p, a)
        tx = modulate(g, "QPSK")
        rx = awgn(jax.random.PRNGKey(7 + t), tx, var)
        llr = demodulate(rx, "QPSK", var, "exact")
        res = decode_transport_block(p, llr, state, iterations=25)
        state = res.state
        succ.append(int(np.asarray(res.tb_ok).sum()))
    assert succ[1] > succ[0], succ


@pytest.mark.slow
def test_cbgti_excluded_blocks_come_from_buffer():
    """Retransmission excluding CB 0 still decodes using the latched copy."""
    A = 20004
    p_all = LDPCParams(BG=1, A=A, G=3 * A, Q_m=2)
    C = p_all.C
    a = jnp.asarray(RNG.integers(0, 2, size=(2, A)).astype(np.int8))
    var = esn0_to_variance(20.0)
    # transmission 1: all code blocks
    state = init_harq_state(p_all, (2,))
    g = encode_transport_block(p_all, a)
    tx = modulate(g, "QPSK")
    rx = awgn(jax.random.PRNGKey(21), tx, var)
    res1 = decode_transport_block(
        p_all, demodulate(rx, "QPSK", var, "exact"), state
    )
    assert np.asarray(res1.tb_ok).all()
    # transmission 2: exclude block 0; decode must still succeed via buffer
    p_part = LDPCParams(BG=1, A=A, G=3 * A, Q_m=2, CBGTI=(0,))
    g2 = encode_transport_block(p_part, a)
    tx2 = modulate(g2, "QPSK")
    rx2 = awgn(jax.random.PRNGKey(22), tx2, var)
    res2 = decode_transport_block(
        p_part, demodulate(rx2, "QPSK", var, "exact"), res1.state
    )
    assert np.asarray(res2.tb_ok).all()
    np.testing.assert_array_equal(np.asarray(res2.a_hat), np.asarray(a))


def test_cbgti_sequence_per_stage_scheduling():
    """Per-stage CBGTI (ChainConfig.cbgti_sequence): the reference's
    tunable-between-steps CBGTI (NRLDPC.m:71-85) — a retransmission that
    reschedules only some code blocks redistributes G over them
    (NRLDPC.m:485-507) while excluded blocks ride the HARQ buffer."""
    p = LDPCParams(BG=2, A=7650, G=22950, Q_m=2)
    assert p.C == 3
    # E_r redistribution: excluding CB 0 spreads G over the other two
    p_part = p.with_tx(rv_id=2, CBGTI=(0,))
    assert p_part.E_r[0] == 0 and sum(p_part.E_r) == p.G
    assert p_part.rv_id == 2 and min(p_part.E_r[1:]) > max(p.E_r) * 1.4
    base = dict(params=p, modulation="QPSK", iterations=8,
                algorithm="min-sum")
    # an all-scheduled cbgti_sequence is the identity: bit-equal counters
    key = jax.random.PRNGKey(11)
    r_none = simulate_batch(ChainConfig(rv_sequence=(0, 2), **base),
                            key, 12.0, 16)
    r_id = simulate_batch(
        ChainConfig(rv_sequence=(0, 2), cbgti_sequence=((), ()), **base),
        key, 12.0, 16)
    for a, b in zip(jax.tree.leaves(r_none), jax.tree.leaves(r_id)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # partial retransmission: stage 2 excludes CB 0.  At high SNR every
    # block decodes at stage 0 (stop-on-success): counters equal the
    # 1-stage run, proving exclusion never corrupts decoded blocks.
    r_part = simulate_batch(
        ChainConfig(rv_sequence=(0, 2), cbgti_sequence=((), (0,)), **base),
        key, 12.0, 16)
    r_one = simulate_batch(ChainConfig(rv_sequence=(0,), **base),
                           key, 12.0, 16)
    assert int(r_part.block_errors) == int(r_one.block_errors) == 0
    assert int(r_part.iterations) == int(r_one.iterations)
    # near the waterfall the partial retransmission must help vs no
    # retransmission (IR combining on the scheduled blocks) — same key, so
    # stage 0 is identical between the two runs
    lo_one = simulate_batch(ChainConfig(rv_sequence=(0,), **base),
                            key, 1.0, 32)
    lo_part = simulate_batch(
        ChainConfig(rv_sequence=(0, 2), cbgti_sequence=((), (0,)), **base),
        key, 1.0, 32)
    assert int(lo_one.block_errors) > 0
    assert int(lo_part.block_errors) < int(lo_one.block_errors)
    # stage-count mismatch is rejected at construction
    with pytest.raises(AssertionError, match="cbgti_sequence"):
        ChainConfig(rv_sequence=(0,), cbgti_sequence=((), (0,)), **base)


def test_simulate_batch_counters():
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=15)
    sim = jax.jit(partial(simulate_batch, cfg, batch=32))
    hi = jax.tree.map(np.asarray, sim(jax.random.PRNGKey(0), 12.0))
    assert hi.blocks == 32 and hi.block_errors == 0 and hi.bit_errors == 0
    lo = jax.tree.map(np.asarray, sim(jax.random.PRNGKey(0), -12.0))
    assert lo.block_errors == 32
    assert lo.bit_errors > 0


def test_harq_iteration_accounting_stops_on_success():
    """Iteration observables follow the reference's stop-on-success protocol.

    The reference stops retransmitting a block the moment it decodes
    (plot_BLER_vs_SNR.m:124-137), so at an SNR where every block decodes at
    rv stage 0, rv_sequence=(0,1,2,3) must produce the SAME total iterations
    and iteration histogram as rv_sequence=(0,) — the later stages' SIMD
    re-decodes must not be counted.
    """
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    base = dict(params=p, modulation="QPSK", iterations=15)
    sim1 = jax.jit(
        partial(simulate_batch, ChainConfig(rv_sequence=(0,), **base), batch=32)
    )
    sim4 = jax.jit(
        partial(
            simulate_batch, ChainConfig(rv_sequence=(0, 1, 2, 3), **base), batch=32
        )
    )
    r1 = jax.tree.map(np.asarray, sim1(jax.random.PRNGKey(3), 12.0))
    r4 = jax.tree.map(np.asarray, sim4(jax.random.PRNGKey(3), 12.0))
    assert r1.block_errors == 0  # precondition: everything decodes at rv 0
    assert r4.iterations == r1.iterations
    np.testing.assert_array_equal(r4.iteration_hist, r1.iteration_hist)
    # and the histogram's mass equals the number of (block, CB) decodes
    assert r1.iteration_hist.sum() == 32 * p.C


def test_simulate_batch_counts_requested_batch():
    """A batch that is no multiple of 128 is simulated as given and counts
    EXACTLY the requested blocks."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=15)
    r = jax.tree.map(
        np.asarray, jax.jit(partial(simulate_batch, cfg, batch=100))(
            jax.random.PRNGKey(2), 12.0
        )
    )
    assert r.blocks == 100 and r.tb_ok.shape == (100,)
    assert r.block_errors == 0 and r.bit_errors == 0
    # iteration histogram mass counts only the requested blocks' decodes
    assert r.iteration_hist.sum() == 100 * p.C
    assert r.iterations == (r.iteration_hist * np.arange(16)).sum()


def test_simulate_batch_reproducible():
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=15)
    sim = jax.jit(partial(simulate_batch, cfg, batch=16))
    r1 = jax.tree.map(np.asarray, sim(jax.random.PRNGKey(5), 1.0))
    r2 = jax.tree.map(np.asarray, sim(jax.random.PRNGKey(5), 1.0))
    assert r1.block_errors == r2.block_errors
    np.testing.assert_array_equal(r1.tb_ok, r2.tb_ok)


@pytest.mark.slow
def test_lbrm_harq_roundtrip():
    """Limited-buffer rate matching (N_cb < N) with HARQ accumulation."""
    A = 4000
    p = LDPCParams(BG=1, A=A, G=6000, Q_m=2, I_LBRM=1, TBS_LBRM=4000, rv_id=0)
    assert p.N_cb < p.N
    batch = 4
    a = jnp.asarray(RNG.integers(0, 2, size=(batch, A)).astype(np.int8))
    var = esn0_to_variance(4.0)
    state = init_harq_state(p, (batch,))
    assert state.d_buf.shape == (batch, p.C, p.N_cb)
    got = None
    for t, rv in enumerate((0, 3)):
        prv = LDPCParams(BG=1, A=A, G=6000, Q_m=2, I_LBRM=1, TBS_LBRM=4000,
                         rv_id=rv)
        g = encode_transport_block(prv, a)
        tx = modulate(g, "QPSK")
        rx = awgn(jax.random.PRNGKey(50 + t), tx, var)
        llr = demodulate(rx, "QPSK", var, "exact")
        res = decode_transport_block(prv, llr, state, iterations=25)
        state = res.state
        got = res
    assert np.asarray(got.tb_ok).all()
    np.testing.assert_array_equal(np.asarray(got.a_hat), np.asarray(a))


@pytest.mark.parametrize(
    "modulation,A,G",
    [
        ("BPSK", 100, 600),
        ("QPSK", 100, 300),
        ("16QAM", 3000, 9000 - 9000 % 4),
        ("64QAM", 100, 300),
        ("256QAM", 4000, 12000),
    ],
)
def test_fused_symbol_path_matches_composition(modulation, A, G):
    """encode_to_symbols == modulate(encode_transport_block) and
    split_rate_matched_symbols == split_rate_matched(demodulate) — the
    interleaver-fusion the chain runs on must be value-exact, every
    modulation order, including multi-code-block configs."""
    from ldpc_3gpp_tpu.models.decoder import (
        split_rate_matched,
        split_rate_matched_symbols,
    )
    from ldpc_3gpp_tpu.models.encoder import encode_to_symbols
    from ldpc_3gpp_tpu.ops.modulation import Q_M

    qm = Q_M[modulation]
    G -= G % qm
    p = LDPCParams(BG=2, A=A, G=G, Q_m=qm)
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.integers(0, 2, size=(3, p.A)).astype(np.int8))

    tx_ref = jax.jit(
        lambda a: modulate(encode_transport_block(p, a), modulation)
    )(a)
    tx_fused = jax.jit(partial(encode_to_symbols, p, modulation=modulation))(a)
    np.testing.assert_array_equal(np.asarray(tx_ref), np.asarray(tx_fused))

    var = esn0_to_variance(2.0)
    rx = awgn(jax.random.PRNGKey(3), tx_ref, var)
    for method in ("exact", "maxlog"):
        d_ref = jax.jit(
            lambda y: split_rate_matched(
                p, demodulate(y, modulation, var, method)
            )
        )(rx)
        d_fused = jax.jit(
            partial(
                split_rate_matched_symbols,
                p,
                modulation=modulation,
                noise_var=var,
                method=method,
            )
        )(rx)
        np.testing.assert_array_equal(np.asarray(d_ref), np.asarray(d_fused))


def test_alpha_schedule_reachable_from_chain():
    """ChainConfig.alpha_schedule reaches the decoder (changes the layered
    NMS trajectory) and is rejected with a clear error on the flooding XLA
    path, which has no use for it (the bit-exact MATLAB-semantics mode)."""
    import jax

    from ldpc_3gpp_tpu.models.chain import ChainConfig, simulate_batch
    from ldpc_3gpp_tpu.spec.params import LDPCParams

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    base = dict(params=p, modulation="QPSK", iterations=8,
                algorithm="min-sum", schedule="layered")
    r0 = jax.jit(
        lambda k: simulate_batch(ChainConfig(**base), k, 3.0, 64)
    )(jax.random.PRNGKey(0))
    r1 = jax.jit(
        lambda k: simulate_batch(
            ChainConfig(**base, alpha_schedule=(0.6, 2)), k, 3.0, 64
        )
    )(jax.random.PRNGKey(0))
    assert int(r0.iterations) != int(r1.iterations)
    with pytest.raises(ValueError, match="alpha_schedule"):
        simulate_batch(
            ChainConfig(params=p, modulation="QPSK", iterations=4,
                        algorithm="min-sum", schedule="flooding",
                        backend="fast", alpha_schedule=(0.6, 1)),
            jax.random.PRNGKey(1), 3.0, 8,
        )
