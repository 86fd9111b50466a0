"""BP decoder tests: noiseless, noisy waterfall, early termination, fillers."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_3gpp_tpu.ops.channel import awgn, esn0_to_variance
from ldpc_3gpp_tpu.ops.decoder import decode
from ldpc_3gpp_tpu.ops.encoder import encode
from ldpc_3gpp_tpu.ops.modulation import demodulate, modulate
from ldpc_3gpp_tpu.spec.params import LDPCParams

RNG = np.random.default_rng(5)
ALGOS = ["sum-product", "min-sum", "offset-min-sum"]


def _random_codewords(p, batch):
    c = RNG.integers(0, 2, size=(batch, p.K)).astype(np.uint8)
    c[:, p.K_prime :] = 0
    return np.asarray(encode(p, jnp.asarray(c)))


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("bg", [1, 2])
def test_noiseless_decode(bg, algorithm):
    p = LDPCParams(BG=bg, A=120, G=360, Q_m=2)
    cw = _random_codewords(p, 4)
    llr = jnp.asarray((1.0 - 2.0 * cw) * 8.0)
    res = jax.jit(partial(decode, p, iterations=10, algorithm=algorithm))(llr)
    np.testing.assert_array_equal(np.asarray(res.bits), cw)
    assert np.asarray(res.parity_ok).all()
    assert (np.asarray(res.iterations) == 0).all()  # satisfied before iterating


@pytest.mark.parametrize("algorithm", ALGOS)
def test_noisy_decode_qpsk(algorithm):
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cw = _random_codewords(p, 16)
    tx = modulate(jnp.asarray(cw), "QPSK")
    var = esn0_to_variance(4.0)
    rx = awgn(jax.random.PRNGKey(2), tx, var)
    llr = demodulate(rx, "QPSK", var, "exact")
    res = jax.jit(partial(decode, p, iterations=30, algorithm=algorithm))(llr)
    match = (np.asarray(res.bits) == cw).all(axis=-1)
    assert match.sum() >= 15, f"{algorithm}: only {match.sum()}/16 decoded at 4 dB"


def test_early_termination_matches_full_run():
    """With and without early stop, successfully decoded words agree."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cw = _random_codewords(p, 8)
    tx = modulate(jnp.asarray(cw), "QPSK")
    var = esn0_to_variance(3.0)
    rx = awgn(jax.random.PRNGKey(3), tx, var)
    llr = demodulate(rx, "QPSK", var, "exact")
    r1 = jax.jit(partial(decode, p, iterations=20, early_termination=True))(llr)
    r2 = jax.jit(partial(decode, p, iterations=20, early_termination=False))(llr)
    ok1, ok2 = np.asarray(r1.parity_ok), np.asarray(r2.parity_ok)
    both = ok1 & ok2
    np.testing.assert_array_equal(
        np.asarray(r1.bits)[both], np.asarray(r2.bits)[both]
    )
    assert (np.asarray(r1.iterations) <= np.asarray(r2.iterations)).all()


def test_filler_llrs_survive_message_passing():
    """Huge filler LLRs must not produce NaNs or flip filler decisions."""
    p = LDPCParams(BG=2, A=99, G=298, Q_m=2)  # K' < K: has fillers
    assert p.num_filler > 0
    cw = _random_codewords(p, 2)
    llr = (1.0 - 2.0 * cw) * 2.0
    llr[:, p.K_prime : p.K] = 1e20  # fillers pinned
    res = jax.jit(partial(decode, p, iterations=10, algorithm="min-sum"))(
        jnp.asarray(llr.astype(np.float32))
    )
    bits = np.asarray(res.bits)
    assert np.isfinite(np.asarray(res.iterations)).all()
    np.testing.assert_array_equal(bits[:, p.K_prime : p.K], 0)


def test_min_sum_close_to_sum_product():
    """Normalized min-sum should be within ~0.2% success of sum-product here."""
    p = LDPCParams(BG=1, A=1000, G=3000, Q_m=2)
    cw = _random_codewords(p, 24)
    tx = modulate(jnp.asarray(cw), "QPSK")
    var = esn0_to_variance(1.2)
    rx = awgn(jax.random.PRNGKey(4), tx, var)
    llr = demodulate(rx, "QPSK", var, "exact")
    sp = jax.jit(partial(decode, p, iterations=25, algorithm="sum-product"))(llr)
    ms = jax.jit(partial(decode, p, iterations=25, algorithm="min-sum"))(llr)
    n_sp = int(np.asarray(sp.parity_ok).sum())
    n_ms = int(np.asarray(ms.parity_ok).sum())
    assert abs(n_sp - n_ms) <= 6, (n_sp, n_ms)


@pytest.mark.slow
def test_early_termination_budget_exact():
    """Never-converged codewords must get EXACTLY `iterations` updates.

    Regression for an off-by-one where the early-termination loop's final
    syndrome-check pass also applied an extra update: with random
    non-convergent LLRs, fast-ET(N) must equal the oracle at N and differ
    from the oracle at N+1.
    """
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    llr = jnp.asarray(RNG.normal(size=(8, p.num_cols * p.Z_c)).astype(np.float32))
    from ldpc_3gpp_tpu.ops.decoder_fast import decode as decode_fast_impl

    for N in (3, 5):
        ro = jax.jit(partial(decode, p, iterations=N, algorithm="min-sum"))(llr)
        ro1 = jax.jit(partial(decode, p, iterations=N + 1, algorithm="min-sum"))(llr)
        rf = jax.jit(
            partial(decode_fast_impl, p, iterations=N, algorithm="min-sum")
        )(llr)
        np.testing.assert_array_equal(np.asarray(rf.bits), np.asarray(ro.bits))
        assert not np.array_equal(np.asarray(rf.bits), np.asarray(ro1.bits))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_auto_backend_resolves_to_xla_path(schedule):
    """backend='auto' is the production XLA path for the schedule — the
    layered decoder or the static-roll flooding decoder — on every platform,
    bit-for-bit, with the schedule keyword dropped."""
    from ldpc_3gpp_tpu.models.decoder import DECODE_BACKENDS
    from ldpc_3gpp_tpu.ops.decoder_fast import decode as decode_fast
    from ldpc_3gpp_tpu.ops.decoder_layered import decode as decode_layered

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    llr = jnp.asarray(
        RNG.normal(1.0, 2.0, size=(4, p.num_cols * p.Z_c)).astype(np.float32)
    )
    want_fn = decode_layered if schedule == "layered" else decode_fast
    got = jax.jit(partial(DECODE_BACKENDS["auto"], p, algorithm="min-sum",
                          iterations=6, schedule=schedule))(llr)
    want = jax.jit(partial(want_fn, p, algorithm="min-sum", iterations=6))(llr)
    assert DECODE_BACKENDS["auto"] is DECODE_BACKENDS["fast"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("backend", ["pallas", "pallas-interpret"])
def test_removed_kernel_backends_rejected(backend):
    """The accelerator-kernel backends are gone: a ChainConfig naming one
    fails at construction, and so does a direct TB decode."""
    from ldpc_3gpp_tpu.models.chain import ChainConfig
    from ldpc_3gpp_tpu.models.decoder import decode_transport_block

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    with pytest.raises(ValueError, match="unknown decode backend"):
        ChainConfig(params=p, modulation="QPSK", backend=backend)
    with pytest.raises(ValueError, match="unknown decode backend"):
        decode_transport_block(p, jnp.zeros((1, p.G)), backend=backend)


def test_message_dtype_rejected():
    """message_dtype was a knob of the removed kernel; no path accepts it."""
    from ldpc_3gpp_tpu.models.chain import ChainConfig
    from ldpc_3gpp_tpu.models.decoder import decode_transport_block

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    with pytest.raises(TypeError):
        ChainConfig(params=p, modulation="QPSK", message_dtype="bfloat16")
    with pytest.raises(TypeError):
        decode_transport_block(p, jnp.zeros((1, p.G)),
                               message_dtype="bfloat16")


def test_layer_order_validation():
    """layer_order: 'natural' / 'reversed' / an explicit permutation of the
    base-graph rows; anything else is rejected before tracing."""
    from ldpc_3gpp_tpu.ops.decoder_fast import _resolve_layer_order
    from ldpc_3gpp_tpu.ops.decoder_layered import decode as decode_layered

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    nr = p.num_rows
    assert _resolve_layer_order(p, "natural") == tuple(range(nr))
    assert _resolve_layer_order(p, "reversed") == tuple(range(nr - 1, -1, -1))
    explicit = tuple(range(1, nr)) + (0,)
    assert _resolve_layer_order(p, explicit) == explicit
    llr = jnp.zeros((2, p.num_cols * p.Z_c))
    for bad in ((0, 1, 2), tuple(range(nr - 1)) + (0,)):
        with pytest.raises(ValueError, match="layer_order must permute"):
            decode_layered(p, llr, layer_order=bad)
