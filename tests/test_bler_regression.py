"""BLER regression against the golden headline curve.

golden/BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json records the
reference configuration's waterfall measured with high statistics (up to 700k
blocks/point) — the framework's equivalent of the MATLAB curve, since the
fast backend implements the identical flooding sum-product algorithm.

The CPU test re-simulates one mid-waterfall point with modest statistics and
checks the measured BLER lies inside a generous binomial confidence interval
of the golden value.  A drift in any chain stage (LLR scaling, rate matching,
decoder math) shows up here as a waterfall shift.
"""
import json
import os
from functools import partial

import jax
import numpy as np
import pytest

from ldpc_3gpp_tpu.models.chain import ChainConfig, simulate_batch
from ldpc_3gpp_tpu.spec.params import LDPCParams

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "golden")
GOLDEN = os.path.join(
    GOLDEN_DIR, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json"
)
BENCH_GOLDEN = os.path.join(GOLDEN_DIR, "bench_path_bler.json")


def _gate_point(sim, batch, curve, reps, target_bler, seed0=1000):
    """Re-simulate the golden point nearest ``target_bler`` and gate it.

    Binomial 99.9%-style interval around the golden probability, sized so a
    waterfall shift of ~0.25 dB (which moves BLER by an order of magnitude
    in these steep regions) trips in either direction.
    """
    idx = int(np.argmin(np.abs(np.log10(np.maximum(curve["bler"], 1e-9))
                               - np.log10(target_bler))))
    esn0 = curve["esn0_db"][idx]
    p_expected = curve["bler"][idx]
    errors = blocks = 0
    for i in range(reps):
        r = sim(jax.random.PRNGKey(seed0 + i), esn0)
        errors += int(np.asarray(r.block_errors))
        blocks += int(np.asarray(r.blocks))
    bler = errors / blocks
    sd = np.sqrt(p_expected * (1 - p_expected) / blocks)
    assert abs(bler - p_expected) < 4.5 * sd + 1e-9, (
        f"measured BLER {bler:.4f} vs golden {p_expected:.4f} at "
        f"{esn0:+.2f} dB ({errors}/{blocks} errors) — waterfall shifted?"
    )


@pytest.mark.slow
def test_mid_waterfall_point_matches_golden():
    with open(GOLDEN) as f:
        g = json.load(f)
    # 0.25 dB point: golden BLER 0.157 — steep region, sensitive to any shift
    idx = g["esn0_db"].index(0.25)
    curve = {"esn0_db": [0.25], "bler": [g["bler"][idx]]}
    params = LDPCParams(BG=2, A=3842, G=11526, Q_m=2)
    cfg = ChainConfig(
        params=params, modulation="QPSK", iterations=8,
        algorithm="sum-product", backend="fast",
    )
    sim = jax.jit(partial(simulate_batch, cfg, batch=64))
    _gate_point(sim, 64, curve, reps=4, target_bler=curve["bler"][0])


@pytest.mark.slow
def test_bench_path_layered_nms_matches_golden():
    """The throughput-bench configuration (BG1 A=8424 Z=384, layered NMS
    12 it) gated against its measured golden waterfall at two anchors:
    the shoulder (BLER ~0.84, catches degradation) and the steep mid-fall
    (BLER ~0.055, catches improvement/shift both ways), through the same
    layered XLA backend the chain runs on every platform."""
    with open(BENCH_GOLDEN) as f:
        g = json.load(f)
    params = LDPCParams(BG=1, A=8424, G=25272, Q_m=2)
    cfg = ChainConfig(
        params=params, modulation="QPSK", iterations=12,
        algorithm="min-sum", backend="fast", schedule="layered",
    )
    sim = jax.jit(partial(simulate_batch, cfg, batch=32))
    _gate_point(sim, 32, g["QPSK_R13"], reps=8, target_bler=0.8)
    _gate_point(sim, 32, g["QPSK_R13"], reps=16, target_bler=0.06, seed0=2000)


@pytest.mark.slow
def test_bench_path_64qam_matches_golden():
    """64QAM R=1/2 leg of the bench-path golden: gates the high-order
    exact-LLR demodulator together with the layered NMS decoder."""
    with open(BENCH_GOLDEN) as f:
        g = json.load(f)
    params = LDPCParams(BG=1, A=8424, G=16848, Q_m=6)
    cfg = ChainConfig(
        params=params, modulation="64QAM", iterations=12,
        algorithm="min-sum", backend="fast", schedule="layered",
    )
    sim = jax.jit(partial(simulate_batch, cfg, batch=32))
    _gate_point(sim, 32, g["QAM64_R12"], reps=8, target_bler=0.9)
    _gate_point(sim, 32, g["QAM64_R12"], reps=8, target_bler=0.2, seed0=2000)
