"""Statistical BLER gates on the card.

Each gate re-measures one bulk Monte-Carlo golden (golden/bulk_*.json)
through the same sharded ``MonteCarlo`` path users run, with
``backend="auto"``, and requires the BLER to sit within 5 combined sigma of
the artifact — a true semantics gate: refactors that preserve the decode
trajectory pass untouched, anything that moves the operating point (layer
order, algorithm constants, early-termination semantics) fails until
``python tools/regen_goldens.py <stage>`` re-measures.  The CPU suite
checks bit-exactness against the C++ oracle; these gates catch a compiler
or platform difference that only shows up as a shifted waterfall.

Run on the card with:

    LDPC_TEST_GPU=1 python -m pytest -m gpu -p no:xdist

(one process: see tests/conftest.py).  Elsewhere every test here skips
with a reason.
"""
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest

from ldpc_3gpp_tpu.models.chain import ChainConfig
from ldpc_3gpp_tpu.ops.modulation import Q_M
from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu.spec.params import LDPCParams
from ldpc_3gpp_tpu.utils.rng import fast_key

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")

#: gate -> (golden file, RNG seed, minimum blocks, batch per device).  The
#: batch sizes only set how the blocks are dispatched (large batches
#: amortize the GPU's per-kernel launch cost at small Z); a gate's sigma
#: depends on its block count alone.
GATES = {
    "bulk": ("bulk_montecarlo.json", 777, 1_300_000, 8192),
    "bulksp": ("bulk_sp_montecarlo.json", 778, 500_000, 4096),
    "bulkcbgti": ("bulk_cbgti_montecarlo.json", 781, 200_000, 1024),
    "bulklbrm": ("bulk_lbrm_montecarlo.json", 779, 500_000, 2048),
}
STEPS_PER_CALL = 2
WINDOW = 4


def _gate_config(name):
    """The golden artifact and the ChainConfig it was measured with."""
    with open(os.path.join(GOLDEN, GATES[name][0])) as f:
        golden = json.load(f)
    g = golden["config"]
    params = dict(BG=g["BG"], A=g["A"], G=g["G"], Q_m=Q_M[g["modulation"]])
    chain = {}
    if name == "bulklbrm":
        params.update(N_L=g["N_L"], I_LBRM=g["I_LBRM"],
                      TBS_LBRM=g["TBS_LBRM"], CBGTI=tuple(g["CBGTI"]))
    if name == "bulkcbgti":
        chain.update(
            rv_sequence=tuple(g["rv_sequence"]),
            cbgti_sequence=tuple(tuple(c) for c in g["cbgti_sequence"]),
        )
    p = LDPCParams(**params)
    cfg = ChainConfig(
        params=p, modulation=g["modulation"], iterations=g["iterations"],
        algorithm=g["algorithm"], backend="auto", schedule=g["schedule"],
        **chain,
    )
    return golden, cfg


@pytest.fixture(scope="module")
def gates(gpu_module):
    """Every gate's MonteCarlo, compiled side by side before the first
    gate runs: XLA compiles outside the GIL, and the four compiles are a
    large share of this tier's time.  Returns name -> (golden, MonteCarlo).
    """
    out = {}
    for name, (_, _, _, batch) in GATES.items():
        golden, cfg = _gate_config(name)
        out[name] = golden, MonteCarlo(cfg, batch_per_device=batch,
                                       steps_per_call=STEPS_PER_CALL)

    def compile_step(golden, mc):
        e = jnp.asarray(golden["config"]["esn0_db"], jnp.float32)
        return mc._step.lower(fast_key(0), e).compile()

    with ThreadPoolExecutor(len(out)) as ex:
        for job in [ex.submit(compile_step, *v) for v in out.values()]:
            job.result()
    return out


def _measure(name, gates):
    """BLER of gate ``name`` over at least its minimum block count."""
    golden, mc = gates[name]
    _, seed, min_blocks, _ = GATES[name]
    esn0_db = golden["config"]["esn0_db"]
    blocks = errors = 0
    key = fast_key(seed)
    while blocks < min_blocks:
        key, sub = jax.random.split(key)
        c = mc.run_pipelined(sub, esn0_db, WINDOW)
        blocks += c["blocks"]
        errors += c["block_errors"]
    return golden, errors / blocks, blocks


def _assert_within_5_sigma(golden, bler, blocks, stage, binomial=False):
    p_hat = golden["bler"]
    q = (1 - p_hat) if binomial else 1.0
    sigma = math.sqrt(p_hat * q * (1 / blocks + 1 / golden["blocks"]))
    assert abs(bler - p_hat) < 5 * sigma, (
        f"{stage} golden stale or semantics drifted on the card: measured "
        f"{bler:.3e} over {blocks} blocks vs golden {p_hat:.3e} "
        f"(|diff| > 5 sigma = {5 * sigma:.2e}) — re-measure with "
        f"tools/regen_goldens.py {stage}"
    )


def test_bulk_golden_not_stale(gates):
    """Layered NMS, 256QAM (golden/bulk_montecarlo.json), ~1.3M blocks."""
    golden, bler, blocks = _measure("bulk", gates)
    _assert_within_5_sigma(golden, bler, blocks, "bulk")


def test_bulk_sp_golden_not_stale(gates):
    """Flooding sum-product, the reference comm.LDPCDecoder semantics
    (golden/bulk_sp_montecarlo.json), ~0.5M blocks.  Its phi uses tanh and
    log, whose last bits differ between XLA backends, so the SP path needs
    its own drift tripwire on the card."""
    golden, bler, blocks = _measure("bulksp", gates)
    _assert_within_5_sigma(golden, bler, blocks, "bulksp")


def test_bulk_cbgti_golden_not_stale(gates):
    """Per-stage CBGTI HARQ (golden/bulk_cbgti_montecarlo.json: BG2 A=7650
    Z=288 C=3, rv (0,2) with stage 2 excluding CB 0), ~0.2M blocks.  ~30%
    of successes at this point come from the skipped-CB b_hat/HARQ-buffer
    carry + E_r redistribution path (NRLDPC.m:471-482,
    NRLDPCDecoder.m:286-318), so breakage there moves the BLER far outside
    the gate."""
    assert gates["bulkcbgti"][1].cfg.params.C == 3  # the multi-CB structure
    golden, bler, blocks = _measure("bulkcbgti", gates)
    _assert_within_5_sigma(golden, bler, blocks, "bulkcbgti", binomial=True)


def test_bulk_lbrm_golden_not_stale(gates):
    """N_L=2 + LBRM-limited buffer (golden/bulk_lbrm_montecarlo.json: BG1
    A=4000 Z=192, TBS_LBRM=6000 -> N_cb=9000 < N, circular buffer wrapped
    by G=12000), ~0.5M blocks."""
    golden, mc = gates["bulklbrm"]
    p = mc.cfg.params
    assert p.N_cb == golden["config"]["N_cb"] < p.N  # the buffer limit
    golden, bler, blocks = _measure("bulklbrm", gates)
    _assert_within_5_sigma(golden, bler, blocks, "bulklbrm")
