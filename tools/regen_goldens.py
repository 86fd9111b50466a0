#!/usr/bin/env python3
"""Regenerate the measured golden BLER artifacts on the GPU.

The golden/*.json curves are MEASURED properties of this framework (the
reference publishes no numbers — SURVEY.md section 6); whenever decoder
semantics change (e.g. the early-termination iteration-budget fix) they must
be re-measured, not hand-edited.  Each stage rewrites one artifact with the
identical protocol recorded in its description.

Stages (run all by default, or name a subset):
  headline  BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json + txt
  spvsms    BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json
  config1   BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json
  config2   config2_and_harq.json (BG1 A=8448 waterfall + HARQ IR demo)
  benchcfg  bench_path_bler.json (bench.py config + 64QAM, layered NMS)
  surface   SNR_vs_A_surface.json (A x rate x {1e-1,1e-2} x {SP,MS})
  snrvsa    SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json + txt
  bulk      bulk_montecarlo.json (20M 256QAM blocks @ 15.75 dB)
  bulksp    bulk_sp_montecarlo.json (2M QPSK blocks, SP flooding gate cfg)
  bulklbrm  bulk_lbrm_montecarlo.json (2M blocks, N_L=2 + LBRM-limited cfg)
  bulkcbgti bulk_cbgti_montecarlo.json (2M blocks, per-stage CBGTI HARQ cfg)

Every stage runs in this one process (the bulk stages call
tools/bulk_montecarlo.py's ``main`` in-process): a JAX process reserves most
of the card's memory when it starts, so a second process on the same card
would fail.
"""
import argparse
import glob
import json
import os
import time

if __package__ in (None, ""):  # script run: tools/ is sys.path[0]
    import _path  # noqa: F401,E402  (checkout shim; no-op when installed)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")

_FORCE_RESUME = False


# Stamped into resumable artifacts so a partial regen after a semantics
# change cannot silently mix stale and fresh measurements: resume only
# reuses entries whose stamp matches the current sources.
from ldpc_3gpp_tpu.utils.fingerprint import semantics_fingerprint  # noqa: E402


def _dump(name, obj):
    path = os.path.join(GOLDEN, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    print(f"wrote {path}")


def _curve_points(points):
    return {
        "esn0_db": [p.esn0_db for p in points],
        "bler": [p.bler for p in points],
        "block_errors": [p.block_errors for p in points],
        "blocks": [p.blocks for p in points],
    }


def headline():
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr

    curves = bler_vs_snr(
        A=[3842], rate=[1 / 3], bg=[2], modulation="QPSK",
        iterations=8, target_block_errors=100, target_bler=1e-3,
        esn0_start=0.0, esn0_delta=0.25, seed=0, algorithm="sum-product",
        backend="auto", schedule="flooding",
        batch_per_device=512, steps_per_call=2, results_dir=GOLDEN,
    )
    pts = curves[(2, 1 / 3, 3842)]
    _dump("BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json", {
        "description": (
            "Headline reference config (plot_BLER_vs_SNR.m defaults): BG2, "
            "A=3842, R=1/3 (G=11526), QPSK, rv=[0], flooding sum-product, "
            "8 iterations, early termination, seed 0, >=100 block errors "
            "per point."
        ),
        **_curve_points(pts),
    })
    return pts


def spvsms(sp_points=None):
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr

    common = dict(
        A=[3842], rate=[1 / 3], bg=[2], modulation="QPSK", iterations=8,
        target_block_errors=100, target_bler=1e-3, esn0_start=0.0,
        esn0_delta=0.25, seed=0, batch_per_device=512, steps_per_call=2,
        results_dir="results",
    )
    out = {
        "description": (
            "Algorithm comparison on the headline config (BG2 A=3842 R=1/3 "
            "QPSK, 8 iterations, >=100 block errors/point): "
            "flooding sum-product vs flooding normalized min-sum "
            "(alpha=0.8125) vs layered normalized min-sum. Layered "
            "converges ~2x per sweep, hence the much earlier waterfall at "
            "the same iteration budget."
        ),
    }
    if sp_points is None:
        sp_points = bler_vs_snr(
            algorithm="sum-product", backend="auto", schedule="flooding",
            **common)[(2, 1 / 3, 3842)]
    nms_f = bler_vs_snr(algorithm="min-sum", backend="auto",
                        schedule="flooding", **common)[(2, 1 / 3, 3842)]
    nms_l = bler_vs_snr(algorithm="min-sum", backend="auto",
                        schedule="layered", **common)[(2, 1 / 3, 3842)]
    for name, pts in (("SP-flooding", sp_points), ("NMS-flooding", nms_f),
                      ("NMS-layered", nms_l)):
        out[name] = {
            "esn0_db": [p.esn0_db for p in pts],
            "bler": [p.bler for p in pts],
        }
    _dump("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", out)


def config1():
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr

    pts = bler_vs_snr(
        A=[100], rate=[1 / 2], bg=[2], modulation="QPSK",
        iterations=50, target_block_errors=100, target_bler=1e-3,
        esn0_start=0.0, esn0_delta=0.5, seed=0, algorithm="min-sum",
        backend="fast", batch_per_device=1024, steps_per_call=2,
        results_dir="results",
    )[(2, 1 / 2, 100)]
    d = _curve_points(pts)
    d.pop("block_errors")
    _dump("BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json", {
        "description": (
            "BASELINE config #1: BG2, A=100, rate 1/2 (G=200), QPSK, AWGN, "
            "flooding normalized min-sum (alpha=0.8125) 50 iterations, "
            "early termination, >=100 block errors/point, seed 0. "
            "CPU-runnable reference curve."
        ),
        **d,
    })


def config2():
    import jax
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr, _make_config, _simulate_point
    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo

    out = {
        "description": (
            "BASELINE config #2 (BG1 A=8448 R=1/3 QPSK, layered normalized "
            "min-sum 12 it, early termination) plus a HARQ incremental-"
            "redundancy demonstration: A=2000 at rate 0.8, single "
            "transmission vs rv sequence (0,2,3,1) with LLR accumulation. "
            "A block counts as decoded at the first rv stage whose "
            "accumulated decode passes the TB CRC."
        ),
    }
    pts = bler_vs_snr(
        A=[8448], rate=[1 / 3], bg=[1], modulation="QPSK",
        iterations=12, target_block_errors=100, target_bler=1e-3,
        esn0_start=-0.5, esn0_delta=0.25, seed=0, algorithm="min-sum",
        backend="auto", schedule="layered",
        batch_per_device=2048, steps_per_call=1, results_dir="results",
    )[(1, 1 / 3, 8448)]
    out["BG1_A8448_layered_NMS_12it"] = {
        "esn0_db": [p.esn0_db for p in pts],
        "bler": [p.bler for p in pts],
        "blocks": [p.blocks for p in pts],
        "mean_iterations_per_cb": [
            p.iterations / max(p.blocks * 2, 1) for p in pts  # C=2 CBs/TB
        ],
    }

    # HARQ IR demo: A=2000, R=0.8 (G=2500), QPSK, layered NMS 12 it.
    for name, rv_seq, esn0s, tbe in (
        ("harq_single_shot_rv0", (0,),
         [x * 0.5 for x in range(12)], 100),
        ("harq_harq_ir_rv0231", (0, 2, 3, 1), [0.0], 20),
    ):
        cfg = _make_config(2000, 0.8, 1, "QPSK", rv_seq, 12, "min-sum",
                           backend="auto", schedule="layered")
        mc = MonteCarlo(cfg, batch_per_device=1024, steps_per_call=2)
        esn0_db, bler = [], []
        key = jax.random.PRNGKey(0)
        for esn0 in esn0s:
            pt, _, key = _simulate_point(mc, key, esn0, tbe, True, 2_000_000)
            esn0_db.append(esn0)
            bler.append(pt.bler)
            print(f"{name} Es/N0={esn0:+.2f}: BLER={pt.bler:.4e} "
                  f"({pt.block_errors}/{pt.blocks})")
        out[name] = {"esn0_db": esn0_db, "bler": bler}
    _dump("config2_and_harq.json", out)


def benchcfg():
    """Waterfalls for the throughput-bench configuration (and a 64QAM one).

    The bench (bench.py) measures BG1 A=8424 (C=1, Z=384) R=1/3 QPSK with
    layered normalized min-sum at 12 iterations — these
    curves put that exact path under a BLER regression gate
    (tests/test_bler_regression.py), plus a 64QAM config so high-order
    demod is gated too.
    """
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr

    common = dict(
        iterations=12, target_block_errors=150, target_bler=1e-3,
        seed=0, algorithm="min-sum", backend="auto", schedule="layered",
        batch_per_device=1024, steps_per_call=2, results_dir="results",
    )
    qpsk = bler_vs_snr(
        A=[8424], rate=[1 / 3], bg=[1], modulation="QPSK",
        esn0_start=-1.25, esn0_delta=0.25, **common,
    )[(1, 1 / 3, 8424)]
    qam64 = bler_vs_snr(
        A=[8424], rate=[1 / 2], bg=[1], modulation="64QAM",
        esn0_start=10.0, esn0_delta=0.25, **common,
    )[(1, 1 / 2, 8424)]
    _dump("bench_path_bler.json", {
        "description": (
            "BLER regression anchors for the throughput-bench path: BG1 "
            "A=8424 (single code block, Z=384), layered normalized min-sum "
            "(alpha=0.8125) 12 iterations, early termination, seed 0, "
            ">=150 block errors/point.  QPSK at R=1/3 (the bench.py config) "
            "and 64QAM at R=1/2 (exact-LLR demod gate).  The CPU regression "
            "test re-simulates mid-waterfall points with backend='fast', "
            "schedule='layered', the trajectory these curves measure."
        ),
        "QPSK_R13": _curve_points(qpsk),
        "QAM64_R12": _curve_points(qam64),
    })


def surface():
    """BASELINE config #4: required-Es/N0 surface over A x rate.

    BG1, QPSK, flooding BP at 50 iterations, A = 1000..8000 step 1000,
    R in {1/5, 1/3, 1/2, 2/3}, both SP and normalized min-sum, 100 block
    errors per point, 0.1 dB steps.  One downward sweep per (algo, rate, A)
    records every (Es/N0, BLER) point; the required Es/N0 at BOTH targets
    (1e-1 and 1e-2) is log-domain-interpolated from the same sweep
    (plot_SNR_vs_A.m:175 rule), so the 1e-1 surface costs nothing extra.
    Checkpoints into the artifact after every (algo, rate) so a crash
    resumes (rerun skips completed entries).
    """
    import jax

    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu.parallel.sweep import _make_config, _simulate_point
    from ldpc_3gpp_tpu.spec.tables import UnsupportedParameters
    from ldpc_3gpp_tpu.utils.rng import fast_key
    import numpy as np

    path = os.path.join(GOLDEN, "SNR_vs_A_surface.json")
    out = {
        "description": (
            "Required Es/N0 surface (BASELINE config #4): BG1, QPSK, "
            "flooding BP 50 iterations, early termination, 100 block "
            "errors/point, 0.1 dB steps, seed 0. "
            "A = 1000..8000 step 1000; rates 1/5 (repetition below the "
            "BG1 mother rate), 1/3, 1/2, 2/3; algorithms sum-product and "
            "normalized min-sum (alpha=0.8125); targets BLER 1e-1 and "
            "1e-2 interpolated in the log domain from one sweep per "
            "config (plot_SNR_vs_A.m:175). delta_ms_minus_sp_db is the "
            "min-sum penalty at BLER 1e-2 per point."
        ),
        "A": list(range(1000, 8001, 1000)),
        "semantics": semantics_fingerprint(),
        "curves": {},
    }
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("semantics") == out["semantics"] or _FORCE_RESUME:
            out["curves"] = prev.get("curves", {})
        elif prev.get("curves"):
            print(
                "surface: decoder-semantics fingerprint changed "
                f"({prev.get('semantics')} -> {out['semantics']}); "
                "discarding previous curves (pass --force-resume to keep)"
            )
    starts = {"0.2": -6.0, "0.333333": -3.5, "0.5": -1.5, "0.666667": 0.5}
    targets = (1e-1, 1e-2)
    for algorithm in ("sum-product", "min-sum"):
        for r_key, rate in (("0.2", 1 / 5), ("0.333333", 1 / 3),
                            ("0.5", 1 / 2), ("0.666667", 2 / 3)):
            ckey = f"{algorithm}/{r_key}"
            if ckey in out["curves"]:
                print(f"skip {ckey} (already measured)")
                continue
            curve = {f"required_esn0_db_at_{t:g}": [] for t in targets}
            for A in out["A"]:
                try:
                    cfg = _make_config(A, rate, 1, "QPSK", (0,), 50,
                                       algorithm, backend="auto",
                                       schedule="flooding")
                except UnsupportedParameters as e:
                    for t in targets:
                        curve[f"required_esn0_db_at_{t:g}"].append(None)
                    print(f"{ckey} A={A}: skip ({e})")
                    continue
                mc = MonteCarlo(cfg, batch_per_device=1024, steps_per_call=2)
                key = fast_key(0)
                esn0 = starts[r_key]
                found = False
                pts = []  # (esn0, bler)
                bler = 1.0
                while bler > min(targets):
                    pt, found, key = _simulate_point(
                        mc, key, esn0, 100, found, 2_000_000,
                        prior_bler=bler if bler < 1 else 0.0)
                    bler = pt.bler
                    pts.append((esn0, max(bler, 0.5 / max(pt.blocks, 1))))
                    esn0 += 0.1
                es = np.array([p[0] for p in pts])
                bl = np.log10([p[1] for p in pts])
                for t in targets:
                    # first crossing below the target, log-interp like
                    # plot_SNR_vs_A.m:175
                    i = int(np.argmax(bl <= np.log10(t)))
                    if i == 0:
                        req = float(es[0])
                    else:
                        req = float(np.interp(np.log10(t),
                                              [bl[i], bl[i - 1]],
                                              [es[i], es[i - 1]]))
                    curve[f"required_esn0_db_at_{t:g}"].append(round(req, 4))
                print(f"{ckey} A={A}: "
                      + ", ".join(f"{t:g}->{curve[f'required_esn0_db_at_{t:g}'][-1]}"
                                  for t in targets), flush=True)
            out["curves"][ckey] = curve
            _dump("SNR_vs_A_surface.json", out)  # checkpoint per (algo, rate)
    # per-point min-sum penalty at 1e-2
    delta = {}
    for r_key in starts:
        sp = out["curves"].get(f"sum-product/{r_key}")
        ms = out["curves"].get(f"min-sum/{r_key}")
        if sp and ms:
            delta[r_key] = [
                None if (a is None or b is None) else round(b - a, 4)
                for a, b in zip(sp["required_esn0_db_at_0.01"],
                                ms["required_esn0_db_at_0.01"])
            ]
    out["delta_ms_minus_sp_db"] = delta
    _dump("SNR_vs_A_surface.json", out)


def snrvsa():
    from ldpc_3gpp_tpu.parallel.sweep import snr_vs_a

    curve = snr_vs_a(backend="fast", batch_per_device=512, steps_per_call=2,
                     results_dir=GOLDEN)[1 / 3]
    _dump("SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json", {
        "description": (
            "plot_SNR_vs_A reproduction (reference defaults, "
            "plot_SNR_vs_A.m:37-49): BG1, R=1/3, QPSK, flooding sum-product "
            "50 iterations, required Es/N0 at BLER=1e-2, 100 block "
            "errors/point, 0.1 dB steps with log-domain interpolation, "
            "seed 0. Measured with the fast backend."
        ),
        "A": [a for a, _ in curve],
        "required_esn0_db": [e for _, e in curve],
    })


def _bulk(argv):
    """tools/bulk_montecarlo.py in this process (one process per card)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bulk_montecarlo",
        os.path.join(os.path.dirname(__file__), "bulk_montecarlo.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)


def bulk():
    """Re-measure golden/bulk_montecarlo.json (the artifact that went stale
    in round 2 when the reversed layer order landed without a bulk regen —
    the stage exists so that cannot recur)."""
    _bulk(["--blocks", "20000000", "--esn0", "15.75"])


def bulksp():
    """Measure golden/bulk_sp_montecarlo.json: the SUM-PRODUCT-flooding
    on-chip statistical gate config (BG2 A=2048 Z=208 QPSK, 8 iterations —
    the reference comm.LDPCDecoder semantics, NRLDPCDecoder.m:120).  Gives
    the SP path its own on-chip drift tripwire
    (tests/test_gpu.py::test_bulk_sp_golden_not_stale); the min-sum
    bulk gate alone could not see SP-only regressions."""
    _bulk(
        ["--blocks", "2000000", "--A", "2048", "--rate", str(1 / 3),
         "--modulation", "QPSK", "--esn0", "0.4", "--iterations", "8",
         "--algorithm", "sum-product", "--schedule", "flooding",
         "--batch-per-device", "256", "--steps-per-call", "32",
         "--out", os.path.join(GOLDEN, "bulk_sp_montecarlo.json")])


def bulklbrm():
    """Measure golden/bulk_lbrm_montecarlo.json: Monte-Carlo golden at a
    NON-DEFAULT parameter-engine config — N_L=2 and LBRM on with a
    genuinely limiting buffer (BG1 A=4000 Z=192, TBS_LBRM=6000 ->
    N_cb=9000 < N=12672, G=12000 wraps the circular buffer) — so the
    sweep-reachable N_L/LBRM paths are exercised end-to-end through the
    sharded Monte-Carlo engine on-chip, not only at the conformance level
    (VERDICT r3 item 6).  Gated by
    tests/test_gpu.py::test_bulk_lbrm_golden_not_stale."""
    _bulk(
        ["--blocks", "2000000", "--A", "4000", "--rate", str(1 / 3),
         "--bg", "1", "--modulation", "QPSK", "--esn0", "-0.3",
         "--iterations", "12", "--algorithm", "min-sum",
         "--schedule", "layered", "--N-L", "2", "--I-LBRM", "1",
         "--TBS-LBRM", "6000",
         "--batch-per-device", "256", "--steps-per-call", "32",
         "--out", os.path.join(GOLDEN, "bulk_lbrm_montecarlo.json")])


def bulkcbgti():
    """Measure golden/bulk_cbgti_montecarlo.json: Monte-Carlo golden at a
    CBGTI-non-default config — BG2 A=7650 Z=288 C=3 QPSK R=1/3, HARQ
    rv_sequence=(0,2) with per-stage CBGTI ((),(0,)): the retransmission
    reschedules only code blocks 1-2, so G redistributes over C'=2
    (NRLDPC.m:485-507) and CB 0 must ride the latched b_hat / HARQ-buffer
    carry path (NRLDPCDecoder.m:286-318).  Operating point measured with
    layered 8-it, 60k-block scans: at -0.5 dB the rv-0-only BLER is
    0.310 (per-CB ~0.115) and the 2-stage final BLER is ~0.115 — i.e.
    essentially every rescheduled-CB failure recovers through the partial
    retransmission while excluded-CB-0 failures ride (and are bounded by)
    the carry, so BOTH CBGTI-specific paths carry dominant statistical
    weight and the golden BLER pins their interplay.  Gated by
    tests/test_gpu.py::test_bulk_cbgti_golden_not_stale (VERDICT r4
    item 3: the last first-class tunable gets a measured end-to-end
    artifact)."""
    _bulk(
        ["--blocks", "2000000", "--A", "7650", "--rate", str(1 / 3),
         "--bg", "2", "--modulation", "QPSK", "--esn0", "-0.5",
         "--iterations", "8", "--algorithm", "min-sum",
         "--schedule", "layered", "--rv-sequence", "0", "2",
         "--cbgti-seq", "[[],[0]]",
         "--batch-per-device", "256", "--steps-per-call", "32",
         "--out", os.path.join(GOLDEN, "bulk_cbgti_montecarlo.json")])


STAGES = {
    "headline": None,  # handled specially (feeds spvsms)
    "spvsms": spvsms,
    "config1": config1,
    "config2": config2,
    "benchcfg": benchcfg,
    "surface": surface,
    "snrvsa": snrvsa,
    "bulk": bulk,
    "bulksp": bulksp,
    "bulklbrm": bulklbrm,
    "bulkcbgti": bulkcbgti,
}


def doc_consistency(root=None):
    """Grep-level doc guard: every "<batch>x<steps> dispatch" the docs
    quote for the bench protocol matches bench.py's actual constants.

    VERDICT round-4 weak #3: DESIGN.md still said "128x1024 ... dispatch"
    after the measured protocol moved to 128x2048 — numbers drifting
    WITHIN the repo's own round, against its measured-numbers-in-sync
    discipline.  Rule: any line in the checked docs that contains the word
    'dispatch' and a token ``<HEADLINE_BATCH>x<digits>`` must quote the
    current protocol, unless the line is marked 'historical'; and
    CLAUDE.md + DESIGN.md must each state the current protocol at least
    once.  Returns a list of problems (empty = consistent); raises under
    regen so a stale doc fails the same command that refreshes artifacts.
    """
    import re

    from ldpc_3gpp_tpu.bench import HEADLINE_BATCH, HEADLINE_STEPS

    proto = f"{HEADLINE_BATCH}x{HEADLINE_STEPS}"
    root = root or os.path.join(os.path.dirname(__file__), "..")
    docs = ("DESIGN.md", "CLAUDE.md",
            os.path.join(".claude", "skills", "verify", "SKILL.md"))
    problems = []
    tok = re.compile(rf"\b{HEADLINE_BATCH}x(\d+)\b")
    for rel in docs:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        mentions_proto = False
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if proto in line or (
                    f"batch={HEADLINE_BATCH} x steps={HEADLINE_STEPS}" in line
                ):
                    mentions_proto = True
                if "dispatch" not in line or "historical" in line:
                    continue
                for m in tok.finditer(line):
                    if m.group(0) != proto:
                        problems.append(
                            f"{rel}:{i}: stale dispatch protocol "
                            f"{m.group(0)!r} (bench.py uses {proto}): "
                            f"{line.strip()!r}"
                        )
        if rel in ("DESIGN.md", "CLAUDE.md") and not mentions_proto:
            problems.append(
                f"{rel}: never states the current bench dispatch protocol "
                f"{proto}"
            )
    return problems


def restamp():
    """Refresh the ``semantics`` stamp of every stamped golden WITHOUT
    re-measuring.

    Only legitimate after a VERIFIED-neutral change: the CPU BLER
    regression gates (tests/test_bler_regression.py) and the card's
    statistical gates (``LDPC_TEST_GPU=1 python -m pytest -m gpu -p
    no:xdist``: test_bulk_golden_not_stale, test_bulk_sp_golden_not_stale,
    test_bulk_cbgti_golden_not_stale, test_bulk_lbrm_golden_not_stale in
    tests/test_gpu.py) must pass against the existing artifacts first,
    proving the source change did not move the measured curves.
    """
    current = semantics_fingerprint()
    for path in sorted(glob.glob(os.path.join(GOLDEN, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "semantics" in data:
            if data["semantics"] != current:
                data["semantics"] = current
                with open(path, "w") as f:
                    json.dump(data, f, indent=1)
                    f.write("\n")
                print(f"restamped {os.path.basename(path)} -> {current}")
            else:
                print(f"{os.path.basename(path)} already current")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stages", nargs="*", default=[],
                    choices=list(STAGES) + [[]])
    ap.add_argument("--force-resume", action="store_true",
                    help="reuse checkpointed surface curves even if the "
                         "decoder-semantics fingerprint changed")
    ap.add_argument("--restamp", action="store_true",
                    help="refresh stamps on existing artifacts without "
                         "re-measuring (ONLY after the BLER gates "
                         "verified the change was semantics-neutral)")
    args = ap.parse_args()
    if args.restamp:
        restamp()
        return
    problems = doc_consistency()
    if problems:
        raise SystemExit(
            "doc/protocol drift (fix the docs or bench.py first; regen "
            "owns the artifacts the docs quote):\n  " + "\n  ".join(problems)
        )
    stages = args.stages or list(STAGES)
    global _FORCE_RESUME
    _FORCE_RESUME = args.force_resume

    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.time()
    sp_pts = None
    if "headline" in stages:
        sp_pts = headline()
        print(f"[{time.time()-t0:.0f}s] headline done")
    for name in stages:
        if name == "headline":
            continue
        if name == "spvsms":
            spvsms(sp_pts)
        else:
            STAGES[name]()
        print(f"[{time.time()-t0:.0f}s] {name} done")


if __name__ == "__main__":
    main()
