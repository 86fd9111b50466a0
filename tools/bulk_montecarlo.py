#!/usr/bin/env python3
"""Bulk Monte-Carlo demonstration (BASELINE config #5, single-chip scale).

Simulates a large number of transport blocks of a 256QAM link at a fixed
Es/N0 with psum-aggregated counters, reporting BLER with tight confidence
and sustained throughput.  On several devices the same code fans out over
all of them (the dp mesh spans every device; see parallel/launcher.py) —
there is no cross-device communication besides the final counter psum.

Example:  python tools/bulk_montecarlo.py --blocks 100000000 --esn0 17.0
"""
import argparse
import json
import os
import time

if __package__ in (None, ""):  # script run: tools/ is sys.path[0]
    import _path  # noqa: F401,E402  (checkout shim; no-op when installed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=10_000_000)
    ap.add_argument("--A", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=1 / 2)
    ap.add_argument("--bg", type=int, default=1)
    ap.add_argument("--modulation", default="256QAM")
    ap.add_argument("--esn0", type=float, default=17.0)
    ap.add_argument("--iterations", type=int, default=12)
    # Deep dispatches: bulk runs have no adaptive host decisions to feed,
    # so unlike the sweeps there is no reason to keep calls small (a pure
    # protocol choice; the BLER statistics are untouched).
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--steps-per-call", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algorithm", default="min-sum",
                    choices=["min-sum", "offset-min-sum", "sum-product"])
    ap.add_argument("--schedule", default="layered",
                    choices=["layered", "flooding"])
    # full parameter engine (NRLDPC.m:51-85 tunables)
    ap.add_argument("--N-L", type=int, default=1, dest="N_L")
    ap.add_argument("--I-LBRM", type=int, default=0, dest="I_LBRM")
    ap.add_argument("--TBS-LBRM", type=int, default=None, dest="TBS_LBRM")
    ap.add_argument("--CBGTI", type=int, nargs="*", default=(), dest="CBGTI")
    ap.add_argument("--rv-sequence", type=int, nargs="*", default=(0,),
                    dest="rv_sequence",
                    help="HARQ redundancy-version sequence (default: 0)")
    ap.add_argument("--cbgti-seq", default=None, dest="cbgti_seq",
                    help="per-stage CBGTI as JSON, e.g. '[[],[0]]' — stage i "
                         "excludes the listed code blocks (tunable-"
                         "between-steps CBGTI, NRLDPC.m:71-85)")
    ap.add_argument("--out", default="golden/bulk_montecarlo.json")
    args = ap.parse_args(argv)

    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from ldpc_3gpp_tpu.models.chain import ChainConfig
    from ldpc_3gpp_tpu.ops.modulation import Q_M
    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu.spec.params import LDPCParams

    qm = Q_M[args.modulation]
    unit = qm * args.N_L
    G = round(args.A / args.rate / unit) * unit
    params = LDPCParams(BG=args.bg, A=args.A, G=G, Q_m=qm, N_L=args.N_L,
                        I_LBRM=args.I_LBRM, TBS_LBRM=args.TBS_LBRM,
                        CBGTI=tuple(args.CBGTI))
    cbgti_seq = (None if args.cbgti_seq is None else
                 tuple(tuple(c) for c in json.loads(args.cbgti_seq)))
    cfg = ChainConfig(
        params=params, modulation=args.modulation, iterations=args.iterations,
        algorithm=args.algorithm, backend="auto", schedule=args.schedule,
        rv_sequence=tuple(args.rv_sequence), cbgti_sequence=cbgti_seq,
    )
    mc = MonteCarlo(
        cfg, batch_per_device=args.batch_per_device,
        steps_per_call=args.steps_per_call,
    )
    from ldpc_3gpp_tpu.utils.rng import fast_key
    key = fast_key(args.seed)
    totals = {"blocks": 0, "block_errors": 0, "bit_errors": 0, "iterations": 0}
    # warm up / compile
    key, sub = jax.random.split(key)
    mc.run(sub, args.esn0)
    t0 = time.time()
    last_print = t0
    while totals["blocks"] < args.blocks:
        key, sub = jax.random.split(key)
        remaining = -(-(args.blocks - totals["blocks"]) // mc.blocks_per_run)
        c = mc.run_pipelined(sub, args.esn0, min(8, max(1, remaining)))
        for k in totals:
            totals[k] += c[k]
        now = time.time()
        if now - last_print > 20:
            rate_bps = totals["blocks"] / (now - t0)
            print(f"{totals['blocks']:,} blocks, {totals['block_errors']:,} "
                  f"errors, {rate_bps:,.0f} blocks/s", flush=True)
            last_print = now
    dt = time.time() - t0
    bler = totals["block_errors"] / totals["blocks"]
    from ldpc_3gpp_tpu.utils.fingerprint import semantics_fingerprint

    result = {
        "description": "Bulk Monte-Carlo (BASELINE config #5 at single-chip "
        "scale): fixed-SNR 256QAM link, psum-aggregated counters.",
        # decoder-semantics stamp: tests/test_goldens_stamped.py flags this
        # artifact as stale whenever the sources it measures change
        "semantics": semantics_fingerprint(),
        "config": {
            "BG": args.bg, "A": args.A, "G": G, "modulation": args.modulation,
            "esn0_db": args.esn0, "iterations": args.iterations,
            "algorithm": args.algorithm, "schedule": args.schedule,
            "N_L": args.N_L, "I_LBRM": args.I_LBRM,
            "TBS_LBRM": args.TBS_LBRM, "CBGTI": list(args.CBGTI),
            "rv_sequence": list(args.rv_sequence),
            "cbgti_sequence": (None if cbgti_seq is None
                               else [list(c) for c in cbgti_seq]),
            "N_cb": params.N_cb, "N": params.N,
            "devices": jax.device_count(),
        },
        "blocks": totals["blocks"],
        "block_errors": totals["block_errors"],
        "bit_errors": totals["bit_errors"],
        "bler": bler,
        "mean_iterations_per_cb": totals["iterations"] / max(totals["blocks"] * params.C, 1),
        "elapsed_s": round(dt, 1),
        "transport_blocks_per_sec": round(totals["blocks"] / dt, 1),
        "info_mbps": round(totals["blocks"] / dt * args.A / 1e6, 2),
    }
    print(json.dumps(result, indent=1))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
