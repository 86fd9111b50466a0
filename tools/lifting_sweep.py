#!/usr/bin/env python3
"""Lifting-size sweep (BASELINE config #3).

Exercises both base graphs across the standard lifting sizes with
higher-order modulations on a rate-matched K/N grid: for each (BG, Z,
modulation) config, runs a high-SNR end-to-end roundtrip (must be
error-free) and one mid-SNR point (records BLER), using the full chain.

Writes golden/lifting_sweep.json.  Use --quick to subsample Z.
"""
import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # script run: tools/ is sys.path[0]
    import _path  # noqa: F401,E402  (checkout shim; no-op when installed)


def params_for_z(bg, Z, qm, rate):
    """Single-code-block params selecting exactly lifting size Z, or None."""
    from ldpc_3gpp_tpu.spec.params import LDPCParams
    from ldpc_3gpp_tpu.spec.tables import UnsupportedParameters

    if bg == 1:
        kb = 22
    else:
        for kb in (10, 9, 8, 6):
            kp = kb * Z
            chk = 10 if kp > 640 else 9 if kp > 560 else 8 if kp > 192 else 6
            if chk == kb:
                break
    K_prime = kb * Z
    L = 16 if K_prime - 16 <= 3824 else 24
    A = K_prime - L
    if A <= 0:
        return None
    # Rate over K' (info+CRC), not A: at tiny Z the CRC dominates and a
    # rate over A alone yields G < K' — an undecodable configuration (the
    # 2Z punctured systematic bits could never be recovered).
    G = int(round(K_prime / rate / qm) * qm)
    try:
        p = LDPCParams(BG=bg, A=A, G=G, Q_m=qm)
    except UnsupportedParameters:
        return None
    if p.Z_c != Z or p.C != 1:
        return None
    return p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="subsample every 3rd Z")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="golden/lifting_sweep.json")
    args = ap.parse_args()

    import jax

    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from ldpc_3gpp_tpu.models.chain import ChainConfig, simulate_batch
    from ldpc_3gpp_tpu.spec.tables import ALL_LIFTING_SIZES

    results = []
    zs = list(ALL_LIFTING_SIZES)
    if args.quick:
        zs = zs[::3]
    t_start = time.time()
    for bg in (1, 2):
        for i, Z in enumerate(zs):
            mod, qm = (("16QAM", 4), ("64QAM", 6))[i % 2]
            rate = 1 / 2 if bg == 1 else 1 / 3
            p = params_for_z(bg, Z, qm, rate)
            if p is None:
                results.append({"bg": bg, "Z": Z, "status": "unsupported"})
                continue
            cfg = ChainConfig(
                params=p, modulation=mod, iterations=20,
                algorithm="min-sum", backend="fast",
            )
            sim = jax.jit(partial(simulate_batch, cfg, batch=args.batch))
            hi = sim(jax.random.PRNGKey(Z), 30.0)
            hi_errs = int(np.asarray(hi.block_errors))
            # mid-SNR point near the waterfall for this rate/modulation
            mid_esn0 = {("16QAM", 1/2): 6.5, ("64QAM", 1/2): 11.0,
                        ("16QAM", 1/3): 4.0, ("64QAM", 1/3): 8.0}[(mod, rate)]
            mid = sim(jax.random.PRNGKey(1000 + Z), mid_esn0)
            rec = {
                "bg": bg, "Z": Z, "i_LS": p.i_LS, "A": p.A, "G": p.G,
                "modulation": mod, "rate": round(rate, 4),
                "high_snr_block_errors": hi_errs,
                "blocks": args.batch,
                "mid_esn0_db": mid_esn0,
                "mid_bler": int(np.asarray(mid.block_errors)) / args.batch,
                "status": "ok" if hi_errs == 0 else "HIGH-SNR ERRORS",
            }
            results.append(rec)
            print(f"BG{bg} Z={Z:3d} {mod} A={p.A:5d}: high-SNR errors "
                  f"{hi_errs}/{args.batch}, BLER@{mid_esn0}dB "
                  f"{rec['mid_bler']:.3f}")
    bad = [r for r in results if r.get("status") == "HIGH-SNR ERRORS"]
    summary = {
        "description": "Lifting-size sweep (BASELINE config #3): both base "
        "graphs across the standard lifting sizes, alternating 16QAM/64QAM, "
        "single-code-block rate-matched grid; high-SNR roundtrip must be "
        "error-free, mid-SNR BLER recorded.",
        "configs_run": len([r for r in results if r.get("status") != "unsupported"]),
        "device": jax.devices()[0].device_kind,
        "high_snr_failures": len(bad),
        "elapsed_s": round(time.time() - t_start, 1),
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n{summary['configs_run']} configs, {len(bad)} high-SNR failures "
          f"-> {args.out}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
