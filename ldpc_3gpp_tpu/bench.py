"""Single-GPU throughput benchmark (the repo-root bench.py implementation).

Default mode prints ONE JSON line with the headline number:

  {"metric": "decoded_info_mbps_per_chip", "value": N, "unit": "Mbit/s",
   "vs_baseline": N, ...}

Config per BASELINE.json north star: BG1, Z=384 (A=8424), rate 1/3, QPSK,
normalized min-sum, full end-to-end chain (encode + modulate + AWGN + exact
LLR demod + BP decode + CRC gating) at an Es/N0 near the waterfall so early
termination reflects realistic iteration counts.

``--sweep`` instead measures the early-termination THROUGHPUT ECONOMICS the
headline over-summarizes: decoded Gbit/s and mean iterations/TB vs Es/N0
across the waterfall, vs the iteration budget, and for two non-flagship
configs (a BG2 mid-Z sum-product-flooding "MATLAB semantics" row and a
small-Z row).  One JSON line per row.

Both modes refuse to run unless JAX's first device is a GPU, and every
result names the device (``device_kind`` and the device count).

vs_baseline is measured codewords/s divided by an estimated MATLAB
single-threaded rate for the same config (comm.LDPCDecoder sum-product,
~25k-bit codewords at tens of iterations ~= 20 codewords/s; the reference
publishes no numbers — BASELINE.json "published": {}).  Target is >= 100x.

vs_measured_scalar_cpu is the fully MEASURED companion ratio: the same
config decoded by the independent single-core scalar C++ oracle
(native/golden.cpp nr_golden_decode, flooding BP with parity-check early
termination), timed on this host right before the GPU measurement.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

MATLAB_CODEWORDS_PER_SEC_EST = 20.0  # documented assumption, see module docstring

#: the flagship operating point (BASELINE.json north star)
FLAGSHIP = dict(A=8424, rate=1 / 3, qm=2, bg=1)

#: the headline dispatch protocol (batch x fori_loop steps per dispatch).
#: Single source of truth: docs quoting "<batch>x<steps> dispatch" are
#: checked against these by tools/regen_goldens.py::doc_consistency
#: (quick-tier test test_doc_consistency) — VERDICT r4 found the DESIGN.md
#: copies had drifted from the measured protocol.
HEADLINE_BATCH = 128
HEADLINE_STEPS = 2048


def measure_scalar_cpu(A, G, qm, esn0_db, iterations, min_seconds=1.5):
    """Measured single-core scalar CPU baseline: the independent C++ oracle.

    Times native/golden.cpp's full TB decode chain (nr_golden_decode —
    deliberately different algorithms from the JAX path: scalar
    lifted-adjacency flooding BP with parity-check early termination) at the
    bench config, on host-generated QPSK channel LLRs at the same Es/N0, for
    both normalized min-sum and sum-product.  This anchors ``vs_baseline``
    with a measured number; the 20 cw/s MATLAB estimate stays as a
    cross-check only.  Returns {algorithm: codewords_per_sec}.
    """
    import numpy as np

    from ldpc_3gpp_tpu.utils.golden import golden_decode, golden_encode

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, size=A).astype(np.uint8)
    g = golden_encode(1, A, G, qm, a)
    # exact QPSK LLRs (positive => bit 0): y = s + n, llr = 2*sqrt(2)*y/var
    var = 10.0 ** (-esn0_db / 10.0)
    y = (1.0 - 2.0 * g.astype(np.float64)) / np.sqrt(2.0)
    y = y + rng.normal(0.0, np.sqrt(var / 2.0), size=G)
    llr = (2.0 * np.sqrt(2.0) / var * y).astype(np.float32)

    rates = {}
    for algorithm in ("min-sum", "sum-product"):
        # warmup (also forces the make build outside the timed region)
        golden_decode(1, A, G, qm, llr, iterations=iterations,
                      algorithm=algorithm)
        n, elapsed = 0, 0.0
        t0 = time.perf_counter()
        while elapsed < min_seconds:
            golden_decode(1, A, G, qm, llr, iterations=iterations,
                          algorithm=algorithm)
            n += 1
            elapsed = time.perf_counter() - t0
        rates[algorithm] = n / elapsed
    return rates


def _flagship_config(iterations=12, algorithm="min-sum", schedule="layered"):
    from ldpc_3gpp_tpu.models.chain import ChainConfig
    from ldpc_3gpp_tpu.spec.params import LDPCParams

    # A=8424 -> B=8448=K_cb: single code block, K'=8448, Z=384 (the
    # north-star kernel shape: BG1, Z=384, min-sum).
    A, rate, qm = FLAGSHIP["A"], FLAGSHIP["rate"], FLAGSHIP["qm"]
    G = round(A / rate / qm) * qm
    params = LDPCParams(BG=FLAGSHIP["bg"], A=A, G=G, Q_m=qm)
    assert params.Z_c == 384 and params.C == 1
    return ChainConfig(
        params=params,
        modulation="QPSK",
        rv_sequence=(0,),
        iterations=iterations,
        algorithm=algorithm,
        early_termination=True,
        backend="auto",  # the XLA layered decoder
        schedule=schedule,  # BASELINE config #2: layered normalized min-sum
    )


def measure_throughput(cfg, esn0, batch=128, steps=1024, trials=3, reps=4):
    """Decoded-info throughput of one (config, Es/N0) cell on this chip.

    Returns (transport_blocks_per_sec, mean_iterations_per_TB,
    block_errors, blocks).  Dispatch protocol per DESIGN.md section 8
    (back-to-back submits, one aggregate host fetch per trial, best-of
    trials).
    """
    from ldpc_3gpp_tpu.models.chain import simulate_batch
    from ldpc_3gpp_tpu.utils.rng import fast_key

    def sim_many(key, esn0_db):
        def body(i, acc):
            r = simulate_batch(cfg, jax.random.fold_in(key, i), esn0_db, batch)
            return (acc[0] + r.blocks, acc[1] + r.block_errors,
                    acc[2] + r.iterations)

        zero = jnp.zeros((), jnp.int32)
        return jax.lax.fori_loop(0, steps, body, (zero, zero, zero))

    sim = jax.jit(sim_many)
    e = jnp.asarray(esn0, jnp.float32)
    r = sim(fast_key(0), e)
    _ = int(r[1])  # host fetch: waits for the warm-up run

    times = []
    errs = blocks = iters = 0
    for t in range(trials):
        t0 = time.perf_counter()
        outs = [sim(fast_key(1 + t * reps + i), e) for i in range(reps)]
        # ONE aggregate scalar fetch is the sync point (it depends on every
        # rep's completion)
        errs_t = int(sum(o[1] for o in outs))
        times.append(time.perf_counter() - t0)
        errs += errs_t
        blocks += int(sum(o[0] for o in outs))
        iters += int(sum(o[2] for o in outs))
    best = min(times) / reps
    tb_per_sec = batch * steps / best
    return tb_per_sec, iters / max(blocks, 1), errs, blocks


def _headline(args):
    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = _flagship_config()
    A = cfg.params.A
    batch = HEADLINE_BATCH
    # sim steps per dispatch: amortises host->device launch latency
    steps = HEADLINE_STEPS
    esn0 = 1.0  # near the BG1 R=1/3 waterfall: realistic iteration mix
    tb_per_sec, mean_it, errs, blocks = measure_throughput(
        cfg, esn0, batch=batch, steps=steps, trials=4, reps=4
    )
    info_mbps = tb_per_sec * A / 1e6

    # Measured single-core scalar C++ baseline at the same config (the
    # independent oracle; see measure_scalar_cpu).  Guarded: the bench's
    # headline number must never depend on the host toolchain.
    try:
        cpu = measure_scalar_cpu(A, cfg.params.G, cfg.params.Q_m, esn0,
                                 cfg.iterations)
    except Exception as e:  # noqa: BLE001
        cpu = {}
        print(f"# scalar-cpu baseline unavailable: {type(e).__name__}: {e}")
    print(
        json.dumps(
            {
                "metric": "decoded_info_mbps_per_chip",
                "value": round(info_mbps, 3),
                "unit": "Mbit/s",
                "vs_baseline": round(
                    tb_per_sec / MATLAB_CODEWORDS_PER_SEC_EST, 2
                ),
                # measured ratio vs the single-core scalar C++ oracle decoding
                # the SAME config (normalized min-sum, 12 it, early term);
                # the MATLAB 20 cw/s figure above is only an estimate
                "vs_measured_scalar_cpu": (
                    round(tb_per_sec / cpu["min-sum"], 2)
                    if "min-sum" in cpu else None
                ),
                "detail": {
                    "scalar_cpu_codewords_per_sec": {
                        k: round(v, 3) for k, v in cpu.items()
                    },
                    "config": "BG1 A=8424 Z=384 R=1/3 QPSK min-sum 12it "
                              "early-term",
                    "esn0_db": esn0,
                    "transport_blocks_per_sec": round(tb_per_sec, 2),
                    "mean_iterations_per_tb": round(mean_it, 3),
                    "block_errors": errs,
                    "blocks": blocks,
                    "device": _device(),
                },
            }
        )
    )


def sweep_rows():
    """The ET-economics measurement grid: (name, cfg-factory, esn0, knobs).

    Rows:
    - flagship vs Es/N0 across the waterfall (approx -1..+4 dB — the BG1
      R=1/3 QPSK waterfall sits near +1 dB; reference protocol
      plot_BLER_vs_SNR.m:30-42 spans the same way)
    - flagship vs iteration budget at the headline point
    - BG2 mid-Z (Z=208) sum-product flooding — the reference decoder's
      literal semantics (NRLDPCDecoder.m:120)
    - the same config, sum-product LAYERED — the fast SP option
    - small-Z (BG2 Z=72) layered min-sum
    - flagship 2-stage HARQ IR at -2 dB — the measured retransmission cost
      (both rv stages execute for almost every block)
    """
    from ldpc_3gpp_tpu.models.chain import ChainConfig
    from ldpc_3gpp_tpu.spec.params import LDPCParams

    def bg2_cfg(A, algorithm, schedule, iterations, qm=2):
        G = round(A * 3 / qm) * qm  # R = 1/3
        params = LDPCParams(BG=2, A=A, G=G, Q_m=qm)
        return ChainConfig(
            params=params, modulation="QPSK", rv_sequence=(0,),
            iterations=iterations, algorithm=algorithm,
            early_termination=True, backend="auto", schedule=schedule,
        )

    rows = []
    for esn0 in (-1.0, 0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0):
        rows.append(dict(
            name=f"flagship_esn0_{esn0:+.1f}",
            cfg=_flagship_config(), esn0=esn0,
            batch=128, steps=256,
        ))
    for it in (4, 8, 12, 25):
        rows.append(dict(
            name=f"flagship_iters_{it}",
            cfg=_flagship_config(iterations=it), esn0=1.0,
            batch=128, steps=256,
        ))
    # BG2 A=2048 -> K'=2064, K_b=10, Z=208: reference-semantics row
    rows.append(dict(
        name="bg2_z208_sumproduct_flooding",
        cfg=bg2_cfg(2048, "sum-product", "flooding", 8), esn0=2.0,
        batch=128, steps=64,
    ))
    # The same config on the LAYERED schedule: the fast sum-product option.
    # Same BP fixed points, different message trajectory — flooding stays
    # the literal MATLAB semantics mode (NRLDPCDecoder.m:120).
    rows.append(dict(
        name="bg2_z208_sumproduct_layered",
        cfg=bg2_cfg(2048, "sum-product", "layered", 8), esn0=2.0,
        batch=128, steps=256,
    ))
    # BG2 A=600 -> K'=616, K_b=9, Z=72: small-Z row
    rows.append(dict(
        name="bg2_z72_packed_layered",
        cfg=bg2_cfg(600, "min-sum", "layered", 12), esn0=2.0,
        batch=512, steps=256,
    ))
    # HARQ incremental-redundancy economics: flagship with a 2-stage rv
    # sequence at an Es/N0 where the first shot usually fails, so the
    # second (Chase+IR-combined) decode really runs — the measured cost of
    # a retransmission round trip vs the single-shot rows above.
    flag_harq = _flagship_config()
    rows.append(dict(
        name="flagship_harq_rv02_esn0_-2.0",
        cfg=ChainConfig(
            params=flag_harq.params, modulation="QPSK",
            rv_sequence=(0, 2), iterations=12, algorithm="min-sum",
            early_termination=True, backend="auto", schedule="layered",
        ),
        esn0=-2.0, batch=128, steps=128,
    ))
    return rows


def run_sweep(trials=3, reps=2):
    """Measure every sweep row; returns a list of result dicts."""
    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    out = []
    for row in sweep_rows():
        cfg = row["cfg"]
        tb_per_sec, mean_it, errs, blocks = measure_throughput(
            cfg, row["esn0"], batch=row["batch"], steps=row["steps"],
            trials=trials, reps=reps,
        )
        rec = {
            "name": row["name"],
            "esn0_db": row["esn0"],
            "iterations_budget": cfg.iterations,
            "algorithm": cfg.algorithm,
            "schedule": cfg.schedule,
            "A": cfg.params.A,
            "Z": cfg.params.Z_c,
            "BG": cfg.params.BG,
            "info_mbps": round(tb_per_sec * cfg.params.A / 1e6, 2),
            "tb_per_sec": round(tb_per_sec, 1),
            "mean_iterations_per_tb": round(mean_it, 3),
            "bler": round(errs / max(blocks, 1), 6),
            "blocks": blocks,
            "device": _device(),
        }
        out.append(rec)
        print(json.dumps(rec))
    return out


def _device():
    """The device every result names: platform, kind and count."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweep", action="store_true",
                    help="measure the ET throughput-economics surface "
                         "(one JSON line per row) instead of the headline")
    args = ap.parse_args(argv)
    dev = _device()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"bench: JAX's first device is {dev['platform']!r} "
            f"({dev['kind']}); the benchmark measures a GPU only"
        )
    print(f"# device: {dev['kind']} x {dev['count']}", flush=True)
    if args.sweep:
        run_sweep()
    else:
        _headline(args)


if __name__ == "__main__":
    main()
