#!/usr/bin/env python3
"""Bring-up smoke run of the NR LDPC link chain on an NVIDIA GPU.

Drives the normal entry points at real size, in phases, and exits non-zero
if any phase fails.  Findings go to earlier lines; the last line of
standard output is one JSON object naming the device JAX ran on:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card, the default):

- card tests: ``LDPC_TEST_GPU=1 python -m pytest -m gpu -p no:xdist`` in a
  child process, run to its end before this process imports JAX, so only
  one process holds the card at a time;
- device: the first JAX device must be a GPU (no CPU fallback); prints its
  kind, the device count and ``nvidia-smi``'s name and power limit;
- compile: the large programs of the next phases, compiled side by side;
- reference experiment: ``parallel.sweep.bler_vs_snr`` with the reference
  defaults (BG2 A=3842 R=1/3 QPSK, flooding sum-product, 8 iterations) at
  two Es/N0 points, each BLER within 5 sigma of the measured golden;
- flagship: ``MonteCarlo`` at BG1 A=8424 Z=384 R=1/3 QPSK, layered
  normalized min-sum with a 12-iteration budget, batch 1024 per device —
  compile seconds, memory analysis, TB/s, decoded Mbit/s, mean iterations;
- vs reference: the same host-generated inputs on the GPU and on
  ``jax.devices("cpu")[0]``: CRC and encoder bit-exact, layered NMS decode
  bit-exact (and timed alone on the card at batch 1024), flooding
  sum-product within a stated tolerance, exact-LLR demodulation within a
  stated rtol.

``--multi`` runs only the multi-card phase: ``MonteCarlo`` over
``default_mesh()`` on every visible card at the flagship must equal, in
integers, the per-device ``simulate_batch`` sums run on one card.

Usage:  python chip_smoke.py            # one card
        python chip_smoke.py --multi    # four cards of one host
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SINGLE_PHASES = ("card_tests", "device", "compile", "reference", "flagship",
                 "vs_reference")
MULTI_PHASES = ("device", "multi")
#: the gpu-marked tests in tests/test_gpu.py (all four must pass, none skip)
N_CARD_TESTS = 4
FLAGSHIP_BATCH = 1024
FLAGSHIP_ESN0_DB = 1.0  # near the BG1 R=1/3 waterfall: realistic iteration mix
#: reference experiment (plot_BLER_vs_SNR.m:30-42 defaults) and the two
#: Es/N0 points it runs: 0.5 and 0.75 dB (golden BLER 0.21 and 0.030)
REFERENCE = dict(A=3842, rate=1 / 3, bg=2, modulation="QPSK", iterations=8,
                 algorithm="sum-product")
REFERENCE_BATCH = 256  # bler_vs_snr's default batch per device


def select_phases(argv=None):
    """Parse the command line; return the phases to run, in order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-card phase over every card")
    args = ap.parse_args(argv)
    return MULTI_PHASES if args.multi else SINGLE_PHASES


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reports no GPU")
    return out


def card_tests() -> None:
    """Run the gpu-marked tests in a child process (before JAX loads here)."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = {**os.environ, "LDPC_TEST_GPU": "1"}
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "-p", "no:xdist",
             "-p", "no:cacheprovider", "-q", "--durations=10",
             f"--junitxml={xml}", "tests"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
        )
        dt = time.perf_counter() - t0
        tail = "\n".join(r.stdout.strip().splitlines()[-25:])
        print(f"card tests ({dt:.1f} s):\n{tail}", flush=True)
        import xml.etree.ElementTree as ET

        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        counts = {k: int(suite.get(k, 0))
                  for k in ("tests", "errors", "failures", "skipped")}
    passed = (counts["tests"] - counts["errors"] - counts["failures"]
              - counts["skipped"])
    if r.returncode != 0 or passed != N_CARD_TESTS or counts["skipped"]:
        raise RuntimeError(
            f"card tests: rc={r.returncode}, {passed} passed of "
            f"{N_CARD_TESTS} expected, counts {counts}"
        )


def check_device(want_count=None):
    """Require a GPU as JAX's first device; returns (device, count)."""
    import jax

    dev = jax.devices()[0]
    count = len(jax.devices())
    if dev.platform != "gpu":
        raise RuntimeError(
            f"JAX's first device is {dev.platform!r} ({dev.device_kind}); "
            "this smoke run needs an NVIDIA GPU and has no CPU fallback"
        )
    if want_count is not None and count != want_count:
        raise RuntimeError(f"need {want_count} GPUs, JAX sees {count}")
    return dev, count


def _flagship_cfg():
    from ldpc_3gpp_tpu.bench import _flagship_config

    cfg = _flagship_config()  # BG1 A=8424 Z=384, layered NMS, 12 iterations
    assert cfg.params.Z_c == 384 and cfg.backend == "auto"
    return cfg


def _sigma5(p_ref, n_ref, n):
    """5 combined binomial sigma of a BLER difference (n and n_ref blocks)."""
    return 5.0 * math.sqrt(p_ref * (1 - p_ref) * (1 / n + 1 / n_ref))


def reference_experiment() -> None:
    """bler_vs_snr at the reference defaults vs the measured golden curve."""
    from ldpc_3gpp_tpu.parallel.sweep import bler_vs_snr

    with open(os.path.join(
        ROOT, "golden", "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json"
    )) as f:
        golden = json.load(f)
    ref = {round(e, 6): (b, n) for e, b, n in
           zip(golden["esn0_db"], golden["bler"], golden["blocks"])}
    with tempfile.TemporaryDirectory() as results:
        t0 = time.perf_counter()
        # from 0.5 dB in 0.25 dB steps; stops at the first point with
        # BLER <= 5e-2, which is the second
        r = REFERENCE
        curves = bler_vs_snr(
            A=[r["A"]], rate=[r["rate"]], bg=[r["bg"]],
            modulation=r["modulation"], iterations=r["iterations"],
            algorithm=r["algorithm"], backend="auto", target_block_errors=50,
            target_bler=5e-2, esn0_start=0.5, esn0_delta=0.25, seed=0,
            batch_per_device=REFERENCE_BATCH, results_dir=results,
            verbose=False,
        )
        dt = time.perf_counter() - t0
        points = curves[(r["bg"], r["rate"], r["A"])]
        fname = os.path.join(results,
                             "BLER_vs_SNR_3842_0.333333_2_QPSK_8_50_0.5_0.txt")
        with open(fname) as f:
            rows = [ln.split() for ln in f if not ln.startswith("#")]
    if len(points) != 2 or len(rows) != 2:
        raise RuntimeError(f"expected 2 sweep points, got {len(points)} "
                           f"and {len(rows)} results-file rows")
    for pt, row in zip(points, rows):
        if abs(float(row[0]) - pt.esn0_db) > 1e-6 or (
                abs(float(row[1]) - pt.bler) > 1e-6 * max(pt.bler, 1e-12)):
            raise RuntimeError(f"results file row {row} != point {pt}")
        p_ref, n_ref = ref[round(pt.esn0_db, 6)]
        tol = _sigma5(p_ref, n_ref, pt.blocks)
        print(f"reference Es/N0={pt.esn0_db:+.2f} dB: BLER {pt.bler:.4e} "
              f"({pt.block_errors}/{pt.blocks}) vs golden {p_ref:.4e}, "
              f"|diff| {abs(pt.bler - p_ref):.2e} < 5 sigma {tol:.2e}?",
              flush=True)
        if pt.block_errors < 50:
            raise RuntimeError(f"only {pt.block_errors} errors at "
                               f"{pt.esn0_db} dB")
        if abs(pt.bler - p_ref) >= tol:
            raise RuntimeError(f"BLER {pt.bler} vs golden {p_ref} at "
                               f"{pt.esn0_db} dB is beyond 5 sigma")
    print(f"reference experiment: {dt:.1f} s (compile included)", flush=True)


def _host_llrs(params, batch, esn0_db, seed):
    """Encoded random codewords + QPSK AWGN channel LLRs, on the host.

    Bits come from numpy; the codeword from the repo's encoder on the CPU
    device; noise from numpy.  The rv-0 transmission is the first G
    non-filler positions after the punctured 2Z columns (k0 = 0); those
    carry channel LLRs, the rest 0, fillers +FILLER_LLR — the decoder input
    the chain builds.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ldpc_3gpp_tpu.models.decoder import FILLER_LLR
    from ldpc_3gpp_tpu.ops.encoder import encode

    rng = np.random.default_rng(seed)
    Z, K, Kp = params.Z_c, params.K, params.K_prime
    c = rng.integers(0, 2, size=(batch, K)).astype(np.int8)
    c[:, Kp:] = 0
    cpu = jax.devices("cpu")[0]
    cw = np.asarray(jax.jit(lambda x: encode(params, x))(
        jax.device_put(jnp.asarray(c), cpu)))
    cols = np.arange(2 * Z, cw.shape[-1])
    tx = cols[(cols < Kp) | (cols >= K)][: params.G]
    assert tx.size == params.G, "G beyond one pass of the buffer"
    var = 10.0 ** (-esn0_db / 10.0)
    y = (1.0 - 2.0 * cw[:, tx]) / np.sqrt(2.0)
    y = y + rng.normal(0.0, np.sqrt(var / 2.0), size=y.shape)
    llr = np.zeros(cw.shape, np.float32)
    llr[:, tx] = 2.0 * np.sqrt(2.0) * y / var
    llr[:, Kp:K] = FILLER_LLR
    return cw, llr


def _timed(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))  # warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def compile_programs(card: str) -> dict:
    """Compile the large GPU programs of the later phases side by side.

    XLA compiles outside the GIL, and cold compiles are most of a run's
    time.  Returns name -> (object, compiled): the flagship MonteCarlo
    and the two jitted decoders, which the later phases call and so reuse
    these executables; the reference experiment builds its own MonteCarlo
    and finds its program in the persistent compilation cache.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from functools import partial

    from ldpc_3gpp_tpu.ops.decoder_fast import decode as decode_fast
    from ldpc_3gpp_tpu.ops.decoder_layered import decode as decode_layered
    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu.parallel.sweep import _make_config
    from ldpc_3gpp_tpu.utils.rng import fast_key

    gpu = jax.devices()[0]
    cfg = _flagship_cfg()
    p, p2 = cfg.params, _sum_product_params()
    r = REFERENCE
    ref_cfg = _make_config(r["A"], r["rate"], r["bg"], r["modulation"], (0,),
                           r["iterations"], r["algorithm"], backend="auto")

    def llrs(p, batch):  # committed to the card, as vs_reference passes them
        return jax.device_put(
            np.zeros((batch, p.num_cols * p.Z_c), np.float32), gpu)

    esn0 = jnp.asarray(FLAGSHIP_ESN0_DB, jnp.float32)
    mc = MonteCarlo(cfg, batch_per_device=FLAGSHIP_BATCH)
    mc_ref = MonteCarlo(ref_cfg, batch_per_device=REFERENCE_BATCH)
    layered = jax.jit(partial(decode_layered, p, iterations=cfg.iterations,
                              algorithm=cfg.algorithm))
    sum_product = jax.jit(partial(decode_fast, p2, iterations=8,
                                  algorithm="sum-product"))
    jobs = {  # name -> (object, jitted function, example arguments)
        "flagship": (mc, mc._step, (fast_key(0), esn0)),
        "reference": (mc_ref, mc_ref._step, (fast_key(0), esn0)),
        "layered": (layered, layered, (llrs(p, FLAGSHIP_BATCH),)),
        "sum_product": (sum_product, sum_product,
                        (llrs(p2, N_SUM_PRODUCT),)),
    }

    def compile_one(name):
        obj, fn, args = jobs[name]
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        print(f"compile {name}: {time.perf_counter() - t0:.1f} s [{card}]",
              flush=True)
        return obj, compiled

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(compile_one, name) for name in jobs}
        programs = {name: f.result() for name, f in futures.items()}
    print(f"compile: {len(jobs)} programs side by side in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return programs


def flagship(card: str, programs: dict) -> None:
    """MonteCarlo at the flagship, batch 1024: memory, rates."""
    from ldpc_3gpp_tpu.utils.rng import fast_key

    cfg = _flagship_cfg()
    p = cfg.params
    mc, compiled = programs["flagship"]
    print(f"flagship chain memory_analysis: {compiled.memory_analysis()}",
          flush=True)
    key = fast_key(0)
    t0 = time.perf_counter()
    mc.run(key, FLAGSHIP_ESN0_DB)  # first call through the user entry point
    first_s = time.perf_counter() - t0
    calls = 8
    t0 = time.perf_counter()
    c = mc.run_pipelined(fast_key(1), FLAGSHIP_ESN0_DB, calls)
    dt = time.perf_counter() - t0
    tb_s = c["blocks"] / dt
    mean_it = c["iterations"] / max(c["blocks"] * p.C, 1)
    print(f"flagship chain: first run() {first_s:.2f} s; {calls} calls x "
          f"{mc.blocks_per_run} TB in {dt:.3f} s = {tb_s:,.1f} TB/s, "
          f"{tb_s * p.A / 1e6:,.2f} decoded Mbit/s, mean {mean_it:.3f} "
          f"it/TB, BLER {c['block_errors'] / c['blocks']:.3e} "
          f"({c['block_errors']}/{c['blocks']}) [{card}]", flush=True)
    if c["blocks"] != calls * mc.blocks_per_run:
        raise RuntimeError(f"counted {c['blocks']} blocks")
    if not 1.0 <= mean_it <= cfg.iterations:
        raise RuntimeError(f"mean iterations {mean_it} out of range")


def _on(dev, fn, *args):
    """Run ``jax.jit(fn)`` on ``dev`` with host inputs; return numpy leaves."""
    import jax
    import numpy as np

    out = jax.jit(fn)(*[jax.device_put(a, dev) for a in args])
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


#: layered NMS codewords compared with the CPU (of the 1024 timed)
N_LAYERED_CPU = 256
#: flooding sum-product codewords compared
N_SUM_PRODUCT = 512


def _sum_product_params():
    """BG2 A=2048 Z=208: the flooding sum-product comparison's code."""
    from ldpc_3gpp_tpu.spec.params import LDPCParams

    p = LDPCParams(BG=2, A=2048, G=6144, Q_m=2)
    assert p.Z_c == 208
    return p


def _vs_cases():
    """The GPU-vs-CPU comparisons: (name, function, host inputs, CPU rows).

    Inputs come from numpy RNGs with fixed seeds, so every process builds
    the same arrays.  ``CPU rows`` limits the CPU to the leading rows (a
    codeword's decode does not depend on the rest of its batch).
    """
    import numpy as np
    from functools import partial

    from ldpc_3gpp_tpu.ops.crc import crc_attach, crc_check
    from ldpc_3gpp_tpu.ops.decoder_fast import decode as decode_fast
    from ldpc_3gpp_tpu.ops.decoder_layered import decode as decode_layered
    from ldpc_3gpp_tpu.ops.encoder import encode
    from ldpc_3gpp_tpu.ops.modulation import demodulate

    rng = np.random.default_rng(11)
    cfg = _flagship_cfg()
    p = cfg.params

    def crc(a):
        b = crc_attach(a, p.tb_crc)
        bad = b.at[:, 7].add(1) % 2
        return b, crc_check(b, p.tb_crc), crc_check(bad, p.tb_crc)

    cases = [
        ("crc", crc, (rng.integers(0, 2, (512, p.A)).astype(np.int8),), None),
        ("encode", partial(encode, p),
         (rng.integers(0, 2, (256, p.K)).astype(np.int8),), None),
    ]
    for mod, var in (("256QAM", 10 ** (-2.0)), ("16QAM", 10 ** (-1.0))):
        y = (rng.normal(size=(64, 4096)) + 1j * rng.normal(size=(64, 4096)))
        cases.append((f"demod_{mod}", partial(
            demodulate, modulation=mod, noise_var=var, method="exact"),
            ((0.7 * y).astype(np.complex64),), None))
    _, llr = _host_llrs(p, FLAGSHIP_BATCH, FLAGSHIP_ESN0_DB, seed=5)
    cases.append(("layered", partial(decode_layered, p,
                                     iterations=cfg.iterations,
                                     algorithm=cfg.algorithm),
                  (llr,), N_LAYERED_CPU))
    p2 = _sum_product_params()
    _, llr2 = _host_llrs(p2, N_SUM_PRODUCT, 0.4, seed=7)
    cases.append(("sum_product", partial(decode_fast, p2, iterations=8,
                                         algorithm="sum-product"),
                  (llr2,), None))
    return cases


def cpu_reference(path: str) -> None:
    """The CPU half of ``vs_reference``, saved to ``path`` (.npz).

    Meant for a child process with JAX_PLATFORMS=cpu that runs while the
    card is busy with other phases; it never touches the GPU.
    """
    import jax
    import numpy as np

    cpu = jax.devices("cpu")[0]
    out = {}
    with jax.default_matmul_precision("highest"):
        for name, fn, args, rows in _vs_cases():
            args = tuple(a[:rows] for a in args) if rows else args
            for i, leaf in enumerate(_on(cpu, fn, *args)):
                out[f"{name}/{i}"] = leaf
    np.savez(path, **out)


def start_cpu_reference(tmp: str):
    """Start ``cpu_reference`` in a CPU-only child; returns (process, path)."""
    path = os.path.join(tmp, "cpu_reference.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.cpu_reference({path!r})"],
        cwd=ROOT, env=env,
    )
    return proc, path


def vs_reference(card: str, cpu_ref, programs: dict) -> None:
    """Same host inputs on the GPU and on the CPU device, compared.

    ``cpu_ref`` is the (process, path) of ``start_cpu_reference``, or None
    to compute the CPU half here; ``programs`` holds the two decoders
    compiled by ``compile_programs``.
    """
    import jax
    import numpy as np

    gpu = jax.devices()[0]
    g = {}
    for name, fn, args, _ in _vs_cases():
        if name not in programs:
            # no f32 product may run in TF32 (the CPU side uses the same)
            with jax.default_matmul_precision("highest"):
                g[name] = _on(gpu, fn, *args)
            continue
        # the two decoders, compiled by compile_programs (they hold no
        # matrix product, so the precision setting does not reach them)
        dec = programs[name][0]
        x = jax.device_put(args[0], gpu)
        t0 = time.perf_counter()
        jax.block_until_ready(dec(x))
        first_s = time.perf_counter() - t0
        g[name] = [np.asarray(v) for v in jax.tree_util.tree_leaves(dec(x))]
        if name != "layered":
            continue
        dt = _timed(dec, x)  # the decoder alone at the flagship, batch 1024
        A = _flagship_cfg().params.A
        print(f"flagship decode alone: first call {first_s:.2f} s; "
              f"{dt * 1e3:.2f} ms per batch of {FLAGSHIP_BATCH} = "
              f"{FLAGSHIP_BATCH / dt:,.1f} codewords/s, "
              f"{FLAGSHIP_BATCH * A / dt / 1e6:,.2f} info Mbit/s, mean "
              f"{float(np.mean(g[name][2])):.3f} it [{card}]", flush=True)
    if cpu_ref is None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cpu_reference.npz")
            cpu_reference(path)
            ref = dict(np.load(path))
    else:
        proc, path = cpu_ref
        t0 = time.perf_counter()
        if proc.wait(timeout=900) != 0:
            raise RuntimeError(f"CPU reference child exited {proc.returncode}")
        print(f"vs reference: waited {time.perf_counter() - t0:.1f} s for the "
              "CPU reference child", flush=True)
        ref = dict(np.load(path))
    c = {name: [ref[f"{name}/{i}"] for i in range(len(g[name]))]
         for name in g}

    # CRC24A attach/check at A=8424 (bf16 0/1 operands, f32 accumulation:
    # exact, sums < 2^24) and the encoder at Z=384: bit-exact
    for name in ("crc", "encode"):
        for x, y in zip(g[name], c[name]):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert not g["crc"][1].any() and g["crc"][2].all(), "CRC flags wrong"
    print("vs reference: CRC24A attach/check at A=8424: bit-exact", flush=True)
    print("vs reference: LDPC encode BG1 Z=384: bit-exact", flush=True)

    # layered NMS at the flagship: bits, parity flags, iteration counts
    n = N_LAYERED_CPU
    for label, x, y in zip(("bits", "parity_ok", "iterations"),
                           g["layered"], c["layered"]):
        np.testing.assert_array_equal(x[:n], y, err_msg=f"layered {label}")
    it = c["layered"][2]
    print(f"vs reference: layered NMS BG1 Z=384, {n} codewords: bit-exact "
          f"(bits, parity flags, iterations; {int(np.sum(~c['layered'][1]))}"
          f" unconverged, iterations {np.bincount(it).tolist()})", flush=True)

    # flooding sum-product at BG2 Z=208: phi = -log(tanh(x/2)) may round
    # differently in the last bits on XLA:GPU and XLA:CPU.  Tolerance: at
    # least 99% of codewords with equal bits and equal parity flags
    gb, gok, git = g["sum_product"]
    cb, cok, cit = c["sum_product"]
    share = float(np.mean(np.all(gb == cb, axis=-1)))
    flags_same = float(np.mean(gok == cok))
    max_dit = int(np.max(np.abs(git.astype(int) - cit.astype(int))))
    print(f"vs reference: flooding SP BG2 Z=208, {len(gb)} codewords: bits "
          f"equal in {share:.4f} of codewords, parity flags equal in "
          f"{flags_same:.4f}, max |iteration difference| {max_dit}",
          flush=True)
    if share < 0.99 or flags_same < 0.99:
        raise RuntimeError("flooding sum-product GPU vs CPU beyond tolerance")

    # exact-LLR demodulation (log-sum-exp): f32 exp/log last-bit differences
    for mod in ("256QAM", "16QAM"):
        (x,), (y,) = g[f"demod_{mod}"], c[f"demod_{mod}"]
        err = np.abs(x - y)
        rel = float(np.max(err / np.maximum(np.abs(y), 1.0)))
        print(f"vs reference: exact-LLR demod {mod}: max |diff| "
              f"{float(err.max()):.3e}, max |diff|/max(|llr|,1) {rel:.3e}",
              flush=True)
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                   err_msg=f"exact demod {mod}")


def multi(card: str, batch=FLAGSHIP_BATCH, steps=2, cfg=None) -> None:
    """MonteCarlo over every device == per-device simulate_batch sums."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from ldpc_3gpp_tpu.models.chain import simulate_batch
    from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo, default_mesh

    cfg = cfg or _flagship_cfg()
    mesh = default_mesh()
    n = mesh.size
    mc = MonteCarlo(cfg, batch_per_device=batch, mesh=mesh,
                    steps_per_call=steps)
    key = jax.random.PRNGKey(2024)
    sim = jax.jit(partial(simulate_batch, cfg, batch=batch))
    dev0 = jax.devices()[0]
    e = jax.device_put(jnp.asarray(FLAGSHIP_ESN0_DB, jnp.float32), dev0)

    # compile the mesh program and the one-card program side by side (XLA
    # compiles outside the GIL); the calls below then load them from the
    # persistent compilation cache
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        e_mesh = jnp.asarray(FLAGSHIP_ESN0_DB, jnp.float32)  # uncommitted
        jobs = [ex.submit(lambda: mc._step.lower(key, e_mesh).compile()),
                ex.submit(lambda: sim.lower(key, e).compile())]
        for j in jobs:
            j.result()
    print(f"multi: compile (both programs) {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    got = mc.run(key, FLAGSHIP_ESN0_DB)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = mc.run_pipelined(jax.random.PRNGKey(1), FLAGSHIP_ESN0_DB, 4)
    dt = time.perf_counter() - t0
    print(f"multi: {n} devices x {batch} TB x {steps} steps; first run() "
          f"{first_s:.1f} s; 4 calls {dt:.3f} s = "
          f"{c['blocks'] / dt:,.1f} TB/s, "
          f"{c['blocks'] / dt * cfg.params.A / 1e6:,.2f} decoded Mbit/s "
          f"[{card}]", flush=True)

    want = dict(blocks=0, block_errors=0, bit_errors=0, iterations=0)
    hist = np.zeros(cfg.iterations + 1, np.int64)
    for d in range(n):
        for i in range(steps):
            k = jax.device_put(
                jax.random.fold_in(jax.random.fold_in(key, d), i), dev0)
            r = sim(k, e)
            for f in want:
                want[f] += int(getattr(r, f))
            hist += np.asarray(r.iteration_hist, np.int64)
    got_hist = got.pop("iteration_hist")
    print(f"multi: mesh {got}, per-device sums {want}", flush=True)
    if got != want or not np.array_equal(got_hist, hist):
        raise RuntimeError(
            f"mesh counters {got} / {got_hist.tolist()} != per-device sums "
            f"{want} / {hist.tolist()}"
        )
    print("multi: mesh counters == per-device simulate_batch sums "
          "(blocks, errors, bit errors, iterations, histogram)", flush=True)


def _run_phases(phases, card, cpu_ref, run):
    """Run the phases in order; returns (device, count), or None when the
    device phase failed (nothing after it runs then)."""
    if "card_tests" in phases:
        run("card_tests", card_tests)  # before this process touches JAX
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"  # host-side inputs
    from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    multi_run = "multi" in phases
    dev_count = run("device", check_device, 4 if multi_run else None)
    if dev_count is None:
        return None
    dev, count = dev_count
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={count}", flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    if multi_run:
        run("multi", multi, card)
        return dev_count
    programs = run("compile", compile_programs, card)
    run("reference", reference_experiment)
    if programs is not None:
        run("flagship", flagship, card, programs)
        run("vs_reference", vs_reference, card, cpu_ref, programs)
    return dev_count


def main(argv=None) -> int:
    phases = select_phases(argv)
    if importlib.util.find_spec("ldpc_3gpp_tpu") is None:
        print("chip_smoke: the ldpc_3gpp_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not {"gpu", "cuda"} & set(plats.split(",")):
        print(f"chip_smoke: JAX_PLATFORMS={plats} names no GPU platform",
              file=sys.stderr)
        return 1
    try:
        card = nvidia_smi()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        print(f"chip_smoke: no NVIDIA GPU visible ({e})", file=sys.stderr)
        return 1
    failed = []

    def run(name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out, status = fn(*args), "ok"
        except Exception as e:  # noqa: BLE001  (report, then fail the run)
            import traceback

            traceback.print_exc()
            failed.append(f"{name}: {type(e).__name__}: {e}")
            out, status = None, "FAILED"
        print(f"== {name}: {status} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        cpu_ref = None
        if "vs_reference" in phases:
            # the CPU half of vs_reference runs alongside the card phases
            cpu_ref = start_cpu_reference(tmp)
        try:
            dev_count = _run_phases(phases, card, cpu_ref, run)
        finally:
            if cpu_ref is not None and cpu_ref[0].poll() is None:
                cpu_ref[0].kill()
                cpu_ref[0].wait()
    if dev_count is None:
        print("\n".join(failed), file=sys.stderr)
        return 1
    dev, count = dev_count
    if failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
