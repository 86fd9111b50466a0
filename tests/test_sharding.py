"""Multi-device sharding: psum-aggregated Monte-Carlo on an 8-device CPU mesh.

Exercises the same shard_map/pjit path the driver's dryrun_multichip uses.
Key invariant (SURVEY.md section 4d): the mesh-aggregated counters for a
given total seed set must be deterministic and independent of how work is
split across devices.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ldpc_3gpp_tpu.models.chain import ChainConfig
from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu.spec.params import LDPCParams


def _cfg():
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    return ChainConfig(params=p, modulation="QPSK", iterations=10)


def test_eight_virtual_devices():
    assert jax.device_count() == 8, "conftest must force 8 CPU devices"


def test_sharded_montecarlo_runs():
    mc = MonteCarlo(_cfg(), batch_per_device=8)
    assert mc.blocks_per_run == 64
    c = mc.run(jax.random.PRNGKey(0), 6.0)
    assert c["blocks"] == 64
    assert c["block_errors"] == 0  # 6 dB is far above the waterfall
    c2 = mc.run(jax.random.PRNGKey(0), -12.0)
    assert c2["block_errors"] == 64


def test_counters_deterministic():
    mc = MonteCarlo(_cfg(), batch_per_device=8)
    a = mc.run(jax.random.PRNGKey(3), 0.5)
    b = mc.run(jax.random.PRNGKey(3), 0.5)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_iteration_histogram_invariants():
    """psum'd per-CB iteration histogram: one entry per (block, CB, rv),
    weighted sum equals the scalar iterations counter."""
    cfg = _cfg()
    mc = MonteCarlo(cfg, batch_per_device=8)
    c = mc.run(jax.random.PRNGKey(5), 2.0)
    hist = c["iteration_hist"]
    assert hist.shape == (cfg.iterations + 1,)
    decodes = c["blocks"] * cfg.params.C * len(cfg.rv_sequence)
    assert hist.sum() == decodes
    assert (hist * np.arange(len(hist))).sum() == c["iterations"]
    # at 2 dB the early-termination mix is nontrivial
    assert (hist > 0).sum() > 1


@pytest.mark.slow
def test_psum_matches_manual_aggregation():
    """Mesh counters == sum of per-shard simulate_batch runs on one device.

    device_step folds the device index into the key, so shard i's work is
    exactly ``simulate_batch(cfg, fold_in(key, i), ...)`` — verifying the
    psum aggregation end to end.
    """
    from ldpc_3gpp_tpu.models.chain import simulate_batch

    cfg = _cfg()
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("dp",))
    mc2 = MonteCarlo(cfg, batch_per_device=16, mesh=mesh2)
    key = jax.random.PRNGKey(1)
    total = mc2.run(key, 1.0)

    sim = jax.jit(partial(simulate_batch, cfg, batch=16))
    manual = {"blocks": 0, "block_errors": 0, "bit_errors": 0, "iterations": 0}
    manual_hist = np.zeros(cfg.iterations + 1, np.int64)
    for i in range(2):
        # device_step folds (device index, then step index 0)
        k = jax.random.fold_in(jax.random.fold_in(key, i), 0)
        r = sim(k, jnp.asarray(1.0, jnp.float32))
        manual["blocks"] += int(r.blocks)
        manual["block_errors"] += int(r.block_errors)
        manual["bit_errors"] += int(r.bit_errors)
        manual["iterations"] += int(r.iterations)
        manual_hist += np.asarray(r.iteration_hist, np.int64)

    total_hist = total.pop("iteration_hist")
    assert manual == total
    np.testing.assert_array_equal(manual_hist, total_hist)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_mesh_counters_match_per_device_sums(schedule):
    """MonteCarlo on all 8 virtual devices, shard_map with its default
    varying-axes check, equals the sum over devices d and steps i of
    ``simulate_batch(cfg, fold_in(fold_in(key, d), i))`` run unsharded —
    every counter and the histogram, in integers, for both schedules."""
    from ldpc_3gpp_tpu.models.chain import simulate_batch

    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=4,
                      algorithm="min-sum", schedule=schedule)
    mc = MonteCarlo(cfg, batch_per_device=2, steps_per_call=2)
    assert mc.mesh.size == 8
    key = jax.random.PRNGKey(7)
    got = mc.run(key, 0.0)

    sim = jax.jit(partial(simulate_batch, cfg, batch=2))
    e = jnp.asarray(0.0, jnp.float32)
    want = {"blocks": 0, "block_errors": 0, "bit_errors": 0, "iterations": 0}
    hist = np.zeros(cfg.iterations + 1, np.int64)
    for d in range(8):
        for i in range(2):
            r = sim(jax.random.fold_in(jax.random.fold_in(key, d), i), e)
            for k in want:
                want[k] += int(getattr(r, k))
            hist += np.asarray(r.iteration_hist, np.int64)
    assert want["block_errors"] > 0  # 0 dB: error-rich, the check has teeth
    np.testing.assert_array_equal(got.pop("iteration_hist"), hist)
    assert got == want


def test_montecarlo_keeps_requested_batch():
    """batch_per_device is simulated as given — no rounding to a multiple of
    128 — and the counters report exactly the requested blocks."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=4)
    mc = MonteCarlo(cfg, batch_per_device=100)
    assert mc.batch_per_device == 100
    assert mc.blocks_per_run == 100 * mc.mesh.size
    c = mc.run(jax.random.PRNGKey(0), 8.0)
    assert c["blocks"] == 100 * mc.mesh.size
    assert c["iteration_hist"].sum() == 100 * mc.mesh.size * p.C


@pytest.mark.slow
def test_per_device_rng_differs():
    """Devices must not simulate identical noise (fold_in by axis_index)."""
    p = LDPCParams(BG=2, A=100, G=300, Q_m=2)
    cfg = ChainConfig(params=p, modulation="QPSK", iterations=4)
    mc = MonteCarlo(cfg, batch_per_device=64)  # <= 64: no efficiency rounding
    # near the waterfall the error count would be a multiple of 8 if all
    # devices were identical; check across several keys
    multiples = 0
    for k in range(4):
        c = mc.run(jax.random.PRNGKey(100 + k), 1.2)
        if c["block_errors"] % 8 == 0:
            multiples += 1
    assert multiples < 4, "per-device counters look identical across the mesh"


@pytest.mark.slow
def test_two_process_distributed_counters(tmp_path):
    """Real jax.distributed over two local processes: both workers must see
    the same globally psum-reduced counters (the multi-host invariant of
    COVERAGE.md section 2.2), launched via the CLI launcher."""
    import subprocess
    import sys

    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from ldpc_3gpp_tpu.parallel.launcher import init_distributed\n"
        "init_distributed()\n"
        "from ldpc_3gpp_tpu.models.chain import ChainConfig\n"
        "from ldpc_3gpp_tpu.parallel.montecarlo import MonteCarlo\n"
        "from ldpc_3gpp_tpu.spec.params import LDPCParams\n"
        "p = LDPCParams(BG=2, A=100, G=300, Q_m=2)\n"
        "cfg = ChainConfig(params=p, modulation='QPSK', iterations=4,\n"
        "                  algorithm='min-sum')\n"
        "mc = MonteCarlo(cfg, batch_per_device=4)\n"
        "c = mc.run(jax.random.PRNGKey(0), 3.0)\n"
        "assert jax.process_count() == 2 and jax.device_count() == 4\n"
        "print('COUNTERS', sorted(c.items()), flush=True)\n"
    )
    import ldpc_3gpp_tpu

    repo_root = os.path.dirname(os.path.dirname(ldpc_3gpp_tpu.__file__))
    import socket

    with socket.socket() as s:  # free port on localhost
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ldpc_3gpp_tpu.parallel.launcher",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--", sys.executable, str(worker)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**{k: v for k, v in os.environ.items()
                    if k not in ("XLA_FLAGS", "JAX_PLATFORMS")},
                 "PYTHONPATH": repo_root},
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [next(ln for ln in o.splitlines() if ln.startswith("COUNTERS"))
             for o in outs]
    assert lines[0] == lines[1], lines
