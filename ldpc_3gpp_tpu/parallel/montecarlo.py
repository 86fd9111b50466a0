"""Device-mesh-parallel Monte-Carlo engine.

The reference's parallelism story is "run N MATLAB instances with different
seeds and merge text files by hand" (plot_BLER_vs_SNR.m:23-27).  Here the
Monte-Carlo codeword batch is the data-parallel axis of a
``jax.sharding.Mesh``: every device simulates its own sub-batch (RNG folded
by device index, replacing the per-instance seeds), and scalar counters are
psum-reduced across devices inside the jitted step — one compiled program,
any number of devices.

Multi-host: under ``jax.distributed`` the same code runs unchanged — the mesh
spans all processes' devices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.chain import ChainConfig, simulate_batch


def default_mesh() -> Mesh:
    """1-D data-parallel mesh over every visible device."""
    devices = np.array(jax.devices())
    return Mesh(devices, ("dp",))


@dataclasses.dataclass
class MonteCarlo:
    """Sharded Monte-Carlo runner for one link configuration.

    ``run(key, esn0_db)`` simulates ``batch_per_device * mesh.size`` transport
    blocks and returns host-side integer counters (already psum-aggregated
    across the mesh).
    """

    cfg: ChainConfig
    batch_per_device: int = 128  # blocks per device per step
    mesh: Optional[Mesh] = None
    steps_per_call: int = 1  # fori_loop'd sim steps per dispatch (amortises
    # host->device launch latency; each step draws fresh blocks/noise)

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = default_mesh()
        mesh, cfg, bpd = self.mesh, self.cfg, self.batch_per_device
        steps = self.steps_per_call

        def device_step(key: jax.Array, esn0_db: jax.Array):
            # Per-device RNG: fold the device's mesh position into the key —
            # the mesh version of "different seeds per instance"
            # (plot_BLER_vs_SNR.m:23-27).
            key = jax.random.fold_in(key, jax.lax.axis_index("dp"))

            def body(i, acc):
                r = simulate_batch(
                    cfg, jax.random.fold_in(key, i), esn0_db, bpd
                )
                return (
                    acc[0] + r.blocks,
                    acc[1] + r.block_errors,
                    acc[2] + r.bit_errors,
                    acc[3] + r.iterations,
                    acc[4] + r.iteration_hist,
                )

            # varying zero (derived from the folded key) so the fori_loop
            # carry has consistent mesh-varying axes under shard_map
            zero = (jax.random.key_data(key).ravel()[0] * 0).astype(jnp.int32)
            hist0 = jnp.zeros((cfg.iterations + 1,), jnp.int32) + zero
            totals = jax.lax.fori_loop(
                0, steps, body, (zero, zero, zero, zero, hist0)
            )
            return tuple(jax.lax.psum(t, "dp") for t in totals)

        self._step = jax.jit(
            shard_map(
                device_step,
                mesh=mesh,
                in_specs=(P(), P()),
                out_specs=(P(), P(), P(), P(), P()),
            )
        )

    @property
    def blocks_per_run(self) -> int:
        return self.batch_per_device * self.mesh.size * self.steps_per_call

    def run(self, key: jax.Array, esn0_db: float) -> Dict[str, Union[int, np.ndarray]]:
        """Mesh-aggregated counters; all values are Python ints except
        'iteration_hist', which is an (iterations+1,) int64 ndarray."""
        blocks, errs, bit_errs, iters, hist = self._step(
            key, jnp.asarray(esn0_db, jnp.float32)
        )
        return {
            "blocks": int(blocks),
            "block_errors": int(errs),
            "bit_errors": int(bit_errs),
            "iterations": int(iters),
            "iteration_hist": np.asarray(hist, dtype=np.int64),
        }

    def run_pipelined(
        self, key: jax.Array, esn0_db: float, calls: int
    ) -> Dict[str, Union[int, np.ndarray]]:
        """``calls`` dispatches summed into ONE host fetch.

        Same value types as ``run``: ints plus the 'iteration_hist' ndarray.

        Every host fetch is a sync point at which the device idles until
        the host dispatches again, so the adaptive sweep loop's
        check-after-every-call pattern leaves gaps.  Submitting a window of
        calls back-to-back and fetching one summed counter keeps the device
        busy; the sweep then decides on window granularity (its stopping
        rules are minimum-sample rules, so overshoot is harmless).
        """
        e = jnp.asarray(esn0_db, jnp.float32)
        outs = [
            self._step(jax.random.fold_in(key, i), e) for i in range(calls)
        ]
        # One host fetch of the (calls, 4) counter matrix (+ histograms);
        # sum in int64 on the host — an on-device int32 window sum can
        # overflow bit_errors at BLER ~ 1 (large-A dispatches carry ~1e8
        # bit errors each).
        mat = np.asarray(jnp.stack([jnp.stack(o[:4]) for o in outs]))
        hist = np.asarray(jnp.stack([o[4] for o in outs]))
        blocks, errs, bit_errs, iters = (
            int(v) for v in mat.astype(np.int64).sum(axis=0)
        )
        return {
            "blocks": blocks,
            "block_errors": errs,
            "bit_errors": bit_errs,
            "iterations": iters,
            "iteration_hist": hist.astype(np.int64).sum(axis=0),
        }
