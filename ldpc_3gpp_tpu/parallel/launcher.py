"""Multi-host launch support.

The reference's multi-machine story is "start N MATLAB processes by hand with
different seeds and merge the text files" (plot_BLER_vs_SNR.m:23-27).  The
mesh equivalent: initialise the jax.distributed runtime so several hosts
(or several local processes) form ONE mesh, then run the exact same
MonteCarlo / sweep code — the dp axis spans all processes' devices, the
counter psum crosses hosts, and per-device RNG folding makes every device's
stream distinct.

Typical usage (one command per host):

    python -m ldpc_3gpp_tpu.parallel.launcher --coordinator HOST0:1234 \
        --num-processes 4 --process-id $WORKER_ID -- \
        python my_sweep.py

The launcher exports LDPC_COORDINATOR / LDPC_NUM_PROCESSES /
LDPC_PROCESS_ID and execs the command; the sweep calls
``init_distributed()`` (no arguments), which picks those up:

    from ldpc_3gpp_tpu.parallel.launcher import init_distributed
    init_distributed()            # env-driven
    ...run sweeps as usual...

Only process 0 writes results files (``is_primary()``); counters are already
globally psum-reduced so every process sees identical totals.
"""
from __future__ import annotations

import os
from typing import Optional

_ENV_COORD = "LDPC_COORDINATOR"
_ENV_NPROC = "LDPC_NUM_PROCESSES"
_ENV_PID = "LDPC_PROCESS_ID"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise jax.distributed; no-ops on a single-process setup.

    Arguments default to the LDPC_* env vars exported by the CLI launcher
    below; with neither, relies on whatever cluster auto-detection
    jax.distributed.initialize performs from the environment.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0


def main(argv: Optional[list] = None) -> None:
    """CLI: export the cluster env vars and exec the worker command."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu.parallel.launcher",
        description="Launch one worker of a multi-process simulation: "
        "exports LDPC_* env vars (read by init_distributed()) and "
        "execs COMMAND.",
    )
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's coordinator service")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command (prefix with -- )")
    args = ap.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no worker command given (append: -- python my_sweep.py)")

    os.environ[_ENV_COORD] = args.coordinator
    os.environ[_ENV_NPROC] = str(args.num_processes)
    os.environ[_ENV_PID] = str(args.process_id)
    os.execvp(cmd[0], cmd)


if __name__ == "__main__":
    main()
