#!/usr/bin/env python3
"""Headline benchmark wrapper (the driver runs this from the repo root).

Canonical implementation: ldpc_3gpp_tpu/bench.py (also installed as the
``ldpc-bench`` console command).  Default mode prints ONE JSON line:

  {"metric": "decoded_info_mbps_per_chip", "value": N, "unit": "Mbit/s",
   "vs_baseline": N, ...}

``--sweep`` prints the early-termination throughput-economics surface
instead (one JSON line per row).  Runs on a GPU only.
"""
from ldpc_3gpp_tpu.bench import main

if __name__ == "__main__":
    main()
