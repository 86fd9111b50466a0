#!/usr/bin/env python3
"""Rebuild golden/plots/*.png from the measured golden/*.json artifacts.

Pure matplotlib — no accelerator, no simulation.  Run after tools/regen_goldens.py
so the committed figures always match the committed numbers.
"""
import json
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

if __package__ in (None, ""):  # script run: tools/ is sys.path[0]
    import _path  # noqa: F401,E402  (checkout shim; no-op when installed)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")
PLOTS = os.path.join(GOLDEN, "plots")


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def bler_curves():
    fig, ax = plt.subplots(figsize=(7, 5))
    head = _load("BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json")
    ax.semilogy(head["esn0_db"], head["bler"], marker="o",
                label="BG2 A=3842 R=1/3 SP-flooding 8it (reference default)")
    cmp_ = _load("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json")
    for key, style in (("NMS-flooding", "s"), ("NMS-layered", "^")):
        ax.semilogy(cmp_[key]["esn0_db"], cmp_[key]["bler"], marker=style,
                    label=f"BG2 A=3842 {key} 8it")
    c1 = _load("BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json")
    ax.semilogy(c1["esn0_db"], c1["bler"], marker="d",
                label="BG2 A=100 R=1/2 NMS 50it")
    c2 = _load("config2_and_harq.json")["BG1_A8448_layered_NMS_12it"]
    ax.semilogy(c2["esn0_db"], c2["bler"], marker="v",
                label="BG1 A=8448 R=1/3 layered-NMS 12it")
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("BLER")
    ax.set_title("3GPP NR LDPC, QPSK, AWGN — measured")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="lower left", fontsize=8)
    out = os.path.join(PLOTS, "bler_curves.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def snr_vs_a():
    from ldpc_3gpp_tpu.utils.plotting import plot_snr_vs_a as _plot

    d = _load("SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json")
    curve = list(zip(d["A"], d["required_esn0_db"]))
    out = _plot({1 / 3: curve}, os.path.join(PLOTS, "snr_vs_a.png"),
                title="Required $E_s/N_0$ @ BLER$=10^{-2}$ vs A "
                      "(BG1, R=1/3, QPSK, SP 50it)")
    print("wrote", out)


def harq_ir():
    d = _load("config2_and_harq.json")
    fig, ax = plt.subplots(figsize=(7, 5))
    ss = d["harq_single_shot_rv0"]
    ax.semilogy(ss["esn0_db"], ss["bler"], marker="o",
                label="single transmission (rv 0)")
    ir = d["harq_harq_ir_rv0231"]
    ax.semilogy(ir["esn0_db"], ir["bler"], marker="*", markersize=14,
                linestyle="none", label="HARQ IR rv (0,2,3,1), LLR accumulation")
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("BLER")
    ax.set_title("HARQ incremental redundancy, BG1 A=2000 R=0.8 QPSK, "
                 "layered-NMS 12it")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="lower left")
    out = os.path.join(PLOTS, "harq_ir.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def base_graphs():
    from ldpc_3gpp_tpu.utils.plotting import plot_base_graph

    for bg in (1, 2):
        out = plot_base_graph(bg, 0, os.path.join(PLOTS, f"base_graph_{bg}.png"))
        print("wrote", out)


def main():
    os.makedirs(PLOTS, exist_ok=True)
    bler_curves()
    snr_vs_a()
    harq_ir()
    base_graphs()


if __name__ == "__main__":
    main()
