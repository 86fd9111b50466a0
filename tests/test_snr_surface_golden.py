"""Structural regression pins on the measured SNR-vs-A surface golden.

golden/SNR_vs_A_surface.json (BASELINE config #4) is measured by
tools/regen_goldens.py surface.  These pins catch a corrupted or
half-regenerated artifact and any physically implausible regression:
information-theoretic ordering across rates, coding gain with block
length, target ordering, and the sum-product vs min-sum relationship.
"""
import json
import os

import numpy as np
import pytest

PATH = os.path.join(os.path.dirname(__file__), "..", "golden",
                    "SNR_vs_A_surface.json")

RATES = ["0.2", "0.333333", "0.5", "0.666667"]
ALGOS = ["sum-product", "min-sum"]


@pytest.fixture(scope="module")
def surface():
    with open(PATH) as f:
        return json.load(f)


def test_surface_complete(surface):
    assert surface["A"] == list(range(1000, 8001, 1000))
    for algo in ALGOS:
        for r in RATES:
            c = surface["curves"][f"{algo}/{r}"]
            for t in ("0.1", "0.01"):
                vals = c[f"required_esn0_db_at_{t}"]
                assert len(vals) == 8 and all(v is not None for v in vals), (
                    algo, r, t)


def test_required_snr_increases_with_rate(surface):
    """At every A and both targets, higher code rate needs more Es/N0."""
    for algo in ALGOS:
        for t in ("0.1", "0.01"):
            cols = np.array([
                surface["curves"][f"{algo}/{r}"][f"required_esn0_db_at_{t}"]
                for r in RATES
            ])  # (4 rates, 8 A)
            assert (np.diff(cols, axis=0) > 0).all(), (algo, t)


def test_coding_gain_with_block_length(surface):
    """Longer blocks need less SNR; allow 0.15 dB of interp/MC wiggle."""
    for algo in ALGOS:
        for r in RATES:
            for t in ("0.1", "0.01"):
                v = np.array(surface["curves"][f"{algo}/{r}"]
                             [f"required_esn0_db_at_{t}"])
                assert (np.diff(v) < 0.15).all(), (algo, r, t)
                assert v[-1] < v[0], (algo, r, t)  # net gain over the range


def test_target_ordering(surface):
    """Reaching BLER 1e-2 always needs at least as much SNR as 1e-1."""
    for algo in ALGOS:
        for r in RATES:
            c = surface["curves"][f"{algo}/{r}"]
            lo = np.array(c["required_esn0_db_at_0.1"])
            hi = np.array(c["required_esn0_db_at_0.01"])
            assert (hi > lo).all(), (algo, r)


def test_min_sum_penalty(surface):
    """Normalized min-sum never beats sum-product beyond MC noise, and the
    penalty stays under 1 dB at 50 iterations (alpha=0.8125)."""
    for r in RATES:
        d = np.array(surface["delta_ms_minus_sp_db"][r], dtype=float)
        assert (d > -0.15).all(), r
        assert (d < 1.0).all(), r
