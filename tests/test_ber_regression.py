"""BER/PER regression against pinned golden curves.

The goldens (tests/golden_ber.json, written by scripts/pin_ber_golden.py)
pin the full-chain link performance — TX → AWGN → detect/sync/equalize/
Viterbi/CRC — at SNRs inside each MCS's waterfall. Same seeds, same frame
count ⇒ the Monte-Carlo is deterministic; a coding-chain regression that
costs fractions of a dB moves these numbers far beyond the tolerance.

The test re-measures a representative subset (cheapest + densest MCS); the
full six-curve surface is re-pinned by re-running the script.
"""
import json
import os

import jax.numpy as jnp
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import evaluation
from jrc.ops.encoder import FrameSpec, make_payload

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ber.json")

SUBSET = [MCS.BPSK_1_2, MCS.QPSK_3_4, MCS.QAM16_3_4]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("mcs", SUBSET, ids=lambda m: m.name)
def test_ber_curve_regression(mcs, golden):
    cfg = OFDMConfig()
    want = golden["curves"][mcs.name]
    n_frames = golden["n_frames"]
    spec = FrameSpec(mcs, payload_bytes=golden["payload_bytes"],
                     packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(
        spec, bytes([2]) + bytes(golden["payload_bytes"] - 1)))
    snrs = [p["snr_db"] for p in want]
    pts = evaluation.link_curve(
        cfg, spec, payload, snrs, n_frames=n_frames, seed=golden["seed"]
    )
    for p, w in zip(pts, want):
        # identical seeds ⇒ deterministic modulo numerics; the tolerance
        # allows backend jitter but fails on any real link regression
        assert abs(p.ber - w["ber"]) <= max(0.01, 0.35 * w["ber"]), (
            mcs.name, p, w)
        assert abs(p.per - w["per"]) <= max(3.0 / n_frames, 0.35 * w["per"]), (
            mcs.name, p, w)


def test_golden_covers_waterfall(golden):
    """Every MCS must have at least one pinned point with real errors and
    one (near-)clean point — otherwise the surface asserts nothing."""
    for name, pts in golden["curves"].items():
        pers = [p["per"] for p in pts]
        assert any(p > 0.02 for p in pers), (name, pers)
        assert any(p <= 0.10 for p in pers), (name, pers)
