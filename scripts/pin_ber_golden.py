"""Pin golden BER/PER curves for all six MCS.

Runs models/evaluation.link_curve (full TX → AWGN channel → full RX chain,
incl. detection/sync) at SNRs spanning each MCS's waterfall and writes
tests/golden_ber.json. The regression test re-runs a subset with the same
seeds and asserts agreement — a coding-chain regression that costs dBs
fails the suite.

Usage: python scripts/pin_ber_golden.py [n_frames]
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import evaluation
from jrc.ops.encoder import FrameSpec, make_payload

# SNR grids straddle each MCS's waterfall (hard-decision Viterbi, LS est)
SNR_GRID = {
    "BPSK_1_2": [0.0, 1.0, 2.0, 4.0],
    "BPSK_3_4": [1.0, 2.0, 3.0, 5.0],
    "QPSK_1_2": [4.0, 5.0, 6.0, 8.0],
    "QPSK_3_4": [6.0, 7.5, 9.0, 11.0],
    "QAM16_1_2": [7.0, 8.5, 10.0, 12.0],
    "QAM16_3_4": [10.0, 11.5, 13.0, 15.0],
}

PAYLOAD_BYTES = 64
SEED = 7


def main() -> int:
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    cfg = OFDMConfig()
    out = {
        "n_frames": n_frames,
        "payload_bytes": PAYLOAD_BYTES,
        "seed": SEED,
        "curves": {},
    }
    for mcs in MCS:
        spec = FrameSpec(mcs, payload_bytes=PAYLOAD_BYTES,
                         packet_type=PacketType.DATA)
        payload = jnp.asarray(
            make_payload(spec, bytes([2]) + bytes(PAYLOAD_BYTES - 1))
        )
        pts = evaluation.link_curve(
            cfg, spec, payload, SNR_GRID[mcs.name],
            n_frames=n_frames, seed=SEED,
        )
        out["curves"][mcs.name] = [
            {"snr_db": p.snr_db, "ber": round(p.ber, 6), "per": round(p.per, 6)}
            for p in pts
        ]
        print(mcs.name, out["curves"][mcs.name], flush=True)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden_ber.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
