#!/usr/bin/env python3
"""Pin complete time-domain TX frames as the wire-format golden.

Generates tests/golden_tx_frames.npz: full 4-antenna waveforms for the
frame-type × steering matrix (frame layout
/root/reference/lib/mimo_precoder_impl.cc:271-293). tests/test_tx_golden.py
audits the stored header structurally AND compares the live TX chain
against it — any wire-format drift fails.

Run only when the wire format intentionally changes; commit the npz.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def build_cases():
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import comm_link
    from jrc.ops import cplx as cx, precoder
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()

    # deterministic sounded channel: ULA at 18° on active carriers
    i_tx = np.arange(cfg.n_tx)
    h_row = np.exp(1j * np.pi * np.sin(np.deg2rad(18.0)) * i_tx)
    h = np.zeros((cfg.fft_len, cfg.n_tx), np.complex64)
    h[np.asarray(cfg.active_carrier_idx)] = h_row
    q_phased, qm_phased = precoder.steering_from_chan_est(
        cfg, cx.from_complex(jnp.asarray(h)), phased=True)
    q_svd, qm_svd = precoder.steering_from_chan_est(
        cfg, cx.from_complex(jnp.asarray(h)), phased=False)

    data_spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=40,
                          packet_type=PacketType.DATA)
    data_payload = make_payload(data_spec, bytes([2]) + b"golden data frame")
    ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24,
                         packet_type=PacketType.NDP)
    ndp_payload = make_payload(ndp_spec, bytes([1]) + b"golden ndp")

    cases = {
        # DFT-matrix fallback precoding (lib/mimo_precoder_impl.cc:761-772)
        "data_fourier": (data_spec, data_payload, dict()),
        # per-subcarrier phased steering (…:848-854, applied …:644-711)
        "data_steered_phased": (data_spec, data_payload,
                                dict(steering=q_phased)),
        # whole-frame mean-Q SVD steering (…:857-861, 596-634)
        "data_mean_svd": (data_spec, data_payload,
                          dict(mean_steering=qm_svd)),
        # radar streams on antennas 2.. (…:434-493), deterministic key
        "data_radar_streams": (data_spec, data_payload,
                               dict(use_radar_streams=True,
                                    rng_key=jax.random.PRNGKey(7))),
        # NDP: unprecoded MIMO-LTF + payload on first 2 antennas (…:379-428)
        "ndp": (ndp_spec, ndp_payload, dict()),
    }

    out = {}
    meta = {}
    for name, (spec, payload, kw) in cases.items():
        tx = comm_link.tx_frame(cfg, spec, jnp.asarray(payload), 1, **kw)
        w = np.asarray(tx.samples)  # (n_tx, n_samples) complex64
        out[f"{name}_wave"] = w
        meta[f"{name}_payload"] = np.asarray(payload)
        meta[f"{name}_mcs"] = np.int32(int(spec.mcs))
        meta[f"{name}_ptype"] = np.int32(int(spec.packet_type))
        meta[f"{name}_payload_bytes"] = np.int32(spec.payload_bytes)
        meta[f"{name}_n_ofdm_sym"] = np.int32(spec.n_ofdm_sym)
    return cfg, out, meta


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    cfg, out, meta = build_cases()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden_tx_frames.npz")
    np.savez_compressed(
        path,
        fft_len=np.int32(cfg.fft_len), cp_len=np.int32(cfg.cp_len),
        n_tx=np.int32(cfg.n_tx), n_ltf=np.int32(cfg.n_ltf),
        n_sync_words=np.int32(cfg.n_sync_words),
        **out, **meta,
    )
    print(f"pinned {len(out)} waveforms -> {path} "
          f"({os.path.getsize(path) / 1e3:.0f} kB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
