#!/usr/bin/env python3
"""Array alignment calibration — mirrors examples/usrp/mimo_usrp_alignment_4tx2rx.grc.

Transmits a tone per TX antenna (one at a time), measures the received
tone's frequency/phase/magnitude per RX channel with ``fft_peak_detect``,
and reports per-(tx,rx) phase offsets — the inter-channel calibration the
reference performs before coherent MIMO operation.

    python apps/alignment.py --tone-freq 1e6
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tone-freq", type=float, default=1e6)
    p.add_argument("--n-samples", type=int, default=4096)
    p.add_argument("--target", default="5:0:10:10",
                   help="reflector used as the calibration path")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import OFDMConfig
    from jrc.ops import channel, cplx as cx, radar

    cfg = OFDMConfig()
    r, v, az, rcs = (float(x) for x in args.target.split(":"))
    targets = channel.Targets((r,), (v,), (az,), (rcs,))
    pos = channel.virtual_positions(cfg.n_tx, cfg.n_rx,
                                    channel.C_LIGHT / cfg.center_freq)
    n = args.n_samples
    t = np.arange(n) / cfg.sample_rate
    tone = np.exp(2j * np.pi * args.tone_freq * t).astype(np.complex64)

    print(f"tone {args.tone_freq/1e6:.3f} MHz, reflector at {r} m / {az} deg")
    phases = np.zeros((cfg.n_tx, cfg.n_rx))
    for tx_i in range(cfg.n_tx):
        tx = np.zeros((cfg.n_tx, n), np.complex64)
        tx[tx_i] = tone
        rx = channel.apply_targets(
            jnp.asarray(tx), targets, sample_rate=cfg.sample_rate,
            center_freq=cfg.center_freq, pos_virtual=pos)
        spec = jnp.fft.fft(cx.to_complex(rx), axis=-1)
        pk = radar.fft_peak_detect(spec, cfg.sample_rate, samp_protect=2)
        for rx_i in range(cfg.n_rx):
            f = float(np.asarray(pk.freq)[rx_i])
            ph = float(np.asarray(pk.phase)[rx_i])
            phases[tx_i, rx_i] = ph
            print(f"  tx{tx_i} -> rx{rx_i}: f={f/1e6:.3f} MHz "
                  f"phase={np.degrees(ph):7.2f} deg "
                  f"mag={float(np.asarray(pk.magnitude)[rx_i]):.4g}")
    # per-element phase steps across the virtual array
    virt = phases.T.reshape(-1)  # rx-major ULA order
    steps = np.degrees(np.angle(np.exp(1j * np.diff(virt))))
    print("virtual-array phase steps (deg):", np.round(steps, 2))
    print("expected step for az: %.2f deg" %
          np.degrees(np.pi * np.sin(np.radians(az))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
