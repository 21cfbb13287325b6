#!/usr/bin/env python3
"""BER/PER-vs-SNR characterization sweep over all MCS.

    python apps/ber_sweep.py --cpu --snrs 2 6 10 14 18 --frames 32 --plot ber.png
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snrs", nargs="+", type=float, default=[2, 6, 10, 14, 18, 22])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--payload-bytes", type=int, default=64)
    p.add_argument("--mcs", nargs="+", default=None, help="subset of MCS names")
    p.add_argument("--soft", action="store_true")
    p.add_argument("--plot", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import evaluation
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    mcs_list = [MCS[m] for m in args.mcs] if args.mcs else list(MCS)
    results = {}
    for mcs in mcs_list:
        spec = FrameSpec(mcs, payload_bytes=args.payload_bytes,
                         packet_type=PacketType.DATA)
        filler = (bytes([2]) + b"ber sweep " * 6)[: spec.payload_bytes]
        payload = jnp.asarray(make_payload(spec, filler))
        pts = evaluation.link_curve(cfg, spec, payload, args.snrs,
                                    n_frames=args.frames, soft=args.soft)
        results[mcs.name] = pts
        for pt in pts:
            print(f"{mcs.name:11s} snr={pt.snr_db:5.1f} dB  ber={pt.ber:.2e}  per={pt.per:.3f}")

    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("mcs,snr_db,ber,per,n_frames\n")
            for name, pts in results.items():
                for pt in pts:
                    fh.write(f"{name},{pt.snr_db},{pt.ber},{pt.per},{pt.n_frames}\n")
        print(f"csv -> {args.csv}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        for name, pts in results.items():
            ax.semilogy([p.snr_db for p in pts],
                        [max(p.ber, 1e-7) for p in pts], "o-", label=name)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("BER")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
