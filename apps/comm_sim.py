#!/usr/bin/env python3
"""Communication simulation app — mirrors
examples/simulation/communication/mimo_ofdm_jrc_comm_sim.grc.

Closed-loop TX→channel→RX over a frame schedule with PER/SNR tracking, the
deliberate CFO injection, NDP channel sounding, and selectable steering.

    python apps/comm_sim.py --frames 20 --snr-db 22 --mcs QPSK_3_4 --steering svd
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--mcs", default="QPSK_3_4")
    p.add_argument("--payload-bytes", type=int, default=100)
    p.add_argument("--snr-db", type=float, default=25.0)
    p.add_argument("--angle", type=float, default=15.0)
    p.add_argument("--path-loss", type=float, default=10.0)
    p.add_argument("--cfo", type=float, default=0.02,
                   help="CFO in cycles/fft_len (the grc's freq_offset)")
    p.add_argument("--steering", choices=["none", "phased", "svd"], default="none")
    p.add_argument("--ndp-every", type=int, default=5,
                   help="insert an NDP sounding frame every N frames")
    p.add_argument("--estimator", choices=["ls", "sta"], default="ls")
    p.add_argument("--soft", action="store_true", help="soft-decision Viterbi")
    p.add_argument("--udp-in", type=int, default=0, metavar="PORT",
                   help="take TX payloads from UDP datagrams on this port "
                        "(packet-generator ingress, README.md:45-46): first "
                        "byte = packet type (1=NDP, 2=DATA, "
                        "lib/stream_encoder_impl.cc:109-118). Overrides the "
                        "canned payloads and --ndp-every")
    p.add_argument("--udp-out", type=int, default=0, metavar="PORT",
                   help="forward CRC-clean decoded payloads to this UDP port")
    p.add_argument("--udp-timeout", type=float, default=10.0,
                   help="seconds to wait for the next --udp-in datagram "
                        "before ending the session")
    p.add_argument("--comm-log", default="comm_log.csv")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import comm_link
    from jrc.ops import decoder as dec_ops
    from jrc.ops import precoder
    from jrc.ops.encoder import FrameSpec, make_payload
    from jrc.utils.logging import CommLog

    cfg = OFDMConfig()
    data_spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                          packet_type=PacketType.DATA)
    ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    payload = jnp.asarray(make_payload(data_spec, bytes([2]) + b"comm sim payload"))
    ndp_payload = jnp.asarray(make_payload(ndp_spec, bytes([1])))
    cfo = args.cfo * 2 * np.pi / cfg.fft_len
    log = CommLog(args.comm_log)
    stats = dec_ops.init_stats()
    mean_steering = None
    seed = 1

    udp_src = udp_sink = None
    spec_cache = {}
    if args.udp_in:
        from jrc.io.udp import UdpPduSource

        udp_src = UdpPduSource(args.udp_in)
        print(f"udp-in: listening on {udp_src.addr[0]}:{udp_src.addr[1]}")
    if args.udp_out:
        from jrc.io.udp import UdpPduSink

        udp_sink = UdpPduSink(args.udp_out)

    for i in range(args.frames):
        if udp_src is not None:
            # loop until a VALID datagram so drops don't consume --frames
            # iterations (same contract as jrc_trx)
            while True:
                pdu = udp_src.get(timeout=args.udp_timeout)
                if pdu is None or 1 <= len(pdu) <= cfg.max_payload:
                    break
                print(f"udp-in: dropping {len(pdu)}-byte datagram")
            if pdu is None:
                print("udp-in: idle timeout, ending session")
                break
            is_ndp = int(pdu[0]) == 1 and args.steering != "none"
            key = (int(pdu[0]) == 1, len(pdu))
            if key not in spec_cache:  # one compile per (type, length)
                spec_cache[key] = FrameSpec(
                    MCS.QPSK_1_2 if key[0] else MCS[args.mcs],
                    payload_bytes=len(pdu),
                    packet_type=PacketType.NDP if key[0] else PacketType.DATA)
            spec = spec_cache[key]
            pl = jnp.asarray(make_payload(spec, bytes(pdu)))
        else:
            is_ndp = args.ndp_every > 0 \
                and i % args.ndp_every == args.ndp_every - 1 \
                and args.steering != "none"
            spec = ndp_spec if is_ndp else data_spec
            pl = ndp_payload if is_ndp else payload
        res = comm_link.loopback(
            cfg, spec, pl, key=jax.random.PRNGKey(i), angle_deg=args.angle,
            path_loss=args.path_loss, snr_db=args.snr_db, cfo=cfo,
            scrambler_seed=seed, estimator=args.estimator, soft=args.soft,
            mean_steering=None if is_ndp else mean_steering,
        )
        seed = seed % 127 + 1
        crc = bool(np.asarray(res.decoded.crc_ok))
        snr = float(np.asarray(res.eq.snr_legacy))
        snr_d = float(np.asarray(res.eq.snr_data))
        if is_ndp and bool(np.asarray(res.eq.sig_ok)) and args.steering != "none":
            _, mean_steering = precoder.steering_from_chan_est(
                cfg, res.eq.chan_est_full, phased=args.steering == "phased")
            print(f"frame {i}: NDP sounding -> steering refreshed ({args.steering})")
            continue
        stats = dec_ops.update_stats(stats, jnp.float32(crc))
        per = float(np.asarray(dec_ops.per_percent(stats)))
        log.log_frame(crc, int(spec.packet_type), snr, snr_d, per)
        if udp_sink is not None and crc:
            udp_sink.send(np.asarray(res.decoded.payload))
        print(f"frame {i}: crc={crc} snr={snr:.1f} dB snr_data={snr_d:.1f} dB per={per:.1f}%")
    print(f"log -> {args.comm_log}")
    if udp_src is not None:
        udp_src.close()
    if udp_sink is not None:
        udp_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
