#!/usr/bin/env python3
"""Full JRC transceiver session — mirrors examples/usrp/mimo_ofdm_jrc_TRX.grc
with the simulated backend, driven through the TRX I/O boundary at the
reference cadence: frames are produced continuously, but a TX+RX radar
burst opens at most once per ``update_period`` (25 Hz at the reference's
0.04 s) — frames in between go out TX-only, exactly the usrp_mimo_trx work
loop (lib/usrp_mimo_trx_impl.cc:287-388). The RX capture is re-aligned by
``num_delay_samps`` and a missed RX deadline skips the dwell (…:374-383,
:488-494). The comm leg models the remote communication receiver
(mimo_ofdm_comm_RX.grc) hearing every transmitted frame.

    python apps/jrc_trx.py --frames 32 --target 12:0:25:10 --radar-aided
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=32,
                   help="total frames transmitted (bursts open at 1/update-period)")
    p.add_argument("--target", default="12:0:25:10",
                   help="range:velocity:azimuth:rcs")
    p.add_argument("--mcs", default="QPSK_3_4")
    p.add_argument("--payload-bytes", type=int, default=80)
    p.add_argument("--radar-aided", action="store_true", default=True)
    p.add_argument("--no-radar-aided", dest="radar_aided", action="store_false")
    p.add_argument("--phased", action="store_true", default=True)
    p.add_argument("--svd", dest="phased", action="store_false")
    p.add_argument("--radar-streams", action="store_true")
    p.add_argument("--ndp-every", type=int, default=8,
                   help="every Nth frame is an NDP sounding frame (0 = never)")
    p.add_argument("--comm-noise-var", type=float, default=1e-4)
    p.add_argument("--update-period", type=float, default=0.04,
                   help="dwell burst period in seconds (reference: 0.04)")
    p.add_argument("--frame-interval", type=float, default=0.01,
                   help="seconds between produced frames (reference: UDP-paced)")
    p.add_argument("--num-delay-samps", type=int, default=24,
                   help="TX->RX latency compensation (usrp_mimo_trx contract)")
    p.add_argument("--doppler-frames", type=int, default=0,
                   help="send this many back-to-back frames per dwell burst "
                        "and estimate target velocity from the slow-time "
                        "Doppler across them (0 = off)")
    p.add_argument("--udp-in", type=int, default=0, metavar="PORT",
                   help="take TX payloads from UDP datagrams on this port "
                        "(the reference's packet-generator ingress, port "
                        "52001 — README.md:45-46): first byte = packet type "
                        "(1=NDP, 2=DATA, lib/stream_encoder_impl.cc:109-118)."
                        " Overrides the canned payloads and --ndp-every")
    p.add_argument("--udp-out", type=int, default=0, metavar="PORT",
                   help="forward each CRC-clean decoded payload to this UDP "
                        "port (socket_pdu egress)")
    p.add_argument("--udp-timeout", type=float, default=10.0,
                   help="seconds to wait for the next --udp-in datagram "
                        "before ending the session")
    p.add_argument("--radar-log", default="radar_log.csv")
    p.add_argument("--comm-log", default="comm_log.csv")
    p.add_argument("--heatmap", default="jrc_range_angle.png")
    p.add_argument("--live", action="store_true",
                   help="timer-refreshed live heatmap + link-metric scatter "
                        "(atomic PNG rewrites)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.io.backend import SimTrx, TrxSession
    from jrc.models import comm_link, jrc_trx
    from jrc.ops import channel, cplx as cx, ofdm, radar
    from jrc.ops.encoder import FrameSpec, make_payload
    from jrc.utils.logging import CommLog, RadarLog
    from jrc.viz.heatmap import render_heatmap

    cfg = OFDMConfig()
    r, v, az, rcs = (float(x) for x in args.target.split(":"))
    targets = channel.Targets((r,), (v,), (az,), (rcs,))
    data_spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                          packet_type=PacketType.DATA)
    ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    data_payload = jnp.asarray(make_payload(data_spec, bytes([2]) + b"jrc data"))
    ndp_payload = jnp.asarray(make_payload(ndp_spec, bytes([1])))

    udp_src = udp_sink = None
    spec_cache = {}
    if args.udp_in:
        from jrc.io.udp import UdpPduSource

        udp_src = UdpPduSource(args.udp_in)
        print(f"udp-in: listening on {udp_src.addr[0]}:{udp_src.addr[1]}")
    if args.udp_out:
        from jrc.io.udp import UdpPduSink

        udp_sink = UdpPduSink(args.udp_out)

    def next_frame(d):
        """(spec, payload, is_ndp) for frame d — from the UDP ingress when
        enabled (one frame per datagram, type byte honored, exact length
        like the reference's pdu_len tag), else the canned schedule."""
        if udp_src is None:
            is_ndp = (args.ndp_every > 0
                      and d % args.ndp_every == args.ndp_every - 1)
            return ((ndp_spec, ndp_payload, True) if is_ndp
                    else (data_spec, data_payload, False))
        while True:
            pdu = udp_src.get(timeout=args.udp_timeout)
            if pdu is None:
                return None  # idle timeout: packet generator stopped
            if 1 <= len(pdu) <= cfg.max_payload:
                break
            print(f"udp-in: dropping {len(pdu)}-byte datagram "
                  f"(valid: 1..{cfg.max_payload})")
        is_ndp = int(pdu[0]) == 1
        key = (is_ndp, len(pdu))
        if key not in spec_cache:  # one compile per (type, length)
            spec_cache[key] = FrameSpec(
                MCS.QPSK_1_2 if is_ndp else MCS[args.mcs],
                payload_bytes=len(pdu),
                packet_type=PacketType.NDP if is_ndp else PacketType.DATA)
        spec = spec_cache[key]
        return spec, jnp.asarray(make_payload(spec, bytes(pdu))), is_ndp

    # the I/O boundary: simulated radio + the reference's work-loop cadence
    session = TrxSession(
        SimTrx(cfg, targets, hw_delay_samps=args.num_delay_samps),
        update_period=args.update_period,
        num_delay_samps=args.num_delay_samps,
    )
    pad_front = 5 * cfg.sym_len

    state = jrc_trx.init_state(cfg)
    rlog, clog = RadarLog(args.radar_log), CommLog(args.comm_log)
    h_of_cache = {}
    live_hm = live_tp = None
    if args.live:
        from jrc.viz.live import LiveHeatmap, LiveTimePlot

        if args.heatmap:
            live_hm = LiveHeatmap(radar.range_axis(cfg.fft_len, cfg.sample_rate),
                                  cfg.angle_axis(16), path=args.heatmap)
        live_tp = LiveTimePlot(path="jrc_metrics.png")
    last_map = None
    n_ok = 0
    n_data = 0
    now = 0.0
    for d in range(args.frames):
        nxt = next_frame(d)
        if nxt is None:
            print("udp-in: idle timeout, ending session")
            break
        spec, pl, is_ndp = nxt
        k_tx, k_comm = jax.random.split(jax.random.PRNGKey(d))

        # TX side: steer from the current feedback state, build the frame
        tx = jrc_trx.jrc_tx(
            cfg, state, spec, pl, key=k_tx,
            radar_aided=args.radar_aided, phased_steering=args.phased,
            use_radar_streams=args.radar_streams, pad_front=pad_front,
        )

        # radar leg through the TRX boundary: burst at most every
        # update_period, TX-only otherwise
        t_frame = now
        burst = session.frame(np.asarray(tx.samples), now)
        now += args.frame_interval
        det = False
        est = None
        if burst is not None:
            rx = cx.from_complex(jnp.asarray(burst.rx))[..., pad_front:]
            est, ra_map, background = jrc_trx.jrc_radar_rx(cfg, state, tx.grid, rx)
            if args.doppler_frames > 1:
                # frame train: extra back-to-back bursts inside this dwell
                # (phase-coherent through the backend's stream clock), then
                # a slow-time Doppler estimate across the train
                sl = slice(cfg.n_sync_words + 1,
                           cfg.n_sync_words + 1 + cfg.n_ltf)
                x_sl = tx.grid.swapaxes(0, 1)[:, sl]
                n_sym_tot = tx.grid.shape[0]
                key_shape = (n_sym_tot, tx.samples.shape[-1])
                if key_shape not in h_of_cache:  # one compile per geometry
                    h_of_cache[key_shape] = jax.jit(
                        lambda r, x_sl=x_sl, n=n_sym_tot: radar.
                        radar_channel_estimate(
                            x_sl, ofdm.ofdm_demodulate(cfg, r, n)[:, sl]))
                h_of = h_of_cache[key_shape]
                hist = [h_of(rx)]
                d0 = args.num_delay_samps
                n_want = tx.samples.shape[-1]
                for _ in range(args.doppler_frames - 1):
                    b2 = session.backend.burst(np.asarray(tx.samples),
                                               n_want + d0)
                    if b2 is None:
                        # a gap breaks slow-time coherence: stop the train
                        # rather than FFT non-uniform samples
                        print("  doppler train aborted: RX deadline miss")
                        break
                    rx2 = cx.from_complex(
                        jnp.asarray(b2.rx[..., d0 : d0 + n_want])
                    )[..., pad_front:]
                    hist.append(h_of(rx2))
                t_train = tx.samples.shape[-1] / cfg.sample_rate
                rd = radar.range_doppler_map(cx.stack(hist))
                vest = radar.range_doppler_estimate(
                    rd, jnp.asarray(radar.range_axis(cfg.fft_len,
                                                     cfg.sample_rate)),
                    jnp.asarray(radar.velocity_axis(
                        len(hist), t_train, cfg.center_freq)))
                if bool(np.asarray(vest.detected)):
                    v = float(vest.velocity_mps)
                    blind = float(vest.blind_zone_mps)
                    v_bin = float(np.asarray(radar.velocity_axis(
                        len(hist), t_train, cfg.center_freq))[1]
                        - np.asarray(radar.velocity_axis(
                            len(hist), t_train, cfg.center_freq))[0])
                    note = ""
                    if abs(v) <= blind + 0.5 * v_bin:
                        note = (f"  [at MTI blind-zone edge (|v| < "
                                f"{blind:.1f} m/s unresolved) — lengthen "
                                f"--doppler-frames]")
                    print(f"  doppler train ({len(hist)} frames): "
                          f"v={v:+.1f} m/s @ {float(vest.range_m):.2f} m"
                          + note)
            state = jrc_trx.radar_state_update(state, est, background)
            last_map = ra_map
            if live_hm is not None:
                # lazy push: the d2h transfer happens only on drawn frames
                live_hm.push(lambda m=ra_map: np.asarray(cx.abs2(m)))
                live_hm.tick()
            det = bool(np.asarray(est.detected))
            if det:
                rlog.log_detection(float(est.power), float(est.snr_db),
                                   float(est.range_m), float(est.angle_deg))

        # comm leg: the remote comm RX hears every frame over the air
        rx_wave = channel.comm_channel(
            tx.samples, angle_deg=az, path_loss=20.0, noise_var=0.0)
        rx_wave = channel.awgn(k_comm, rx_wave, args.comm_noise_var)
        rx_wave = cx.concatenate(
            [rx_wave, cx.zeros(2 * cfg.n_sync_words * cfg.sym_len)], axis=-1)
        comm = comm_link.rx_chain(cfg, spec, rx_wave)
        crc = bool(np.asarray(comm.decoded.crc_ok))
        if udp_sink is not None and crc:
            udp_sink.send(np.asarray(comm.decoded.payload))
        if is_ndp and bool(np.asarray(comm.eq.sig_ok)):
            # NDP sounding feedback (chan_est.csv -> precoder in the reference)
            state = state._replace(
                chan_est=comm.eq.chan_est_full, chan_valid=jnp.bool_(True))
        if not is_ndp:
            n_data += 1
            n_ok += crc
        clog.log_frame(crc, int(spec.packet_type),
                       float(np.asarray(comm.eq.snr_legacy)),
                       float(np.asarray(comm.eq.snr_data)),
                       100.0 * (1 - n_ok / max(n_data, 1)))
        if live_tp is not None:
            live_tp.push("snr_db", t_frame, float(np.asarray(comm.eq.snr_legacy)))
            live_tp.push("per_%", t_frame, 100.0 * (1 - n_ok / max(n_data, 1)))
            live_tp.tick()
        kind = "NDP " if is_ndp else "DATA"
        leg = "BURST" if burst is not None else "tx-only"
        msg = f"frame {d} [{kind}] {leg}: crc={crc}"
        if est is not None:
            msg += (f" radar det={det} range={float(est.range_m):.2f} "
                    f"angle={float(est.angle_deg):.1f}")
        msg += f" steer_angle={float(np.asarray(state.radar_angle)):.1f}"
        print(msg)
    if last_map is not None and args.heatmap:
        power = np.asarray(jax.jit(cx.abs2)(last_map))
        render_heatmap(power, radar.range_axis(cfg.fft_len, cfg.sample_rate),
                       cfg.angle_axis(16), path=args.heatmap)
    print(f"bursts={session.n_bursts} tx_only={session.n_tx_only} "
          f"missed={session.n_missed}; "
          f"PER: {100.0 * (1 - n_ok / max(n_data, 1)):.1f}% "
          f"over {n_data} DATA frames")
    if udp_src is not None:
        udp_src.close()
    if udp_sink is not None:
        udp_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
