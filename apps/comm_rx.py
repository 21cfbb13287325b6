#!/usr/bin/env python3
"""Receive-only app — mirrors examples/usrp/mimo_ofdm_comm_RX.grc.

Streams an IQ capture (complex64 file, or a self-generated demo capture)
through the native ring + block RX pipeline and reports decoded frames.

    python apps/comm_rx.py --iq capture.c64 --mcs QPSK_3_4 --payload-bytes 100
    python apps/comm_rx.py --demo          # generate and decode a demo capture
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iq", help="IQ capture file (complex64, or interleaved "
                               "int16 with --iq-format sc16)")
    p.add_argument("--iq-format", choices=["fc32", "sc16"], default="fc32",
                   help="file sample format: fc32 = complex64 (the "
                        "reference's host format), sc16 = interleaved int16 "
                        "re,im (what radios record natively)")
    p.add_argument("--wire", choices=["fc32", "sc16"], default=None,
                   help="ring + host->device transfer format; sc16 halves "
                        "bytes/sample with on-device dequantization. "
                        "Default: fc32 for complex64 input, sc16 for sc16 "
                        "files (which stay quantized end-to-end; an "
                        "explicit --wire fc32 with an sc16 file is "
                        "rejected rather than silently overridden)")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--mcs", default="QPSK_3_4")
    p.add_argument("--payload-bytes", type=int, default=64)
    p.add_argument("--dynamic", action="store_true",
                   help="SIG-driven RX: discover each frame's MCS/length/"
                        "type from its SIG field (mixed traffic); --mcs/"
                        "--payload-bytes then only shape the demo capture")
    p.add_argument("--max-payload", type=int, default=256,
                   help="length envelope of the dynamic kernel")
    p.add_argument("--block-len", type=int, default=1 << 16)
    p.add_argument("--udp-out", type=int, default=0,
                   help="forward decoded payloads to this UDP port")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="decode the whole capture in one time-block sharded "
                        "step over an N-device jax mesh (ppermute halo "
                        "exchange; BASELINE config 5) instead of the "
                        "streaming ring pipeline. Requires N available "
                        "devices (use --cpu with "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                        "or jax_num_cpu_devices for virtual devices)")
    p.add_argument("--chan-est-csv", default=None,
                   help="write each received NDP frame's MIMO channel "
                        "estimate here in the reference chan_est.csv format "
                        "(lib/mimo_ofdm_equalizer_impl.cc:378-416) — the "
                        "sounding feedback the TX precoder consumes; "
                        "requires --dynamic (NDP is SIG-classified)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.io.stream import BlockStreamer
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                     packet_type=PacketType.DATA)

    if args.dynamic and args.payload_bytes > args.max_payload:
        p.error(f"--payload-bytes {args.payload_bytes} exceeds the dynamic "
                f"kernel's --max-payload {args.max_payload} envelope — such "
                "frames can never decode")
    if args.chan_est_csv and not args.dynamic:
        p.error("--chan-est-csv requires --dynamic (NDP frames are "
                "classified from their SIG field)")
    if args.demo:
        from jrc.models import comm_link
        from jrc.ops import channel

        payload = jnp.asarray(make_payload(spec, bytes([2]) + b"comm_rx demo"))
        tx = comm_link.tx_frame(cfg, spec, payload, 1)
        frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                                path_loss=5.0, noise_var=0.0))
        ndp_wave = None
        if args.dynamic:
            # mixed traffic: every 4th frame is an NDP sounding frame so the
            # --chan-est-csv feedback path is exercised end-to-end
            ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24,
                                 packet_type=PacketType.NDP)
            ndp_payload = jnp.asarray(
                make_payload(ndp_spec, bytes([1]) + b"comm_rx ndp"))
            ndp_tx = comm_link.tx_frame(cfg, ndp_spec, ndp_payload, 1)
            ndp_wave = np.asarray(channel.comm_channel(
                ndp_tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0))
        rng = np.random.default_rng(0)
        cap = (rng.normal(0, 1e-4, (4 * args.block_len, 2))
               .view(np.complex128)[:, 0]).astype(np.complex64)
        pos, k = 700, 0
        while True:
            w = ndp_wave if (ndp_wave is not None and k % 4 == 3) else frame
            if pos + len(w) >= len(cap) - 100:
                break
            cap[pos : pos + len(w)] += w
            pos += len(w) + 3000
            k += 1
    elif args.iq:
        if args.iq_format == "sc16":
            cap = np.fromfile(args.iq, np.int16).reshape(-1, 2)
        else:
            cap = np.fromfile(args.iq, np.complex64)
    else:
        p.error("--iq or --demo required")
        return 2

    sink = None
    if args.udp_out:
        from jrc.io.udp import UdpPduSink

        sink = UdpPduSink(args.udp_out)

    if args.mesh:
        return _run_sharded(args, cfg, spec, cap, sink)

    sc16_input = cap.dtype == np.int16
    if sc16_input and args.wire == "fc32":
        p.error("--wire fc32 with an sc16 capture: the sc16 path stays "
                "quantized end-to-end; convert the file first if you need "
                "the float wire")
    wire = "sc16" if sc16_input else (args.wire or "fc32")
    streamer = BlockStreamer(
        cfg, None if args.dynamic else spec, block_len=args.block_len,
        max_frames=32, max_payload=args.max_payload, wire=wire)
    n_ndp = 0
    chunk = 1 << 15
    for i in range(0, len(cap), chunk):
        part = cap[i : i + chunk]
        if sc16_input:
            streamer.push_sc16(part)  # native int16 straight onto the wire
        else:
            streamer.push(part)
        for res in streamer.process_available():
            n_ndp += _report(res, sink, args.chan_est_csv)
    for res in streamer.flush():
        n_ndp += _report(res, sink, args.chan_est_csv)
    s = streamer.stats
    print(f"blocks={s.blocks} frames={s.frames} crc_ok={s.crc_ok} "
          f"dropped_samples={s.dropped_samples}")
    if args.chan_est_csv:
        print(f"chan_est: {n_ndp} NDP sounding update(s) -> "
              f"{args.chan_est_csv}" if n_ndp else
              "chan_est: no NDP frame received; nothing written")
    return 0


def _run_sharded(args, cfg, spec, cap, sink) -> int:
    """One sharded step over the whole capture (config 5 from the CLI)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jrc.models import streaming
    from jrc.parallel import streaming as pstream
    from jrc.runtime import SC16_SCALE

    if cap.dtype == np.int16:  # sc16 file: dequantize for the sharded step
        cap = ((cap.astype(np.float32) / SC16_SCALE) @ [1, 1j]
               ).astype(np.complex64)
    n_dev = args.mesh
    if len(jax.devices()) < n_dev:
        raise SystemExit(
            f"--mesh {n_dev}: only {len(jax.devices())} devices available")
    mesh = pstream.make_time_mesh(n_dev)
    # pad to an equal per-device split whose block exceeds halo + history
    if args.dynamic:
        halo = (streaming.frame_window_samples_dynamic(cfg, args.max_payload)
                + cfg.fft_len)
    else:
        halo = streaming.frame_window_samples(cfg, spec) + cfg.fft_len
    need = max(len(cap), n_dev * 2 * (halo + cfg.fft_len))
    n = -(-need // n_dev) * n_dev
    cap = np.concatenate([cap, np.zeros(n - len(cap), np.complex64)])
    if args.dynamic:
        res = pstream.sharded_rx_dynamic(
            cfg, mesh, jnp.asarray(cap), max_frames_per_block=32,
            max_payload=args.max_payload)
    else:
        res = pstream.sharded_rx(cfg, spec, mesh, jnp.asarray(cap),
                                 max_frames_per_block=32)
    n_ndp = 0
    for blk in range(n_dev):
        # slice one device block out of every per-slot field (the last two
        # fields are the psum-reduced scalars)
        per_block = jax.tree.map(lambda a, b=blk: a[b], tuple(res)[:-2])
        n_ndp += _report(type(res)(*per_block, res.n_frames, res.n_crc_ok),
                         sink, args.chan_est_csv)
    print(f"mesh={n_dev} frames={int(np.asarray(res.n_frames))} "
          f"crc_ok={int(np.asarray(res.n_crc_ok))}")
    if args.chan_est_csv and n_ndp:
        print(f"chan_est: {n_ndp} NDP sounding update(s) -> "
              f"{args.chan_est_csv}")
    return 0


def _report(res, sink, chan_est_csv=None) -> int:
    """Print per-frame lines; export the latest NDP sounding estimate when
    requested (the equalizer→precoder feedback loop the reference closes
    through chan_est.csv). Returns the number of NDP estimates written."""
    import numpy as np

    valid = np.asarray(res.valid)
    crc = np.asarray(res.crc_ok)
    snr = np.asarray(res.snr_db)
    payload = np.asarray(res.payload)
    # dynamic results carry SIG-discovered lengths; static payloads are
    # already exact — egress must honor the pdu_len contract either way
    plen = (np.asarray(res.payload_len) if hasattr(res, "payload_len")
            else np.full(len(valid), payload.shape[-1]))
    mcs = np.asarray(res.mcs) if hasattr(res, "mcs") else None
    n_ndp = 0
    for k in np.nonzero(valid)[0]:
        extra = f" mcs={int(mcs[k])}" if mcs is not None else ""
        is_ndp = (hasattr(res, "chan_est_ok")
                  and bool(np.asarray(res.chan_est_ok)[k]))
        if is_ndp:
            extra += " type=NDP"
        print(f"  frame @ {int(np.asarray(res.start)[k])}: crc={bool(crc[k])} "
              f"snr={float(snr[k]):.1f} dB{extra}")
        if sink is not None and crc[k]:
            sink.send(payload[k][: int(plen[k])])
        if chan_est_csv and is_ndp:
            from jrc.utils.logging import write_chan_est_csv

            write_chan_est_csv(chan_est_csv, np.asarray(res.chan_est[k]))
            n_ndp += 1
    return n_ndp


if __name__ == "__main__":
    sys.exit(main())
