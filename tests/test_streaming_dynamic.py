"""SIG-driven dynamic streaming: mixed-MCS + NDP captures decode end-to-end
(the reference's normal traffic pattern,
lib/mimo_ofdm_equalizer_impl.cc:650-781, lib/stream_decoder_impl.cc:129-172)."""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import comm_link, streaming
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload

CFG = OFDMConfig()
MAXP = 96


def _frame(mcs, msg, ptype=PacketType.DATA, seed=1):
    spec = FrameSpec(mcs, payload_bytes=len(msg), packet_type=ptype)
    type_byte = bytes([2 if ptype is PacketType.DATA else 1])
    payload = jnp.asarray(make_payload(spec, type_byte + msg[1:]))
    tx = comm_link.tx_frame(CFG, spec, payload, seed)
    wave = channel.comm_channel(
        tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0
    )
    return np.asarray(wave), np.asarray(payload), spec


def test_mixed_traffic_capture_decodes():
    """Interleaved BPSK/QPSK/16QAM DATA frames + an NDP frame in one capture,
    decoded by the streaming executor with per-frame SIG discovery."""
    traffic = [
        (MCS.BPSK_1_2, b"\x02 bpsk frame payload", PacketType.DATA),
        (MCS.QPSK_3_4, b"\x02 qpsk frame with a longer payload......", PacketType.DATA),
        (MCS.QPSK_1_2, b"\x01 ndp", PacketType.NDP),
        (MCS.QAM16_3_4, b"\x02 16qam frame payload data bytes", PacketType.DATA),
    ]
    frames = [_frame(m, msg, pt, seed=3 + i) for i, (m, msg, pt) in enumerate(traffic)]

    block_len = 8192
    n_blocks = 2
    cap = np.zeros(block_len * n_blocks, np.complex64)
    positions = []
    pos = 600
    for wave, _, _ in frames:
        cap[pos : pos + len(wave)] += wave
        positions.append(pos)
        pos += len(wave) + 1500
    assert pos < block_len * n_blocks
    halo = streaming.frame_window_samples_dynamic(CFG, MAXP) + CFG.fft_len
    cap = np.concatenate([cap, np.zeros(halo, np.complex64)])

    res = streaming.scan_rx_dynamic(
        CFG, jnp.asarray(cap), block_len, n_blocks,
        max_frames_per_block=4, max_payload=MAXP,
    )
    valid = np.asarray(res.valid)
    assert int(valid.sum()) == len(frames), valid

    order = np.argsort(np.where(valid, np.asarray(res.start), 10**9))[: len(frames)]
    for slot, (mcs, msg, ptype), (wave, payload, spec) in zip(order, traffic, frames):
        assert bool(np.asarray(res.sig_ok)[slot]), (mcs, "sig")
        assert bool(np.asarray(res.crc_ok)[slot]), (mcs, "crc")
        assert int(np.asarray(res.mcs)[slot]) == int(mcs)
        want_type = 1 if ptype is PacketType.DATA else 0
        assert int(np.asarray(res.packet_type_bit)[slot]) == want_type
        plen = int(np.asarray(res.payload_len)[slot])
        assert plen == spec.payload_bytes
        got = np.asarray(res.payload)[slot][:plen]
        np.testing.assert_array_equal(got, payload)


def test_dynamic_matches_static_path():
    """On single-MCS traffic the dynamic executor must agree with the
    static-spec fast path frame for frame."""
    wave, payload, spec = _frame(MCS.QPSK_1_2, b"\x02 static vs dynamic", seed=9)
    block_len = 8192
    cap = np.zeros(block_len, np.complex64)
    cap[700 : 700 + len(wave)] += wave
    halo_d = streaming.frame_window_samples_dynamic(CFG, MAXP) + CFG.fft_len
    cap_d = np.concatenate([cap, np.zeros(halo_d, np.complex64)])
    halo_s = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
    cap_s = np.concatenate([cap, np.zeros(halo_s, np.complex64)])

    dyn = streaming.scan_rx_dynamic(
        CFG, jnp.asarray(cap_d), block_len, 1, max_frames_per_block=2,
        max_payload=MAXP,
    )
    st = streaming.scan_rx(
        CFG, spec, jnp.asarray(cap_s), block_len, 1, max_frames_per_block=2
    )
    assert int(np.asarray(dyn.valid).sum()) == 1
    assert int(np.asarray(st.valid).sum()) == 1
    i_d = int(np.argmax(np.asarray(dyn.valid)))
    i_s = int(np.argmax(np.asarray(st.valid)))
    assert int(np.asarray(dyn.start)[i_d]) == int(np.asarray(st.start)[i_s])
    assert bool(np.asarray(dyn.crc_ok)[i_d]) and bool(np.asarray(st.crc_ok)[i_s])
    plen = int(np.asarray(dyn.payload_len)[i_d])
    np.testing.assert_array_equal(
        np.asarray(dyn.payload)[i_d][:plen], np.asarray(st.payload)[i_s][:plen]
    )


def test_sharded_dynamic_mixed_traffic():
    """8-device mesh, one mixed-MCS frame per block (NDP on device 5):
    every frame decodes exactly once; repeated calls reuse the jitted step."""
    from jrc.parallel import streaming as pstream

    mcss = [MCS.BPSK_1_2, MCS.QPSK_3_4, MCS.QAM16_1_2, MCS.QPSK_1_2]
    block_len, n_dev = 8192, 8
    cap = np.zeros(block_len * n_dev, np.complex64)
    for d in range(n_dev):
        mcs = mcss[d % len(mcss)]
        pt = PacketType.NDP if d == 5 else PacketType.DATA
        spec = FrameSpec(mcs, payload_bytes=20 + d, packet_type=pt)
        pl = jnp.asarray(make_payload(
            spec, bytes([2 if pt is PacketType.DATA else 1]) + bytes(19 + d)))
        tx = comm_link.tx_frame(CFG, spec, pl, d + 1)
        wave = np.asarray(channel.comm_channel(
            tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0))
        pos = d * block_len + (d * 977) % (block_len - len(wave) - 8)
        cap[pos : pos + len(wave)] += wave

    mesh = pstream.make_time_mesh(n_dev)
    res = pstream.sharded_rx_dynamic(
        CFG, mesh, jnp.asarray(cap), max_frames_per_block=4, max_payload=64)
    assert int(np.asarray(res.n_frames)) == n_dev
    assert int(np.asarray(res.n_crc_ok)) == n_dev
    # the NDP sounding estimate rides the sharded surface: exactly one
    # chan_est_ok slot (device 5's NDP frame), and its estimate carries the
    # broadside channel (flat phase across TX at the active carriers)
    ce_ok = np.asarray(res.chan_est_ok)
    assert int(ce_ok.sum()) == 1
    blk, slot = map(int, np.argwhere(ce_ok)[0])
    assert blk == 5
    h = np.asarray(res.chan_est)[blk, slot]  # (fft_len, n_tx)
    active = np.asarray(CFG.active_carrier_idx)
    assert np.abs(h[active]).min() > 0.1  # live on active carriers
    ph = np.angle(h[active, 1:] * np.conj(h[active, :-1]))
    assert np.abs(ph).max() < 0.1  # angle 0 ⇒ no inter-antenna phase ramp
    hits0 = pstream._build_sharded_rx.cache_info().hits
    pstream.sharded_rx_dynamic(
        CFG, mesh, jnp.asarray(cap), max_frames_per_block=4, max_payload=64)
    assert pstream._build_sharded_rx.cache_info().hits == hits0 + 1


def test_ndp_chan_est_through_streaming(tmp_path):
    """A mixed NDP+DATA capture streamed through
    BlockStreamer(spec=None) surfaces the NDP MIMO channel estimate
    (chan_est + chan_est_ok), which round-trips the reference chan_est.csv
    format and steers the precoder toward the sounded angle — closing the
    over-the-air sounding loop (lib/mimo_ofdm_equalizer_impl.cc:378-416 →
    lib/mimo_precoder_impl.cc:775-898)."""
    from jrc.io.stream import BlockStreamer
    from jrc.ops import cplx as cx, precoder
    from jrc.utils.logging import read_chan_est_csv, write_chan_est_csv

    angle = 20.0
    waves = []
    for mcs, msg, pt in [
        (MCS.QPSK_3_4, b"\x02 data before sounding", PacketType.DATA),
        (MCS.QPSK_1_2, b"\x01 ndp sounding", PacketType.NDP),
        (MCS.QAM16_1_2, b"\x02 data after sounding!", PacketType.DATA),
    ]:
        spec = FrameSpec(mcs, payload_bytes=len(msg), packet_type=pt)
        type_byte = bytes([2 if pt is PacketType.DATA else 1])
        pl = jnp.asarray(make_payload(spec, type_byte + msg[1:]))
        tx = comm_link.tx_frame(CFG, spec, pl, 3)
        waves.append(np.asarray(channel.comm_channel(
            tx.samples, angle_deg=angle, path_loss=5.0, noise_var=0.0)))

    block_len = 8192
    cap = np.zeros(3 * block_len, np.complex64)
    pos = 500
    for w in waves:
        cap[pos : pos + len(w)] += w
        pos += len(w) + 1800

    s = BlockStreamer(CFG, None, block_len=block_len, max_frames=4,
                      max_payload=MAXP)
    s.push(cap)
    ests, n_data = [], 0
    for res in list(s.process_available()) + list(s.flush()):
        valid = np.asarray(res.valid)
        ce_ok = np.asarray(res.chan_est_ok)
        for i in np.nonzero(valid)[0]:
            assert bool(np.asarray(res.crc_ok)[i])
            if ce_ok[i]:
                assert int(np.asarray(res.packet_type_bit)[i]) == 0
                ests.append(np.asarray(res.chan_est[i]))
            else:
                assert int(np.asarray(res.packet_type_bit)[i]) == 1
                n_data += 1
    assert len(ests) == 1 and n_data == 2

    # round-trip the reference CSV format, then consume it in the precoder
    path = str(tmp_path / "chan_est.csv")
    write_chan_est_csv(path, ests[0])
    back = read_chan_est_csv(path, CFG.fft_len, CFG.n_tx)
    np.testing.assert_allclose(back, ests[0], rtol=0, atol=1e-6)

    h = cx.from_complex(jnp.asarray(back))
    q, q_mean = precoder.steering_from_chan_est(CFG, h, phased=True)
    assert q.shape == (CFG.fft_len, CFG.n_tx, CFG.n_tx)
    active = np.asarray(CFG.active_carrier_idx)
    h_mean = cx.mean(h[jnp.asarray(active)], axis=0)
    est_angle = float(precoder.mean_channel_angle(h_mean))
    assert abs(est_angle - angle) < 1.5, est_angle


def test_block_streamer_dynamic_mode():
    """BlockStreamer(spec=None): mixed traffic through the native ring."""
    from jrc.io.stream import BlockStreamer

    frames = [
        _frame(MCS.QPSK_3_4, b"\x02 streamer qpsk", seed=21),
        _frame(MCS.QAM16_1_2, b"\x02 streamer 16qam!", seed=22),
    ]
    block_len = 8192
    cap = np.zeros(2 * block_len, np.complex64)
    pos = 500
    for wave, _, _ in frames:
        cap[pos : pos + len(wave)] += wave
        pos += len(wave) + 2000

    s = BlockStreamer(CFG, None, block_len=block_len, max_frames=4,
                      max_payload=MAXP)
    s.push(cap)
    results = list(s.process_available()) + list(s.flush())
    got = []
    for res in results:
        valid = np.asarray(res.valid)
        for i in np.nonzero(valid)[0]:
            got.append((int(np.asarray(res.mcs)[i]),
                        bool(np.asarray(res.crc_ok)[i])))
    assert sorted(got) == sorted(
        [(int(MCS.QPSK_3_4), True), (int(MCS.QAM16_1_2), True)]), got
