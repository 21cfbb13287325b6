"""Logging formats, viz rendering, IO backends, UDP PDU parity."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.utils import logging as jlog
from jrc.io.backend import SimTrx, FileTrx
from jrc.io.udp import UdpPduSink, UdpPduSource

CFG = OFDMConfig()


def test_chan_est_csv_roundtrip(tmp_path, rng):
    h = (rng.normal(size=(64, 4)) + 1j * rng.normal(size=(64, 4))).astype(np.complex64)
    p = str(tmp_path / "chan_est.csv")
    jlog.write_chan_est_csv(p, h)
    back = jlog.read_chan_est_csv(p, 64, 4)
    np.testing.assert_allclose(back, h, rtol=1e-5)
    # format matches the reference parser's expectation: "sc:(re,im);(re,im);..."
    line0 = open(p).readline()
    assert line0.startswith("0:(") and line0.count(";") == 3  # 4 cells, 3 separators


def test_radar_log_roundtrip(tmp_path):
    p = str(tmp_path / "radar_log.csv")
    log = jlog.RadarLog(p)
    log.log_detection(1.5, 22.0, 14.2, -17.5)
    log.log_detection(1.7, 25.0, 13.9, 31.25)
    # the precoder reads the LAST line's 5th field as the angle
    assert abs(jlog.RadarLog.last_angle(p) - 31.25) < 1e-6
    txt = open(p).read()
    assert "NEW RECORD" in txt


def test_comm_log_format(tmp_path):
    p = str(tmp_path / "comm_log.csv")
    log = jlog.CommLog(p)
    log.log_frame(True, 2, 25.5, 24.1, 4.0)
    lines = [l for l in open(p) if "," in l]
    assert len(lines) == 1
    fields = [f.strip() for f in lines[0].split(",")]
    assert fields[1] == "1" and fields[2] == "2"


def test_heatmap_render(tmp_path, rng):
    from jrc.viz.heatmap import render_heatmap

    m = rng.normal(size=(512, 128)) + 1j * rng.normal(size=(512, 128))
    rb = np.linspace(0, 76.8, 512)
    ab = CFG.angle_axis(16)
    path = str(tmp_path / "map.png")
    render_heatmap(m, rb, ab, path=path)
    assert os.path.getsize(path) > 1000


def test_timeplot_render(tmp_path):
    from jrc.viz.timeplot import TimeSeries

    ts = TimeSeries(window_s=10.0)
    for i in range(50):
        ts.add("snr", i * 0.5, 20 + np.sin(i / 5))
        ts.add("per", i * 0.5, 5.0 / (1 + i))
    path = str(tmp_path / "tp.png")
    ts.render(path=path)
    assert os.path.getsize(path) > 1000
    # sliding window evicted old samples
    assert all(t >= 24.5 - 10.0 for t, _ in ts._data["snr"])


def test_sim_trx_radar_alignment():
    """SimTrx closes the radar loop through the backend boundary."""
    from jrc.models import comm_link
    from jrc.ops import ofdm, radar

    targets = channel.Targets((10.0,), (0.0,), (15.0,), (10.0,))
    trx = SimTrx(CFG, targets)
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=30, packet_type=PacketType.NDP)
    payload = jnp.zeros(30, jnp.uint8).at[0].set(1)
    tx = comm_link.tx_frame(CFG, spec, payload, 1, pad_tail=3 * CFG.sym_len)
    burst = trx.burst(np.asarray(tx.samples))
    assert burst.rx.shape[0] == CFG.n_rx
    n_sym = tx.grid.shape[0]
    y = ofdm.ofdm_demodulate(CFG, jnp.asarray(burst.rx), n_sym)
    x_ref = tx.grid.swapaxes(0, 1)
    sl = slice(5, 5 + CFG.n_ltf)
    h = radar.radar_channel_estimate(x_ref[:, sl], y[:, sl])
    ra = radar.range_angle_map(h)
    est = radar.range_angle_estimate(
        ra, jnp.asarray(np.linspace(0, 76.8, 512), jnp.float32),
        jnp.asarray(CFG.angle_axis(16), jnp.float32))
    assert bool(est.detected)
    assert abs(float(est.range_m) - 10.0) < 0.6


def test_file_trx_roundtrip(tmp_path):
    spec_len = 800
    tx = (np.arange(4 * spec_len).reshape(4, spec_len) + 0j).astype(np.complex64)
    tx_path = str(tmp_path / "tx.c64")
    trx = FileTrx(CFG, tx_path=tx_path)
    trx.burst(tx)
    stored = np.fromfile(tx_path, np.complex64).reshape(-1, 4).T
    np.testing.assert_array_equal(stored, tx)


def test_file_trx_sc16_roundtrip(tmp_path):
    """sc16 record/replay at the TRX file boundary: TX recorded as int16
    interleaved (UHD's OTW format), replayed as an RX capture within one
    quantization LSB."""
    rng = np.random.default_rng(0)
    n = 600
    tx = (rng.normal(0, 0.2, (CFG.n_rx, n, 2)) @ [1, 1j]).astype(np.complex64)
    path = str(tmp_path / "cap.sc16")
    rec = FileTrx(CFG, tx_path=path, fmt="sc16")
    rec.burst(tx)
    q = np.fromfile(path, np.int16)
    assert q.size == CFG.n_rx * n * 2  # 4 B/sample on disk
    play = FileTrx(CFG, rx_path=path, fmt="sc16")
    res = play.burst(np.zeros((CFG.n_tx, n), np.complex64), n)
    np.testing.assert_allclose(res.rx, tx, atol=1.5 / 32767.0)


def test_udp_pdu_loopback():
    src = UdpPduSource(port=52710)
    sink = UdpPduSink(port=52710)
    try:
        sink.send(np.frombuffer(b"\x02hello udp", np.uint8))
        pdu = src.get(timeout=2.0)
        assert pdu is not None
        assert bytes(pdu) == b"\x02hello udp"
        assert pdu[0] == 2  # packet type byte convention
    finally:
        src.close()
        sink.close()


def test_radar_capture_csv_roundtrip(tmp_path):
    """Reference radar-channel capture CSV (lib/mimo_ofdm_radar_impl.cc:
    348-387): header 'HH:MM:SS.mmm, N_tx, N_rx, fft_len:' then the
    channel-major complex tensor as '(re,im);…;' — write, parse back,
    bit-exact; format shape checked against the Eigen csv_formatting."""
    import re

    from jrc.utils.logging import (append_radar_capture_csv,
                                       read_radar_capture_csv)

    rng = np.random.default_rng(5)
    chan = (rng.normal(size=(CFG.n_virtual, CFG.fft_len, 2)) * [1, 1j]) \
        .sum(-1).astype(np.complex64)
    path = str(tmp_path / "radar_chan.csv")
    append_radar_capture_csv(path, chan, CFG.n_tx, CFG.n_rx,
                             timestamp="10:20:30.456")
    append_radar_capture_csv(path, 2 * chan, CFG.n_tx, CFG.n_rx)

    line = open(path).readline().rstrip("\n")
    m = re.match(r"^(\d2:\d2:\d2\.\d3), (\d+), (\d+), (\d+):(\(.*\);)$"
                 .replace(r"\d2", r"\d{2}").replace(r"\d3", r"\d{3}"), line)
    assert m, line
    assert (m.group(2), m.group(3), m.group(4)) == ("4", "2", "64")
    assert line.count(";") == CFG.n_virtual * CFG.fft_len  # incl. matSuffix

    caps = read_radar_capture_csv(path)
    assert len(caps) == 2
    ts, n_tx, n_rx, parsed = caps[0]
    assert (ts, n_tx, n_rx) == ("10:20:30.456", CFG.n_tx, CFG.n_rx)
    np.testing.assert_allclose(parsed, chan, rtol=1e-6)
    np.testing.assert_allclose(caps[1][3], 2 * chan, rtol=1e-6)
