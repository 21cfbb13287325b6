"""Native C++ runtime: ring buffer semantics, threading, host streaming."""
import threading
import time

import numpy as np

from jrc.runtime import IQRing, load_library, mean_power


def test_native_library_builds():
    assert load_library() is not None, "g++ build of libjrc_runtime.so failed"


def test_ring_block_layout():
    r = IQRing(1 << 14)
    x = (np.arange(5000) + 1j * np.arange(5000)).astype(np.complex64)
    assert r.push(x) == 5000
    b = r.pop_block(2048, 512, 256)
    assert np.all(b[:256] == 0)  # pre-stream history is zero
    np.testing.assert_array_equal(b[256 : 256 + 2048], x[:2048])
    np.testing.assert_array_equal(b[256 + 2048 :], x[2048 : 2048 + 512])
    b2 = r.pop_block(2048, 512, 256)
    np.testing.assert_array_equal(b2[:256], x[2048 - 256 : 2048])  # real history
    assert r.pop_block(2048, 512, 256) is None  # not enough buffered


def test_ring_wraparound():
    r = IQRing(1 << 10)  # 1024 samples
    total = 0
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=300).astype(np.complex64) * (1 + 1j) for _ in range(6)]
    expect = []
    for c in chunks:
        n = r.push(c)
        expect.extend(c[:n].tolist())
        total += n
        while True:
            b = r.pop_block(256, 64, 0)
            if b is None:
                break
    # no crash across wrap; drops accounted
    assert r.dropped() + total == 6 * 300


def test_ring_overflow_drops():
    r = IQRing(1 << 8)  # 256
    x = np.ones(1000, np.complex64)
    accepted = r.push(x)
    assert accepted == 256
    assert r.dropped() == 744


def test_threaded_producer_consumer():
    r = IQRing(1 << 12)
    n_total = 200_000
    src = (np.arange(n_total) % 997 + 1j).astype(np.complex64)
    consumed = []

    def producer():
        pos = 0
        while pos < n_total:
            n = r.push(src[pos : pos + 512])
            pos += 512
            if n < 512:
                time.sleep(0.0005)

    t = threading.Thread(target=producer)
    t.start()
    deadline = time.time() + 20
    got = 0
    while time.time() < deadline:
        b = r.pop_block(1024, 0, 0)
        if b is None:
            if not t.is_alive() and r.available() < 1024:
                break
            time.sleep(0.0002)
            continue
        consumed.append(b)
        got += 1024
    t.join()
    # conservation: consumed + still-buffered + dropped == produced
    assert got + r.available() + r.dropped() == n_total
    # consumed data is a prefix-ordered subsequence of the source modulo drops;
    # with no drops it is exact
    if r.dropped() == 0:
        flat = np.concatenate(consumed)
        np.testing.assert_array_equal(flat, src[: len(flat)])


def test_mean_power():
    assert abs(mean_power(np.full(64, 3.0, np.complex64)) - 9.0) < 1e-5
    assert mean_power(np.zeros(0, np.complex64)) == 0.0


def test_block_streamer_end_to_end():
    """Ring → jitted RX: frames pushed through the host path decode."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.io.stream import BlockStreamer
    from jrc.models import comm_link
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=32, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"host stream"))
    tx = comm_link.tx_frame(cfg, spec, payload, 1)
    frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                            path_loss=5.0, noise_var=0.0))
    streamer = BlockStreamer(cfg, spec, block_len=1 << 14, max_frames=8)
    rng = np.random.default_rng(0)
    n_frames = 0
    for _ in range(3):  # three pushes of noise+frames
        chunk = (rng.normal(0, 1e-4, (1 << 14, 2)).view(np.complex128)[:, 0]).astype(np.complex64)
        chunk[1000 : 1000 + len(frame)] += frame
        n_frames += 1
        streamer.push(chunk)
        for _res in streamer.process_available():
            pass
    for _res in streamer.flush():
        pass
    assert streamer.stats.crc_ok == n_frames
    assert streamer.stats.dropped_samples == 0


def test_fallback_ring_preserves_history_across_wrap(monkeypatch):
    """numpy-fallback ring: the consumer's left-history region must survive
    a producer filling the ring to capacity (the native ring reserves it;
    the fallback now does too)."""
    import jrc.runtime as rt

    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "_lib_err", "forced-fallback")
    r = rt.IQRing(16)
    assert not r.native
    x = (np.arange(1, 100) + 0j).astype(np.complex64)
    assert r.push(x[:16]) == 16          # fill
    b = r.pop_block(8, 0, 4)             # consume 8, history=4 registered
    np.testing.assert_array_equal(b[4:].real, np.arange(1, 9))
    pushed = r.push(x[16:32])            # refill — must NOT clobber 5..8
    assert pushed <= 12                  # 4 history slots stay reserved
    b2 = r.pop_block(8, 0, 4)
    np.testing.assert_array_equal(b2[:4].real, np.arange(5, 9))  # true history
    np.testing.assert_array_equal(b2[4:].real, np.arange(9, 17))


def test_streamer_flush_drains_multiple_buffered_superblocks():
    """flush() after pushing several superblocks without interleaved
    processing must recover every frame (the old pad-first order dropped
    the residual tail)."""
    import jax.numpy as jnp

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.io.stream import BlockStreamer
    from jrc.models import comm_link
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=48, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"flush"))
    frame = np.asarray(channel.comm_channel(
        comm_link.tx_frame(cfg, spec, payload, 1).samples,
        angle_deg=0.0, path_loss=5.0, noise_var=0.0))

    block_len = 1 << 13
    s = BlockStreamer(cfg, spec, block_len=block_len, max_frames=8,
                      ring_capacity=8 * block_len)
    # 2.5 superblocks of data with frames throughout, pushed all at once
    n = int(2.5 * block_len)
    cap = np.zeros(n, np.complex64)
    pos, nf = 600, 0
    while pos + len(frame) < n - 100:
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + 900
        nf += 1
    s.push(cap)
    results = list(s.flush())  # no process_available() beforehand
    assert s.stats.crc_ok == nf, (s.stats.crc_ok, nf)


def test_streamer_flush_tail_in_halo_region_and_idempotent():
    """Two flush guarantees: (1) a frame whose trigger lands PAST the final
    padded block's ownership span (in what would be its halo) still decodes
    — one pad alone left up to `halo` trailing samples undecoded; (2) a
    repeat flush with nothing new pushed is a no-op (no zero-block kernel
    dispatches)."""
    import jax.numpy as jnp

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.io.stream import BlockStreamer
    from jrc.models import comm_link
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=48, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"halo tail"))
    frame = np.asarray(channel.comm_channel(
        comm_link.tx_frame(cfg, spec, payload, 1).samples,
        angle_deg=0.0, path_loss=5.0, noise_var=0.0))

    block_len = 1 << 13
    s = BlockStreamer(cfg, spec, block_len=block_len, max_frames=8,
                      ring_capacity=8 * block_len)
    # trigger just past the span; total capture length in (span, span+halo)
    pos = s.span + 16
    n = pos + len(frame) + 8
    assert s.span < n < s.span + s.halo  # the scenario under test
    cap = np.zeros(n, np.complex64)
    cap[pos : pos + len(frame)] = frame
    s.push(cap)
    list(s.flush())
    assert s.stats.crc_ok == 1, s.stats
    blocks_after_first_flush = s.stats.blocks
    list(s.flush())  # idempotent: no extra zero-block dispatches
    assert s.stats.blocks == blocks_after_first_flush
