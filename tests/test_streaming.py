"""Time-block sharded streaming RX (BASELINE config 5) on the 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.models import comm_link, streaming
from jrc.parallel import streaming as pstream

CFG = OFDMConfig()
SPEC = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)


def _capture(n_dev=8, block_len=8192, gap=2111, seed=0):
    payload = jnp.asarray(make_payload(SPEC, bytes([2]) + b"stream frame"))
    tx = comm_link.tx_frame(CFG, SPEC, payload, 1)
    frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                            path_loss=5.0, noise_var=0.0))
    rng = np.random.default_rng(seed)
    cap = (rng.normal(0, 1e-4, (n_dev * block_len, 2)).view(np.complex128)[:, 0]).astype(np.complex64)
    starts = []
    pos = 500
    while pos + len(frame) < len(cap) - 100:
        cap[pos : pos + len(frame)] += frame
        starts.append(pos)
        pos += len(frame) + gap
    return cap, starts, payload


def test_all_frames_found_exactly_once():
    cap, true_starts, payload = _capture()
    mesh = pstream.make_time_mesh()
    assert mesh.devices.size == 8
    res = pstream.sharded_rx(CFG, SPEC, mesh, jnp.asarray(cap))
    assert int(res.n_frames) == len(true_starts)
    assert int(res.n_crc_ok) == len(true_starts)
    starts = np.sort(np.asarray(res.start)[np.asarray(res.valid)])
    assert len(starts) == len(set(starts.tolist()))  # no duplicates
    # every decoded payload matches
    ok = np.asarray(res.crc_ok)[np.asarray(res.valid)]
    assert ok.all()
    pl = np.asarray(res.payload)[np.asarray(res.valid)]
    for row in pl:
        np.testing.assert_array_equal(row, np.asarray(payload))


def test_sharded_matches_single_device():
    """Multi-device sharding must be bit-identical to one device."""
    cap, _, _ = _capture()
    res8 = pstream.sharded_rx(CFG, SPEC, pstream.make_time_mesh(8), jnp.asarray(cap))
    res1 = pstream.sharded_rx(CFG, SPEC, pstream.make_time_mesh(1), jnp.asarray(cap),
                              max_frames_per_block=64)
    s8 = np.sort(np.asarray(res8.start)[np.asarray(res8.valid)])
    s1 = np.sort(np.asarray(res1.start)[np.asarray(res1.valid)])
    np.testing.assert_array_equal(s8, s1)
    assert int(res8.n_crc_ok) == int(res1.n_crc_ok)


def test_boundary_straddling_frame():
    """A frame placed exactly across a block boundary decodes once."""
    block_len = 8192
    payload = jnp.asarray(make_payload(SPEC, bytes([2]) + b"edge"))
    tx = comm_link.tx_frame(CFG, SPEC, payload, 1)
    frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                            path_loss=5.0, noise_var=0.0))
    rng = np.random.default_rng(1)
    cap = (rng.normal(0, 1e-4, (8 * block_len, 2)).view(np.complex128)[:, 0]).astype(np.complex64)
    # trigger lands ~60 samples before the boundary; most of the frame after it
    pos = block_len - 100
    cap[pos : pos + len(frame)] += frame
    res = pstream.sharded_rx(CFG, SPEC, pstream.make_time_mesh(8), jnp.asarray(cap))
    assert int(res.n_frames) == 1
    assert int(res.n_crc_ok) == 1


def test_rx_block_single_call():
    """The unsharded block kernel works standalone (bench path)."""
    cap, true_starts, payload = _capture(n_dev=1, block_len=32768)
    halo = streaming.frame_window_samples(CFG, SPEC) + 64
    x = jnp.concatenate([jnp.asarray(cap), jnp.zeros(halo, jnp.complex64)])
    res = streaming.rx_block(CFG, SPEC, x, len(cap), max_frames=16)
    assert int(res.valid.sum()) == len(true_starts)
    assert int(res.crc_ok.sum()) == len(true_starts)


def test_owned_frames_not_evicted_by_preblock_trigger():
    """A trigger in the ignore_gap span just before a block's ownership
    window must not consume one of that block's max_frames slots: with the
    block at capacity, every owned frame still decodes (the pre-span
    candidates exist only to drive re-trigger suppression). Regression for
    the sort-then-mask eviction bug, on both the flat-stream and the
    windowed per-block detector paths."""
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=16, packet_type=PacketType.DATA)
    payload = jnp.asarray(
        __import__("jrc.ops.encoder", fromlist=["make_payload"])
        .make_payload(spec, bytes([2]) + b"evict"))
    tx = comm_link.tx_frame(CFG, spec, payload, 1)
    frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                            path_loss=5.0, noise_var=0.0))
    block_len, n_blocks, mf = 8192, 2, 2
    halo = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
    cap = np.zeros(n_blocks * block_len + halo, np.complex64)
    # block 0: one frame whose trigger sits within ignore_gap (=640) of the
    # block-1 boundary; block 1: exactly max_frames frames
    positions = [block_len - 400, block_len + 700, block_len + 2500]
    for pos in positions:
        cap[pos : pos + len(frame)] += frame

    for bl in (block_len, block_len + 8):  # flat path / windowed vmap path
        if bl != block_len:
            cap2 = np.zeros(n_blocks * bl + halo, np.complex64)
            cap2[: len(cap)] = cap
        else:
            cap2 = cap
        res = streaming.scan_rx(CFG, spec, jnp.asarray(cap2), bl, n_blocks,
                                max_frames_per_block=mf)
        valid = np.asarray(res.valid)
        assert int(valid.sum()) == 3, (bl, valid)
        assert np.asarray(res.crc_ok)[valid].all(), bl
        got = sorted(np.asarray(res.start)[valid].tolist())
        # the trigger fires a few tens of samples into the STF plateau
        for g, want in zip(got, positions):
            assert 0 <= g - want <= CFG.fft_len, (bl, got)
