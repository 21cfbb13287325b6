"""Seeded fuzz: randomized captures through the flat executors.

Random frame placements (gaps, block straddles) and random per-frame
MCS/payloads must all be recovered exactly — the batched flat-stream
executors may differ from the per-frame reference chain in mechanism but
never in result.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import comm_link, streaming
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload

CFG = OFDMConfig()
BLOCK_LEN = 1 << 13


def _place(cap, frame, pos):
    cap[pos : pos + len(frame)] += frame


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_flat_executor_recovers_random_layout(seed):
    rng = np.random.default_rng(seed)
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=48, packet_type=PacketType.DATA)
    n_blocks = 6
    n = BLOCK_LEN * n_blocks
    halo = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
    cap = (rng.normal(0, 1e-4, (n + halo, 2))
           .astype(np.float32).view(np.complex64)[:, 0]).astype(np.complex64)

    placed = []  # (pos, payload bytes)
    pos = int(rng.integers(200, 1500))
    while True:
        payload = bytes([2]) + bytes(rng.integers(0, 256, 47).tolist())
        pj = jnp.asarray(make_payload(spec, payload))
        frame = np.asarray(channel.comm_channel(
            comm_link.tx_frame(CFG, spec, pj, 1).samples,
            angle_deg=float(rng.uniform(-30, 30)), path_loss=5.0,
            noise_var=0.0))
        if pos + len(frame) >= n - 50:
            break
        _place(cap, frame, pos)
        placed.append((pos, np.asarray(pj, np.uint8)))
        pos += len(frame) + int(rng.integers(700, 4000))

    res = streaming.scan_rx(CFG, spec, jnp.asarray(cap), BLOCK_LEN, n_blocks,
                            max_frames_per_block=6)
    valid = np.asarray(res.valid)
    starts = np.asarray(res.start)[valid]
    order = np.argsort(starts)
    payloads = np.asarray(res.payload)[valid][order]
    crc = np.asarray(res.crc_ok)[valid][order]
    assert len(starts) == len(placed)
    n_ok = 0
    win = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
    for k, (pos, ref) in enumerate(placed):
        # equivalence oracle: the per-frame reference chain on a slice
        # around this frame must agree with the batched flat executor
        # bit-for-bit (a random steering angle can hit a Fourier-pattern
        # null — then BOTH must fail identically)
        lo = max(pos - 600, 0)
        ref_res = comm_link.rx_chain(
            CFG, spec, jnp.asarray(cap[lo : pos + win]))
        ref_crc = bool(np.asarray(ref_res.decoded.crc_ok))
        assert bool(crc[k]) == ref_crc, (seed, k)
        if ref_crc:
            n_ok += 1
            np.testing.assert_array_equal(payloads[k], ref)
            np.testing.assert_array_equal(
                np.asarray(ref_res.decoded.payload), ref)
        # trigger fires inside the frame's STF plateau
        assert 0 <= sorted(starts)[k] - pos < 2 * CFG.sym_len
    assert n_ok >= len(placed) - 2  # at most the odd beam-null casualty


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_flat_executor_recovers_random_mixed_traffic(seed):
    rng = np.random.default_rng(100 + seed)
    n_blocks = 6
    n = BLOCK_LEN * n_blocks
    max_payload = 64
    halo = streaming.frame_window_samples_dynamic(CFG, max_payload) + CFG.fft_len
    cap = (rng.normal(0, 1e-4, (n + halo, 2))
           .astype(np.float32).view(np.complex64)[:, 0]).astype(np.complex64)

    mcs_pool = list(MCS)
    placed = []  # (pos, mcs, n_bytes, payload)
    pos = int(rng.integers(200, 1500))
    while True:
        mcs = mcs_pool[int(rng.integers(len(mcs_pool)))]
        is_ndp = bool(rng.integers(4) == 0)
        nbytes = int(rng.integers(8, max_payload + 1))
        spec = FrameSpec(mcs, payload_bytes=nbytes,
                         packet_type=PacketType.NDP if is_ndp
                         else PacketType.DATA)
        payload = bytes([1 if is_ndp else 2]) + bytes(
            rng.integers(0, 256, nbytes - 1).tolist())
        pj = jnp.asarray(make_payload(spec, payload))
        frame = np.asarray(channel.comm_channel(
            comm_link.tx_frame(CFG, spec, pj, 1).samples,
            angle_deg=0.0, path_loss=5.0, noise_var=0.0))
        if pos + len(frame) >= n - 50:
            break
        _place(cap, frame, pos)
        placed.append((pos, int(mcs), nbytes, np.asarray(pj, np.uint8)))
        pos += len(frame) + int(rng.integers(700, 4000))

    res = streaming.scan_rx_dynamic(
        CFG, jnp.asarray(cap), BLOCK_LEN, n_blocks,
        max_frames_per_block=6, max_payload=max_payload)
    valid = np.asarray(res.valid)
    order = np.argsort(np.asarray(res.start)[valid])
    crc = np.asarray(res.crc_ok)[valid][order]
    mcs_got = np.asarray(res.mcs)[valid][order]
    plen = np.asarray(res.payload_len)[valid][order]
    payloads = np.asarray(res.payload)[valid][order]
    assert len(crc) == len(placed)
    for k, (pos, mcs, nbytes, ref) in enumerate(placed):
        assert bool(crc[k]), (seed, k, mcs)
        assert int(mcs_got[k]) == mcs
        assert int(plen[k]) == nbytes
        np.testing.assert_array_equal(payloads[k][:nbytes], ref[:nbytes])


@pytest.mark.parametrize("seed,wire", [(0, "fc32"), (1, "sc16"), (2, "sc16")])
def test_streamer_random_chunking_matches_oracle(seed, wire):
    """BlockStreamer under adversarial ingest: random chunk sizes, random
    interleave of push/process, random frame gaps (some straddling
    superblock boundaries), sc16 wire mixing quantized-complex pushes with
    native int16 pushes — the decoded (trigger, payload) set must equal the
    one-shot scan_rx oracle over the same capture."""
    from jrc.io.stream import BlockStreamer
    from jrc.runtime import SC16_SCALE

    rng = np.random.default_rng(100 + seed)
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=40, packet_type=PacketType.DATA)
    block_len, n_super = 1 << 13, 3
    n = block_len * n_super
    cap = (rng.normal(0, 1e-4, (n, 2)) @ [1, 1j]).astype(np.complex64)
    placed = []
    pos = int(rng.integers(300, 1200))
    while True:
        payload = bytes([2]) + bytes(rng.integers(0, 256, 39).tolist())
        pj = jnp.asarray(make_payload(spec, payload))
        frame = np.asarray(channel.comm_channel(
            comm_link.tx_frame(CFG, spec, pj, 1 + len(placed) % 127).samples,
            angle_deg=0.0, path_loss=5.0, noise_var=0.0))
        if pos + len(frame) >= n - 8:
            break
        _place(cap, frame, pos)
        placed.append((pos, payload))
        pos += len(frame) + int(rng.integers(700, 2600))
    assert len(placed) >= 8

    s = BlockStreamer(CFG, spec, block_len=block_len, max_frames=16, wire=wire)
    got = []
    blk_idx = [0]  # superblock counter: streamer starts are block-relative

    def drain(it):
        for res in it:
            base = blk_idx[0] * s.span
            blk_idx[0] += 1
            valid = np.asarray(res.valid)
            for k in np.nonzero(valid)[0]:
                assert bool(np.asarray(res.crc_ok)[k])
                got.append((base + int(np.asarray(res.start)[k]),
                            bytes(np.asarray(res.payload)[k])))

    i = 0
    while i < n:
        m = int(rng.integers(1, 3 * block_len))
        chunk = cap[i : i + m]
        if wire == "sc16" and rng.integers(2):
            q = np.clip(np.rint(chunk.view(np.float32) * SC16_SCALE),
                        -32767, 32767).astype(np.int16).reshape(-1, 2)
            s.push_sc16(q)
        else:
            s.push(chunk)
        i += m
        if rng.integers(2):
            drain(s.process_available())
    drain(s.flush())
    drain(s.flush())  # idempotent: contributes nothing

    # oracle: the flat executor over the same capture in one shot
    halo = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
    oracle = streaming.scan_rx(
        CFG, spec, jnp.asarray(np.concatenate([cap, np.zeros(halo, np.complex64)])),
        block_len, n_super, max_frames_per_block=16)
    ov = np.asarray(oracle.valid)
    want = sorted(
        (int(np.asarray(oracle.start)[k]), bytes(np.asarray(oracle.payload)[k]))
        for k in np.nonzero(ov)[0])
    assert sorted(got) == want
    # and the oracle itself found every placed frame
    assert len(want) == len(placed)
    for (g_pos, g_pl), (w_pos, w_pl) in zip(
            sorted(got), sorted((p, make_payload(spec, pl).tobytes())
                                for p, pl in placed)):
        assert 0 <= g_pos - w_pos <= CFG.fft_len
        assert g_pl == w_pl
