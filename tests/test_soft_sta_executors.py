"""Soft-decision + STA tracking through the PRODUCTION executors
the flat-stream, dynamic, and sharded paths accept
``soft=True`` / ``estimator='sta'`` instead of hard-wiring ls/hard.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import comm_link, streaming
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload

CFG = OFDMConfig()
BLOCK_LEN = 1 << 13
N_BLOCKS = 8


def _capture(spec, payload, noise_var, gap=997, seed=3):
    """Frames + AWGN at a pinned noise level; returns (cap, n_frames)."""
    rng = np.random.default_rng(seed)
    tx = comm_link.tx_frame(CFG, spec, payload, 1).samples
    frame = np.asarray(
        channel.comm_channel(tx, angle_deg=0.0, path_loss=5.0, noise_var=0.0)
    )
    n = BLOCK_LEN * N_BLOCKS
    # halo covering both the static window and the dynamic executor's
    # worst-case (max_payload=64) envelope, so one capture serves all tests
    halo = max(
        streaming.frame_window_samples(CFG, spec),
        streaming.frame_window_samples_dynamic(CFG, 64),
    ) + CFG.fft_len
    cap = (
        rng.normal(0, np.sqrt(noise_var / 2), (n + halo, 2))
        .astype(np.float32).view(np.complex64)[:, 0]
    ).astype(np.complex64)
    pos, nf = 600, 0
    while pos + len(frame) < n - 100:
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + gap
        nf += 1
    return cap, nf


def test_soft_decoding_beats_hard_at_pinned_snr():
    """Same capture, same executor: max-log-MAP LLRs must cut both the
    payload BER and the CRC failure count vs hard decisions (the soft
    coding gain of the rate-3/4 code at 16-QAM)."""
    spec = FrameSpec(MCS.QAM16_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    rng = np.random.default_rng(3)
    payload_bytes = bytes([2]) + bytes(rng.integers(0, 256, 63).tolist())
    payload = jnp.asarray(make_payload(spec, payload_bytes))
    cap, nf = _capture(spec, payload, noise_var=6e-3)
    ref = np.asarray(payload, np.uint8)[None].repeat(nf, 0)

    stats = {}
    for soft in (False, True):
        res = streaming.scan_rx(
            CFG, spec, jnp.asarray(cap), BLOCK_LEN, N_BLOCKS,
            max_frames_per_block=4, soft=soft,
        )
        valid = np.asarray(res.valid)
        pay = np.asarray(res.payload)[valid][:nf]
        bit_errs = int(np.unpackbits(pay ^ ref[: len(pay)]).sum())
        stats[soft] = (int(np.asarray(res.crc_ok).sum()), bit_errs)

    hard_crc, hard_errs = stats[False]
    soft_crc, soft_errs = stats[True]
    assert nf == 32
    assert hard_crc < nf  # the pinned SNR does stress the hard decoder
    assert soft_crc >= hard_crc + 5
    assert soft_errs * 4 < hard_errs


def test_sta_through_flat_executor():
    """estimator='sta' rides the flat-stream path end-to-end (decision-
    directed tracking, reference lib/mimo_ofdm_equalizer_impl.cc:500-592)."""
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=48, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + bytes(44)))
    cap, nf = _capture(spec, payload, noise_var=1e-4)
    res = streaming.scan_rx(
        CFG, spec, jnp.asarray(cap), BLOCK_LEN, N_BLOCKS,
        max_frames_per_block=4, estimator="sta",
    )
    assert int(np.asarray(res.crc_ok).sum()) == nf


def test_dynamic_executor_soft_and_sta():
    """The SIG-driven dynamic executor accepts soft + sta jointly."""
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=48, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + bytes(44)))
    cap, nf = _capture(spec, payload, noise_var=1e-4)
    res = streaming.scan_rx_dynamic(
        CFG, jnp.asarray(cap), BLOCK_LEN, N_BLOCKS,
        max_frames_per_block=4, max_payload=64, estimator="sta", soft=True,
    )
    assert int(np.asarray(res.crc_ok).sum()) == nf
    assert np.all(np.asarray(res.mcs)[np.asarray(res.valid)] == int(MCS.QPSK_3_4))


def test_sharded_soft_matches_unsharded():
    """soft=True through the sharded executor: same totals as the flat
    single-device run on the same capture."""
    from jrc.parallel import streaming as pstream

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs >=2 devices")
    spec = FrameSpec(MCS.QAM16_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    rng = np.random.default_rng(3)
    payload = jnp.asarray(
        make_payload(spec, bytes([2]) + bytes(rng.integers(0, 256, 63).tolist()))
    )
    cap, nf = _capture(spec, payload, noise_var=6e-3)
    n = BLOCK_LEN * N_BLOCKS

    flat = streaming.scan_rx(
        CFG, spec, jnp.asarray(cap), BLOCK_LEN, N_BLOCKS,
        max_frames_per_block=4, soft=True,
    )
    mesh = pstream.make_time_mesh(2)
    shr = pstream.sharded_rx(
        CFG, spec, mesh, jnp.asarray(cap[:n]), max_frames_per_block=16,
        soft=True,
    )
    assert int(np.asarray(shr.n_frames)) == nf
    assert int(np.asarray(shr.n_crc_ok)) == int(np.asarray(flat.crc_ok).sum())


def test_sta_tracks_time_varying_multipath_where_ls_fails():
    """The point of STA (lib/mimo_ofdm_equalizer_impl.cc:500-592): a second
    propagation path whose complex gain rotates across the frame makes the
    channel frequency-selective AND time-varying — pilot CPE can't fix it
    (it's not a common phase) and the frame-initial LS estimate goes stale.
    Decision-directed tracking follows it symbol by symbol."""
    spec = FrameSpec(MCS.QAM16_3_4, payload_bytes=256, packet_type=PacketType.DATA)
    rng = np.random.default_rng(1)
    payload = jnp.asarray(
        make_payload(spec, bytes([2]) + bytes(rng.integers(0, 256, 255).tolist()))
    )
    tx = comm_link.tx_frame(CFG, spec, payload, 1)
    wave = np.asarray(
        channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=4.0,
                             noise_var=0.0)
    )
    n = len(wave)
    t = np.arange(n) / n
    tap = 0.4 * np.exp(2j * np.pi * 0.25 * t)  # quarter-turn over the frame
    delayed = np.zeros_like(wave)
    delayed[6:] = wave[:-6]
    rx = (wave + tap * delayed).astype(np.complex64)
    rx += (rng.normal(0, np.sqrt(1e-4 / 2), (n, 2))
           .astype(np.float32).view(np.complex64)[:, 0])
    rxp = jnp.asarray(np.concatenate(
        [rx, np.zeros(2 * CFG.n_sync_words * CFG.sym_len, np.complex64)]))

    res_ls = comm_link.rx_chain(CFG, spec, rxp, estimator="ls")
    res_sta = comm_link.rx_chain(CFG, spec, rxp, estimator="sta")
    ref = np.asarray(payload, np.uint8)

    def bit_errs(res):
        pay = np.asarray(res.decoded.payload)
        return int(np.unpackbits(pay ^ ref[: len(pay)]).sum())

    assert not bool(np.asarray(res_ls.decoded.crc_ok))
    assert bit_errs(res_ls) > 100
    assert bool(np.asarray(res_sta.decoded.crc_ok))
    assert bit_errs(res_sta) == 0
