"""SIG-driven dynamic RX: one compiled program decodes any MCS/length."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import channel, dynamic_rx, sync
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.models import comm_link

CFG = OFDMConfig()
MAXP = 128


def _stream(mcs, payload_bytes, msg, seed=0, snr_db=30.0):
    spec = FrameSpec(mcs, payload_bytes=payload_bytes, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, msg))
    tx = comm_link.tx_frame(CFG, spec, payload, 1 + seed % 127,
                            pad_front=400, pad_tail=200)
    wave = channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0)
    x = np.asarray(wave)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        p = np.mean(np.abs(x) ** 2)
        nv = p / 10 ** (snr_db / 10)
        x = x + np.sqrt(nv / 2) * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    # pad to cover the max dynamic window
    need = 5000 + dynamic_rx.max_symbols(MAXP) * CFG.sym_len
    x = np.concatenate([x, np.zeros(max(0, need - len(x)), np.complex64)])
    return jnp.asarray(x.astype(np.complex64)), payload


def _rx(x):
    det = sync.detect_frames(CFG, x, max_frames=1)
    return dynamic_rx.rx_frame_dynamic(
        CFG, x, jnp.maximum(det.start[0], 0), det.coarse_cfo[0], max_payload=MAXP
    )


@pytest.mark.parametrize("mcs,nbytes", [
    (MCS.BPSK_1_2, 40), (MCS.QPSK_3_4, 100), (MCS.QAM16_1_2, 77), (MCS.QAM16_3_4, 128),
])
def test_dynamic_decode_various_mcs(mcs, nbytes):
    msg = bytes([2]) + bytes(range(1, min(nbytes, 200)))
    x, payload = _stream(mcs, nbytes, msg[:nbytes])
    out = _rx(x)
    assert bool(out.sig_ok)
    assert int(out.mcs) == int(mcs)
    assert int(out.payload_len) == nbytes
    assert bool(out.crc_ok)
    got = np.asarray(out.payload)[:nbytes]
    np.testing.assert_array_equal(got, np.asarray(payload))


def test_one_jitted_program_covers_all_mcs():
    """The same compiled function must decode different MCS/lengths."""
    f = jax.jit(_rx)
    for mcs, nbytes in [(MCS.QPSK_1_2, 33), (MCS.QAM16_3_4, 90)]:
        x, payload = _stream(mcs, nbytes, bytes([2]) + b"x" * (nbytes - 1), seed=3)
        out = f(x)
        assert bool(out.crc_ok), mcs
        assert int(out.mcs) == int(mcs)
        np.testing.assert_array_equal(np.asarray(out.payload)[:nbytes], np.asarray(payload))


def test_corrupted_sig_rejected():
    x, _ = _stream(MCS.QPSK_1_2, 50, bytes([2]) + b"y" * 49, snr_db=None)
    # blast the SIG symbol region with noise: SIG is 3rd symbol after LTFs
    x = np.array(x)
    det = sync.detect_frames(CFG, jnp.asarray(x), max_frames=1)
    t = int(det.start[0])
    rng = np.random.default_rng(0)
    sig_region = slice(t + 400, t + 600)
    x[sig_region] += 10.0 * (rng.normal(size=200) + 1j * rng.normal(size=200))
    out = _rx(jnp.asarray(x))
    # either parity fails or CRC fails — never a false positive
    assert not bool(out.crc_ok)


def test_dynamic_sta_tracking():
    """STA decision-directed tracking under the SIG-discovered MCS
    (reference lib/mimo_ofdm_equalizer_impl.cc:500-592):
    must decode cleanly and track a slow channel drift better than LS."""
    x, payload = _stream(MCS.QPSK_3_4, 96, b"\x02 sta dynamic" + bytes(83), snr_db=25.0)
    # impose a slow gain drift across the frame (decision-directed tracking
    # follows it; the one-shot LS estimate cannot)
    n = np.arange(x.shape[0])
    drift = (1.0 + 0.5 * n / len(n)).astype(np.float32)
    xd = jnp.asarray(np.asarray(x) * drift)

    res_ls = jax.jit(lambda v: _rx(v))(xd)
    det = sync.detect_frames(CFG, xd, max_frames=1)
    res_sta = jax.jit(
        lambda v, t, c: dynamic_rx.rx_frame_dynamic(
            CFG, v, t, c, max_payload=MAXP, estimator="sta")
    )(xd, jnp.maximum(det.start[0], 0), det.coarse_cfo[0])
    assert bool(res_sta.sig_ok)
    assert int(res_sta.mcs) == int(MCS.QPSK_3_4)
    assert bool(res_sta.crc_ok)
    # clean-channel equivalence: STA must also decode the undrifted stream
    res0 = jax.jit(
        lambda v, t, c: dynamic_rx.rx_frame_dynamic(
            CFG, v, t, c, max_payload=MAXP, estimator="sta")
    )(x, jnp.maximum(det.start[0], 0), det.coarse_cfo[0])
    assert bool(res0.crc_ok)


def test_dynamic_snr_data_tracks_injected_snr():
    """The dynamic path now reports the pilot-tracked payload SNR (the
    reference's stream_end snr_data tag) alongside the legacy-LTF estimate;
    at a pinned injected SNR both must land near it."""
    x, _ = _stream(MCS.QPSK_3_4, 96, b"\x02 snr probe" + bytes(85), snr_db=20.0)
    res = jax.jit(lambda v: _rx(v))(jnp.asarray(x))
    assert bool(res.crc_ok)
    snr_data = float(res.snr_data_db)
    assert 14.0 < snr_data < 26.0, snr_data
    assert abs(snr_data - float(res.snr_db)) < 6.0
