"""End-to-end communication loopback (BASELINE configs 1 & 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.models import comm_link

CFG = OFDMConfig()


def _run(mcs, *, snr_db=30.0, cfo=0.0, angle=0.0, estimator="ls", soft=False,
         payload_bytes=80, seed=0, mean_steering=None):
    spec = FrameSpec(mcs, payload_bytes=payload_bytes, packet_type=PacketType.DATA)
    msg = bytes([2]) + b"jrc payload " * 5
    payload = jnp.asarray(make_payload(spec, msg[:payload_bytes]))
    res = comm_link.loopback(
        CFG, spec, payload, key=jax.random.key(seed), angle_deg=angle,
        snr_db=snr_db, cfo=cfo, estimator=estimator, soft=soft,
        mean_steering=mean_steering, scrambler_seed=1 + seed % 127,
    )
    return res, payload


@pytest.mark.parametrize("mcs", list(MCS))
def test_all_mcs_decode(mcs):
    res, payload = _run(mcs, snr_db=30.0)
    assert bool(res.sync_found)
    assert bool(res.eq.sig_ok)
    assert bool(res.decoded.crc_ok)
    np.testing.assert_array_equal(np.asarray(res.decoded.payload), np.asarray(payload))


def test_cfo_injection_and_recovery():
    cfo = 0.02 * 2 * np.pi / 64  # the comm-sim's deliberate CFO
    res, payload = _run(MCS.QPSK_3_4, snr_db=25.0, cfo=cfo)
    assert bool(res.decoded.crc_ok)
    assert abs(float(res.total_cfo) - cfo) < 2e-4


def test_off_broadside_angle():
    res, payload = _run(MCS.QPSK_1_2, snr_db=28.0, angle=20.0)
    assert bool(res.decoded.crc_ok)


def test_sig_fields_match_spec():
    res, _ = _run(MCS.QAM16_3_4, payload_bytes=120)
    assert int(res.eq.sig_rate_bitmap) == 13  # QAM16_3_4 received bitmap
    assert int(res.eq.sig_length) == 124  # +4 CRC bytes
    assert int(res.eq.sig_ptype) == 1  # DATA


def test_snr_estimate_reasonable():
    res, _ = _run(MCS.QPSK_1_2, snr_db=20.0)
    # legacy-SNR estimate should be within a few dB of injected + array gain
    assert 15.0 < float(res.eq.snr_legacy) < 35.0


def test_low_snr_fails_crc():
    res, _ = _run(MCS.QAM16_3_4, snr_db=-2.0, seed=3)
    # at -2 dB SNR 16-QAM 3/4 cannot survive
    assert not bool(res.decoded.crc_ok)


def test_sta_estimator_decodes():
    res, payload = _run(MCS.QPSK_1_2, snr_db=25.0, estimator="sta")
    assert bool(res.decoded.crc_ok)


def test_soft_decisions_decode():
    res, payload = _run(MCS.QPSK_3_4, snr_db=18.0, soft=True)
    assert bool(res.decoded.crc_ok)


def test_ndp_frame_roundtrip():
    """NDP frames produce a full (fft_len, n_tx) channel estimate."""
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    payload = jnp.zeros(24, jnp.uint8).at[0].set(1)
    res = comm_link.loopback(CFG, spec, payload, key=jax.random.key(1),
                             snr_db=30.0, angle_deg=10.0)
    assert bool(res.eq.sig_ok)
    assert int(res.eq.sig_ptype) == 0  # NDP bit
    h = np.asarray(res.eq.chan_est_full)
    assert h.shape == (64, 4)
    active = CFG.active_carrier_idx
    # per-antenna phase structure: antenna k sees exp(j·k·π·sin(10°))
    hm = np.asarray(res.eq.chan_mean)
    expect = np.exp(1j * np.pi * np.sin(np.deg2rad(10.0)) * np.arange(4))
    got = hm / hm[0]
    want = expect / expect[0]
    np.testing.assert_allclose(np.angle(got * np.conj(want)), 0, atol=0.05)
