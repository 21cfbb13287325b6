"""Full JRC closed loop: radar-assisted precoding (BASELINE config 4)."""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.models import jrc_trx

CFG = OFDMConfig()
TARGETS = channel.Targets(ranges=(12.0,), velocities=(0.0,), azimuths=(25.0,), rcs=(10.0,))
DATA_SPEC = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
NDP_SPEC = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
DATA_PAYLOAD = jnp.asarray(make_payload(DATA_SPEC, bytes([2]) + b"jrc data frame"))
NDP_PAYLOAD = jnp.asarray(make_payload(NDP_SPEC, bytes([1])))
NV = 1e-4


def test_radar_detects_while_transmitting_data():
    st = jrc_trx.init_state(CFG)
    r = jrc_trx.jrc_step(CFG, st, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                         key=jax.random.key(0), comm_noise_var=NV)
    assert bool(r.radar_est.detected)
    assert abs(float(r.radar_est.range_m) - 12.0) < 0.6
    assert abs(float(r.radar_est.angle_deg) - 25.0) < 2.0
    assert bool(r.state.radar_valid)


def test_radar_aided_beamforming_gain():
    """After the first dwell, radar-aided steering must beat the Fourier
    fallback by several dB of effective channel power."""
    st = jrc_trx.init_state(CFG)
    r0 = jrc_trx.jrc_step(CFG, st, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(0), radar_aided=True, comm_noise_var=NV)
    r1 = jrc_trx.jrc_step(CFG, r0.state, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(1), radar_aided=True, comm_noise_var=NV)
    h0 = float(abs(r0.comm.eq.chan_mean[0]))
    h1 = float(abs(r1.comm.eq.chan_mean[0]))
    assert 20 * np.log10(h1 / h0) > 3.0
    assert bool(r1.comm.decoded.crc_ok)


def test_ndp_chan_est_then_svd_steering():
    st = jrc_trx.init_state(CFG)
    rn = jrc_trx.jrc_step(CFG, st, NDP_SPEC, NDP_PAYLOAD, TARGETS,
                          key=jax.random.key(2), radar_aided=False, comm_noise_var=NV)
    assert bool(rn.state.chan_valid)
    # per-subcarrier SVD steering from the NDP estimate
    rd = jrc_trx.jrc_step(CFG, rn.state, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(3), radar_aided=False,
                          phased_steering=False, comm_noise_var=NV)
    assert bool(rd.comm.decoded.crc_ok)
    # and phased mean steering (smoothing)
    rp = jrc_trx.jrc_step(CFG, rn.state, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(4), radar_aided=False,
                          phased_steering=True, smoothing=True, comm_noise_var=NV)
    assert bool(rp.comm.decoded.crc_ok)


def test_radar_streams_mode():
    """Antennas 1..3 carry random QPSK radar streams; data still decodes and
    the radar still sees the target."""
    st = jrc_trx.init_state(CFG)
    r0 = jrc_trx.jrc_step(CFG, st, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(5), comm_noise_var=NV)
    r1 = jrc_trx.jrc_step(CFG, r0.state, DATA_SPEC, DATA_PAYLOAD, TARGETS,
                          key=jax.random.key(6), use_radar_streams=True,
                          comm_noise_var=NV)
    assert bool(r1.radar_est.detected)
    assert bool(r1.comm.decoded.crc_ok)


def test_state_is_a_pytree():
    """JRCState must be jit/scan-compatible (replaces the CSV side channels)."""
    st = jrc_trx.init_state(CFG)
    leaves = jax.tree_util.tree_leaves(st)
    assert all(hasattr(l, "dtype") for l in leaves)
    st2 = jax.tree_util.tree_map(lambda x: x, st)
    assert isinstance(st2, jrc_trx.JRCState)


def test_steering_fallback_chain():
    st = jrc_trx.init_state(CFG)
    # nothing valid -> Fourier
    per_sc, mean_q = jrc_trx.select_steering(CFG, st, radar_aided=True,
                                             phased_steering=True, smoothing=False)
    assert per_sc is None
    from jrc.ops.precoder import fourier_matrix
    np.testing.assert_allclose(np.asarray(mean_q), fourier_matrix(4), atol=1e-6)
    # radar valid -> steering vector in column 0
    st = st._replace(radar_valid=jnp.bool_(True), radar_angle=jnp.float32(20.0))
    _, mq = jrc_trx.select_steering(CFG, st, radar_aided=True,
                                    phased_steering=True, smoothing=False)
    q = np.asarray(mq)
    expect = np.exp(-1j * np.pi * np.sin(np.deg2rad(20.0)) * np.arange(4))
    got = q[:, 0] / q[0, 0]
    np.testing.assert_allclose(got, expect / expect[0], atol=1e-5)
    assert np.abs(q[:, 1:]).max() < 1e-6  # phased: only column 0 used


def test_multi_dwell_moving_target_tracking_gain():
    """The paper's headline claim (lib/mimo_precoder_impl.cc:903-983): over a
    multi-dwell run with a target moving off-broadside, radar-aided steering
    tracks the angle and sustains a comm-SNR gain over the Fourier fallback
    of at least the phased-array expectation (~6 dB for 4 TX, minus
    pointing loss)."""
    st = jrc_trx.init_state(CFG)
    angles = [24.0, 20.0, 16.0, 12.0, 8.0]
    fresh = jrc_trx.init_state(CFG)  # never updated -> Fourier fallback
    gains_db = []
    for d, az in enumerate(angles):
        tgt = channel.Targets(ranges=(12.0,), velocities=(8.0,),
                              azimuths=(az,), rcs=(10.0,))
        # background recording frozen: in the reference the clutter buffer is
        # calibrated before operation (set_background_record toggle) — a
        # moving target must not be subtracted against its own history
        r = jrc_trx.jrc_step(CFG, st, DATA_SPEC, DATA_PAYLOAD, tgt,
                             key=jax.random.key(10 + d), radar_aided=True,
                             background_record=False, comm_noise_var=NV)
        # radar must track the moving target
        assert bool(r.radar_est.detected), (d, az)
        assert abs(float(r.radar_est.angle_deg) - az) < 2.5, (d, az)
        if d > 0:  # steering used the PREVIOUS dwell's angle estimate
            rf = jrc_trx.jrc_step(CFG, fresh, DATA_SPEC, DATA_PAYLOAD, tgt,
                                  key=jax.random.key(10 + d), radar_aided=True,
                                  background_record=False, comm_noise_var=NV)
            h_aided = float(abs(r.comm.eq.chan_mean[0]))
            h_fourier = float(abs(rf.comm.eq.chan_mean[0]))
            gains_db.append(20 * np.log10(h_aided / h_fourier))
            assert bool(r.comm.decoded.crc_ok), (d, az)
        st = r.state
    # steering from the previous dwell's angle: mean gain near the 4-TX
    # array-gain expectation despite the 4 deg/dwell pointing lag
    assert np.mean(gains_db) >= 3.0, gains_db
    assert min(gains_db) > 0.0, gains_db
