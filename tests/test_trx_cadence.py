"""TRX work-loop cadence semantics (reference lib/usrp_mimo_trx_impl.cc).

Covers the three timing contracts of the reference's USRP heartbeat the
blueprint flags:

* ``update_period`` gating — a TX+RX burst at most every 0.04 s, TX-only
  frames in between (…:287-388);
* ``num_delay_samps`` — the RX capture is shifted to re-align with the TX
  frame start (…:374-383);
* RX deadline miss — the frame is skipped and the loop continues
  (…:488-494).
"""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.io.backend import SimTrx, TrxSession
from jrc.models import jrc_trx
from jrc.ops import channel, cplx as cx
from jrc.ops.encoder import FrameSpec, make_payload

CFG = OFDMConfig()
TARGETS = channel.Targets((12.0,), (0.0,), (25.0,), (10.0,))
SPEC = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
PAYLOAD = jnp.asarray(make_payload(SPEC, bytes([2]) + b"cadence"))
PAD_FRONT = 5 * CFG.sym_len
DELAY = 24


def _dwell_loop(session, n_frames, frame_interval, state=None):
    """Drive the backend-routed JRC dwell loop; returns (state, estimates,
    burst_flags)."""
    state = state or jrc_trx.init_state(CFG)
    ests, flags = [], []
    now = 0.0
    for d in range(n_frames):
        tx = jrc_trx.jrc_tx(CFG, state, SPEC, PAYLOAD,
                            key=jax.random.PRNGKey(d), pad_front=PAD_FRONT)
        burst = session.frame(np.asarray(tx.samples), now)
        now += frame_interval
        flags.append(burst is not None)
        if burst is not None:
            rx = cx.from_complex(jnp.asarray(burst.rx))[..., PAD_FRONT:]
            est, _ra, background = jrc_trx.jrc_radar_rx(CFG, state, tx.grid, rx)
            state = jrc_trx.radar_state_update(state, est, background)
            ests.append(est)
    return state, ests, flags


def test_update_period_gates_bursts():
    """25 Hz dwells from 100 Hz frames: every 4th frame opens a burst."""
    session = TrxSession(SimTrx(CFG, TARGETS, hw_delay_samps=DELAY),
                         update_period=0.04, num_delay_samps=DELAY)
    _, _, flags = _dwell_loop(session, 12, frame_interval=0.01)
    assert flags == [d % 4 == 0 for d in range(12)]
    assert session.n_bursts == 3 and session.n_tx_only == 9


def test_delayed_rx_realigned_still_images():
    """The hardware TX→RX latency is compensated by num_delay_samps: the
    dwell loop images the target at the true range/angle."""
    session = TrxSession(SimTrx(CFG, TARGETS, hw_delay_samps=DELAY),
                         update_period=0.04, num_delay_samps=DELAY)
    state, ests, _ = _dwell_loop(session, 8, frame_interval=0.04)
    assert len(ests) == 8
    assert all(bool(np.asarray(e.detected)) for e in ests)
    last = ests[-1]
    assert abs(float(last.range_m) - 12.0) < 0.6
    assert abs(float(last.angle_deg) - 25.0) < 2.0
    assert bool(np.asarray(state.radar_valid))


def test_uncompensated_delay_biases_range():
    """Sanity that the alignment matters: with num_delay_samps = 0 the same
    hardware delay shows up as a range bias of delay·c/(2·fs) ≈ 28.8 m."""
    session = TrxSession(SimTrx(CFG, TARGETS, hw_delay_samps=DELAY),
                         update_period=0.04, num_delay_samps=0)
    _, ests, _ = _dwell_loop(session, 2, frame_interval=0.04)
    bias = DELAY * channel.C_LIGHT / (2 * CFG.sample_rate)
    est = ests[-1]
    assert abs(float(est.range_m) - (12.0 + bias)) < 1.5


def test_rx_deadline_miss_skips_frame():
    """A missed RX deadline drops that dwell's capture; the loop keeps
    imaging on the following dwells."""
    session = TrxSession(
        SimTrx(CFG, TARGETS, hw_delay_samps=DELAY, miss_bursts={1}),
        update_period=0.04, num_delay_samps=DELAY,
    )
    state, ests, flags = _dwell_loop(session, 4, frame_interval=0.04)
    assert flags == [True, False, True, True]
    assert session.n_missed == 1 and session.n_bursts == 3
    assert all(bool(np.asarray(e.detected)) for e in ests)
    assert abs(float(ests[-1].range_m) - 12.0) < 0.6


def test_rx_time_shifted_with_alignment():
    """Stripping num_delay_samps moves the capture start forward in time;
    the reported rx_time must move with it (no cross-dwell timestamp bias)."""
    trx = SimTrx(CFG, TARGETS, hw_delay_samps=DELAY)
    session = TrxSession(trx, update_period=0.0, num_delay_samps=DELAY)
    tx = jrc_trx.jrc_tx(CFG, jrc_trx.init_state(CFG), SPEC, PAYLOAD,
                        key=jax.random.PRNGKey(0), pad_front=PAD_FRONT)
    raw_t = trx._t  # backend clock before the burst
    burst = session.frame(np.asarray(tx.samples), now=0.0)
    assert burst is not None
    assert abs(burst.rx_time - (raw_t + DELAY / CFG.sample_rate)) < 1e-12
