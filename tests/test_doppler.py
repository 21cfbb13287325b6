"""Cross-dwell range-Doppler processing over phase-coherent TRX bursts.

The reference simulates target Doppler (lib/target_simulator_impl.cc:164,
280-286) but never estimates velocity — its chain stops at the range-angle
map. Here the SimTrx backend's stream-continuous Doppler phase (t0 advances
with the stream clock, like the reference's per-sample streaming filter)
makes consecutive burst captures phase-coherent, and a slow-time FFT over
the per-dwell radar channel estimates recovers the target velocity.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.io.backend import SimTrx, TrxSession
from jrc.models import comm_link
from jrc.ops import channel, cplx as cx, ofdm, radar
from jrc.ops.encoder import FrameSpec, make_payload

CFG = OFDMConfig()
SPEC = FrameSpec(MCS.QPSK_1_2, payload_bytes=30, packet_type=PacketType.NDP)
PAYLOAD = jnp.asarray(make_payload(SPEC, bytes([1]) + bytes(26)))
N_DWELLS = 64
V_TRUE = 30.0  # m/s
R_TRUE = 12.0


def _dwell_history():
    """Burst the same frame back-to-back; return per-dwell channel
    estimates (n_dwells, n_virt, fft_len) and the dwell period."""
    targets = channel.Targets((R_TRUE,), (V_TRUE,), (20.0,), (10.0,))
    trx = SimTrx(CFG, targets)
    session = TrxSession(trx, update_period=0.0)  # every frame bursts
    tx = comm_link.tx_frame(CFG, SPEC, PAYLOAD, 1, pad_tail=3 * CFG.sym_len)
    tx_np = np.asarray(tx.samples)
    dwell_period = tx_np.shape[-1] / CFG.sample_rate
    x_ref = tx.grid.swapaxes(0, 1)
    sl = slice(CFG.n_sync_words + 1, CFG.n_sync_words + 1 + CFG.n_ltf)
    n_sym = tx.grid.shape[0]

    est = jax.jit(lambda rx: radar.radar_channel_estimate(
        x_ref[:, sl], ofdm.ofdm_demodulate(CFG, rx, n_sym)[:, sl]))
    hist = []
    for _ in range(N_DWELLS):
        burst = session.frame(tx_np, now=0.0)
        hist.append(est(cx.from_complex(jnp.asarray(burst.rx))))
    return cx.stack(hist), dwell_period


def test_velocity_recovered_from_dwell_history():
    hist, t_dwell = _dwell_history()
    v_bins = radar.velocity_axis(N_DWELLS, t_dwell, CFG.center_freq)
    v_max = channel.C_LIGHT / CFG.center_freq / (4 * t_dwell)
    assert v_max > V_TRUE  # unambiguous at back-to-back frame cadence
    rd = jax.jit(radar.range_doppler_map)(hist)
    r_bins = np.linspace(
        0, channel.C_LIGHT * CFG.fft_len / (2 * CFG.sample_rate),
        CFG.fft_len * 8,
    )
    est = radar.range_doppler_estimate(
        rd, jnp.asarray(r_bins, jnp.float32), jnp.asarray(v_bins))
    v_res = channel.C_LIGHT / CFG.center_freq / (2 * N_DWELLS * t_dwell)
    assert bool(np.asarray(est.detected))
    assert abs(float(est.range_m) - R_TRUE) < 0.6
    assert abs(float(est.velocity_mps) - V_TRUE) < v_res


def test_static_scene_has_no_offzero_doppler():
    """v = 0: everything lands in the guarded zero-Doppler column, so the
    detector must NOT fire off-zero."""
    targets = channel.Targets((R_TRUE,), (0.0,), (20.0,), (10.0,))
    trx = SimTrx(CFG, targets)
    session = TrxSession(trx, update_period=0.0)
    tx = comm_link.tx_frame(CFG, SPEC, PAYLOAD, 1, pad_tail=3 * CFG.sym_len)
    tx_np = np.asarray(tx.samples)
    x_ref = tx.grid.swapaxes(0, 1)
    sl = slice(CFG.n_sync_words + 1, CFG.n_sync_words + 1 + CFG.n_ltf)
    n_sym = tx.grid.shape[0]
    est_fn = jax.jit(lambda rx: radar.radar_channel_estimate(
        x_ref[:, sl], ofdm.ofdm_demodulate(CFG, rx, n_sym)[:, sl]))
    hist = cx.stack([
        est_fn(cx.from_complex(jnp.asarray(session.frame(tx_np, 0.0).rx)))
        for _ in range(16)
    ])
    rd = radar.range_doppler_map(hist)
    v_bins = radar.velocity_axis(16, tx_np.shape[-1] / CFG.sample_rate,
                                 CFG.center_freq)
    r_bins = np.linspace(0, 76.8, CFG.fft_len * 8)
    est = radar.range_doppler_estimate(
        rd, jnp.asarray(r_bins, jnp.float32), jnp.asarray(v_bins))
    assert not bool(np.asarray(est.detected))
