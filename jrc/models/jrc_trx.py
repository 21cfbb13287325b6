"""Full JRC transceiver: simultaneous data transmission + radar sensing with
radar-assisted precoding (BASELINE config 4).

Composed equivalent of the reference's JRC TRX flowgraph
(examples/usrp/mimo_ofdm_jrc_TRX.grc): the precoder steers DATA frames using
either the NDP channel-estimate feedback or the radar's angle estimate, while
every transmitted frame is simultaneously correlated against its echoes to
image the scene.

The reference's cross-block file side channels become an explicit
:class:`JRCState` pytree:

    chan_est.csv  (lib/mimo_ofdm_equalizer_impl.cc:378-416 →
                   lib/mimo_precoder_impl.cc:775-898)   → state.chan_est
    radar_log.csv (lib/range_angle_estimator_impl.cc:255-279 →
                   lib/mimo_precoder_impl.cc:903-983)   → state.radar_angle
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig, PacketType
from jrc.ops import channel, cplx as cx, encoder, ofdm, precoder, radar
from jrc.models import comm_link


class JRCState(NamedTuple):
    """Cross-frame feedback state (the in-memory checkpoint; replaces CSVs)."""

    chan_est: cx.CArray  # (fft_len, n_tx) last NDP estimate
    chan_valid: jax.Array  # bool
    radar_angle: jax.Array  # deg, last detected target angle
    radar_valid: jax.Array  # bool
    background: radar.BackgroundState
    frame_count: jax.Array  # int32


def init_state(cfg: OFDMConfig, record_len: int = 8) -> JRCState:
    return JRCState(
        chan_est=cx.zeros((cfg.fft_len, cfg.n_tx)),
        chan_valid=jnp.bool_(False),
        radar_angle=jnp.float32(0.0),
        radar_valid=jnp.bool_(False),
        background=radar.init_background(record_len, cfg.n_virtual, cfg.fft_len),
        frame_count=jnp.int32(0),
    )


def select_steering(
    cfg: OFDMConfig,
    state: JRCState,
    *,
    radar_aided: bool,
    phased_steering: bool,
    smoothing: bool,
):
    """(per_sc_Q | None, mean_Q) with the reference's fallback chain:
    radar angle → channel estimate → Fourier (lib/mimo_precoder_impl.cc:496-532).

    Per-subcarrier steering applies only when not smoothing and not
    radar-aided (…:598-607); otherwise a single mean matrix is used.
    """
    q_dft = cx.from_complex(precoder.fourier_matrix(cfg.n_tx))
    q_sc, q_mean_chan = precoder.steering_from_chan_est(
        cfg, state.chan_est, phased=phased_steering
    )
    if radar_aided:
        q_radar = precoder.steering_from_angle(
            cfg, state.radar_angle, phased=phased_steering
        )
        mean_q = cx.where(
            state.radar_valid,
            q_radar,
            cx.where(state.chan_valid, q_mean_chan, q_dft),
        )
        return None, mean_q
    mean_q = cx.where(state.chan_valid, q_mean_chan, q_dft)
    if smoothing:
        return None, mean_q
    per_sc = cx.where(
        state.chan_valid, q_sc, cx.broadcast_to(q_dft, q_sc.shape)
    )
    return per_sc, mean_q


class JRCStepResult(NamedTuple):
    state: JRCState
    comm: comm_link.RxResult
    radar_est: radar.RangeAngleEstimate
    ra_map: jax.Array


def jrc_tx(
    cfg: OFDMConfig,
    state: JRCState,
    spec: encoder.FrameSpec,
    payload: jax.Array,
    *,
    key: jax.Array,
    radar_aided: bool = True,
    phased_steering: bool = True,
    smoothing: bool = False,
    use_radar_streams: bool = False,
    scrambler_seed=1,
    pad_front: int | None = None,
    pad_tail: int | None = None,
) -> comm_link.TxFrame:
    """TX side of one dwell: steer from the feedback state and build the
    padded multi-antenna frame (the precoder + zero_pad legs of the TRX
    flowgraph). DATA frames are steered; NDP is never precoded
    (lib/mimo_precoder_impl.cc:379-428)."""
    if pad_front is None:
        pad_front = 5 * cfg.sym_len
    if pad_tail is None:
        pad_tail = 3 * cfg.sym_len
    if spec.packet_type is PacketType.DATA:
        per_sc, mean_q = select_steering(
            cfg, state, radar_aided=radar_aided,
            phased_steering=phased_steering, smoothing=smoothing,
        )
    else:
        per_sc, mean_q = None, None  # NDP is never precoded
    return comm_link.tx_frame(
        cfg, spec, payload, scrambler_seed,
        steering=per_sc, mean_steering=mean_q,
        use_radar_streams=use_radar_streams and spec.packet_type is PacketType.DATA,
        rng_key=key,
        pad_front=pad_front, pad_tail=pad_tail,
    )


def jrc_radar_rx(
    cfg: OFDMConfig,
    state: JRCState,
    tx_grid: jax.Array,  # (n_sym, n_tx, fft_len) frequency-domain reference
    rx: jax.Array,  # (n_rx, n_samples) echo time-aligned to the frame START
    *,
    background_record: bool = True,
    interp_factor_range: int = 8,
    interp_factor_angle: int = 16,
    window_range: str | None = None,
    snr_threshold_db: float = 15.0,
):
    """Radar leg of one dwell from an aligned RX burst: demodulate the echo,
    estimate the per-(tx,rx,sc) channel over the MIMO-LTF symbols, remove
    background, image, detect (mimo_ofdm_radar → range_angle_estimator).

    ``rx`` must start at the frame's first sample — the ``usrp_mimo_trx``
    ``num_delay_samps`` contract (lib/usrp_mimo_trx_impl.cc:374-383), which
    :class:`jrc.io.backend.TrxSession` enforces (front padding already
    stripped by the caller). Returns (est, ra_map, background_state).
    """
    n_sym_total = tx_grid.shape[0]
    y = ofdm.ofdm_demodulate(cfg, rx, n_sym_total)
    x_ref = tx_grid.swapaxes(0, 1)
    n_pre = cfg.n_sync_words + 1
    sl = slice(n_pre, n_pre + cfg.n_ltf)
    h_radar = radar.radar_channel_estimate(x_ref[:, sl], y[:, sl])
    h_clean, background = radar.background_removal(
        state.background, h_radar, record=background_record
    )
    ra_map = radar.range_angle_map(h_clean, interp_factor_range,
                                   interp_factor_angle,
                                   window_range=window_range)
    est = radar.range_angle_estimate(
        ra_map,
        jnp.asarray(radar.range_axis(cfg.fft_len, cfg.sample_rate,
                                     interp_factor_range)),
        jnp.asarray(cfg.angle_axis(interp_factor_angle), jnp.float32),
        snr_threshold_db=snr_threshold_db,
    )
    return est, ra_map, background


def radar_state_update(
    state: JRCState, est: radar.RangeAngleEstimate, background
) -> JRCState:
    """Fold a dwell's radar detection into the feedback state (the
    radar_log.csv append → precoder poll of the reference)."""
    return state._replace(
        radar_angle=jnp.where(
            est.detected, est.angle_deg, state.radar_angle
        ).astype(jnp.float32),
        radar_valid=state.radar_valid | est.detected,
        background=background,
        frame_count=state.frame_count + 1,
    )


def jrc_step(
    cfg: OFDMConfig,
    state: JRCState,
    spec: encoder.FrameSpec,
    payload: jax.Array,
    targets: channel.Targets,
    *,
    key: jax.Array,
    radar_aided: bool = True,
    phased_steering: bool = True,
    smoothing: bool = False,
    use_radar_streams: bool = False,
    background_record: bool = True,
    comm_angle_deg: float | None = None,
    comm_path_loss: float = 20.0,
    comm_snr_db: float = 25.0,
    comm_noise_var: float | None = None,  # absolute noise (overrides comm_snr_db)
    radar_noise_var: float = 0.0,
    scrambler_seed=1,
    interp_factor_range: int = 8,
    interp_factor_angle: int = 16,
    window_range: str | None = None,
    snr_threshold_db: float = 15.0,
) -> JRCStepResult:
    """One JRC dwell: steer → TX → (echo → radar update) ∥ (comm RX → decode).

    For DATA frames the radar angle (or channel estimate) steers the
    precoder; for NDP frames the comm receiver's channel estimate refreshes
    ``state.chan_est`` — both closed loops of the reference.
    ``comm_angle_deg`` defaults to the first target's azimuth (receiver
    mounted on the sensed vehicle, the paper's use case).
    """
    if comm_angle_deg is None:
        comm_angle_deg = targets.azimuths[0]
    k_tx, k_radar, k_comm = jax.random.split(key, 3)

    pad_front = 5 * cfg.sym_len
    tx = jrc_tx(
        cfg, state, spec, payload, key=k_tx,
        radar_aided=radar_aided, phased_steering=phased_steering,
        smoothing=smoothing, use_radar_streams=use_radar_streams,
        scrambler_seed=scrambler_seed,
        pad_front=pad_front, pad_tail=3 * cfg.sym_len,
    )

    # ---- radar leg: time-aligned echo of this very frame
    wavelength = channel.C_LIGHT / cfg.center_freq
    pos = channel.virtual_positions(cfg.n_tx, cfg.n_rx, wavelength)
    echo = channel.apply_targets(
        tx.samples, targets,
        sample_rate=cfg.sample_rate, center_freq=cfg.center_freq, pos_virtual=pos,
    )
    if radar_noise_var > 0:
        echo = channel.awgn(k_radar, echo, radar_noise_var)
    # the TX/RX timing contract (usrp_mimo_trx num_delay_samps) aligns the RX
    # window to the frame start — drop the front padding before demodulation
    est, ra_map, background = jrc_radar_rx(
        cfg, state, tx.grid, echo[..., pad_front:],
        background_record=background_record,
        interp_factor_range=interp_factor_range,
        interp_factor_angle=interp_factor_angle,
        window_range=window_range,
        snr_threshold_db=snr_threshold_db,
    )

    # ---- comm leg: ULA receiver at the target vehicle's angle
    rx_wave = channel.comm_channel(
        tx.samples, angle_deg=comm_angle_deg, path_loss=comm_path_loss,
        noise_var=0.0, cfo=0.0,
    )
    if comm_noise_var is None:
        sig_pow = jnp.mean(cx.abs2(rx_wave))
        nv = sig_pow / 10.0 ** (comm_snr_db / 10.0)
    else:
        nv = jnp.asarray(comm_noise_var, jnp.float32)
    rx_wave = channel.awgn(k_comm, rx_wave, nv)
    rx_wave = cx.concatenate(
        [rx_wave, cx.zeros(2 * cfg.n_sync_words * cfg.sym_len)], axis=-1
    )
    comm = comm_link.rx_chain(cfg, spec, rx_wave)

    # ---- state update (the reference's CSV writes)
    if spec.packet_type is PacketType.NDP:
        upd = comm.eq.sig_ok
        new_chan_est = cx.where(upd, comm.eq.chan_est_full, state.chan_est)
        chan_valid = state.chan_valid | upd
    else:
        new_chan_est = state.chan_est
        chan_valid = state.chan_valid
    new_state = radar_state_update(state, est, background)._replace(
        chan_est=new_chan_est, chan_valid=chan_valid,
    )
    return JRCStepResult(state=new_state, comm=comm, radar_est=est, ra_map=ra_map)
