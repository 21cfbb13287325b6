"""Radar-only closed loop: TX frame → target scene → range-angle estimation.

Composed equivalent of the reference's radar-sim flowgraph
(examples/simulation/radar/mimo_ofdm_jrc_radar_sim.grc): mimo_precoder →
IFFT/CP → zero_pad → 4× target_simulator (+AWGN) → CP-removal/FFT →
mimo_ofdm_radar → range-IFFT → corner-turn → angle-FFT →
range_angle_estimator. The RX window is time-aligned with TX by construction
(the usrp_mimo_trx timed-burst contract, lib/usrp_mimo_trx_impl.cc:287-388).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import channel, encoder, ofdm, radar
from jrc.models import comm_link


class RadarFrameResult(NamedTuple):
    estimate: radar.RangeAngleEstimate
    ra_map: jax.Array  # (n_range, n_angle) complex
    chan: jax.Array  # (n_virt, fft_len) radar channel estimate
    background: radar.BackgroundState


def radar_frame(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    payload: jax.Array,
    targets: channel.Targets,
    *,
    key: jax.Array,
    scrambler_seed: int = 1,
    noise_var: float = 0.0,
    interp_factor_range: int = 8,
    interp_factor_angle: int = 16,
    window_range: str | None = None,
    snr_threshold_db: float = 15.0,
    background: radar.BackgroundState | None = None,
    use_radar_streams: bool = False,
    mean_steering: jax.Array | None = None,
    self_coupling_db: float | None = None,
    random_phase: bool = False,
    n_pre: int | None = None,
    n_corr_sym: int | None = None,
) -> RadarFrameResult:
    """One full radar dwell: TX, propagate, estimate, image, detect.

    ``n_pre``/``n_corr_sym`` default to the reference's 5 preamble symbols
    (4 sync + SIG) and n_tx MIMO-LTF correlation symbols (radar-sim grc
    ``N_pre``, ``N_sym``).
    """
    if n_pre is None:
        n_pre = cfg.n_sync_words + 1
    if n_corr_sym is None:
        n_corr_sym = cfg.n_ltf

    k_tx, k_ch, k_n = jax.random.split(key, 3)
    tx = comm_link.tx_frame(
        cfg,
        spec,
        payload,
        scrambler_seed,
        rng_key=k_tx,
        use_radar_streams=use_radar_streams,
        mean_steering=mean_steering,
        pad_front=0,
        pad_tail=3 * cfg.sym_len,
    )
    wavelength = channel.C_LIGHT / cfg.center_freq
    pos = channel.virtual_positions(cfg.n_tx, cfg.n_rx, wavelength)
    rx = channel.apply_targets(
        tx.samples,
        targets,
        sample_rate=cfg.sample_rate,
        center_freq=cfg.center_freq,
        pos_virtual=pos,
        rng_key=k_ch if random_phase else None,
        self_coupling_db=self_coupling_db,
    )
    if noise_var > 0:
        rx = channel.awgn(k_n, rx, noise_var)

    n_sym_total = tx.grid.shape[0]
    y = ofdm.ofdm_demodulate(cfg, rx, n_sym_total)  # (n_rx, n_sym, fft_len)

    x_ref = tx.grid.swapaxes(0, 1)  # (n_tx, n_sym, fft_len)
    sl = slice(n_pre, n_pre + n_corr_sym)
    h = radar.radar_channel_estimate(x_ref[:, sl], y[:, sl])

    if background is not None:
        h, background = radar.background_removal(background, h)
    else:
        background = radar.init_background(8, cfg.n_virtual, cfg.fft_len)

    ra = radar.range_angle_map(h, interp_factor_range, interp_factor_angle,
                               window_range=window_range)
    est = radar.range_angle_estimate(
        ra,
        jnp.asarray(radar.range_axis(cfg.fft_len, cfg.sample_rate,
                                     interp_factor_range)),
        jnp.asarray(cfg.angle_axis(interp_factor_angle), jnp.float32),
        snr_threshold_db=snr_threshold_db,
    )
    return RadarFrameResult(estimate=est, ra_map=ra, chan=h, background=background)
