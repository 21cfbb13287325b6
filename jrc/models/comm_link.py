"""End-to-end OFDM communication link: TX frame → channel → synchronized RX.

The composed equivalent of the reference's comm-sim flowgraph
(examples/simulation/communication/mimo_ofdm_jrc_comm_sim.grc): encoder →
mimo_precoder → IFFT/CP → zero_pad → [ULA phase + path loss + CFO + AWGN] →
frame_detector → frame_sync → FFT → equalizer → decoder.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import channel, cplx as cx, decoder, encoder, equalizer, ofdm, precoder, sync


class TxFrame(NamedTuple):
    samples: cx.CArray  # (n_tx, n_samples) time domain
    grid: cx.CArray  # (n_sym_total, n_tx, fft_len) frequency domain (pre-IFFT)


def tx_frame(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    payload: jax.Array,
    scrambler_seed,
    *,
    steering: jax.Array | None = None,
    mean_steering: jax.Array | None = None,
    use_radar_streams: bool = False,
    rng_key=None,
    pad_front: int = 0,
    pad_tail: int = 0,
) -> TxFrame:
    """Full TX chain: encode → precode/assemble → IFFT+CP → zero-pad."""
    syms = encoder.encode_frame(spec, payload, scrambler_seed)
    grid = precoder.assemble_frame(
        cfg,
        spec,
        syms,
        steering=steering,
        mean_steering=mean_steering,
        use_radar_streams=use_radar_streams,
        rng_key=rng_key,
    )
    per_ant = grid.swapaxes(0, 1)  # (n_tx, n_sym, fft_len)
    t = ofdm.ofdm_modulate(cfg, per_ant)  # (n_tx, n_samples)
    if pad_front or pad_tail:
        t = ofdm.zero_pad(t, pad_front, pad_tail)
    return TxFrame(samples=t, grid=grid)


class RxResult(NamedTuple):
    decoded: decoder.DecodedFrame
    eq: equalizer.EqualizedFrame
    detection: sync.Detections
    total_cfo: jax.Array
    sync_found: jax.Array


def rx_chain(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    samples: jax.Array,
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> RxResult:
    """Full RX chain on a 1-D sample stream containing (at least) one frame.

    The frame geometry is fixed by ``spec`` (the SIG decode is still run and
    returned for verification, as the reference gates on it).
    """
    samples = cx.from_complex(samples)
    n_frame_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym  # from first LTF copy
    det = sync.detect_frames(
        cfg, samples, threshold=threshold, min_n_peaks=min_n_peaks, max_frames=1
    )
    trigger = jnp.maximum(det.start[0], 0)
    symbols_t, total_cfo, found = sync.extract_frame(
        cfg, samples, trigger, det.coarse_cfo[0], n_frame_sym
    )
    grid = ofdm.fft_symbols(cfg, symbols_t)  # (n_sym, fft_len)
    eq = equalizer.equalize_frame(cfg, spec, grid, total_cfo, estimator=estimator)
    dec = decoder.decode_frame(spec, eq.z, soft=soft)
    return RxResult(
        decoded=dec, eq=eq, detection=det, total_cfo=total_cfo, sync_found=found
    )


def loopback(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    payload: jax.Array,
    *,
    key: jax.Array,
    angle_deg: float = 0.0,
    path_loss: float = 10.0,
    snr_db: float | None = 30.0,
    cfo: float = 0.0,
    scrambler_seed: int = 1,
    mean_steering: jax.Array | None = None,
    estimator: str = "ls",
    soft: bool = False,
) -> RxResult:
    """TX → comm channel → RX in one call (the comm-sim closed loop).

    ``snr_db`` sets AWGN relative to the *received* mean signal power
    (None ⇒ noiseless); ``cfo`` is radians/sample as injected by the
    comm-sim channel model (0.02/fft_len · 2π equivalent).
    """
    k_tx, k_ch = jax.random.split(key)
    tx = tx_frame(
        cfg,
        spec,
        payload,
        scrambler_seed,
        mean_steering=mean_steering,
        rng_key=k_tx,
        pad_front=5 * cfg.sym_len,
        pad_tail=6 * cfg.sym_len + 10,
    )
    clean = channel.comm_channel(
        tx.samples,
        angle_deg=angle_deg,
        path_loss=path_loss,
        noise_var=0.0,
        cfo=cfo,
    )
    if snr_db is not None:
        sig_pow = jnp.mean(cx.abs2(clean))
        noise_var = sig_pow / (10.0 ** (snr_db / 10.0))
        rx = channel.awgn(k_ch, clean, noise_var)
    else:
        rx = clean
    # guard tail so dynamic_slice in extract_frame never clips
    rx = cx.concatenate([rx, cx.zeros(2 * cfg.n_sync_words * cfg.sym_len)], axis=-1)
    return rx_chain(cfg, spec, rx, estimator=estimator, soft=soft)
