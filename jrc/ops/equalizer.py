"""MIMO-OFDM equalizer: channel estimation, CPE tracking, SIG decode, MMSE.

JAX-native equivalent of ``mimo_ofdm_equalizer`` (lib/mimo_ofdm_equalizer_impl.cc),
the reference's RX core. The per-symbol state machine keyed by stream tags
becomes a batched pipeline over a (n_sym_total, fft_len) frequency grid with a
``lax.scan`` only where true sequential dependencies exist (the running
pilot-noise estimate feeding the MMSE denominator, and the decision-directed
STA channel update). All complex arithmetic is pair-form (ops/cplx.py).

Algorithm citations (reference file:line):
* sampling-offset precompensation  …:261-264 (Sourour et al.)
* L-LTF channel + SNR estimate     …:272-305
* common-phase-error from pilots   …:908-922
* SIG decode (BPSK + Viterbi)      …:650-781
* MIMO channel estimation          …:392-399 (NDP), …:433-452 (DATA)
* scaled-MMSE data equalization    …:536-550, ZF for NDP …:900-906
* STA decision-directed tracking   …:500-534 (α=0.5), …:552-592 (α=0.4)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import cplx as cx
from jrc.ops import modulation
from jrc.ops.encoder import FrameSpec
from jrc.ops.precoder import parse_signal_field_bits
from jrc.ops.viterbi import viterbi_decode, hard_to_values


class EqualizedFrame(NamedTuple):
    z: cx.CArray  # (n_data_sym, n_data_carriers) equalized symbols
    snr_legacy: jax.Array  # dB, from the L-LTF pair
    snr_data: jax.Array  # dB, from pilot tracking over the payload
    chan_est_full: cx.CArray  # (fft_len, n_tx) NDP MIMO estimate (zeros for DATA)
    chan_mean: cx.CArray  # (n_tx,) mean over active carriers (NDP) / scalar-per-tx0
    sig_rate_bitmap: jax.Array
    sig_length: jax.Array
    sig_ptype: jax.Array
    sig_ok: jax.Array


def sampling_offset_compensate(cfg: OFDMConfig, grid: cx.CArray, cfo_total) -> cx.CArray:
    """Y[sym,i] ·= exp(j·2π·sym·(sym_len/fft_len)·ε0·(i−fft/2)), ε0 = cfo·/ω_c."""
    grid = cx.from_complex(grid)
    n_sym = grid.shape[-2]
    eps0 = cfo_total * cfg.sample_rate / (2 * jnp.pi * cfg.center_freq)
    sym = jnp.arange(n_sym, dtype=jnp.float32)[:, None]
    i = jnp.arange(cfg.fft_len, dtype=jnp.float32)[None, :] - cfg.fft_len / 2
    phase = 2 * jnp.pi * sym * (cfg.sym_len / cfg.fft_len) * eps0 * i
    return grid * cx.expj(phase)


def legacy_channel_estimate(cfg: OFDMConfig, y0: cx.CArray, y1: cx.CArray):
    """L-LTF pair → (H (fft_len,), snr_dB).

    H starts as raw y0; on active carriers H = (y0+y1)/(2·ltf); SNR from the
    sum/difference power of the two repetitions (…:272-305).
    """
    active = jnp.asarray(cfg.active_carrier_idx)
    ltf = cx.from_complex(np.asarray(cfg.lltf_freq))
    noise = jnp.sum(cx.abs2(y0[active] - y1[active]))
    signal = jnp.sum(cx.abs2(y0[active] + y1[active]))
    h = y0
    h = h.at[active].set((y0[active] + y1[active]) / (2.0 * ltf[active]))
    snr_db = 10.0 * jnp.log10(signal / noise / 2.0)
    return h, snr_db


def common_phase_error(cfg: OFDMConfig, y: cx.CArray, chan: cx.CArray, ref_pilots: cx.CArray):
    """(β, est_rx_pilots): β = arg Σ_p y[p]·conj(chan[p]·ref[p]) (…:908-922)."""
    pidx = jnp.asarray(cfg.pilot_carrier_idx)
    est = chan[..., pidx] * ref_pilots
    beta = cx.angle(cx.sum(cx.mul_conj(y[..., pidx], est), axis=-1))
    return beta, est


def decode_sig(z_sig: cx.CArray):
    """Equalized SIG data carriers → (rate_bitmap, ptype, length, ok)."""
    bits = (cx.real(z_sig) > 0).astype(jnp.uint8)  # BPSK decision
    decoded = viterbi_decode(hard_to_values(bits), n_out=24)
    return parse_signal_field_bits(decoded)


def mimo_channel_estimate_ndp(cfg: OFDMConfig, y_ltf: cx.CArray):
    """(n_ltf, fft_len) received MIMO-LTFs → (fft_len, n_tx) LS estimate.

    Ĥ(sc,tx) = Σ_l conj(X_ltf[sc,tx,l])·y[l,sc]  (…:392-399); the in-memory
    replacement for chan_est.csv. Also returns the active-carrier mean.
    """
    x_conj = cx.from_complex(np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)))
    h = cx.einsum("stl,ls->st", x_conj, y_ltf)  # (fft_len, n_tx)
    active = jnp.asarray(cfg.active_carrier_idx)
    h_mean = cx.mean(h[active], axis=0)
    return h, h_mean


def effective_channel_estimate(cfg: OFDMConfig, y_ltf: cx.CArray):
    """(n_ltf, fft_len) → (fft_len,) effective precoded channel for stream 0.

    H_eff(sc) = Σ_l conj(X_ltf[sc,0,l])·y[l,sc] / n_ltf on active carriers,
    zero elsewhere (…:433-452).
    """
    x0_conj = cx.from_complex(np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)[:, 0, :]))
    h = cx.einsum("sl,ls->s", x0_conj, y_ltf) / cfg.n_ltf
    mask = jnp.zeros(cfg.fft_len, bool).at[jnp.asarray(cfg.active_carrier_idx)].set(True)
    return cx.where(mask, h, cx.zeros(cfg.fft_len))


def _sta_decision(z: cx.CArray, mcs: MCS) -> cx.CArray:
    """Hard decision re-modulated with the TX scaling (…:509-517)."""
    vals = modulation.hard_decision(z, mcs)
    return modulation.modulate(vals, mcs)


def equalize_data_symbols(
    cfg: OFDMConfig,
    spec: FrameSpec,
    y_data: cx.CArray,  # (n_data_sym, fft_len), sampling-offset precompensated
    h_legacy: cx.CArray,  # (fft_len,)
    h_eff: cx.CArray,  # (fft_len,) effective channel (DATA frames)
    estimator: str = "ls",
):
    """Payload equalization with CPE + pilot SNR tracking (+ optional STA).

    Returns (z (n_data_sym, 48) pair, snr_data_dB).
    """
    is_data = spec.packet_type is PacketType.DATA
    didx = jnp.asarray(cfg.data_carrier_idx)
    pidx = jnp.asarray(cfg.pilot_carrier_idx)
    sched = cx.from_complex(np.asarray(cfg.pilot_symbols))
    n_sym = y_data.shape[0]
    rows = jnp.arange(n_sym) % sched.shape[0]
    ref_pilots_all = sched[rows]  # (n_sym, n_pilot)
    sta = estimator == "sta"
    alpha = 0.4 if is_data else 0.5

    h0 = h_eff if is_data else h_legacy

    if not sta:
        # no decision-directed update ⇒ h is fixed and the only sequential
        # dependency is the running pilot-noise average inside the MMSE
        # loading — a length-n_sym cumsum. Everything else is per-symbol
        # parallel (the scan formulation paid ~5 kernels of latency per
        # symbol; the reference's loop is sample-serial anyway,
        # lib/mimo_ofdm_equalizer_impl.cc:453-592).
        def per_symbol(y, ref):
            beta, est = common_phase_error(cfg, y, h0, ref)
            y = y * cx.expj(-beta)
            return y, jnp.sum(cx.abs2(est)), jnp.sum(cx.abs2(est - y[pidx]))

        y_rot, sig_k, noise_k = jax.vmap(per_symbol)(y_data, ref_pilots_all)
        noise_cum = jnp.cumsum(noise_k)  # inclusive, as the scan ordered it
        count_cum = jnp.arange(1, n_sym + 1) * cfg.n_pilot_carriers
        if is_data:
            csi = cx.abs2(h0[didx])[None, :] + (noise_cum / count_cum)[:, None]
            z = cx.mul_conj(y_rot[:, didx], h0[None, didx]) / csi
        else:
            z = y_rot[:, didx] / h0[None, didx]
        sig_sum, noise_sum = jnp.sum(sig_k), noise_k.sum()
        count = n_sym * cfg.n_pilot_carriers
        snr_data = 10.0 * jnp.log10((sig_sum / count) / (noise_sum / count))
        return z, snr_data

    def step(carry, xs):
        h, sig_sum, noise_sum, count = carry
        y, ref = xs
        beta, est = common_phase_error(cfg, y, h, ref)
        y = y * cx.expj(-beta)
        pilot_err = est - y[pidx]
        sig_sum = sig_sum + jnp.sum(cx.abs2(est))
        noise_sum = noise_sum + jnp.sum(cx.abs2(pilot_err))
        count = count + cfg.n_pilot_carriers

        if is_data:
            csi = cx.abs2(h[didx]) + noise_sum / count
            z = cx.mul_conj(y[didx], h[didx]) / csi
        else:
            z = y[didx] / h[didx]  # ZF; h == h_legacy unless STA updated it

        if sta:
            x_hat = _sta_decision(z, spec.mcs)
            h_upd_data = y[didx] / x_hat
            h_upd_pilot = y[pidx] / ref
            h = h.at[didx].set(h[didx] * (1 - alpha) + h_upd_data * alpha)
            h = h.at[pidx].set(h[pidx] * (1 - alpha) + h_upd_pilot * alpha)

        return (h, sig_sum, noise_sum, count), z

    carry0 = (h0, jnp.float32(0.0), jnp.float32(0.0), jnp.int32(0))
    (h_fin, sig_sum, noise_sum, count), z = jax.lax.scan(
        step, carry0, (y_data, ref_pilots_all)
    )
    snr_data = 10.0 * jnp.log10((sig_sum / count) / (noise_sum / count))
    return z, snr_data


def equalize_frame(
    cfg: OFDMConfig,
    spec: FrameSpec,
    grid: cx.CArray,  # (n_sym_total, fft_len) post-FFT, shifted
    cfo_total,
    estimator: str = "ls",
) -> EqualizedFrame:
    """Full per-frame equalization: LTF est → SIG → MIMO est → payload.

    ``spec`` fixes the static frame geometry (as the SIG field would); the
    decoded SIG values are returned so callers can verify consistency —
    the reference gates everything on the SIG parity check (…:308-344).
    """
    grid = sampling_offset_compensate(cfg, grid, cfo_total)

    h_legacy, snr_legacy = legacy_channel_estimate(cfg, grid[0], grid[1])

    # SIG (symbol index 2): CPE with pilot row 0 then zero-forcing
    ref0 = cx.from_complex(np.asarray(cfg.pilot_symbols)[0])
    beta, _ = common_phase_error(cfg, grid[2], h_legacy, ref0)
    y_sig = grid[2] * cx.expj(-beta)
    didx = jnp.asarray(cfg.data_carrier_idx)
    z_sig = y_sig[didx] / h_legacy[didx]
    rate_bitmap, ptype, length, sig_ok = decode_sig(z_sig)

    # MIMO-LTF block: symbols 3 .. 3+n_ltf
    y_ltf = grid[3 : 3 + cfg.n_ltf]
    if spec.packet_type is PacketType.NDP:
        chan_full, chan_mean = mimo_channel_estimate_ndp(cfg, y_ltf)
        h_eff = cx.zeros(cfg.fft_len)
    else:
        chan_full = cx.zeros((cfg.fft_len, cfg.n_tx))
        h_eff = effective_channel_estimate(cfg, y_ltf)
        active = jnp.asarray(cfg.active_carrier_idx)
        chan_mean = cx.broadcast_to(cx.mean(h_eff[active]), (cfg.n_tx,))

    y_data = grid[3 + cfg.n_ltf :]
    z, snr_data = equalize_data_symbols(
        cfg, spec, y_data, h_legacy, h_eff, estimator=estimator
    )
    return EqualizedFrame(
        z=z,
        snr_legacy=snr_legacy,
        snr_data=snr_data,
        chan_est_full=chan_full,
        chan_mean=chan_mean,
        sig_rate_bitmap=rate_bitmap,
        sig_length=length,
        sig_ptype=ptype,
        sig_ok=sig_ok,
    )
