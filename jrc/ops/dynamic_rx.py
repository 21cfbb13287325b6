"""SIG-driven dynamic receive: decode frames whose MCS / length / type are
discovered from the SIG field at runtime, like the reference RX.

The reference equalizer+decoder are fully dynamic — `decode_signal_field`
re-parameterizes the state machine per frame (lib/mimo_ofdm_equalizer_impl.cc:
650-781, lib/stream_decoder_impl.cc:129-172). Under XLA everything must be
static-shaped, so this module compiles one program that covers the whole MCS
× length envelope:

* symbols are extracted up to a static ``max_n_sym`` bound and masked by the
  SIG-derived symbol count;
* demod → depuncture → Viterbi runs once per MCS branch under ``lax.switch``
  (each branch has its own static geometry sized for ``max_payload``), with
  out-of-frame positions erased so the shared Viterbi treats them as
  zero-information;
* the CRC runs over a traced byte count.

``estimator="sta"`` adds decision-directed STA channel tracking inside the
masked scan (reference lib/mimo_ofdm_equalizer_impl.cc:500-592): the
per-symbol hard re-modulation runs under a ``lax.switch`` over the
SIG-discovered MCS, α = 0.4 (DATA) / 0.5 (NDP) as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, mcs_tables
from jrc.ops import cplx as cx
from jrc.ops import coding, equalizer, modulation, ofdm, sync
from jrc.ops.precoder import SIG_RATE_TO_MCS
from jrc.ops.viterbi import viterbi_decode, hard_to_values


def max_symbols(max_payload: int, n_data_carriers: int = 48) -> int:
    """Worst-case DATA symbol count over all MCS (BPSK-1/2 ⇒ n_dbps=24)."""
    return math.ceil((16 + 8 * (max_payload + 4) + 6) / (n_data_carriers // 2))


#: SIG rate bitmap → MCS index table (0..15; invalid → 0 with ok=False)
_RATE_LUT = np.zeros(16, np.int32)
for bitmap, mcs in SIG_RATE_TO_MCS.items():
    _RATE_LUT[bitmap] = int(mcs)
_RATE_VALID = np.zeros(16, bool)
for bitmap in SIG_RATE_TO_MCS:
    _RATE_VALID[bitmap] = True


class DynamicFrame(NamedTuple):
    payload: jax.Array  # (max_payload,) uint8, valid up to payload_len
    payload_len: jax.Array  # bytes (without CRC)
    crc_ok: jax.Array
    mcs: jax.Array  # int32 MCS index
    packet_type_bit: jax.Array  # 0=NDP, 1=DATA
    n_ofdm_sym: jax.Array
    sig_ok: jax.Array
    snr_db: jax.Array  # legacy-LTF estimate (stream_start tag)
    snr_data_db: jax.Array  # pilot-tracked payload SNR (stream_end tag)
    chan_est: cx.CArray  # (fft_len, n_tx) NDP MIMO estimate (chan_est.csv)
    chan_est_ok: jax.Array  # NDP frame with valid SIG → chan_est is live


def frame_geometry(mcs_idx, data_size_byte, n_data_carriers: int = 48):
    """Traced packet math (reference lib/utils.cc:26-53): n_ofdm_sym,
    n_data_bits from a traced MCS index and byte count."""
    _, _, n_dbps = (jnp.asarray(t) for t in mcs_tables(n_data_carriers))
    dbps = n_dbps[mcs_idx]
    bits = 16 + 8 * data_size_byte + 6
    n_sym = (bits + dbps - 1) // dbps
    return n_sym, n_sym * dbps


def max_trellis_bits(max_payload: int, n_data_carriers: int = 48) -> int:
    """Static trellis length covering every MCS branch's envelope (the
    per-branch symbol capacity rounds up differently per n_dbps)."""
    from jrc.config import MCSParams

    max_bytes = max_payload + 4
    return max(
        math.ceil((16 + 8 * max_bytes + 6) / MCSParams(m, n_data_carriers).n_dbps)
        * MCSParams(m, n_data_carriers).n_dbps
        for m in MCS
    )


def payload_values_dynamic(
    z: jax.Array,  # (max_n_sym, n_dc) equalized symbols (masked beyond frame)
    mcs_idx: jax.Array,
    data_size_byte: jax.Array,
    max_payload: int,
    soft: bool = False,
    n_data_carriers: int = 48,
) -> jax.Array:
    """lax.switch over the 6 MCS: demod → depuncture, each branch padding
    its depunctured values with erasures to the shared
    2·``max_trellis_bits`` envelope. One Viterbi call then serves every
    MCS/length — positions beyond a frame's true coded extent are erased, so
    the survivor path through the real steps is the same MLE path the
    per-branch decode would find (zero-cost steps never change it).
    ``soft=True`` feeds max-log-MAP LLRs instead of ±1 hard values."""
    max_bytes = max_payload + 4
    t_max = max_trellis_bits(max_payload, n_data_carriers)

    def branch(mcs: MCS):
        from jrc.config import MCSParams

        mp = MCSParams(mcs, n_data_carriers)
        branch_max_sym = math.ceil((16 + 8 * max_bytes + 6) / mp.n_dbps)
        branch_max_bits = branch_max_sym * mp.n_dbps

        def run(z_in, n_bytes):
            _n_sym, n_data_bits = frame_geometry(
                jnp.int32(int(mcs)), n_bytes, n_data_carriers)
            zz = z_in[:branch_max_sym].reshape(-1)
            if soft:
                chan_values = modulation.soft_llr(zz, mcs)
            else:
                vals = modulation.hard_decision(zz, mcs)
                chan_values = hard_to_values(coding.merge_symbols(vals, mp.n_bpsc))
            values = coding.depuncture(
                chan_values, mcs, 2 * branch_max_bits, erasure=0.0
            )
            # erase positions beyond this frame's true coded extent
            pos = jnp.arange(2 * branch_max_bits)
            values = jnp.where(pos < 2 * n_data_bits, values, 0.0)
            return jnp.pad(values, (0, 2 * t_max - 2 * branch_max_bits))

        return run

    branches = [branch(m) for m in MCS]
    return jax.lax.switch(
        jnp.clip(mcs_idx, 0, len(MCS) - 1), branches, z, data_size_byte
    )


def payload_from_bits_dynamic(
    decoded: jax.Array,  # (..., ≥ 16 + 8·(max_payload+4)) Viterbi output
    data_size_byte: jax.Array,
    max_payload: int,
):
    """descramble → bytes → length-masked CRC (MCS-independent)."""
    max_bytes = max_payload + 4
    descrambled = coding.descramble(decoded)
    data_bits = descrambled[..., 16 : 16 + 8 * max_bytes]
    pdu = coding.bits_to_bytes(data_bits)
    crc_ok = coding.crc32_check_residue(pdu, n_valid=data_size_byte)
    return pdu, crc_ok


def decode_payload_dynamic(
    cfg: OFDMConfig,
    z: jax.Array,  # (max_n_sym, 48) equalized symbols (masked beyond frame)
    mcs_idx: jax.Array,
    data_size_byte: jax.Array,
    max_payload: int,
):
    """demod (per-MCS switch) → one shared Viterbi → descramble → CRC.

    Returns (payload bytes (max_payload+4,), crc_ok).
    """
    values = payload_values_dynamic(z, mcs_idx, data_size_byte, max_payload)
    decoded = viterbi_decode(values, n_out=16 + 8 * (max_payload + 4))
    return payload_from_bits_dynamic(decoded, data_size_byte, max_payload)


class DynamicPre(NamedTuple):
    """Pre-Viterbi state of one dynamic frame (lets a batching caller run
    ONE flat Viterbi over all frames; see models/streaming.scan_rx)."""

    values: jax.Array  # (2·max_trellis_bits,) depunctured channel values
    mcs: jax.Array
    length: jax.Array  # data_size_byte from SIG (payload + 4 CRC)
    packet_type_bit: jax.Array
    n_ofdm_sym: jax.Array
    sig_ok: jax.Array
    snr_db: jax.Array  # legacy-LTF estimate
    snr_data_db: jax.Array  # pilot-tracked payload SNR over active symbols
    chan_est: cx.CArray  # (fft_len, n_tx) NDP MIMO LS estimate


def rx_frame_dynamic_values(
    cfg: OFDMConfig,
    x: jax.Array,  # sample stream (padded: trigger + max window must fit)
    trigger: jax.Array,
    coarse_cfo: jax.Array,
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
) -> DynamicPre:
    """Sync + equalize + demod one frame with SIG-discovered parameters,
    stopping before the Viterbi pass."""
    max_n_sym = max_symbols(max_payload, cfg.n_data_carriers)
    n_sym_total = 2 + 1 + cfg.n_ltf + max_n_sym

    syms_t, total_cfo, _found = sync.extract_frame(
        cfg, x, trigger, coarse_cfo, n_sym_total
    )
    return rx_frame_dynamic_values_from_syms(
        cfg, syms_t, total_cfo, max_payload=max_payload, estimator=estimator,
        soft=soft,
    )


def rx_frame_dynamic_values_from_syms(
    cfg: OFDMConfig,
    syms_t,  # (n_sym_total, fft_len) time-domain symbols from extract
    total_cfo: jax.Array,
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
) -> DynamicPre:
    """SIG decode + equalize + demod from already-extracted symbols (the
    batching executor extracts all frames at once; see
    sync.extract_frames_batch)."""
    max_n_sym = max_symbols(max_payload, cfg.n_data_carriers)
    grid = ofdm.fft_symbols(cfg, syms_t)
    grid = equalizer.sampling_offset_compensate(cfg, grid, total_cfo)

    h_legacy, snr_db = equalizer.legacy_channel_estimate(cfg, grid[0], grid[1])

    # SIG
    ref0 = cx.from_complex(np.asarray(cfg.pilot_symbols)[0])
    beta, _ = equalizer.common_phase_error(cfg, grid[2], h_legacy, ref0)
    y_sig = grid[2] * cx.expj(-beta)
    didx = jnp.asarray(cfg.data_carrier_idx)
    z_sig = y_sig[didx] / h_legacy[didx]
    rate_bitmap, ptype, length, sig_ok = equalizer.decode_sig(z_sig)
    mcs_idx = jnp.asarray(_RATE_LUT)[jnp.clip(rate_bitmap, 0, 15)]
    sig_ok = sig_ok & jnp.asarray(_RATE_VALID)[jnp.clip(rate_bitmap, 0, 15)]
    length = jnp.clip(length, 4, max_payload + 4)
    n_sym, _ = frame_geometry(mcs_idx, length, cfg.n_data_carriers)

    # MIMO-LTF: both estimates, runtime-selected by packet type
    y_ltf = grid[3 : 3 + cfg.n_ltf]
    h_eff = equalizer.effective_channel_estimate(cfg, y_ltf)
    # full (fft_len, n_tx) NDP sounding estimate — the streaming surface's
    # replacement for the equalizer's chan_est.csv write on NDP frames
    # (lib/mimo_ofdm_equalizer_impl.cc:378-416); meaningful when the SIG
    # says NDP, computed unconditionally for static shapes
    h_ndp, _ = equalizer.mimo_channel_estimate_ndp(cfg, y_ltf)

    # data equalization over the max envelope with a masked scan:
    y_data = grid[3 + cfg.n_ltf :]
    pidx = jnp.asarray(cfg.pilot_carrier_idx)
    sched = cx.from_complex(np.asarray(cfg.pilot_symbols))
    rows = jnp.arange(max_n_sym) % sched.shape[0]
    refs = sched[rows]
    is_data_frame = ptype == 1

    sta = estimator == "sta"
    # α = 0.4 for DATA, 0.5 for NDP (lib/mimo_ofdm_equalizer_impl.cc:510,560)
    alpha = jnp.where(is_data_frame, 0.4, 0.5)

    def _sta_remod(z):
        """Hard re-modulation under the SIG-discovered MCS (CArray pytree
        flows through lax.switch directly)."""
        branches = [
            (lambda zz, m=m: modulation.modulate(
                modulation.hard_decision(zz, m), m))
            for m in MCS
        ]
        return jax.lax.switch(jnp.clip(mcs_idx, 0, len(MCS) - 1), branches, z)

    h0 = cx.where(is_data_frame, h_eff, h_legacy)

    if not sta:
        # fixed h ⇒ only the running pilot-noise average is sequential — a
        # length-max_n_sym cumsum; per-symbol CPE/equalization is parallel
        # (mirrors equalizer.equalize_data_symbols' non-STA fast path)
        ks = jnp.arange(max_n_sym)
        active = ks < n_sym
        w = active.astype(jnp.float32)

        def per_symbol(y, ref):
            beta_k, est = equalizer.common_phase_error(cfg, y, h0, ref)
            y = y * cx.expj(-beta_k)
            return y, jnp.sum(cx.abs2(est)), jnp.sum(cx.abs2(est - y[pidx]))

        y_rot, sig_k, noise_k = jax.vmap(per_symbol)(y_data, refs)
        noise_cum = jnp.cumsum(w * noise_k)
        count_cum = jnp.cumsum(jnp.where(active, cfg.n_pilot_carriers, 0))
        csi = (
            cx.abs2(h0[didx])[None, :]
            + (noise_cum / jnp.maximum(count_cum, 1))[:, None]
        )
        z_mmse = cx.mul_conj(y_rot[:, didx], h0[None, didx]) / csi
        z_zf = y_rot[:, didx] / h0[None, didx]
        z = cx.where(is_data_frame, z_mmse, z_zf)
        z = cx.where(active[:, None], z, cx.zeros(z.shape))
        sig_sum = jnp.sum(w * sig_k)
        noise_sum = noise_cum[-1]
        snr_data = 10.0 * jnp.log10(
            jnp.maximum(sig_sum, 1e-30) / jnp.maximum(noise_sum, 1e-30))
    else:
        def step(carry, xs):
            h, sig_sum, noise_sum, count = carry
            y, ref, k = xs
            active_sym = k < n_sym
            beta_k, est = equalizer.common_phase_error(cfg, y, h, ref)
            y = y * cx.expj(-beta_k)
            w = active_sym.astype(jnp.float32)
            sig_sum = sig_sum + w * jnp.sum(cx.abs2(est))
            noise_sum = noise_sum + w * jnp.sum(cx.abs2(est - y[pidx]))
            count = count + jnp.where(active_sym, cfg.n_pilot_carriers, 0)
            csi = cx.abs2(h[didx]) + noise_sum / jnp.maximum(count, 1)
            z_mmse = cx.mul_conj(y[didx], h[didx]) / csi
            z_zf = y[didx] / h[didx]
            z = cx.where(is_data_frame, z_mmse, z_zf)
            x_hat = _sta_remod(z)
            h_upd_data = y[didx] / x_hat
            h_upd_pilot = y[pidx] / ref
            h_new = h.at[didx].set(h[didx] * (1 - alpha) + h_upd_data * alpha)
            h_new = h_new.at[pidx].set(h[pidx] * (1 - alpha) + h_upd_pilot * alpha)
            h = cx.where(active_sym, h_new, h)
            return (h, sig_sum, noise_sum, count), cx.where(
                active_sym, z, cx.zeros(z.shape))

        (_, sig_sum, noise_sum, _), z = jax.lax.scan(
            step,
            (h0, jnp.float32(0), jnp.float32(0), jnp.int32(0)),
            (y_data, refs, jnp.arange(max_n_sym)),
        )
        snr_data = 10.0 * jnp.log10(
            jnp.maximum(sig_sum, 1e-30) / jnp.maximum(noise_sum, 1e-30))

    values = payload_values_dynamic(
        z, mcs_idx, length, max_payload, soft=soft,
        n_data_carriers=cfg.n_data_carriers)
    return DynamicPre(
        values=values,
        mcs=mcs_idx,
        length=length,
        packet_type_bit=ptype,
        n_ofdm_sym=n_sym,
        sig_ok=sig_ok,
        snr_db=snr_db,
        snr_data_db=snr_data,
        chan_est=h_ndp,
    )


def rx_frame_dynamic_finish(
    pre: DynamicPre, decoded: jax.Array, max_payload: int
) -> DynamicFrame:
    """Viterbi output bits → DynamicFrame (descramble / bytes / CRC)."""
    pdu, crc_ok = payload_from_bits_dynamic(decoded, pre.length, max_payload)
    return DynamicFrame(
        payload=pdu[..., :max_payload],
        payload_len=pre.length - 4,
        crc_ok=crc_ok & pre.sig_ok,
        mcs=pre.mcs,
        packet_type_bit=pre.packet_type_bit,
        n_ofdm_sym=pre.n_ofdm_sym,
        sig_ok=pre.sig_ok,
        snr_db=pre.snr_db,
        snr_data_db=pre.snr_data_db,
        chan_est=pre.chan_est,
        # the reference writes chan_est.csv at the NDP MIMO-LTF stage,
        # before any payload CRC (…:378-416) — gate only on type + SIG
        chan_est_ok=(pre.packet_type_bit == 0) & pre.sig_ok,
    )


def rx_frame_dynamic(
    cfg: OFDMConfig,
    x: jax.Array,
    trigger: jax.Array,
    coarse_cfo: jax.Array,
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
) -> DynamicFrame:
    """Sync + equalize + decode one frame with SIG-discovered parameters."""
    pre = rx_frame_dynamic_values(
        cfg, x, trigger, coarse_cfo, max_payload=max_payload,
        estimator=estimator, soft=soft,
    )
    decoded = viterbi_decode(pre.values, n_out=16 + 8 * (max_payload + 4))
    return rx_frame_dynamic_finish(pre, decoded, max_payload)
