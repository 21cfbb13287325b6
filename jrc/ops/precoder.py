"""MIMO precoder: full TX frame assembly with steering.

JAX-native equivalent of ``mimo_precoder`` (lib/mimo_precoder_impl.cc), the
reference's TX core. Differences in *mechanism*, parity in *function*:

* steering matrices for all subcarriers are computed in one batched
  closed-form **complex Householder** construction instead of a per-line
  Eigen JacobiSVD loop over a CSV file (lib/mimo_precoder_impl.cc:775-898).
  For a single-RX channel row h, the top right-singular vector of the 1×n_tx
  matrix is conj(h)/‖h‖ in closed form; the Householder reflector that maps
  e0 onto it supplies an orthonormal null-space complement — the same
  function as JacobiSVD's V (whose complement basis is equally arbitrary),
  with no iterative decomposition and no complex HLO;
* the channel-estimate / radar-angle feedback arrives as in-memory arrays
  (see models/jrc_trx.py JRCState) instead of ``chan_est.csv``/``radar_log.csv``
  polled by mtime;
* frame assembly is a scatter into a dense (n_sym_total, n_tx, fft_len)
  frequency grid followed by einsum precoding — matmul-shaped, pair-form complex.

Frame layout per antenna (lib/mimo_precoder_impl.cc:271-293):
``[sync×4 | SIG | MIMO-LTF×n_ltf | DATA×n_sym]``; legacy preamble and SIG are
transmitted only on the first two antennas (…:342,:359).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType, RATE_FIELD
from jrc.ops import cplx as cx
from jrc.ops import modulation
from jrc.ops.encoder import FrameSpec
from jrc.ops.ofdm import allocate_carriers

# ---------------------------------------------------------------------------
# SIG field
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def signal_field_symbols(spec: FrameSpec) -> np.ndarray:
    """48 BPSK symbols of the SIG field for a frame spec (static).

    Bit layout (lib/mimo_precoder_impl.cc:985-1060): 4 rate bits (MSB-first
    nibble of rate_field), 1 packet-type bit, 12 length bits (LSB-first),
    1 even-parity bit over the first 17, 6 zero tail; conv-coded rate-1/2
    without scrambling; BPSK mapped.
    """
    rate = RATE_FIELD[spec.mcs]
    length = spec.data_size_byte
    bits = np.zeros(24, np.uint8)
    bits[0:4] = [(rate >> 3) & 1, (rate >> 2) & 1, (rate >> 1) & 1, rate & 1]
    bits[4] = spec.packet_type.sig_bit
    for i in range(12):
        bits[5 + i] = (length >> i) & 1
    bits[17] = bits[:17].sum() % 2
    # static precompute: pure numpy so no device work happens at trace time
    coded = np.zeros(48, np.uint8)
    state = 0
    for i, b in enumerate(bits):
        state = ((state << 1) & 0x7E) | int(b)
        coded[2 * i] = bin(state & 0o155).count("1") % 2
        coded[2 * i + 1] = bin(state & 0o117).count("1") % 2
    return np.asarray(modulation.constellation(1))[coded].astype(np.complex64)


def parse_signal_field_bits(bits: jax.Array):
    """Decode 24 SIG bits → (mcs_rate_bitmap, packet_type_bit, length, ok).

    Mirrors lib/mimo_ofdm_equalizer_impl.cc:650-781: parity over bits 0..16
    must equal bit 17 and the tail must be zero.
    """
    bits = bits.astype(jnp.int32)
    rate_bitmap = bits[..., 0] | (bits[..., 1] << 1) | (bits[..., 2] << 2) | (bits[..., 3] << 3)
    ptype = bits[..., 4]
    weights = 1 << jnp.arange(12, dtype=jnp.int32)
    length = jnp.sum(bits[..., 5:17] * weights, axis=-1)
    parity = jnp.sum(bits[..., :17], axis=-1) % 2
    tail_ok = jnp.sum(bits[..., 18:24], axis=-1) == 0
    ok = (parity == bits[..., 17]) & tail_ok
    return rate_bitmap, ptype, length, ok


#: received rate_bitmap value → MCS (lib/mimo_ofdm_equalizer_impl.cc:729-760)
SIG_RATE_TO_MCS = {11: MCS.BPSK_1_2, 15: MCS.BPSK_3_4, 10: MCS.QPSK_1_2,
                   14: MCS.QPSK_3_4, 9: MCS.QAM16_1_2, 13: MCS.QAM16_3_4}


# ---------------------------------------------------------------------------
# Steering
# ---------------------------------------------------------------------------


def fourier_matrix(n: int) -> np.ndarray:
    """DFT precoding fallback matrix (lib/mimo_precoder_impl.cc:761-772)."""
    k = np.arange(n)
    return (np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)).astype(np.complex64)


def _q_from_h(h: cx.CArray, n_tx: int, phased: bool) -> cx.CArray:
    """Steering matrix Q (..., n_tx, n_tx) from channel rows h (..., n_tx).

    phased (lib/mimo_precoder_impl.cc:848-854): Q.col0 = conj(h), zero else,
    scaled √n_tx/‖Q‖_F. SVD steering (…:857-861): unitary V with
    V.col0 ∝ conj(h) — built as a complex Householder reflector (see module
    docstring); its Frobenius normalization √n_tx/‖V‖_F is identically 1.
    """
    h = cx.from_complex(h)
    norm = jnp.sqrt(jnp.sum(cx.abs2(h), axis=-1, keepdims=True))
    nonzero = norm[..., 0] > 0

    if phased:
        scale = jnp.where(norm > 0, np.sqrt(n_tx) / norm, 0.0)
        col0 = h.conj() * scale
        q = cx.zeros((*h.shape, n_tx))
        return q.at[..., 0].set(col0)

    # unit top right-singular vector v ∝ conj(h)
    v = h.conj() / jnp.where(norm > 0, norm, 1.0)
    v0 = v[..., 0]
    v0_abs = jnp.sqrt(cx.abs2(v0))
    alpha = cx.where(v0_abs > 1e-12, v0 / jnp.maximum(v0_abs, 1e-12), cx.carray(1.0, 0.0))
    e0 = np.zeros(n_tx, np.float32)
    e0[0] = 1.0
    w = v - cx.CArray(alpha.re[..., None] * e0, alpha.im[..., None] * e0)
    wn2 = jnp.sum(cx.abs2(w), axis=-1)  # ∈ [0, 4]
    outer = cx.einsum("...i,...j->...ij", w, w.conj())
    eye = jnp.eye(n_tx, dtype=jnp.float32)
    H = cx.CArray(eye - 2.0 * outer.re / jnp.maximum(wn2, 1e-12)[..., None, None],
                  -2.0 * outer.im / jnp.maximum(wn2, 1e-12)[..., None, None])
    # w → 0 means v is already ±e0 (up to phase): H degenerates to identity
    H = cx.where((wn2 > 1e-12)[..., None, None], H, cx.CArray(
        jnp.broadcast_to(eye, H.shape), jnp.zeros(H.shape, jnp.float32)))
    zero = cx.zeros(H.shape)
    return cx.where(nonzero[..., None, None], H, zero)


def steering_from_chan_est(
    cfg: OFDMConfig, chan_est: cx.CArray, phased: bool = False
):
    """Per-subcarrier and mean steering from an NDP channel estimate.

    ``chan_est``: (fft_len, n_tx) rows in shifted order (zeros on inactive
    carriers — the in-memory analog of chan_est.csv). Returns
    (Q (fft_len, n_tx, n_tx), Q_mean (n_tx, n_tx)); the mean averages over
    active carriers only (lib/mimo_precoder_impl.cc:872-893).
    """
    chan_est = cx.from_complex(chan_est)
    q = _q_from_h(chan_est, cfg.n_tx, phased)
    active = jnp.asarray(cfg.active_carrier_idx)
    h_mean = cx.mean(chan_est[active], axis=0)
    q_mean = _q_from_h(h_mean, cfg.n_tx, phased)
    return q, q_mean


def steering_from_angle(cfg: OFDMConfig, angle_deg, phased: bool = True) -> cx.CArray:
    """Radar-aided steering: synthesize the ULA vector for an angle estimate
    (lib/mimo_precoder_impl.cc:956-959) and build the mean Q from it."""
    i_tx = jnp.arange(cfg.n_tx)
    h = cx.expj(jnp.pi * jnp.sin(jnp.deg2rad(angle_deg)) * i_tx)
    return _q_from_h(h, cfg.n_tx, phased)


def mean_channel_angle(chan_mean: cx.CArray):
    """Debug angle estimate from the mean channel:
    ``asin(arg(h1/h0)/π)`` in degrees (lib/mimo_precoder_impl.cc:511-527)."""
    chan_mean = cx.from_complex(chan_mean)
    ratio = chan_mean[..., 1] / chan_mean[..., 0]
    return jnp.rad2deg(jnp.arcsin(cx.angle(ratio) / jnp.pi))


# ---------------------------------------------------------------------------
# Frame assembly
# ---------------------------------------------------------------------------


def assemble_siso_frame(
    cfg: OFDMConfig, data_syms: cx.CArray, pilot_row0: int = 0
) -> cx.CArray:
    """Legacy SISO carrier allocator — ``ofdm_frame_generator`` parity
    (lib/ofdm_frame_generator_impl.cc): sync words + data/pilot mapping, one
    antenna, no SIG/MIMO-LTF. (n_sym, 48) → (n_sync+n_sym, fft_len).
    Superseded by :func:`assemble_frame` in the JRC graphs."""
    sync = cx.from_complex(np.asarray(cfg.sync_words_freq))
    payload = allocate_carriers(cfg, data_syms, pilot_row0=pilot_row0)
    return cx.concatenate([sync, payload], axis=-2)


def _stream_grids(
    cfg: OFDMConfig,
    spec: FrameSpec,
    data_syms: cx.CArray,
    use_radar_streams: bool,
    rng_key,
) -> cx.CArray:
    """(n_streams, n_sym, fft_len) frequency grids: stream 0 = data+pilots,
    streams 1.. = random QPSK/2 'radar streams' on data *and* pilot carriers
    (lib/mimo_precoder_impl.cc:434-493)."""
    grid0 = allocate_carriers(cfg, data_syms, pilot_row0=0)
    if not use_radar_streams:
        return grid0[None]
    if rng_key is None:
        raise ValueError(
            "use_radar_streams=True needs an rng_key (the radar streams are "
            "random QPSK, lib/mimo_precoder_impl.cc:434-493)")
    n_extra = cfg.n_tx - 1
    n_sym = data_syms.shape[-2]
    n_active = cfg.n_data_carriers + cfg.n_pilot_carriers
    vals = jax.random.randint(rng_key, (n_extra, n_sym, n_active), 0, 4)
    qpsk = modulation.constellation_pair(2, tx_scale=True)
    sym = qpsk[vals]
    extra = cx.zeros((n_extra, n_sym, cfg.fft_len))
    dc = jnp.asarray(cfg.data_carrier_idx)
    pc = jnp.asarray(cfg.pilot_carrier_idx)
    extra = extra.at[..., dc].set(sym[..., : cfg.n_data_carriers])
    extra = extra.at[..., pc].set(sym[..., cfg.n_data_carriers :])
    return cx.concatenate([grid0[None], extra], axis=0)


def assemble_frame(
    cfg: OFDMConfig,
    spec: FrameSpec,
    data_syms: cx.CArray,
    *,
    steering: cx.CArray | None = None,  # (fft_len, n_tx, n_tx) per-sc Q
    mean_steering: cx.CArray | None = None,  # (n_tx, n_tx)
    use_radar_streams: bool = False,
    rng_key=None,
) -> cx.CArray:
    """Build the full TX frequency grid (n_total_sym, n_tx, fft_len).

    Precoding mode selection mirrors lib/mimo_precoder_impl.cc:496-532:
    per-subcarrier ``steering`` > ``mean_steering`` > Fourier fallback.
    NDP frames (spec.packet_type) are never precoded: MIMO-LTF mapped
    directly, payload duplicated on the first two antennas (…:379-428).
    """
    n_tx = cfg.n_tx
    data_syms = cx.from_complex(data_syms)
    n_sym = data_syms.shape[-2]
    assert n_sym == spec.n_ofdm_sym, (n_sym, spec.n_ofdm_sym)
    n_total = cfg.n_sync_words + 1 + cfg.n_ltf + n_sym
    legacy_ants = min(2, n_tx)

    grid = cx.zeros((n_total, n_tx, cfg.fft_len))

    # --- legacy sync preamble on first 2 antennas (…:336-350)
    sync = cx.from_complex(np.asarray(cfg.sync_words_freq))  # (4, fft_len)
    grid = grid.at[: cfg.n_sync_words, :legacy_ants, :].set(
        cx.broadcast_to(sync[:, None, :], (cfg.n_sync_words, legacy_ants, cfg.fft_len))
    )

    # --- SIG on first 2 antennas with pilot row 0 (…:356-372)
    sig = cx.from_complex(signal_field_symbols(spec))
    sig_grid = allocate_carriers(cfg, sig[None, :], pilot_row0=0)[0]
    grid = grid.at[cfg.n_sync_words, :legacy_ants, :].set(
        cx.broadcast_to(sig_grid, (legacy_ants, cfg.fft_len))
    )

    ltf_rows = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    data_rows = slice(cfg.n_sync_words + 1 + cfg.n_ltf, n_total)
    x_ltf = cx.from_complex(np.asarray(cfg.ltf_mapped_sc_ss_sym))  # (fft_len, n_tx, n_ltf)

    if spec.packet_type is PacketType.NDP:
        # unprecoded MIMO-LTF on all antennas (…:379-388)
        grid = grid.at[ltf_rows].set(x_ltf.transpose(2, 1, 0))
        # NDP payload + pilots, unprecoded, first 2 antennas (…:393-428)
        payload_grid = allocate_carriers(cfg, data_syms, pilot_row0=0)
        grid = grid.at[data_rows, :legacy_ants, :].set(
            cx.broadcast_to(payload_grid[:, None, :], (n_sym, legacy_ants, cfg.fft_len))
        )
        return grid

    # --- DATA: build streams and select precoder
    streams = _stream_grids(cfg, spec, data_syms, use_radar_streams, rng_key)
    n_streams = streams.shape[0]

    if steering is not None:
        q = cx.from_complex(steering)  # (fft_len, n_tx, n_tx)
        ltf_pre = cx.einsum("sij,sjl->lis", q, x_ltf)  # (n_ltf, n_tx, fft_len)
        data_pre = cx.einsum("sij,jks->kis", q[:, :, :n_streams], streams)
    else:
        if mean_steering is not None:
            qm = cx.from_complex(mean_steering)
        else:
            qm = cx.from_complex(fourier_matrix(n_tx))
        ltf_pre = cx.einsum("ij,sjl->lis", qm, x_ltf)
        data_pre = cx.einsum("ij,jks->kis", qm[:, :n_streams], streams)

    grid = grid.at[ltf_rows].set(ltf_pre)
    grid = grid.at[data_rows].set(data_pre)
    return grid
