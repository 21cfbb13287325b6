"""Typed OFDM / JRC system configuration.

JAX-native replacement for the reference's scattered configuration:

* the ``ofdm_config`` embedded-python module inside every flowgraph
  (``examples/simulation/radar/mimo_ofdm_jrc_radar_sim.grc``) which holds the
  carrier sets, pilot schedule, STF/LTF sequences and the P-matrix,
* the per-block constructor arguments (``grc/*.block.yml``),
* the MCS/packet math of ``lib/utils.cc:26-111``.

Everything here is a frozen, hashable dataclass so a config can be passed as a
``jax.jit`` static argument; derived sequences are cached numpy arrays (device
constants are created at trace time).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Tuple

import numpy as np


class MCS(enum.IntEnum):
    """Modulation-and-coding schemes (reference include/mimo_ofdm_jrc/stream_encoder.h:26-34)."""

    BPSK_1_2 = 0
    BPSK_3_4 = 1
    QPSK_1_2 = 2
    QPSK_3_4 = 3
    QAM16_1_2 = 4
    QAM16_3_4 = 5


class PacketType(enum.IntEnum):
    """Packet types (reference include/mimo_ofdm_jrc/stream_encoder.h:35-38).

    The 1-bit SIG-field encoding is ``NDP -> 0`` and ``DATA -> 1``
    (reference lib/utils.cc:42-52).
    """

    NDP = 1
    DATA = 2

    @property
    def sig_bit(self) -> int:
        return 0 if self is PacketType.NDP else 1


#: SIG-field "rate" nibble per MCS (reference lib/utils.cc:55-110).
RATE_FIELD = {
    MCS.BPSK_1_2: 0x0D,
    MCS.BPSK_3_4: 0x0F,
    MCS.QPSK_1_2: 0x05,
    MCS.QPSK_3_4: 0x07,
    MCS.QAM16_1_2: 0x09,
    MCS.QAM16_3_4: 0x0B,
}

#: Coded bits per subcarrier per MCS.
N_BPSC = {
    MCS.BPSK_1_2: 1,
    MCS.BPSK_3_4: 1,
    MCS.QPSK_1_2: 2,
    MCS.QPSK_3_4: 2,
    MCS.QAM16_1_2: 4,
    MCS.QAM16_3_4: 4,
}

#: Code-rate numerator/denominator per MCS.
CODE_RATE = {
    MCS.BPSK_1_2: (1, 2),
    MCS.BPSK_3_4: (3, 4),
    MCS.QPSK_1_2: (1, 2),
    MCS.QPSK_3_4: (3, 4),
    MCS.QAM16_1_2: (1, 2),
    MCS.QAM16_3_4: (3, 4),
}

#: Max payload bytes incl. CRC (reference lib/utils.h:33).
MAX_PAYLOAD_SIZE = 3100

#: Convolutional code generators, K=7 (reference lib/utils.cc:207-217).
CONV_POLY_A = 0o155
CONV_POLY_B = 0o117

#: CRC-32 residue over payload+FCS (reference lib/stream_decoder_impl.cc:279-281).
CRC32_RESIDUE = 558161692


@lru_cache(maxsize=None)
def mcs_tables(n_data_carriers: int = 48):
    """(n_bpsc, n_cbps, n_dbps) int32 arrays indexed by MCS value.

    Mirrors ``ofdm_mcs`` (reference lib/utils.cc:55-110) but as arrays so a
    traced MCS index can be used for in-jit gathers.
    """
    n_bpsc = np.array([N_BPSC[m] for m in MCS], np.int32)
    n_cbps = n_bpsc * n_data_carriers
    rate_n = np.array([CODE_RATE[m][0] for m in MCS], np.int32)
    rate_d = np.array([CODE_RATE[m][1] for m in MCS], np.int32)
    n_dbps = n_cbps * rate_n // rate_d
    return n_bpsc, n_cbps, n_dbps


@dataclass(frozen=True)
class MCSParams:
    """Per-MCS frame math — ``ofdm_mcs`` of reference lib/utils.cc:55-110."""

    mcs: MCS
    n_data_carriers: int = 48

    @property
    def n_bpsc(self) -> int:
        return N_BPSC[self.mcs]

    @property
    def n_cbps(self) -> int:
        return self.n_data_carriers * self.n_bpsc

    @property
    def n_dbps(self) -> int:
        num, den = CODE_RATE[self.mcs]
        return self.n_cbps * num // den

    @property
    def rate_field(self) -> int:
        return RATE_FIELD[self.mcs]

    @property
    def punctured(self) -> bool:
        return CODE_RATE[self.mcs] == (3, 4)


@dataclass(frozen=True)
class PacketParams:
    """Frame math for one packet — ``packet_param`` of reference lib/utils.cc:26-53.

    ``data_size_byte`` includes the 4-byte CRC.
    """

    mcs_params: MCSParams
    data_size_byte: int
    packet_type: PacketType

    @property
    def n_ofdm_sym(self) -> int:
        # 16 service zeros + payload bits + >=6 tail bits (reference lib/utils.cc:31)
        return math.ceil((16 + 8 * self.data_size_byte + 6) / self.mcs_params.n_dbps)

    @property
    def n_data_bits(self) -> int:
        return self.n_ofdm_sym * self.mcs_params.n_dbps

    @property
    def n_pad_bits(self) -> int:
        return self.n_data_bits - (16 + 8 * self.data_size_byte + 6)

    @property
    def n_encoded_bits(self) -> int:
        return self.n_ofdm_sym * self.mcs_params.n_cbps

    @property
    def n_symbols(self) -> int:
        """Complex data symbols in the frame payload."""
        return self.n_ofdm_sym * self.mcs_params.n_data_carriers


def _lltf_base() -> np.ndarray:
    """Custom 64-point L-LTF used by the reference (fft-shifted order, DC at idx 32).

    Matches ``l_ltf_64_custom`` in the ``ofdm_config`` epy module of
    ``examples/simulation/radar/mimo_ofdm_jrc_radar_sim.grc`` — the 802.11
    L-LTF left/right sequences with the band-edge guard reworked to
    ``[0,0,0,0,1,1, ltf_left, 0, ltf_right, -1,-1, 0,0,0]``.
    """
    ltf_left = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
    ltf_right = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
    seq = [0, 0, 0, 0, 1, 1] + ltf_left + [0] + ltf_right + [-1, -1] + [0, 0, 0]
    out = np.array(seq, np.complex64)
    assert out.shape == (64,)
    return out


def _lstf_base() -> np.ndarray:
    """802.11 L-STF (fft-shifted order), magnitude sqrt(13/6)·(1+1j)/... as in the
    reference's ``l_stf_64_def`` (radar-sim grc ``ofdm_config``)."""
    a = 1.4719601443879746
    p = a * (1 + 1j)
    m = -a * (1 - 1j) * 1  # == -(a+aj)
    seq = np.zeros(64, np.complex64)
    # indices (shifted order) with ±(1+1j): from the epy module literal
    plus = [8, 16, 28, 44, 48, 52, 56]
    minus = [12, 20, 24, 36, 40]
    for i in plus:
        seq[i] = p
    for i in minus:
        seq[i] = -p
    return seq


@dataclass(frozen=True)
class OFDMConfig:
    """Static system configuration (hashable ⇒ usable as a jit static arg)."""

    fft_len: int = 64
    cp_len: int = 16
    n_tx: int = 4
    n_rx: int = 2
    n_ltf: int | None = None  # defaults to n_tx
    #: data subcarriers in logical (centered) indices, DC = 0
    data_carriers: Tuple[int, ...] = tuple(
        list(range(-26, -21)) + list(range(-20, -7)) + list(range(-6, 0))
        + list(range(1, 7)) + list(range(8, 21)) + list(range(22, 27))
    )
    pilot_carriers: Tuple[int, ...] = (-21, -7, 7, 21)
    #: number of legacy sync symbols at frame head (STF,STF,LTF_rot,LTF)
    n_sync_words: int = 4
    sample_rate: float = 125e6
    center_freq: float = 24e9
    max_payload: int = MAX_PAYLOAD_SIZE

    def __post_init__(self):
        if self.n_ltf is None:
            object.__setattr__(self, "n_ltf", self.n_tx)
        if not 1 <= self.n_tx <= 4:
            raise ValueError(f"n_tx must be 1..4 (P_ltf is 4x4), got {self.n_tx}")
        if self.n_ltf < self.n_tx:
            raise ValueError(
                f"n_ltf ({self.n_ltf}) must be >= n_tx ({self.n_tx}) to "
                "separate the TX channels")
        # every LTF-based estimator (equalizer NDP/DATA, radar channel
        # separation) assumes the P_ltf rows are orthogonal; the reference's
        # 4x4 matrix sliced to [:n_tx, :n_ltf] is orthogonal for n_tx in
        # {1, 2, 4} but NOT for n_tx = 3 (rows 0 and 2 correlate) — reject
        # rather than silently leak ~1/3-level cross-TX energy into every
        # channel estimate
        p = np.array(
            [[1, -1, 1, 1], [1, 1, -1, 1], [1, 1, 1, -1], [-1, 1, 1, 1]],
            np.float32)[: self.n_tx, : self.n_ltf]
        gram = p @ p.T
        if not np.allclose(gram, np.diag(np.diag(gram))):
            raise ValueError(
                f"P_ltf rows are not orthogonal for n_tx={self.n_tx}, "
                f"n_ltf={self.n_ltf}; use n_tx in {{1, 2, 4}} or n_ltf=4")

    # ---- sizes -----------------------------------------------------------
    @property
    def n_data_carriers(self) -> int:
        return len(self.data_carriers)

    @property
    def n_pilot_carriers(self) -> int:
        return len(self.pilot_carriers)

    @property
    def sym_len(self) -> int:
        return self.fft_len + self.cp_len

    @property
    def n_virtual(self) -> int:
        """Virtual array elements (TX·RX)."""
        return self.n_tx * self.n_rx

    @property
    def max_n_sym(self) -> int:
        """Upper bound on DATA OFDM symbols (reference lib/utils.h:34)."""
        return (16 + 8 * self.max_payload + 6) // 24 + 1

    @property
    def n_header_syms(self) -> int:
        """sync words + SIG + MIMO-LTFs preceding the data symbols."""
        return self.n_sync_words + 1 + self.n_ltf

    # ---- index maps ------------------------------------------------------
    @cached_property
    def data_carrier_idx(self) -> np.ndarray:
        """Data carrier indices into the fft-shifted (DC at fft_len/2) grid."""
        return np.asarray(self.data_carriers, np.int32) + self.fft_len // 2

    @cached_property
    def pilot_carrier_idx(self) -> np.ndarray:
        return np.asarray(self.pilot_carriers, np.int32) + self.fft_len // 2

    @cached_property
    def active_carrier_idx(self) -> np.ndarray:
        """Sorted union of data+pilot indices (shifted grid)."""
        return np.sort(np.concatenate([self.data_carrier_idx, self.pilot_carrier_idx])).astype(np.int32)

    @cached_property
    def data_mask(self) -> np.ndarray:
        m = np.zeros(self.fft_len, bool)
        m[self.data_carrier_idx] = True
        return m

    @cached_property
    def pilot_mask(self) -> np.ndarray:
        m = np.zeros(self.fft_len, bool)
        m[self.pilot_carrier_idx] = True
        return m

    # ---- sequences -------------------------------------------------------
    @cached_property
    def lstf_freq(self) -> np.ndarray:
        """L-STF, fft-shifted frequency order. (radar-sim grc ``l_stf_64_def``)."""
        return _lstf_base()

    @cached_property
    def lltf_freq(self) -> np.ndarray:
        """Custom L-LTF, fft-shifted order (radar-sim grc ``l_ltf_64_custom``)."""
        return _lltf_base()

    @cached_property
    def symbol_rotation(self) -> np.ndarray:
        """Per-carrier rotation [1,-1j,-1,1j]·16 applied to the 3rd sync word."""
        return np.tile(np.array([1, -1j, -1, 1j], np.complex64), self.fft_len // 4)

    @cached_property
    def lltf_rot_freq(self) -> np.ndarray:
        return (self.symbol_rotation * self.lltf_freq).astype(np.complex64)

    @cached_property
    def sync_words_freq(self) -> np.ndarray:
        """(n_sync_words, fft_len) legacy preamble in frequency domain:
        [STF, STF, LTF_rot, LTF] (radar-sim grc ``l_stf_ltf_64``)."""
        return np.stack(
            [self.lstf_freq, self.lstf_freq, self.lltf_rot_freq, self.lltf_freq]
        ).astype(np.complex64)

    @cached_property
    def p_ltf(self) -> np.ndarray:
        """Orthogonal MIMO-LTF mapping matrix (radar-sim grc ``P_ltf``)."""
        return np.array(
            [[1, -1, 1, 1], [1, 1, -1, 1], [1, 1, 1, -1], [-1, 1, 1, 1]],
            np.complex64,
        )[: self.n_tx, : self.n_ltf]

    @cached_property
    def ltf_mapped_sc_ss_sym(self) -> np.ndarray:
        """(fft_len, n_tx, n_ltf): P_ltf · ltf[sc] per subcarrier
        (radar-sim grc ``ltf_mapped_sc__ss_sym``, row-major (tx, ltf))."""
        return np.einsum("tl,s->stl", self.p_ltf, self.lltf_freq).astype(np.complex64)

    @cached_property
    def lltf_time(self) -> np.ndarray:
        """Time-domain L-LTF, normalized as the reference does:
        ``N_sc·ifft(fftshift(ltf))/sqrt(nnz(ltf))`` (radar-sim grc epy)."""
        ltf = self.lltf_freq
        t = self.fft_len * np.fft.ifft(np.fft.fftshift(ltf)) / np.sqrt(np.count_nonzero(ltf))
        return t.astype(np.complex64)

    @cached_property
    def lltf_fir(self) -> np.ndarray:
        """Matched filter taps: time-reversed conjugate of lltf_time."""
        return np.conj(self.lltf_time)[::-1].astype(np.complex64)

    @cached_property
    def pilot_symbols(self) -> np.ndarray:
        """(127, n_pilot) pilot polarity schedule.

        The reference uses a 127-entry pattern of (1,1,1,-1)/(-1,-1,-1,1) rows
        (the 802.11 pilot-polarity sequence applied to the (1,1,1,-1) base) —
        radar-sim grc ``pilot_symbols``. Row k is used for OFDM symbol k mod 127.
        """
        # 802.11 polarity sequence p_{0..126}
        polarity = np.array([
            1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1, -1, -1, 1, 1, -1, 1,
            1, -1, 1, 1, 1, 1, 1, 1, -1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1,
            -1, -1, 1, -1, 1, -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, -1, 1,
            -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1, -1, 1, -1, -1, 1, -1, 1, 1,
            1, 1, -1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, -1, 1, 1,
            1, -1, -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
        ], np.int8)
        base = np.array([1, 1, 1, -1], np.float32)
        return (polarity[:, None] * base[None, :]).astype(np.complex64)

    # ---- radar axes ------------------------------------------------------
    def range_axis(self, interp_factor_range: int = 8) -> np.ndarray:
        """Range bins in meters — delegates to :func:`ops.radar.range_axis`
        (one convention everywhere: the reference flowgraph's
        inclusive-endpoint linspace; see that docstring for the 0.2%
        spacing note)."""
        from jrc.ops.radar import range_axis as _ra

        return _ra(self.fft_len, self.sample_rate, interp_factor_range)

    def angle_axis(self, interp_factor_angle: int = 16) -> np.ndarray:
        """Angle bins in degrees over the virtual array.

        ``arcsin(2/n · (k − n/2))`` — slot k of the shifted angle FFT holds
        spatial frequency bin k − n/2 (cplx.dft_mats shift_out), so this is
        the axis the periodogram actually lands on. Deliberate deviation:
        the reference's GUI axis adds +0.5 bin (radar-sim grc
        ``angle_axis``), which biases every reported azimuth by half an
        interpolated bin (~+0.45° at the default grid, measured on clean
        point targets); with this axis the angle error is zero-mean
        quantization.
        """
        n = self.n_virtual * interp_factor_angle
        k = np.arange(n)
        return np.degrees(np.arcsin(np.clip(2.0 / n * (k - n / 2), -1, 1)))


DEFAULT_CONFIG = OFDMConfig()
