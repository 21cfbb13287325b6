"""Stream encoder: payload bytes → modulated OFDM data symbols.

Batched, jit-compilable equivalent of ``stream_encoder``
(lib/stream_encoder_impl.cc:74-245): CRC-32 append → SERVICE zeros + bits →
scramble (per-frame incrementing seed) → zero tail → conv encode → puncture →
(no interleaving, matching the reference) → split → constellation map.

Frame geometry (payload length, MCS, packet type) is static per compiled
specialization — mirroring the reference where each PDU defines its frame —
while payload contents and scrambler seeds are traced, so a batch of frames
encodes in one fused program.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, MCSParams, PacketParams, PacketType
from jrc.ops import coding, modulation


@dataclass(frozen=True)
class FrameSpec:
    """Static frame geometry: everything the SIG field carries.

    ``payload_bytes`` is the PSDU length *without* CRC (the reference adds 4
    CRC bytes before computing packet_param, lib/stream_encoder_impl.cc:129).
    """

    mcs: MCS
    payload_bytes: int
    packet_type: PacketType
    n_data_carriers: int = 48

    @property
    def data_size_byte(self) -> int:
        return self.payload_bytes + 4

    @property
    def mcs_params(self) -> MCSParams:
        return MCSParams(self.mcs, self.n_data_carriers)

    @property
    def packet_params(self) -> PacketParams:
        return PacketParams(self.mcs_params, self.data_size_byte, self.packet_type)

    @property
    def n_ofdm_sym(self) -> int:
        return self.packet_params.n_ofdm_sym


def encode_frame(spec: FrameSpec, payload: jax.Array, scrambler_seed) -> jax.Array:
    """(..., payload_bytes) uint8 + seed → (..., n_ofdm_sym, 48) complex symbols.

    ``scrambler_seed``: traced int in 1..127 (the reference increments one per
    frame, lib/stream_encoder_impl.cc:171-175).
    """
    pp = spec.packet_params
    mp = spec.mcs_params
    batch_shape = payload.shape[:-1]

    fcs = coding.crc32_bytes(payload)  # (...,) uint32
    fcs_bytes = jnp.stack(
        [(fcs >> (8 * k)).astype(jnp.uint8) for k in range(4)], axis=-1
    )  # little-endian, matching the memcpy append (lib/stream_encoder_impl.cc:155)
    pdu = jnp.concatenate([payload.astype(jnp.uint8), fcs_bytes], axis=-1)

    bits = jnp.zeros((*batch_shape, pp.n_data_bits), jnp.uint8)
    bits = bits.at[..., 16 : 16 + 8 * pp.data_size_byte].set(coding.bytes_to_bits(pdu))

    scrambled = coding.scramble(bits, scrambler_seed)
    tail0 = pp.n_data_bits - pp.n_pad_bits - 6
    scrambled = scrambled.at[..., tail0 : tail0 + 6].set(0)  # reset_tail_bits

    coded = coding.puncture(coding.conv_encode(scrambled), spec.mcs)
    values = coding.split_symbols(coded, mp.n_bpsc)
    syms = modulation.modulate(values, spec.mcs)
    return syms.reshape(*batch_shape, pp.n_ofdm_sym, mp.n_data_carriers)


def make_payload(spec: FrameSpec, data: bytes) -> np.ndarray:
    """Host helper: pack python bytes (first byte = packet type, as the UDP
    PDU convention, lib/stream_encoder_impl.cc:109-118) to the spec length."""
    assert len(data) <= spec.payload_bytes
    buf = np.zeros(spec.payload_bytes, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf
