"""Stream decoder: equalized symbols → payload bytes + CRC verdict.

Batched equivalent of ``stream_decoder`` (lib/stream_decoder_impl.cc:103-407):
hard decision per carrier → bit unpack → Viterbi (with depuncturing) →
descramble → CRC-32 residue check → payload. Soft-decision decoding is also
available (capability upgrade; the reference is hard-decision only).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


from jrc.ops import coding, modulation
from jrc.ops.encoder import FrameSpec
from jrc.ops.viterbi import hard_to_values, viterbi_decode
from jrc.ops.coding import depuncture


class DecodedFrame(NamedTuple):
    payload: jax.Array  # (..., payload_bytes) uint8 (without CRC)
    crc_ok: jax.Array  # (...,) bool
    scrambler_seed: jax.Array  # (...,) int32 recovered initial LFSR state


def frame_values(
    spec: FrameSpec, z: jax.Array, soft: bool = False, noise_var=1.0
) -> jax.Array:
    """(..., n_data_sym, 48) equalized symbols → (..., 2·n_data_bits)
    depunctured channel values, ready for any Viterbi backend.

    Split out of :func:`decode_frame` so a caller batching many frames can
    run ONE flat Viterbi call over all of them (the Pallas kernel cannot
    sit under the per-frame vmap; see ops/viterbi_pallas.py)."""
    pp = spec.packet_params
    mp = spec.mcs_params
    zs = z.reshape(*z.shape[:-2], -1)  # (..., n_sym·48)
    if soft:
        llrs = modulation.soft_llr(zs, spec.mcs, noise_var)
        return depuncture(llrs, spec.mcs, 2 * pp.n_data_bits, erasure=0.0)
    vals = modulation.hard_decision(zs, spec.mcs)
    rx_bits = coding.merge_symbols(vals, mp.n_bpsc)
    return depuncture(
        hard_to_values(rx_bits), spec.mcs, 2 * pp.n_data_bits, erasure=0.0
    )


def frame_from_bits(spec: FrameSpec, decoded: jax.Array) -> DecodedFrame:
    """(..., n_data_bits) Viterbi output bits → payload + CRC verdict
    (descramble → CRC-32 residue; second half of :func:`decode_frame`)."""
    pp = spec.packet_params
    descrambled = coding.descramble(decoded)
    seed = coding.recover_scrambler_seed(decoded)

    n_bytes = pp.data_size_byte  # payload + 4 CRC
    data_bits = descrambled[..., 16 : 16 + 8 * n_bytes]
    pdu = coding.bits_to_bytes(data_bits)
    crc_ok = coding.crc32_check_residue(pdu)
    return DecodedFrame(payload=pdu[..., :-4], crc_ok=crc_ok, scrambler_seed=seed)


def decode_frame(
    spec: FrameSpec, z: jax.Array, soft: bool = False, noise_var=1.0
) -> DecodedFrame:
    """(..., n_data_sym, 48) equalized symbols → payload + CRC verdict."""
    values = frame_values(spec, z, soft=soft, noise_var=noise_var)
    decoded = viterbi_decode(values, n_out=spec.packet_params.n_data_bits)
    return frame_from_bits(spec, decoded)


class LinkStats(NamedTuple):
    """Rolling PER/SNR statistics (reference boost rolling_mean windows,
    lib/stream_decoder_impl.cc:63-64: PER window 25, SNR window 1)."""

    crc_history: jax.Array  # (window,) float32 of 0/1 failures
    count: jax.Array  # frames seen


def init_stats(window: int = 25) -> LinkStats:
    return LinkStats(crc_history=jnp.zeros(window, jnp.float32), count=jnp.int32(0))


def update_stats(stats: LinkStats, crc_ok) -> LinkStats:
    hist = jnp.roll(stats.crc_history, 1).at[0].set(1.0 - crc_ok)
    return LinkStats(crc_history=hist, count=stats.count + 1)


def per_percent(stats: LinkStats) -> jax.Array:
    n = jnp.minimum(stats.count, stats.crc_history.shape[0])
    return 100.0 * jnp.sum(stats.crc_history) / jnp.maximum(n, 1)
