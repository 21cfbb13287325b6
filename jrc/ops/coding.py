"""Bit-level codec kernels: scrambler, convolutional code, puncturing, CRC-32.

JAX-native reimplementation of the reference's bit pipeline
(``lib/utils.cc:137-293``, ``lib/stream_encoder_impl.cc:168-222``,
``lib/stream_decoder_impl.cc:409-433``). Everything is expressed as batched
array ops over int8/int32 lanes — no per-bit Python or scan where a gather or
a shifted-XOR suffices:

* **scrambler** — the 7-bit LFSR x^7+x^4+1 output is periodic with period 127,
  so scrambling is a single gather from a precomputed cycle at a seed-dependent
  phase (instead of the reference's sequential loop, lib/utils.cc:175-186).
* **convolutional encoder** — K=7 polys 0o155/0o117 as XOR of 7 shifted copies
  of the input (lib/utils.cc:207-217).
* **puncturing** — rate-3/4 drops i%6 ∈ {3,4} (lib/utils.cc:220-248); static
  gather/scatter index maps.
* **CRC-32** — boost::crc_32_type (= IEEE reflected CRC-32); in-jit via a
  byte-table ``lax.scan`` for streaming checks, host-side via ``zlib.crc32``.
"""
from __future__ import annotations

import zlib
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import CONV_POLY_A, CONV_POLY_B, MCS, CODE_RATE

# ---------------------------------------------------------------------------
# Scrambler (7-bit LFSR x^7 + x^4 + 1)
# ---------------------------------------------------------------------------


def _lfsr_feedback(state: int) -> int:
    return ((state >> 6) ^ (state >> 3)) & 1


@lru_cache(maxsize=1)
def _scrambler_tables():
    """(cycle[127] uint8, phase[128] int32, state_at[127] int32).

    ``cycle`` is the periodic LFSR output; ``phase[s]`` is the index into the
    cycle at which the output of an LFSR seeded with state ``s`` starts;
    ``state_at[i]`` inverts it (the state whose phase is ``i``).
    ``phase[0] = 0`` is a dummy (all-zero state never occurs for seeds 1..127).
    """
    cycle = np.zeros(127, np.uint8)
    phase = np.zeros(128, np.int32)
    state_at = np.zeros(127, np.int32)
    state = 1
    for i in range(127):
        phase[state] = i
        state_at[i] = state
        fb = _lfsr_feedback(state)
        cycle[i] = fb
        state = ((state << 1) & 0x7E) | fb
    assert state == 1
    return cycle, phase, state_at


def scramble_sequence(seed, n: int) -> jax.Array:
    """LFSR output bits of length ``n`` for (possibly traced) ``seed`` ∈ 1..127."""
    cycle, phase, _ = _scrambler_tables()
    cycle = jnp.asarray(cycle, jnp.uint8)
    phase_t = jnp.asarray(phase, jnp.int32)
    p = phase_t[jnp.asarray(seed, jnp.int32)]
    idx = (p + jnp.arange(n, dtype=jnp.int32)) % 127
    return cycle[idx]


def scramble(bits: jax.Array, seed) -> jax.Array:
    """XOR ``bits`` (..., n) with the LFSR sequence for ``seed``.

    Equivalent to reference ``scramble()`` (lib/utils.cc:175-186). Involutive:
    scrambling twice with the same seed is the identity.
    """
    seq = scramble_sequence(seed, bits.shape[-1])
    return jnp.bitwise_xor(bits.astype(jnp.uint8), seq)


@lru_cache(maxsize=32)
def _descramble_basis(n: int) -> np.ndarray:
    """(7, n) LFSR output basis: row j is the sequence from initial state
    e_j = bit j of the MSB-first packed state. The LFSR is linear over
    GF(2), so the sequence for any state is the XOR of the rows whose state
    bits are set."""
    cycle, phase, _ = _scrambler_tables()
    basis = np.zeros((7, n), np.uint8)
    for j in range(7):
        s = 1 << (6 - j)  # MSB-first packing
        idx = (phase[s] + np.arange(n)) % 127
        basis[j] = cycle[idx]
    return basis


def descramble(bits: jax.Array) -> jax.Array:
    """Self-synchronizing descramble: recover LFSR state from the first 7 bits.

    The first 16 data bits pre-scramble are the all-zero SERVICE field, so the
    first 7 received bits are the raw LFSR output; the reference packs them
    MSB-first into the state (lib/stream_decoder_impl.cc:409-433) and
    descrambles from bit 7 on. Returns bits with positions 0..6 zeroed.

    The LFSR is linear over GF(2), so the seed-dependent sequence is the XOR
    of 7 static basis sequences selected by the recovered state bits — pure
    elementwise work instead of a per-frame phase gather.
    """
    n = bits.shape[-1]
    bits = bits.astype(jnp.uint8)
    basis = _descramble_basis(n - 7)  # (7, n-7) numpy constants
    seq = jnp.zeros_like(bits[..., 7:])
    for j in range(7):
        seq = seq ^ (bits[..., j : j + 1] & jnp.asarray(basis[j]))
    head = jnp.zeros_like(bits[..., :7])
    return jnp.concatenate([head, jnp.bitwise_xor(bits[..., 7:], seq)], axis=-1)


def recover_scrambler_seed(bits: jax.Array) -> jax.Array:
    """Initial LFSR state (the TX ``scrambler_seed``) from the first 7
    received data bits.

    The SERVICE field is all-zero pre-scramble, so the first 7 received
    bits are the LFSR's first 7 OUTPUTS. Packing them MSB-first (the
    reference's register reconstruction,
    lib/stream_decoder_impl.cc:409-433) yields the register state AFTER
    those 7 shifts — the cycle phase must step back 7 to report the state
    the TX actually seeded (its per-frame incrementing seed,
    lib/stream_encoder_impl.cc:171-175). Garbage input maps to some state
    in 1..127; gate on CRC as always.
    """
    _, phase, state_at = _scrambler_tables()
    weights = 1 << jnp.arange(6, -1, -1, dtype=jnp.int32)
    s7 = jnp.sum(bits[..., :7].astype(jnp.int32) * weights, axis=-1)
    p0 = (jnp.asarray(phase)[s7] - 7) % 127
    return jnp.asarray(state_at)[p0]


# ---------------------------------------------------------------------------
# Convolutional encoder (K=7, 0o155 / 0o117)
# ---------------------------------------------------------------------------

_TAPS_A = tuple(k for k in range(7) if (CONV_POLY_A >> k) & 1)  # (0, 2, 3, 5, 6)
_TAPS_B = tuple(k for k in range(7) if (CONV_POLY_B >> k) & 1)  # (0, 1, 2, 3, 6)


def conv_encode(bits: jax.Array) -> jax.Array:
    """Rate-1/2 convolutional encode: (..., n) bits → (..., 2n) coded bits.

    Matches reference ``convolutional_encoding`` (lib/utils.cc:207-217):
    out[2i] = parity(state & 0o155), out[2i+1] = parity(state & 0o117) where
    state holds in[i-6..i]. Implemented as XOR of shifted input copies —
    fully parallel, elementwise.
    """
    b = bits.astype(jnp.uint8)

    def branch(taps):
        acc = jnp.zeros_like(b)
        for k in taps:
            if k == 0:
                acc = acc ^ b
            else:
                shifted = jnp.pad(b[..., :-k], [(0, 0)] * (b.ndim - 1) + [(k, 0)])
                acc = acc ^ shifted
        return acc

    out_a = branch(_TAPS_A)
    out_b = branch(_TAPS_B)
    return jnp.stack([out_a, out_b], axis=-1).reshape(*b.shape[:-1], 2 * b.shape[-1])


# ---------------------------------------------------------------------------
# Puncturing / depuncturing
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _puncture_keep_idx(n_coded: int) -> np.ndarray:
    """Indices kept by the rate-3/4 puncturer (drop i%6 ∈ {3,4}),
    reference lib/utils.cc:220-248."""
    i = np.arange(n_coded)
    return i[(i % 6 != 3) & (i % 6 != 4)].astype(np.int32)


def puncture(coded: jax.Array, mcs: MCS) -> jax.Array:
    """Apply the per-MCS puncturing pattern to (..., 2n) coded bits.

    The rate-3/4 pattern is period-6 (drop i%6 ∈ {3,4}), so puncturing is a
    reshape + column slice — no index gather."""
    if CODE_RATE[mcs] == (1, 2):
        return coded
    n = coded.shape[-1]
    n_keep = len(_puncture_keep_idx(n))
    m6 = -(-n // 6)
    c = jnp.concatenate(
        [coded, jnp.zeros((*coded.shape[:-1], 6 * m6 - n), coded.dtype)],
        axis=-1,
    ) if 6 * m6 != n else coded
    c = c.reshape(*coded.shape[:-1], m6, 6)
    out = jnp.concatenate([c[..., :3], c[..., 5:6]], axis=-1)
    return out.reshape(*coded.shape[:-1], 4 * m6)[..., :n_keep]


def depuncture(bits: jax.Array, mcs: MCS, n_coded: int, erasure=0) -> jax.Array:
    """Re-insert erasures at punctured positions → (..., n_coded).

    ``erasure`` marks positions with no channel information; the Viterbi
    branch metric must treat them as zero-cost (see ops/viterbi.py).
    Period-6 pattern ⇒ pure reshape/concat (the index scatter this replaces
    was ~6× the demod cost of the SIG-driven executor, which evaluates all
    MCS branches under the batched ``lax.switch``)."""
    if CODE_RATE[mcs] == (1, 2):
        assert bits.shape[-1] == n_coded
        return bits
    m6 = -(-n_coded // 6)
    pad = 4 * m6 - bits.shape[-1]
    b = bits
    if pad:
        b = jnp.concatenate(
            [b, jnp.full((*b.shape[:-1], pad), erasure, b.dtype)], axis=-1
        )
    b = b.reshape(*bits.shape[:-1], m6, 4)
    e = jnp.full((*bits.shape[:-1], m6, 1), erasure, bits.dtype)
    out = jnp.concatenate([b[..., :3], e, e, b[..., 3:4]], axis=-1)
    return out.reshape(*bits.shape[:-1], 6 * m6)[..., :n_coded]


@lru_cache(maxsize=None)
def _interleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    """802.11-style two-step interleaver permutation (reference
    lib/utils.cc:251-275). out[k] = in[second[first[k]]]."""
    s = max(n_bpsc // 2, 1)
    j = np.arange(n_cbps)
    first = s * (j // s) + (j + (16 * j // n_cbps)) % s
    i = np.arange(n_cbps)
    second = 16 * i - (n_cbps - 1) * (16 * i // n_cbps)
    return second[first].astype(np.int32)


def interleave(bits: jax.Array, n_cbps: int, n_bpsc: int, reverse: bool = False) -> jax.Array:
    """Per-symbol block interleaver. Present for parity: the reference ships
    this but never enables it (lib/stream_encoder_impl.cc:183-184 commented
    out; no deinterleave at lib/stream_decoder_impl.cc:267)."""
    perm = _interleave_perm(n_cbps, n_bpsc)
    n_sym = bits.shape[-1] // n_cbps
    b = bits.reshape(*bits.shape[:-1], n_sym, n_cbps)
    if reverse:
        inv = np.argsort(perm).astype(np.int32)
        out = b[..., jnp.asarray(inv)]
    else:
        out = b[..., jnp.asarray(perm)]
    return out.reshape(*bits.shape)


def depuncture_mask(mcs: MCS, n_coded: int) -> np.ndarray:
    """Boolean mask (n_coded,) of positions carrying real channel bits."""
    m = np.zeros(n_coded, bool)
    if CODE_RATE[mcs] == (1, 2):
        m[:] = True
    else:
        m[_puncture_keep_idx(n_coded)] = True
    return m


# ---------------------------------------------------------------------------
# CRC-32 (boost::crc_32_type == IEEE 802.3 reflected CRC-32)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _crc32_table() -> np.ndarray:
    poly = 0xEDB88320
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        tab[i] = c
    return tab


def crc32_host(data: bytes) -> int:
    """Host-side CRC-32, identical to boost::crc_32_type (zlib.crc32)."""
    return zlib.crc32(data) & 0xFFFFFFFF


@lru_cache(maxsize=8)
def _crc32_linear_tables(n_max: int):
    """CRC-32 is linear over GF(2), so the register after a message is the
    XOR of per-byte contributions that depend only on (byte value, distance
    from the message end) plus a length-dependent init term:

        crc(msg[:L]) = E[L] ⊕ ⨁_j T[L−1−j, msg[j]] ⊕ 0xFFFFFFFF

    T[d, v] = register from byte v propagated through d trailing zero bytes
    (starting register 0); E[L] = the 0xFFFFFFFF init register propagated
    through L zero bytes. Returns (T (n_max, 256), E (n_max+1,)) uint32.
    """
    tab = _crc32_table()

    def zstep(crc):
        return tab[crc & 0xFF] ^ (crc >> 8)

    T = np.zeros((n_max, 256), np.uint64)
    T[0] = tab.astype(np.uint64)
    for d in range(1, n_max):
        T[d] = zstep(T[d - 1].astype(np.uint32)).astype(np.uint64)
    E = np.zeros(n_max + 1, np.uint64)
    E[0] = 0xFFFFFFFF
    for i in range(1, n_max + 1):
        E[i] = zstep(np.uint32(E[i - 1]))
    return T.astype(np.uint32), E.astype(np.uint32)


def crc32_bytes(data: jax.Array, n_valid=None) -> jax.Array:
    """In-jit CRC-32 over (..., n) uint8 byte arrays.

    ``n_valid`` (traced or static) limits the CRC to the first bytes; trailing
    bytes are skipped so frames of different byte lengths share a single
    compiled program.

    Uses the GF(2)-linear decomposition (one small-table gather + XOR-tree
    reduce) instead of a byte-serial table scan of ~n sequential steps.
    """
    n = data.shape[-1]
    T_np, E_np = _crc32_linear_tables(n)
    data = data.astype(jnp.int32)
    if n_valid is None:
        n_valid = n
    n_valid = jnp.asarray(n_valid, jnp.int32)
    j = jnp.arange(n, dtype=jnp.int32)
    d = n_valid[..., None] - 1 - j  # distance from message end
    flat = jnp.clip(d, 0, n - 1) * 256 + data
    contrib = jnp.asarray(T_np.reshape(-1))[flat]
    contrib = jnp.where(d >= 0, contrib, jnp.uint32(0))
    crc = jax.lax.reduce(
        contrib, np.uint32(0), jax.lax.bitwise_xor, (contrib.ndim - 1,)
    )
    init = jnp.asarray(E_np)[jnp.clip(n_valid, 0, n)]
    return crc ^ init ^ jnp.uint32(0xFFFFFFFF)


def crc32_check_residue(payload_with_fcs: jax.Array, n_valid=None) -> jax.Array:
    """True iff CRC over payload+FCS leaves the magic residue 558161692
    (reference lib/stream_decoder_impl.cc:279-281)."""
    return crc32_bytes(payload_with_fcs, n_valid) == jnp.uint32(558161692)


# ---------------------------------------------------------------------------
# Bit/byte packing helpers
# ---------------------------------------------------------------------------


def bytes_to_bits(data: jax.Array) -> jax.Array:
    """(..., n) uint8 bytes → (..., 8n) bits, LSB-first per byte
    (reference generate_bits, lib/utils.cc:166-172)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).astype(jnp.uint8)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """(..., 8n) bits → (..., n) uint8 bytes, LSB-first per byte."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).astype(jnp.uint32)
    weights = (1 << jnp.arange(8, dtype=jnp.uint32))
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def split_symbols(bits: jax.Array, n_bpsc: int) -> jax.Array:
    """Group coded bits into constellation symbol values, LSB-first
    (reference split_symbols, lib/utils.cc:278-293)."""
    n_sym = bits.shape[-1] // n_bpsc
    b = bits[..., : n_sym * n_bpsc].reshape(*bits.shape[:-1], n_sym, n_bpsc)
    weights = (1 << jnp.arange(n_bpsc, dtype=jnp.int32))
    return jnp.sum(b.astype(jnp.int32) * weights, axis=-1)


def merge_symbols(values: jax.Array, n_bpsc: int) -> jax.Array:
    """Inverse of :func:`split_symbols`: symbol values → bits, LSB-first
    (reference lib/stream_decoder_impl.cc:259-265)."""
    shifts = jnp.arange(n_bpsc, dtype=jnp.int32)
    bits = (values[..., :, None] >> shifts) & 1
    return bits.reshape(*values.shape[:-1], values.shape[-1] * n_bpsc).astype(jnp.uint8)
