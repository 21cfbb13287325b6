"""Codec kernels vs golden scalar oracles (formulas of reference lib/utils.cc)."""
import numpy as np
import pytest

from jrc.config import MCS, MCSParams, PacketParams, PacketType
from jrc.ops import coding
from tests.golden import golden_conv_encode, golden_puncture_34, golden_scramble


def test_scramble_matches_golden(rng):
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    for seed in [1, 7, 64, 127]:
        got = np.asarray(coding.scramble(bits, seed))
        want = golden_scramble(bits, seed)
        np.testing.assert_array_equal(got, want)


def test_scramble_involution(rng):
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    out = coding.scramble(coding.scramble(bits, 42), 42)
    np.testing.assert_array_equal(np.asarray(out), bits)


def test_descramble_recovers(rng):
    # data with 16 leading service zeros, like generate_bits
    data = np.concatenate([np.zeros(16, np.uint8), rng.integers(0, 2, 400).astype(np.uint8)])
    for seed in [1, 55, 127]:
        scrambled = np.asarray(coding.scramble(data, seed))
        recovered = np.asarray(coding.descramble(scrambled))
        np.testing.assert_array_equal(recovered[16:], data[16:])


def test_conv_encode_matches_golden(rng):
    bits = rng.integers(0, 2, 256).astype(np.uint8)
    got = np.asarray(coding.conv_encode(bits))
    want = golden_conv_encode(bits)
    np.testing.assert_array_equal(got, want)


def test_conv_encode_batched(rng):
    bits = rng.integers(0, 2, (3, 128)).astype(np.uint8)
    got = np.asarray(coding.conv_encode(bits))
    for i in range(3):
        np.testing.assert_array_equal(got[i], golden_conv_encode(bits[i]))


def test_puncture_matches_golden(rng):
    bits = rng.integers(0, 2, 288).astype(np.uint8)
    got = np.asarray(coding.puncture(bits, MCS.QPSK_3_4))
    np.testing.assert_array_equal(got, golden_puncture_34(bits))
    # rate 1/2 is identity
    np.testing.assert_array_equal(np.asarray(coding.puncture(bits, MCS.QPSK_1_2)), bits)


def test_depuncture_roundtrip(rng):
    n_coded = 288
    bits = rng.integers(0, 2, n_coded).astype(np.int32)
    p = coding.puncture(bits, MCS.BPSK_3_4)
    d = np.asarray(coding.depuncture(p, MCS.BPSK_3_4, n_coded, erasure=-1))
    keep = d != -1
    np.testing.assert_array_equal(d[keep], bits[keep])
    assert keep.sum() == n_coded * 2 // 3  # rate 3/4 keeps 4 of every 6 coded bits
    assert (~keep).sum() == n_coded // 3


def test_crc32_matches_zlib(rng):
    data = rng.integers(0, 256, 100).astype(np.uint8)
    got = int(np.asarray(coding.crc32_bytes(data)))
    assert got == coding.crc32_host(data.tobytes())


def test_crc32_residue():
    import zlib

    payload = b"hello jrc world"
    fcs = zlib.crc32(payload).to_bytes(4, "little")
    arr = np.frombuffer(payload + fcs, np.uint8)
    assert bool(np.asarray(coding.crc32_check_residue(arr)))
    bad = arr.copy()
    bad[3] ^= 1
    assert not bool(np.asarray(coding.crc32_check_residue(bad)))


def test_crc32_masked_length(rng):
    data = rng.integers(0, 256, 64).astype(np.uint8)
    padded = np.concatenate([data, np.full(32, 0xAB, np.uint8)])
    got = int(np.asarray(coding.crc32_bytes(padded, n_valid=64)))
    assert got == coding.crc32_host(data.tobytes())


def test_bit_packing_roundtrip(rng):
    data = rng.integers(0, 256, 32).astype(np.uint8)
    bits = coding.bytes_to_bits(data)
    np.testing.assert_array_equal(np.asarray(coding.bits_to_bytes(bits)), data)


def test_split_merge_symbols(rng):
    bits = rng.integers(0, 2, 96).astype(np.uint8)
    for n_bpsc in (1, 2, 4):
        vals = coding.split_symbols(bits, n_bpsc)
        back = np.asarray(coding.merge_symbols(vals, n_bpsc))
        np.testing.assert_array_equal(back, bits)


def test_packet_params_match_reference_math():
    # reference lib/utils.cc:26-53 formulas
    m = MCSParams(MCS.QPSK_3_4)
    assert (m.n_bpsc, m.n_cbps, m.n_dbps) == (2, 96, 72)
    p = PacketParams(m, data_size_byte=104, packet_type=PacketType.DATA)
    assert p.n_ofdm_sym == int(np.ceil((16 + 8 * 104 + 6) / 72))
    assert p.n_data_bits == p.n_ofdm_sym * 72
    assert p.n_pad_bits == p.n_data_bits - (16 + 8 * 104 + 6)
    assert p.n_encoded_bits == p.n_ofdm_sym * 96


def test_recover_scrambler_seed_all_seeds():
    """The reported seed is the TX's INITIAL LFSR state for every valid
    seed (the recovered register must be stepped back 7 outputs — the
    naive MSB-first packing is the state AFTER the first 7 shifts)."""
    import jax
    import jax.numpy as jnp

    from jrc.ops.coding import recover_scrambler_seed, scramble

    zeros = jnp.zeros((127, 16), jnp.uint8)
    seeds = jnp.arange(1, 128, dtype=jnp.int32)
    scrambled = jax.vmap(scramble)(zeros, seeds)
    got = recover_scrambler_seed(scrambled)
    np.testing.assert_array_equal(np.asarray(got), np.arange(1, 128))
