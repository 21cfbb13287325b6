"""Viterbi decoder: encode→decode identities, puncturing, noise, batching."""
import numpy as np

from jrc.config import MCS
from jrc.ops import coding, viterbi


def _roundtrip(bits, mcs):
    coded = coding.conv_encode(bits)
    punct = coding.puncture(coded, mcs)
    return np.asarray(viterbi.decode_bits(punct, mcs, bits.shape[-1]))


def test_rate_half_identity(rng):
    bits = rng.integers(0, 2, 240).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(bits, MCS.BPSK_1_2), bits)


def test_rate_34_identity(rng):
    bits = rng.integers(0, 2, 288).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(bits, MCS.QPSK_3_4), bits)


def test_batched_identity(rng):
    bits = rng.integers(0, 2, (5, 144)).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(bits, MCS.QAM16_3_4), bits)


def test_corrects_bit_errors(rng):
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    coded = np.array(coding.conv_encode(bits))
    # flip a few well-separated coded bits
    for pos in (10, 70, 130, 330):
        coded[pos] ^= 1
    out = np.asarray(viterbi.decode_bits(coded, MCS.BPSK_1_2, 200))
    np.testing.assert_array_equal(out, bits)


def test_soft_decisions_beat_hard(rng):
    """Soft-decision decode with confidence-weighted values should fix a
    pattern hard decisions cannot."""
    bits = rng.integers(0, 2, 150).astype(np.uint8)
    coded = np.asarray(coding.conv_encode(bits)).astype(np.float32)
    values = 2.0 * coded - 1.0
    noise = rng.normal(0, 0.7, values.shape).astype(np.float32)
    noisy = values + noise
    soft = np.asarray(viterbi.viterbi_decode(noisy, n_out=150))
    # soft decoding at this SNR should be error-free with very high probability
    assert (soft != bits).mean() < 0.02


def test_long_frame(rng):
    """Metrics renormalization keeps long frames stable (max payload scale)."""
    bits = rng.integers(0, 2, 4096).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(bits, MCS.QPSK_1_2), bits)


def test_chunked_matches_vanilla(rng):
    """viterbi_decode_chunked is bit-identical to the sequential decoder."""
    for T, B, L in [(200, 1, 64), (576, 4, 128), (1531, 2, 100)]:
        bits = rng.integers(0, 2, (B, T)).astype(np.uint8)
        coded_arr = np.asarray(coding.conv_encode(bits)).astype(np.float32)
        vals = 2 * coded_arr - 1 + rng.normal(0, 0.5, coded_arr.shape).astype(np.float32)
        v1 = np.asarray(viterbi.viterbi_decode(vals, n_out=T))
        v2 = np.asarray(viterbi.viterbi_decode_chunked(vals, n_out=T, chunk_len=L))
        np.testing.assert_array_equal(v1, v2)


def test_pallas_kernel_matches_vanilla(rng):
    """The Triton Viterbi kernel (Pallas interpreter) is bit-identical to
    the XLA scan on noisy codewords."""
    from jrc.ops import viterbi_pallas

    bits = rng.integers(0, 2, (3, 300)).astype(np.uint8)
    coded_arr = np.asarray(coding.conv_encode(bits)).astype(np.float32)
    vals = 2 * coded_arr - 1 + rng.normal(0, 0.4, coded_arr.shape).astype(np.float32)
    v1 = np.asarray(viterbi.viterbi_decode(vals, n_out=300))
    v2 = np.asarray(viterbi_pallas.viterbi_decode_pallas(
        vals, n_out=300, unroll=2, interpret=True))
    np.testing.assert_array_equal(v1, v2)
