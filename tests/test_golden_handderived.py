"""Hand-derived golden vectors per codec stage.

Unlike tests/golden.py (a numpy re-implementation of the reference
algorithms — a shared misreading would pass both sides), every expected
value here was traced BY HAND from the reference C++ statements, register
step by register step, and is hard-coded as a literal. The derivations are
documented inline so they can be re-checked against the cited lines.
"""
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, PacketType
from jrc.ops import coding, modulation
from jrc.ops.encoder import FrameSpec
from jrc.ops.precoder import signal_field_symbols


def test_scrambler_sequence_seed1_hand_trace():
    """lib/utils.cc:175-186: state 7-bit, feedback = bit6 ^ bit3,
    state' = ((state<<1) & 0x7e) | feedback.

    Hand trace from initial_state = 1:
      state: 1→2→4→8→17→34→68→9→19→38→76→24→49→98→69→11→23
      fb   : 0  0  0  1  0   0   1  1  0   0   0   1   0   1   1   1
    """
    expected = [0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1]
    seq = np.asarray(coding.scramble_sequence(1, 16))
    np.testing.assert_array_equal(seq, expected)
    # scramble() of zero bits IS the sequence (out = fb ^ 0)
    out = np.asarray(coding.scramble(jnp.zeros(16, jnp.uint8), 1))
    np.testing.assert_array_equal(out, expected)


def test_conv_encoder_hand_trace():
    """lib/utils.cc:207-217: state = ((state<<1)&0x7e)|in[i];
    out[2i] = parity(state & 0o155), out[2i+1] = parity(state & 0o117).

    Hand trace for in = [1,0,1,1,0,0,0] (states 1,2,5,11,22,44,88):
      pairs: (1,1) (0,1) (0,0) (0,1) (1,0) (1,0) (0,0)
    Cross-checked via the shift-register identity
      out_a[i] = in[i]^in[i-2]^in[i-3]^in[i-5]^in[i-6],
      out_b[i] = in[i]^in[i-1]^in[i-2]^in[i-3]^in[i-6].
    """
    bits = jnp.asarray([1, 0, 1, 1, 0, 0, 0], jnp.uint8)
    expected = [1, 1, 0, 1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 0]
    np.testing.assert_array_equal(np.asarray(coding.conv_encode(bits)), expected)


def test_puncture_34_keep_positions():
    """lib/utils.cc:220-248: rate 3/4 keeps exactly the positions with
    i % 6 ∉ {3, 4} — for inputs 0..11 the survivors are 0,1,2,5,6,7,8,11."""
    vals = jnp.arange(12, dtype=jnp.float32)
    out = np.asarray(coding.puncture(vals, MCS.QPSK_3_4))
    np.testing.assert_array_equal(out, [0, 1, 2, 5, 6, 7, 8, 11])


def test_sig_field_qpsk34_len68_hand_trace():
    """lib/mimo_precoder_impl.cc:985-1060 for QPSK-3/4, 68-byte frame, DATA.

    Hand-assembled 24 header bits:
      rate_field(QPSK_3_4) = 0x07 (lib/utils.cc:87), stored MSB-first
        nibble → bits[0:4] = 0,1,1,1;
      packet_type_field(DATA) bit0 = 1 (lib/utils.cc:47) → bits[4] = 1;
      length 68 = 0b000001000100 LSB-first → bits[5:17] =
        0,0,1,0,0,0,1,0,0,0,0,0;
      even parity over bits[0:17]: six ones → bits[17] = 0;
      six zero tail bits.
    The SIG symbols are then the rate-1/2 conv code of those 24 bits
    (state machine from 0, no scrambling) BPSK-mapped — the encoder itself
    is pinned by test_conv_encoder_hand_trace.
    """
    header = np.array(
        [0, 1, 1, 1,
         1,
         0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0,
         0,
         0, 0, 0, 0, 0, 0], np.uint8)
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    assert spec.data_size_byte == 68  # payload + 4-byte CRC

    coded = np.asarray(coding.conv_encode(jnp.asarray(header)))
    expected_syms = np.asarray(modulation.constellation(1))[coded]
    got = signal_field_symbols(spec)
    np.testing.assert_allclose(got, expected_syms.astype(np.complex64))

    # and the receiver-side parse must invert the hand-assembled layout
    from jrc.ops.precoder import SIG_RATE_TO_MCS, parse_signal_field_bits

    bitmap, ptype, length, ok = parse_signal_field_bits(jnp.asarray(header))
    assert int(bitmap) == 0b1110  # header[0:4]=0,1,1,1 read LSB-first
    assert SIG_RATE_TO_MCS[int(bitmap)] is MCS.QPSK_3_4
    assert int(ptype) == 1 and int(length) == 68 and bool(ok)
