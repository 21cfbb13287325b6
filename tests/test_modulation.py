"""Constellation map/demap: gr-digital table parity and roundtrips."""
import numpy as np

from jrc.config import MCS
from jrc.ops import modulation


def test_bpsk_table():
    pts = modulation.constellation(1)
    np.testing.assert_allclose(pts, [-1, 1])


def test_qpsk_tx_scaling():
    # reference halves gr-digital QPSK points (lib/stream_encoder_impl.cc:219-221)
    pts = modulation.constellation(2, tx_scale=True)
    np.testing.assert_allclose(np.abs(pts), 0.5, rtol=1e-6)
    # Gray mapping: bit0 = sign(re), bit1 = sign(im)
    assert pts[0].real < 0 and pts[0].imag < 0
    assert pts[1].real > 0 and pts[1].imag < 0
    assert pts[2].real < 0 and pts[2].imag > 0
    assert pts[3].real > 0 and pts[3].imag > 0


def test_qam16_unit_power():
    pts = modulation.constellation(4)
    np.testing.assert_allclose(np.mean(np.abs(pts) ** 2), 1.0, rtol=1e-6)
    assert len(np.unique(np.round(pts, 6))) == 16


def test_map_demap_roundtrip(rng):
    for mcs in MCS:
        n_vals = 2 ** [1, 1, 2, 2, 4, 4][mcs]
        vals = rng.integers(0, n_vals, 256)
        syms = modulation.modulate(vals, mcs)
        # demap must invert even with the TX scaling (nearest point is scale-robust
        # for PSK; for 16-QAM TX and decision tables coincide)
        got = np.asarray(modulation.hard_decision(np.asarray(syms), mcs))
        np.testing.assert_array_equal(got, vals)


def test_demap_with_noise(rng):
    vals = rng.integers(0, 4, 2000)
    syms = np.asarray(modulation.modulate(vals, MCS.QPSK_1_2)) * 2.0  # undo tx scale
    noisy = syms + (rng.normal(0, 0.05, 2000) + 1j * rng.normal(0, 0.05, 2000))
    got = np.asarray(modulation.hard_decision(noisy, MCS.QPSK_1_2))
    assert (got == vals).mean() > 0.999


def test_soft_llr_signs(rng):
    vals = rng.integers(0, 16, 500)
    syms = np.asarray(modulation.modulate(vals, MCS.QAM16_1_2))
    llrs = np.asarray(modulation.soft_llr(syms, MCS.QAM16_1_2))
    bits = np.asarray(modulation.hard_decision(syms, MCS.QAM16_1_2))
    from jrc.ops.coding import merge_symbols

    hard_bits = np.asarray(merge_symbols(bits, 4))
    np.testing.assert_array_equal((llrs > 0).astype(np.uint8), hard_bits)
