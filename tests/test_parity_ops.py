"""Parity ops the reference ships but the main chains bypass."""
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import coding, radar
from jrc.ops.precoder import assemble_siso_frame
from tests.golden import golden_interleave

CFG = OFDMConfig()


def test_interleave_matches_golden(rng):
    for n_bpsc in (1, 2, 4):
        n_cbps = 48 * n_bpsc
        bits = rng.integers(0, 2, 3 * n_cbps).astype(np.uint8)
        got = np.asarray(coding.interleave(jnp.asarray(bits), n_cbps, n_bpsc))
        want = golden_interleave(bits, n_cbps, n_bpsc)
        np.testing.assert_array_equal(got, want)


def test_interleave_roundtrip(rng):
    n_cbps, n_bpsc = 96, 2
    bits = rng.integers(0, 2, 2 * n_cbps).astype(np.uint8)
    fwd = coding.interleave(jnp.asarray(bits), n_cbps, n_bpsc)
    back = np.asarray(coding.interleave(fwd, n_cbps, n_bpsc, reverse=True))
    np.testing.assert_array_equal(back, bits)


def test_corner_turn():
    v = jnp.arange(8 * 512).reshape(8, 512).astype(jnp.complex64)
    out = np.asarray(radar.corner_turn(v, interp_factor=16))
    assert out.shape == (512, 128)
    np.testing.assert_array_equal(out[:, :8], np.asarray(v).T)
    assert np.abs(out[:, 8:]).max() == 0


def test_siso_frame_layout(rng):
    data = (rng.normal(size=(3, 48)) + 1j * rng.normal(size=(3, 48))).astype(np.complex64)
    grid = np.asarray(assemble_siso_frame(CFG, jnp.asarray(data)))
    assert grid.shape == (4 + 3, 64)
    np.testing.assert_allclose(grid[:4], CFG.sync_words_freq, atol=1e-6)
    np.testing.assert_allclose(grid[4:, CFG.data_carrier_idx], data, atol=1e-6)
