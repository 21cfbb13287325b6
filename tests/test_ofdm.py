"""OFDM modulate/demodulate and carrier allocation."""
import numpy as np
import jax.numpy as jnp

from jrc.config import OFDMConfig
from jrc.ops import ofdm


def test_modulate_demodulate_roundtrip(rng):
    cfg = OFDMConfig()
    grid = (rng.normal(size=(3, 5, 64)) + 1j * rng.normal(size=(3, 5, 64))).astype(np.complex64)
    t = ofdm.ofdm_modulate(cfg, jnp.asarray(grid))
    assert t.shape == (3, 5 * 80)
    back = ofdm.ofdm_demodulate(cfg, t, 5)
    np.testing.assert_allclose(np.asarray(back), grid, atol=1e-5)


def test_cp_is_cyclic(rng):
    cfg = OFDMConfig()
    grid = (rng.normal(size=(1, 64)) + 1j * rng.normal(size=(1, 64))).astype(np.complex64)
    t = np.asarray(ofdm.ofdm_modulate(cfg, jnp.asarray(grid)))
    np.testing.assert_allclose(t[:16], t[64:80], atol=1e-6)


def test_carrier_allocation_roundtrip(rng):
    cfg = OFDMConfig()
    data = (rng.normal(size=(4, 48)) + 1j * rng.normal(size=(4, 48))).astype(np.complex64)
    grid = ofdm.allocate_carriers(cfg, jnp.asarray(data))
    out = np.asarray(ofdm.extract_data_carriers(cfg, grid))
    np.testing.assert_allclose(out, data, atol=1e-7)
    # pilots follow the 127-row schedule
    pilots = np.asarray(ofdm.extract_pilot_carriers(cfg, grid))
    sched = cfg.pilot_symbols
    for k in range(4):
        np.testing.assert_allclose(pilots[k], sched[k % 127], atol=1e-7)
    # guard/DC carriers stay zero
    g = np.asarray(grid)
    used = np.concatenate([cfg.data_carrier_idx, cfg.pilot_carrier_idx])
    unused = np.setdiff1d(np.arange(64), used)
    assert np.abs(g[:, unused]).max() == 0


def test_zero_pad_lengths(rng):
    import jax

    cfg = OFDMConfig()
    x = jnp.ones((2, 100), jnp.complex64)
    y = ofdm.zero_pad(x, 10, 20, rng_key=jax.random.key(0))
    assert y.shape == (2, 130)
    # noise is low power
    assert float(abs(y[:, :10]).max()) < 1.0
    np.testing.assert_allclose(np.asarray(y[:, 10:110]), np.asarray(x))
