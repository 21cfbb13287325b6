"""OFDM symbol-level ops: carrier allocation, IFFT/CP, CP-strip/FFT.

Replaces the reference's per-antenna chains of stock GNU Radio blocks
(``fft_vxx`` + ``digital_ofdm_cyclic_prefixer`` on TX, ``stream_to_vector`` +
``fft_vxx`` on RX, and ``lib/ofdm_cyclic_prefix_remover_impl.cc``) with batched
pair-form array ops over a (..., n_sym, fft_len) frequency grid. All
transforms are 64-point DFT **matmuls** with the fftshift fused into the
constant matrix (see ops/cplx.py) — one matmul per frame instead of
the reference's per-symbol FFTW calls.

Conventions:
* frequency grids are **fft-shifted** (DC at index fft_len/2), matching the
  reference's shifted fft_vxx blocks and carrier index tables
  (lib/mimo_precoder_impl.cc:126-152);
* transforms are unitary (norm="ortho"). The reference's absolute scaling
  (unnormalized FFTW + 1/sqrt(64) window) differs by a constant factor only,
  which washes out in channel estimation/equalization.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import cplx as cx


@lru_cache(maxsize=None)
def _fwd_mats(fft_len: int):
    """fftshift(fft(x, ortho)) as one matrix pair."""
    return cx.dft_mats(fft_len, shift_out=True)


@lru_cache(maxsize=None)
def _inv_mats(fft_len: int):
    """ifft(ifftshift(grid), ortho) as one matrix pair."""
    return cx.dft_mats(fft_len, inverse=True, shift_in=True)


def allocate_carriers(
    cfg: OFDMConfig,
    data_syms: cx.CArray,
    pilot_row0: int = 0,
) -> cx.CArray:
    """Scatter data symbols + scheduled pilots into the shifted FFT grid.

    ``data_syms``: (..., n_sym, n_data_carriers) → (..., n_sym, fft_len).
    Pilot for OFDM symbol k is schedule row ``(pilot_row0 + k) % 127``
    (reference lib/mimo_precoder_impl.cc data/pilot copy loops).
    """
    data_syms = cx.from_complex(data_syms)
    n_sym = data_syms.shape[-2]
    grid = cx.zeros((*data_syms.shape[:-1], cfg.fft_len))
    grid = grid.at[..., jnp.asarray(cfg.data_carrier_idx)].set(data_syms)
    sched = cx.from_complex(np.asarray(cfg.pilot_symbols))  # (127, n_pilot)
    rows = (pilot_row0 + jnp.arange(n_sym)) % sched.shape[0]
    pilots = sched[rows]  # (n_sym, n_pilot)
    grid = grid.at[..., jnp.asarray(cfg.pilot_carrier_idx)].set(
        cx.broadcast_to(pilots, (*grid.shape[:-1], cfg.n_pilot_carriers))
    )
    return grid


def extract_data_carriers(cfg: OFDMConfig, grid: cx.CArray) -> cx.CArray:
    """(..., fft_len) → (..., n_data_carriers)."""
    return grid[..., jnp.asarray(cfg.data_carrier_idx)]


def extract_pilot_carriers(cfg: OFDMConfig, grid: cx.CArray) -> cx.CArray:
    return grid[..., jnp.asarray(cfg.pilot_carrier_idx)]


def ofdm_modulate(cfg: OFDMConfig, grid: cx.CArray) -> cx.CArray:
    """Shifted frequency grid → time samples with cyclic prefix.

    (..., n_sym, fft_len) → (..., n_sym·(fft_len+cp_len)) flattened time
    stream per leading index. Equivalent of the reference's shifted IFFT
    ``fft_vxx`` + ``digital_ofdm_cyclic_prefixer`` per antenna.
    """
    grid = cx.from_complex(grid)
    x = cx.apply_dft(grid, _inv_mats(cfg.fft_len))
    with_cp = cx.concatenate([x[..., -cfg.cp_len :], x], axis=-1)
    return with_cp.reshape(*grid.shape[:-2], grid.shape[-2] * cfg.sym_len)


def ofdm_demodulate(cfg: OFDMConfig, samples: cx.CArray, n_sym: int) -> cx.CArray:
    """Time samples → shifted frequency grid, dropping each symbol's CP.

    (..., n_sym·sym_len) → (..., n_sym, fft_len). Equivalent of
    ``ofdm_cyclic_prefix_remover`` (lib/ofdm_cyclic_prefix_remover_impl.cc:69)
    + shifted forward ``fft_vxx``.
    """
    samples = cx.from_complex(samples)
    x = samples[..., : n_sym * cfg.sym_len].reshape(
        *samples.shape[:-1], n_sym, cfg.sym_len
    )
    x = x[..., cfg.cp_len :]
    return cx.apply_dft(x, _fwd_mats(cfg.fft_len))


def zero_pad(
    samples: cx.CArray, pad_front: int, pad_tail: int, rng_key=None, noise_std: float = 0.1
) -> cx.CArray:
    """Pad a frame with low-power complex Gaussian noise samples front/tail
    (reference zero_pad, lib/zero_pad_impl.cc:61-94; N(0, 1e-2) variance ⇒
    std 0.1 per quadrature pair)."""
    import jax.random as jr

    samples = cx.from_complex(samples)
    shape_f = (*samples.shape[:-1], pad_front)
    shape_t = (*samples.shape[:-1], pad_tail)
    if rng_key is None:
        front = cx.zeros(shape_f)
        tail = cx.zeros(shape_t)
    else:
        k1, k2, k3, k4 = jr.split(rng_key, 4)
        s = noise_std / np.sqrt(2.0)
        front = cx.CArray(s * jr.normal(k1, shape_f), s * jr.normal(k2, shape_f))
        tail = cx.CArray(s * jr.normal(k3, shape_t), s * jr.normal(k4, shape_t))
    return cx.concatenate([front, samples, tail], axis=-1)


def fft_symbols(cfg: OFDMConfig, sym_samples: cx.CArray) -> cx.CArray:
    """CP-less (..., fft_len) symbol samples → shifted spectrum (as the RX
    chain's forward fft_vxx after frame_sync already stripped CPs)."""
    return cx.apply_dft(cx.from_complex(sym_samples), _fwd_mats(cfg.fft_len))
