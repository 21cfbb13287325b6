"""Constellation mapping / hard-decision demapping (complex-free pairs).

The reference uses gr-digital's ``constellation_bpsk/qpsk/16qam`` objects
(``lib/stream_encoder_impl.cc:58-60``, ``lib/stream_decoder_impl.cc:186-192``)
with one quirk: QPSK points are additionally halved at the encoder
(``lib/stream_encoder_impl.cc:219-221``). Tables below reproduce the
gr-digital 3.8 Gray mappings; demapping is a batched nearest-point argmin
(identical decisions to gr-digital's sign/region decision makers for these
grids) over (re, im) pair distances — a fused elementwise reduction.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, N_BPSC
from jrc.ops import cplx as cx

_SQRT_HALF = np.sqrt(0.5)
_QAM16_LEVEL = np.sqrt(0.1)


@lru_cache(maxsize=None)
def constellation(n_bpsc: int, tx_scale: bool = False) -> np.ndarray:
    """Constellation points indexed by symbol value (gr-digital 3.8 layout).

    ``tx_scale`` applies the reference encoder's extra 1/2 on QPSK
    (lib/stream_encoder_impl.cc:219-221).
    """
    if n_bpsc == 1:  # BPSK: 0 → -1, 1 → +1
        pts = np.array([-1.0, 1.0], np.complex64)
    elif n_bpsc == 2:  # QPSK Gray: bit0 = sign(re), bit1 = sign(im)
        pts = np.array(
            [
                -_SQRT_HALF - 1j * _SQRT_HALF,
                +_SQRT_HALF - 1j * _SQRT_HALF,
                -_SQRT_HALF + 1j * _SQRT_HALF,
                +_SQRT_HALF + 1j * _SQRT_HALF,
            ],
            np.complex64,
        )
        if tx_scale:
            pts = pts / 2.0
    elif n_bpsc == 4:  # gr-digital constellation_16qam Gray mapping
        L = _QAM16_LEVEL
        re = np.array([-3, 1, -1, 3], np.float32) * L  # indexed by bits (b1 b0)
        im = np.array([1, -1, 3, -3], np.float32) * L  # indexed by bits (b3 b2)
        vals = np.arange(16)
        pts = (re[vals & 3] + 1j * im[(vals >> 2) & 3]).astype(np.complex64)
    else:
        raise ValueError(f"unsupported n_bpsc={n_bpsc}")
    return pts.astype(np.complex64)


def constellation_pair(n_bpsc: int, tx_scale: bool = False) -> cx.CArray:
    return cx.from_complex(constellation(n_bpsc, tx_scale))


def modulate(values: jax.Array, mcs: MCS) -> cx.CArray:
    """Symbol values → constellation points (pair form) with TX scaling."""
    return constellation_pair(N_BPSC[mcs], tx_scale=True)[values]


def _point_distances(symbols: cx.CArray, pts: cx.CArray) -> jax.Array:
    """|z - p_k|² per candidate point: (..., n) → (..., n, n_points)."""
    symbols = symbols if isinstance(symbols, cx.CArray) else cx.from_complex(symbols)
    dre = symbols.re[..., None] - pts.re
    dim = symbols.im[..., None] - pts.im
    return dre * dre + dim * dim


def hard_decision(symbols, mcs: MCS) -> jax.Array:
    """Nearest-constellation-point demap → symbol values (int32).

    Equivalent to gr-digital ``decision_maker`` as used by the reference
    decoder (lib/stream_decoder_impl.cc:186-192). The decoder-side tables are
    the *unscaled* gr-digital points — the reference's MMSE equalizer restores
    unit amplitude, and for nearest-point decisions a common positive scale on
    the constellation is irrelevant for QPSK/BPSK; for 16-QAM the reference
    also decides against the unscaled table.
    """
    d2 = _point_distances(symbols, constellation_pair(N_BPSC[mcs]))
    return jnp.argmin(d2, axis=-1).astype(jnp.int32)


def soft_llr(symbols, mcs: MCS, noise_var=1.0) -> jax.Array:
    """Per-bit LLRs via max-log-MAP: (..., n) symbols → (..., n·n_bpsc).

    Not present in the reference (hard decisions only) but exposed so the
    batched Viterbi can run soft-decision — a capability upgrade that falls
    out of the vectorized formulation for free.
    """
    n_bpsc = N_BPSC[mcs]
    vals = np.arange(len(constellation(n_bpsc)))
    d2 = _point_distances(symbols, constellation_pair(n_bpsc)) / jnp.asarray(noise_var)
    llrs = []
    for k in range(n_bpsc):
        mask1 = jnp.asarray((vals >> k) & 1, bool)
        m1 = jnp.min(jnp.where(mask1, d2, jnp.inf), axis=-1)
        m0 = jnp.min(jnp.where(~mask1, d2, jnp.inf), axis=-1)
        llrs.append(m0 - m1)  # >0 ⇒ bit=1 more likely
    out = jnp.stack(llrs, axis=-1)
    return out.reshape(*out.shape[:-2], out.shape[-2] * n_bpsc)
