"""Link characterization: Monte-Carlo BER/PER curves through the full chain.

The reference reports only live rolling PER (lib/stream_decoder_impl.cc:63,
297); this harness produces proper BER/PER-vs-SNR curves by vmapping the
entire TX→channel→RX loopback over noise realizations — the quantitative
"bit-exact-within-SNR" validation surface for the rebuild.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.models import comm_link
from jrc.ops import channel, cplx as cx
from jrc.ops.encoder import FrameSpec


class LinkPoint(NamedTuple):
    snr_db: float
    ber: float
    per: float
    n_frames: int


def _loopback_once(cfg, spec, payload, tx_wave, key, noise_var, estimator, soft):
    rx = channel.awgn(key, tx_wave, noise_var)
    rx = cx.concatenate([rx, cx.zeros(2 * cfg.n_sync_words * cfg.sym_len)], axis=-1)
    res = comm_link.rx_chain(cfg, spec, rx, estimator=estimator, soft=soft)
    bit_errors = jnp.sum(
        coding_bit_errors(res.decoded.payload, payload)
    )
    return bit_errors, res.decoded.crc_ok


def coding_bit_errors(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-byte popcount of XOR (bit errors between byte arrays)."""
    x = jnp.bitwise_xor(a.astype(jnp.uint8), b.astype(jnp.uint8)).astype(jnp.int32)
    cnt = jnp.zeros_like(x)
    for k in range(8):
        cnt = cnt + ((x >> k) & 1)
    return cnt


def link_curve(
    cfg: OFDMConfig,
    spec: FrameSpec,
    payload: jax.Array,
    snr_dbs,
    *,
    n_frames: int = 32,
    angle_deg: float = 0.0,
    path_loss: float = 10.0,
    cfo: float = 0.0,
    estimator: str = "ls",
    soft: bool = False,
    seed: int = 0,
) -> list[LinkPoint]:
    """BER/PER at each SNR; the TX waveform is built once, noise is vmapped."""
    tx = comm_link.tx_frame(
        cfg, spec, payload, 1,
        pad_front=5 * cfg.sym_len, pad_tail=6 * cfg.sym_len + 10,
    )
    clean = channel.comm_channel(
        tx.samples, angle_deg=angle_deg, path_loss=path_loss, noise_var=0.0, cfo=cfo
    )
    sig_pow = float(jnp.mean(cx.abs2(clean)))

    run = jax.jit(
        jax.vmap(
            partial(_loopback_once, cfg, spec, payload, clean,
                    estimator=estimator, soft=soft),
            in_axes=(0, None),
        ),
        static_argnames=(),
    )

    points = []
    total_bits = 8 * spec.payload_bytes
    for i, snr in enumerate(np.atleast_1d(snr_dbs)):
        nv = sig_pow / 10.0 ** (snr / 10.0)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1000 * i), n_frames)
        errs, ok = run(keys, jnp.float32(nv))
        ber = float(jnp.sum(errs)) / (n_frames * total_bits)
        per = 1.0 - float(jnp.sum(ok.astype(jnp.float32))) / n_frames
        points.append(LinkPoint(float(snr), ber, per, n_frames))
    return points
