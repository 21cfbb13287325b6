"""Data-parallel batch processing: many dwells/captures across devices.

The antenna/frame fan-out the reference achieves by graph replication
(4× IFFT/CP chains, one target_simulator per TX antenna — SURVEY §2.3 item 2)
generalizes on accelerators to sharding a leading batch axis: N independent radar
dwells (or RX captures) are processed as one sharded program, with psum
reductions for aggregate link statistics.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jrc.config import OFDMConfig
from jrc.ops import cplx as cx, radar


def batched_range_angle_maps(
    mesh: Mesh,
    chans: jax.Array,  # (n_dwells, n_virt, fft_len) channel estimates
    interp_factor_range: int = 8,
    interp_factor_angle: int = 16,
):
    """Shard a batch of radar channel estimates over 'batch' and produce the
    power maps + per-dwell peak estimates in one program."""

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P("batch")))
    def run(h):
        maps = jax.vmap(
            lambda hh: radar.range_angle_map(hh, interp_factor_range, interp_factor_angle)
        )(h)
        return cx.abs2(maps)

    chans = jax.device_put(cx.from_complex(chans), NamedSharding(mesh, P("batch")))
    return run(chans)


def batched_rx(
    mesh: Mesh,
    cfg: OFDMConfig,
    spec,
    captures: jax.Array,  # (n_captures, n_samples) independent sample blocks
    *,
    max_frames: int = 8,
):
    """Decode a batch of independent captures data-parallel over the mesh.

    Each capture must already include the trailing halo (see
    models/streaming.frame_window_samples). Returns per-capture
    (n_frames, n_crc_ok) float32 counts, sharded P('batch').
    """
    from jrc.models import streaming

    block_len = captures.shape[-1] - (
        streaming.frame_window_samples(cfg, spec) + cfg.fft_len
    )

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P("batch")))
    def run(caps):
        def one(x):
            res = streaming.rx_block(cfg, spec, x, block_len, max_frames=max_frames)
            return jnp.stack([
                jnp.sum(res.valid.astype(jnp.float32)),
                jnp.sum(res.crc_ok.astype(jnp.float32)),
            ])

        return jax.vmap(one)(caps)

    captures = jax.device_put(cx.from_complex(captures), NamedSharding(mesh, P("batch")))
    return run(captures)
