"""Synthetic impaired IQ captures for the benchmark and the GPU smoke test.

A continuous capture of identical frames at a fixed gap, with the reference
comm-sim's deliberate impairments (SURVEY §4.2): a CFO of 0.02/fft_len
cycles/sample (comm-sim grc ``freq_offset``) on every frame and AWGN at
``snr_db``. CRC counts on such a capture are earned through the full
sync / CFO-recovery / equalization chain, not an impairment-free shortcut.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.models import comm_link
from jrc.ops import channel
from jrc.ops.encoder import FrameSpec, make_payload


class Capture(NamedTuple):
    samples: np.ndarray  # (n_samples + halo,) complex64, trailing zeros
    n_frames: int
    payload: np.ndarray  # (payload_bytes,) uint8 carried by every frame
    starts: np.ndarray  # (n_frames,) first sample of each frame
    frame_len: int


def impaired_capture(
    cfg: OFDMConfig,
    spec: FrameSpec,
    n_samples: int,
    *,
    halo: int,
    text: bytes = b"bench frame",
    gap: int = 2111,
    snr_db: float = 25.0,
    seed: int = 0,
) -> Capture:
    """Frames from sample 500 on, ``gap`` samples apart, none past
    ``n_samples − 100``; ``halo`` trailing zeros follow. The TX side runs
    on the CPU backend (a few small programs); the noise comes from
    ``seed``."""
    cfo = 0.02 * 2 * np.pi / cfg.fft_len  # radians/sample
    with jax.default_device(jax.devices("cpu")[0]):
        payload = jnp.asarray(make_payload(spec, bytes([2]) + text))
        tx_samples = jax.jit(
            lambda p: comm_link.tx_frame(cfg, spec, p, 1).samples
        )(payload)
        frame = np.asarray(jax.jit(
            lambda s: channel.comm_channel(
                s, angle_deg=0.0, path_loss=5.0, noise_var=0.0, cfo=cfo)
        )(tx_samples))
    rng = np.random.default_rng(seed)
    noise_var = float(np.mean(np.abs(frame) ** 2)) / 10 ** (snr_db / 10)
    cap = (
        rng.normal(0, np.sqrt(noise_var / 2), (n_samples, 2))
        .view(np.complex128)[:, 0]
    ).astype(np.complex64)
    starts = np.arange(500, n_samples - 100 - len(frame), len(frame) + gap)
    for pos in starts:
        cap[pos : pos + len(frame)] += frame
    cap = np.concatenate([cap, np.zeros(halo, np.complex64)])
    return Capture(cap, len(starts), np.asarray(payload), starts, len(frame))
