"""Host streaming driver: native IQ ring → jitted block RX, double-buffered.

The control loop that replaces the GNU Radio scheduler for continuous
operation on one host: a producer thread pushes IQ into the native SPSC ring
(jrc/runtime); the consumer loop pops overlapped superblocks
``[left_hist | n_blocks·block_len | halo]``, stages them on the accelerator
as float32 (re, im) pairs, and feeds them to the compiled flat-stream RX
kernel. Staging and dispatch are ASYNCHRONOUS — while block k computes on
the device, block k+1's host→device transfer is already in flight
(``pipeline_depth`` results are kept pending before the first readback), so
sustained throughput is max(transfer, compute), not their sum.

Congestion drops whole ring pushes (bounded loss) instead of blocking the
producer — the behavior the reference hacks into matrix_transpose
(lib/matrix_transpose_impl.cc:86-89).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Iterator

import numpy as np

from jrc.config import OFDMConfig
from jrc.models import streaming as block_rx
from jrc.ops import cplx as cx, sync
from jrc.ops.encoder import FrameSpec
from jrc.runtime import IQRing, IQRing16, SC16_SCALE


@dataclass
class StreamStats:
    blocks: int = 0
    frames: int = 0
    crc_ok: int = 0
    dropped_samples: int = 0


class BlockStreamer:
    """Pop-stage-dispatch pipeline over a ring with a compiled RX kernel."""

    def __init__(
        self,
        cfg: OFDMConfig,
        spec: FrameSpec | None,
        *,
        block_len: int = 1 << 17,
        n_blocks: int = 1,
        max_frames: int = 64,
        max_payload: int = 256,
        estimator: str = "ls",
        soft: bool = False,
        ring_capacity: int | None = None,
        jit: bool = True,
        device=None,
        pipeline_depth: int = 2,
        wire: str = "fc32",
        full_scale: float = 1.0,
    ):
        """``spec=None`` selects the SIG-driven dynamic kernel: each frame's
        MCS/length/type is discovered from its SIG field (mixed traffic),
        bounded by ``max_payload``. A concrete ``spec`` compiles the faster
        static-geometry kernel.

        One kernel dispatch covers ``n_blocks`` ownership blocks of
        ``block_len`` samples (the flat-stream executor) — large superblocks
        amortize per-dispatch latency; per-block ``max_frames`` slots.
        ``device`` stages superblocks there as float32 (re, im) pairs
        (the CArray layout the compute path uses);
        ``pipeline_depth`` dispatches stay in flight before the first
        result readback, overlapping ingest with compute.

        ``wire`` selects the ring/transfer sample format:

        * ``"fc32"`` — float32 (re, im), 8 B/sample, bit-exact (the
          reference's host format, lib/usrp_mimo_trx_impl.cc:219-238);
        * ``"sc16"`` — int16 (re, im), 4 B/sample — UHD's native
          over-the-wire format. Halves ring memory AND host→device
          bandwidth (the sustained-throughput ceiling on any rig);
          dequantization runs on-device, fused by XLA into the head of the
          RX kernel. ``full_scale`` maps the float amplitude that hits
          int16 ±32767 (UHD convention: 1.0).
        """
        import jax
        import jax.numpy as jnp

        assert block_len % sync.SEG == 0, block_len
        self.cfg = cfg
        self.spec = spec
        self.block_len = block_len
        self.n_blocks = n_blocks
        self.span = block_len * n_blocks
        if spec is None:
            self.halo = (
                block_rx.frame_window_samples_dynamic(cfg, max_payload)
                + cfg.fft_len
            )
            fn = partial(
                block_rx.flat_rx_dynamic, cfg,
                block_len=block_len, n_blocks=n_blocks,
                own_lo=block_rx.left_history_samples(cfg),
                max_frames=max_frames, max_payload=max_payload,
                estimator=estimator, soft=soft,
            )
        else:
            self.halo = block_rx.frame_window_samples(cfg, spec) + cfg.fft_len
            fn = partial(
                block_rx.flat_rx, cfg, spec,
                block_len=block_len, n_blocks=n_blocks,
                own_lo=block_rx.left_history_samples(cfg),
                max_frames=max_frames, estimator=estimator, soft=soft,
            )
        self.left_hist = block_rx.left_history_samples(cfg)
        if wire not in ("fc32", "sc16"):
            raise ValueError(f"wire must be 'fc32' or 'sc16', got {wire!r}")
        self.wire = wire
        self.full_scale = float(full_scale)
        if wire == "sc16":
            self.ring = IQRing16(ring_capacity or 4 * self.span,
                                 full_scale=full_scale)
            dq = jnp.float32(self.full_scale / SC16_SCALE)

            def fn_wire(xp):  # int16 (n, 2) → on-device dequant → RX kernel
                return fn(xp=cx.CArray(
                    xp[:, 0].astype(jnp.float32) * dq,
                    xp[:, 1].astype(jnp.float32) * dq,
                ))
        else:
            self.ring = IQRing(ring_capacity or 4 * self.span)
            fn_wire = fn
        self._rx = jax.jit(fn_wire) if jit else fn_wire
        self._counts = jax.jit(
            lambda valid, crc: jax.numpy.stack([
                jax.numpy.sum(valid.astype(jax.numpy.float32)),
                jax.numpy.sum(crc.astype(jax.numpy.float32)),
            ]).reshape(1, 2)
        )
        self._device = device
        self._depth = max(1, pipeline_depth)
        self._pending: deque = deque()
        self._flushed = False
        self.stats = StreamStats()

    def push(self, samples: np.ndarray) -> int:
        """Push complex64 samples (quantized on the way in on an sc16 wire)."""
        self._flushed = False
        return self.ring.push(samples)

    def push_sc16(self, samples: np.ndarray) -> int:
        """Push already-quantized int16 (re, im) samples — the zero-convert
        path for radio drivers that deliver sc16 natively. sc16 wire only."""
        if self.wire != "sc16":
            raise ValueError("push_sc16 requires wire='sc16'")
        self._flushed = False
        return self.ring.push_sc16(samples)

    def _stage(self, blk: np.ndarray):
        """Host block → device-resident wire-format buffer.

        fc32: complex64 → float32 (re, im) pair (8 B/sample on the wire);
        sc16: the ring's int16 (n, 2) block goes up as-is (4 B/sample) —
        dequantization happens on-device inside the jitted kernel.

        ``jax.device_put`` is asynchronous: the transfer of this superblock
        overlaps the previous superblock's device compute.
        """
        import jax

        if self.wire == "sc16":
            return (jax.device_put(blk, self._device)
                    if self._device is not None else blk)
        # blk.real/.imag are float32 strided views of the complex64 block;
        # one ascontiguousarray call is the single copy (astype would copy
        # a second time)
        x = cx.CArray(
            np.ascontiguousarray(blk.real),
            np.ascontiguousarray(blk.imag),
        )
        return jax.device_put(x, self._device) if self._device is not None else x

    def _finalize(self, res):
        # one tiny (1, 2) float32 readback instead of per-slot arrays; this
        # sync closes the pipeline stage
        counts = np.asarray(self._counts(res.valid, res.crc_ok))
        self.stats.blocks += self.n_blocks
        self.stats.frames += int(counts[0, 0])
        self.stats.crc_ok += int(counts[0, 1])
        self.stats.dropped_samples = self.ring.dropped()
        return res

    def process_available(self) -> Iterator[block_rx.BlockRxResult]:
        """Process every complete superblock currently buffered.

        Yields finalized results one pipeline-depth behind the dispatches, so
        the ingest (ring pop + float32 split + h2d) of the next superblock
        runs while the device computes the current one.
        """
        while True:
            blk = self.ring.pop_block(self.span, self.halo, self.left_hist)
            if blk is None:
                break
            self._pending.append(self._rx(xp=self._stage(blk)))
            while len(self._pending) >= self._depth:
                yield self._finalize(self._pending.popleft())
        while self._pending:
            yield self._finalize(self._pending.popleft())

    def flush(self) -> Iterator[block_rx.BlockRxResult]:
        """Zero-pad the tail so ALL trailing data forms final block(s).

        Drains complete superblocks FIRST — computing the pad before
        draining would miss it when more than one superblock is buffered
        and silently drop the residual tail. When the residual extends past
        one superblock's ownership span (into what would be its halo), a
        SECOND zero superblock flushes that remainder too — a single pad
        left up to ``halo`` trailing samples undecoded. Idempotent: a
        repeat flush with nothing new pushed is a no-op (no zero-block
        kernel dispatches)."""
        yield from self.process_available()
        if self._flushed:
            return
        avail = self.ring.available()
        if avail > 0:
            self.ring.push(np.zeros(self.span + self.halo - avail, np.complex64))
            yield from self.process_available()
            if avail > self.span:
                # the real tail reached into the padded block's halo region
                # (owned by the NEXT block): one more zero span drains it —
                # halo < span, so two blocks always suffice
                self.ring.push(np.zeros(self.span, np.complex64))
                yield from self.process_available()
        self._flushed = True
