"""Batched block RX: process a long IQ capture containing many frames.

This is the data-plane kernel of the streaming executor: one call takes a
block of samples and produces decoded frames + link stats for every frame
whose *trigger* lies inside the block. Frames may extend past the block end
into a halo region appended by the caller (the sharded executor in
jrc/parallel/streaming.py fetches the halo from the right-neighbor device
via collective permute) — the exactly-once ownership rule that replaces the
reference's sample-serial detector/sync state machines
(lib/frame_detector_impl.cc, lib/frame_sync_impl.cc).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import cplx as cx, decoder, dynamic_rx, equalizer, ofdm, sync, viterbi
from jrc.ops.encoder import FrameSpec


class BlockRxResult(NamedTuple):
    payload: jax.Array  # (max_frames, payload_bytes)
    crc_ok: jax.Array  # (max_frames,)
    sig_ok: jax.Array  # (max_frames,)
    snr_db: jax.Array  # (max_frames,)
    start: jax.Array  # (max_frames,) trigger index within the block
    valid: jax.Array  # (max_frames,) frame slot used


def frame_window_samples(cfg: OFDMConfig, spec: FrameSpec) -> int:
    """Samples needed from a trigger to process one frame (sync window +
    raw LTF region + CP-stripped symbols + correlator slack)."""
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    sync_length = cfg.n_sync_words * cfg.sym_len
    return sync_length + 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len + cfg.fft_len


def left_history_samples(cfg: OFDMConfig) -> int:
    """Samples of left-neighbor history needed so a plateau that begins in
    the previous block is seen with its true trigger (no re-trigger at the
    block head): the full trigger-chain lookback — the sparsify stage reads
    the trigger mask back ``max_peak_distance−1`` samples, the mask's
    peaks-in-window another ``max_peak_distance−1``, and the autocorrelation
    / power moving sums ``max(win+lag, pwin)−1`` more — rounded up to the
    detector's candidate-segment size (sync.SEG) so the flat-stream batched detector
    can align block ownership to segment boundaries. 384 samples for the
    default fft_len=64 numerology; 768 for fft_len=128 (the previous
    ``2·sym_len + 2·fft_len`` form under-provisioned there, so a boundary-
    straddling plateau could re-trigger as a duplicate frame)."""
    mpd = 2 * cfg.sym_len
    lag = cfg.fft_len // 4
    win = cfg.fft_len // 2
    pwin = int(1.5 * win)
    need = 2 * (mpd - 1) + max(win + lag, pwin) - 1
    return -(-need // sync.SEG) * sync.SEG


class _PreDecoded(NamedTuple):
    """Everything up to (but not including) the Viterbi pass for one block:
    lets the capture-level executor run ONE flat Viterbi over all blocks'
    frames (the Pallas kernel cannot sit under the per-frame vmap)."""

    values: jax.Array  # (max_frames, 2·n_data_bits) depunctured values
    found: jax.Array  # (max_frames,) LTF peak pair existed
    sig_ok: jax.Array  # (max_frames,)
    snr_db: jax.Array  # (max_frames,)
    start: jax.Array  # (max_frames,) trigger relative to own_lo (-1 invalid)
    owned: jax.Array  # (max_frames,)


def _rx_block_prelude(
    cfg: OFDMConfig,
    spec: FrameSpec,
    x: cx.CArray,
    block_len: int,
    *,
    own_lo: int,
    max_frames: int,
    threshold: float,
    min_n_peaks: int,
    estimator: str,
    soft: bool,
) -> _PreDecoded:
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    # own_window: history/halo triggers must not evict owned frames from
    # the max_frames slot budget (they still drive ignore_gap suppression)
    det = sync.detect_frames(
        cfg, x, threshold=threshold, min_n_peaks=min_n_peaks,
        max_frames=max_frames, own_window=(own_lo, block_len),
    )
    owned = det.valid & (det.start >= own_lo) & (det.start < own_lo + block_len)
    starts = jnp.where(owned, det.start, 0)

    def one_frame(trigger, cfo):
        syms_t, total_cfo, found = sync.extract_frame(cfg, x, trigger, cfo, n_sym)
        grid = ofdm.fft_symbols(cfg, syms_t)
        eq = equalizer.equalize_frame(cfg, spec, grid, total_cfo, estimator=estimator)
        values = decoder.frame_values(spec, eq.z, soft=soft)
        return values, found, eq.sig_ok, eq.snr_legacy

    values, found, sig_ok, snr = jax.vmap(one_frame)(starts, det.coarse_cfo)
    return _PreDecoded(
        values=values,
        found=found,
        sig_ok=sig_ok,
        snr_db=snr,
        start=jnp.where(owned, det.start - own_lo, -1),
        owned=owned,
    )


# 'auto' Viterbi backend per platform: the Triton kernel on the GPU, the scan
# on the CPU (tests). Any other platform has no tested formulation.
AUTO_VITERBI = {"gpu": "pallas", "cpu": "scan"}


def _viterbi_backend(name: str):
    """Resolve a Viterbi backend name → decode function.

    'scan' (ops/viterbi.py) runs everywhere, incl. under vmap; 'pallas' is
    the Triton kernel (ops/viterbi_pallas.py), needs a GPU, and must be
    called on a flat batch outside any vmap; 'auto' picks per
    ``jax.default_backend()`` from AUTO_VITERBI and raises elsewhere."""
    if name == "auto":
        backend = jax.default_backend()
        if backend not in AUTO_VITERBI:
            raise RuntimeError(
                f"no Viterbi formulation for backend {backend!r} "
                f"(known: {sorted(AUTO_VITERBI)})")
        name = AUTO_VITERBI[backend]
    if name == "pallas":
        from jrc.ops.viterbi_pallas import viterbi_decode_pallas

        return viterbi_decode_pallas
    if name == "scan":
        return viterbi.viterbi_decode
    raise ValueError(f"unknown viterbi_backend {name!r}")


def _finish_block(
    spec: FrameSpec, pre: _PreDecoded, bits: jax.Array
) -> BlockRxResult:
    dec = decoder.frame_from_bits(spec, bits)
    return BlockRxResult(
        payload=dec.payload,
        crc_ok=dec.crc_ok & pre.found & pre.owned,
        sig_ok=pre.sig_ok & pre.owned,
        snr_db=pre.snr_db,
        start=pre.start,
        valid=pre.owned,
    )


def rx_block(
    cfg: OFDMConfig,
    spec: FrameSpec,
    x: jax.Array,  # (left_hist + block_len + halo,) samples
    block_len: int,
    *,
    own_lo: int = 0,  # ownership window [own_lo, own_lo + block_len)
    max_frames: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> BlockRxResult:
    """Detect and decode every frame whose trigger lies in the ownership
    window; ``start`` is reported relative to ``own_lo``."""
    x = cx.from_complex(x)
    pre = _rx_block_prelude(
        cfg, spec, x, block_len, own_lo=own_lo, max_frames=max_frames,
        threshold=threshold, min_n_peaks=min_n_peaks, estimator=estimator,
        soft=soft,
    )
    bits = viterbi.viterbi_decode(
        pre.values, n_out=spec.packet_params.n_data_bits
    )
    return _finish_block(spec, pre, bits)


def flat_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    xp: cx.CArray,  # flat [left-history | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,
    *,
    max_frames: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    viterbi_backend: str = "auto",
) -> BlockRxResult:
    """One flat pass over a pre-assembled stream: detection
    (autocorr/trigger/candidates) runs once over the unduplicated samples,
    every frame is extracted in one batched row read, and ONE Viterbi call
    decodes them all. ``start`` is reported relative to ``own_lo``; results
    are (n_blocks·max_frames,)-flat. Used by scan_rx (left history = zeros)
    and by the sharded executor's per-device body (left history = the
    ppermute'd neighbor tail). ``estimator='sta'`` enables decision-directed
    STA channel tracking, ``soft=True`` max-log-MAP LLR demapping
    (lib/mimo_ofdm_equalizer_impl.cc:500-592; soft is a capability upgrade
    over the reference's hard decisions)."""
    mf = max_frames
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=mf,
    )
    owned = det.valid
    trig_flat = jnp.where(owned, det.start, 0).reshape(-1)
    cfo_flat = det.coarse_cfo.reshape(-1)
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym

    syms, total_cfo, found = sync.extract_frames_batch(
        cfg, xp, trig_flat, cfo_flat, n_sym
    )

    def one_frame(sym, tc):
        eq = equalizer.equalize_frame(
            cfg, spec, ofdm.fft_symbols(cfg, sym), tc, estimator=estimator
        )
        return decoder.frame_values(spec, eq.z, soft=soft), eq.sig_ok, eq.snr_legacy

    values, sig_ok, snr = jax.vmap(one_frame)(syms, total_cfo)
    n_data_bits = spec.packet_params.n_data_bits
    bits = _viterbi_backend(viterbi_backend)(values, n_out=n_data_bits)
    dec = decoder.frame_from_bits(spec, bits)
    owned_flat = owned.reshape(-1)
    return BlockRxResult(
        payload=dec.payload,
        crc_ok=dec.crc_ok & found & owned_flat,
        sig_ok=sig_ok & owned_flat,
        snr_db=snr,
        start=jnp.where(owned, det.start - own_lo, -1).reshape(-1),
        valid=owned_flat,
    )


def scan_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    x: jax.Array,  # (n_blocks·block_len + halo,) samples
    block_len: int,
    n_blocks: int,
    *,
    max_frames_per_block: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    batched: bool = True,
    viterbi_backend: str = "auto",
) -> BlockRxResult:
    """Stream ``n_blocks`` fixed-size blocks through the rx_block body.

    Blocks are independent given the ``[left-history | block | halo]`` window
    (same ownership rule the sharded executor uses over the mesh), so the
    default formulation is **batched**: all block windows are gathered into a
    (n_blocks, window) tensor and the per-block prelude (detect → sync → FFT
    → equalize → demap) runs as one vmap; the Viterbi pass then runs ONCE
    over the flat (n_blocks·max_frames) batch — on the GPU via the Triton
    kernel (``viterbi_backend='auto'|'pallas'``), on the CPU via the
    lax.scan formulation. ``batched=False`` falls back to
    a sequential ``lax.scan`` over blocks (small program, O(1) memory in
    n_blocks) for very long captures.
    """
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    left_hist = left_history_samples(cfg)
    x = cx.from_complex(x)
    assert x.shape[-1] >= n_blocks * block_len + halo
    xp = cx.concatenate([cx.zeros(left_hist), x], axis=-1)
    window = left_hist + block_len + halo

    def one_block(blk):
        return rx_block(
            cfg, spec, blk, block_len, own_lo=left_hist,
            max_frames=max_frames_per_block, threshold=threshold,
            min_n_peaks=min_n_peaks, estimator=estimator, soft=soft,
        )

    if batched and block_len % sync.SEG == 0:
        return flat_rx(
            cfg, spec, xp, block_len, n_blocks, left_hist,
            max_frames=max_frames_per_block, threshold=threshold,
            min_n_peaks=min_n_peaks, estimator=estimator, soft=soft,
            viterbi_backend=viterbi_backend,
        )
    if batched:
        starts = jnp.arange(n_blocks, dtype=jnp.int32) * block_len
        # static slices, not an index-array gather: XLA turns these into
        # plain copies instead of a (n_blocks, window) gather that gets
        # re-materialized into every consumer
        blocks = cx.stack(
            [xp[..., b * block_len : b * block_len + window] for b in range(n_blocks)]
        )
        pre = jax.vmap(
            lambda blk: _rx_block_prelude(
                cfg, spec, blk, block_len, own_lo=left_hist,
                max_frames=max_frames_per_block, threshold=threshold,
                min_n_peaks=min_n_peaks, estimator=estimator, soft=soft,
            )
        )(blocks)
        n_data_bits = spec.packet_params.n_data_bits
        flat_values = pre.values.reshape(-1, pre.values.shape[-1])
        bits = _viterbi_backend(viterbi_backend)(flat_values, n_out=n_data_bits)
        bits = bits.reshape(n_blocks, max_frames_per_block, n_data_bits)
        res = _finish_block(spec, pre, bits)
        results = res._replace(
            start=jnp.where(res.valid, res.start + starts[:, None], -1)
        )
    else:
        def body(_, b):
            start = b * block_len
            blk = cx.dynamic_slice_in_dim(xp, start, window)
            res = one_block(blk)
            out = res._replace(
                start=jnp.where(res.valid, res.start + start, -1)
            )
            return None, out

        _, results = jax.lax.scan(body, None, jnp.arange(n_blocks))
    # (n_blocks, max_frames, ...) → flatten the frame-slot axis
    return BlockRxResult(*[
        r.reshape(-1, *r.shape[2:]) for r in results
    ])


# ---------------------------------------------------------------------------
# SIG-driven dynamic streaming: MCS / length / packet type discovered per
# frame from the SIG field (reference lib/mimo_ofdm_equalizer_impl.cc:650-781,
# lib/stream_decoder_impl.cc:129-172) — one compiled program covers the whole
# MCS × length envelope. The static-spec path above remains as the fast
# known-spec specialization.
# ---------------------------------------------------------------------------


class DynBlockRxResult(NamedTuple):
    payload: jax.Array  # (max_frames, max_payload) uint8
    payload_len: jax.Array  # (max_frames,) bytes (without CRC)
    crc_ok: jax.Array  # (max_frames,)
    sig_ok: jax.Array  # (max_frames,)
    mcs: jax.Array  # (max_frames,) int32 MCS index from SIG
    packet_type_bit: jax.Array  # (max_frames,) 0=NDP 1=DATA
    snr_db: jax.Array  # (max_frames,) legacy-LTF (stream_start tag)
    snr_data_db: jax.Array  # (max_frames,) pilot-tracked payload SNR
    start: jax.Array  # (max_frames,) trigger index
    valid: jax.Array  # (max_frames,)
    chan_est: cx.CArray  # (max_frames, fft_len, n_tx) NDP MIMO estimate
    chan_est_ok: jax.Array  # (max_frames,) NDP + valid SIG → chan_est live


def frame_window_samples_dynamic(cfg: OFDMConfig, max_payload: int) -> int:
    """Samples needed from a trigger for the worst-case dynamic frame
    (BPSK-1/2 at max_payload)."""
    n_sym = 2 + 1 + cfg.n_ltf + dynamic_rx.max_symbols(
        max_payload, cfg.n_data_carriers)
    sync_length = cfg.n_sync_words * cfg.sym_len
    return sync_length + 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len + cfg.fft_len


def rx_block_dynamic(
    cfg: OFDMConfig,
    x: jax.Array,  # (left_hist + block_len + halo,) samples
    block_len: int,
    *,
    own_lo: int = 0,
    max_frames: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> DynBlockRxResult:
    """Detect every owned frame and decode it with SIG-discovered
    MCS/length/type (mixed-traffic captures: interleaved MCS, NDP + DATA)."""
    x = cx.from_complex(x)
    det = sync.detect_frames(
        cfg, x, threshold=threshold, min_n_peaks=min_n_peaks,
        max_frames=max_frames, own_window=(own_lo, block_len),
    )
    owned = det.valid & (det.start >= own_lo) & (det.start < own_lo + block_len)
    starts = jnp.where(owned, det.start, 0)

    frames = jax.vmap(
        lambda t, c: dynamic_rx.rx_frame_dynamic(
            cfg, x, t, c, max_payload=max_payload, estimator=estimator,
            soft=soft,
        )
    )(starts, det.coarse_cfo)
    return DynBlockRxResult(
        payload=frames.payload,
        payload_len=jnp.where(owned, frames.payload_len, 0),
        crc_ok=frames.crc_ok & owned,
        sig_ok=frames.sig_ok & owned,
        mcs=frames.mcs,
        packet_type_bit=frames.packet_type_bit,
        snr_db=frames.snr_db,
        snr_data_db=frames.snr_data_db,
        start=jnp.where(owned, det.start - own_lo, -1),
        valid=owned,
        chan_est=frames.chan_est,
        chan_est_ok=frames.chan_est_ok & owned,
    )


def flat_rx_dynamic(
    cfg: OFDMConfig,
    xp: cx.CArray,  # flat [left-history | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,
    *,
    max_frames: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    viterbi_backend: str = "auto",
) -> DynBlockRxResult:
    """SIG-driven analog of :func:`flat_rx`: one detection pass, one
    batched extraction, one shared-envelope Viterbi call.
    ``estimator='sta'`` adds decision-directed tracking under the
    SIG-discovered MCS; ``soft=True`` feeds LLRs to the shared Viterbi."""
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames,
    )
    owned = det.valid
    trig_flat = jnp.where(owned, det.start, 0).reshape(-1)
    cfo_flat = det.coarse_cfo.reshape(-1)
    n_sym_total = 2 + 1 + cfg.n_ltf + dynamic_rx.max_symbols(
        max_payload, cfg.n_data_carriers)
    syms, total_cfo, _found = sync.extract_frames_batch(
        cfg, xp, trig_flat, cfo_flat, n_sym_total
    )
    pre = jax.vmap(
        lambda sym, tc: dynamic_rx.rx_frame_dynamic_values_from_syms(
            cfg, sym, tc, max_payload=max_payload, estimator=estimator,
            soft=soft,
        )
    )(syms, total_cfo)
    bits = _viterbi_backend(viterbi_backend)(
        pre.values, n_out=16 + 8 * (max_payload + 4)
    )
    frames = jax.vmap(
        lambda p, b: dynamic_rx.rx_frame_dynamic_finish(p, b, max_payload)
    )(pre, bits)
    owned_flat = owned.reshape(-1)
    return DynBlockRxResult(
        payload=frames.payload,
        payload_len=jnp.where(owned_flat, frames.payload_len, 0),
        crc_ok=frames.crc_ok & owned_flat,
        sig_ok=frames.sig_ok & owned_flat,
        mcs=frames.mcs,
        packet_type_bit=frames.packet_type_bit,
        snr_db=frames.snr_db,
        snr_data_db=frames.snr_data_db,
        start=jnp.where(owned, det.start - own_lo, -1).reshape(-1),
        valid=owned_flat,
        chan_est=frames.chan_est,
        chan_est_ok=frames.chan_est_ok & owned_flat,
    )


def scan_rx_dynamic(
    cfg: OFDMConfig,
    x: jax.Array,  # (n_blocks·block_len + halo,) samples
    block_len: int,
    n_blocks: int,
    *,
    max_frames_per_block: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    batched: bool = True,
    viterbi_backend: str = "auto",
) -> DynBlockRxResult:
    """Dynamic-RX analog of :func:`scan_rx`: all blocks processed as one
    vmapped batch (or a sequential scan with ``batched=False``). When
    ``block_len`` is SEG-aligned the batched path runs the flat-stream
    detector and ONE Viterbi over every frame's SIG-discovered envelope
    (the Triton kernel on the GPU via ``viterbi_backend='auto'``)."""
    halo = frame_window_samples_dynamic(cfg, max_payload) + cfg.fft_len
    left_hist = left_history_samples(cfg)
    x = cx.from_complex(x)
    assert x.shape[-1] >= n_blocks * block_len + halo
    xp = cx.concatenate([cx.zeros(left_hist), x], axis=-1)
    window = left_hist + block_len + halo

    def one_block(blk):
        return rx_block_dynamic(
            cfg, blk, block_len, own_lo=left_hist,
            max_frames=max_frames_per_block, max_payload=max_payload,
            threshold=threshold, min_n_peaks=min_n_peaks,
            estimator=estimator, soft=soft,
        )

    starts = jnp.arange(n_blocks, dtype=jnp.int32) * block_len
    if batched and block_len % sync.SEG == 0:
        return flat_rx_dynamic(
            cfg, xp, block_len, n_blocks, left_hist,
            max_frames=max_frames_per_block, max_payload=max_payload,
            threshold=threshold, min_n_peaks=min_n_peaks,
            estimator=estimator, soft=soft,
            viterbi_backend=viterbi_backend,
        )
    if batched:
        blocks = cx.stack(
            [xp[..., b * block_len : b * block_len + window] for b in range(n_blocks)]
        )
        res = jax.vmap(one_block)(blocks)
        results = res._replace(
            start=jnp.where(res.valid, res.start + starts[:, None], -1)
        )
    else:
        def body(_, b):
            blk = cx.dynamic_slice_in_dim(xp, b * block_len, window)
            res = one_block(blk)
            return None, res._replace(
                start=jnp.where(res.valid, res.start + b * block_len, -1)
            )

        _, results = jax.lax.scan(body, None, jnp.arange(n_blocks))
    return DynBlockRxResult(*[
        r.reshape(-1, *r.shape[2:]) for r in results
    ])
