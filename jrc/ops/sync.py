"""Frame detection and synchronization (complex-free pair form).

Batched replacement for the reference's per-sample state machines:

* ``frame_detector`` (lib/frame_detector_impl.cc) — Schmidl-Cox-style STF
  plateau detection built from a lag-16 autocorrelation over a 32-sample
  window normalized by a 48-sample power average (the comm-sim grc wires
  delay(fft/4) → conj·mult → moving_avg(fft/2) ÷ (1/1.5)·moving_avg(|x|²,
  1.5·fft/2)). The SEARCH/COPY state machine becomes a parallel run-length
  computation (associative-scan cummax), all candidate frames found in one
  pass; coarse CFO = arg(autocorr)/(fft/4) at the trigger
  (lib/frame_detector_impl.cc:113).
* ``frame_sync`` (lib/frame_sync_impl.cc) — LTF matched filter over a
  SYNC_LENGTH window, top-4 peak-pair search at lag fft_len (±1), fine CFO
  from the peak-pair phase (…:230-285), and symbol extraction that keeps the
  raw 2×fft_len LTF region and strips the CP of every following symbol
  (…:175-197).

Everything is batched and jit-friendly; sample-serial recursions are replaced
by cumsum/scan formulations with identical outputs. Complex samples are
(re, im) pairs — the autocorrelation, matched filter, and CFO derotation are
fused real elementwise/matmul ops with no complex HLO (see ops/cplx.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import OFDMConfig
from jrc.ops import cplx as cx

SEG = 128  # candidate-extraction segment (must stay < max_peak_distance)


def _shift_right(x: jax.Array, k: int) -> jax.Array:
    """x delayed by k samples along the last axis, zeros shifted in."""
    if k == 0:
        return x
    if k >= x.shape[-1]:
        return jnp.zeros_like(x)
    pad = jnp.zeros((*x.shape[:-1], k), x.dtype)
    return jnp.concatenate([pad, x[..., :-k]], axis=-1)


def moving_sum(x, win: int):
    """Trailing-window sum: out[n] = Σ_{k=0}^{win-1} x[n-k] (zeros history).

    Matches GNU Radio moving-average alignment (history-padded).

    Computed by binary shift-and-add doubling (log2(win) shifted adds) rather
    than a cumsum difference: the cumsum difference loses precision to
    cancellation on long blocks; doubling is pure elementwise+slice work
    that XLA fuses, and sums exactly the window terms.
    """
    if isinstance(x, cx.CArray):
        return cx.CArray(moving_sum(x.re, win), moving_sum(x.im, win))
    # sums[w][n] = Σ_{k<w} x[n-k] for power-of-two w, built by doubling
    acc = None
    shift = 0
    s = x
    w = 1
    while True:
        if win & w:
            part = _shift_right(s, shift)
            acc = part if acc is None else acc + part
            shift += w
        w *= 2
        if w > win:
            break
        s = s + _shift_right(s, w // 2)
    return acc


def autocorrelation(cfg: OFDMConfig, x: cx.CArray):
    """(autocorr a[n], normalized correlation cor[n]) per the detector chain.

    a[n] = Σ_{k<fft/2} conj(x[n-16-k])·x[n-k];
    cor[n] = |a[n]| / ((1/1.5)·Σ_{k<1.5·fft/2} |x[n-k]|²).
    """
    x = cx.from_complex(x)
    lag = cfg.fft_len // 4
    win = cfg.fft_len // 2
    pwin = int(1.5 * win)
    xd = cx.concatenate([cx.zeros((*x.shape[:-1], lag)), x[..., :-lag]], axis=-1)
    c = cx.mul_conj(x, xd)  # x · conj(x_delayed)
    a = moving_sum(c, win)
    p = moving_sum(cx.abs2(x), pwin) / 1.5
    cor = cx.cabs(a) / jnp.maximum(p, 1e-12)
    return a, cor


def _run_lengths(mask: jax.Array) -> jax.Array:
    """Length of the current True-run ending at each position (parallel)."""
    n = mask.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    last_false = jnp.where(mask, jnp.int32(-1), idx)
    last_false = jax.lax.associative_scan(jnp.maximum, last_false, axis=-1)
    return idx - last_false


class Detections(NamedTuple):
    """Up to max_frames candidate frame triggers in a sample block."""

    start: jax.Array  # (max_frames,) int32 trigger sample index (-1 = none)
    coarse_cfo: jax.Array  # (max_frames,) float32 rad/sample
    valid: jax.Array  # (max_frames,) bool
    n_candidates: jax.Array  # int32: raw trigger-cluster count before the
    #                          max_frames·4 candidate cap (overflow detector)


def _gap_tolerant_triggers(
    mask: jax.Array, min_n_peaks: int, max_peak_distance: int
) -> jax.Array:
    """Trigger mask per the reference's SEARCH counter
    (lib/frame_detector_impl.cc:89-134): a trigger fires at a peak when
    ``min_n_peaks`` peaks have accumulated and the current peak is within
    ``MAX_PEAK_DISTANCE`` of the group's first — i.e. at peak number k when
    peak k−min_n_peaks lies < max_peak_distance behind. Peaks need NOT be
    consecutive; noise dips inside the plateau don't reset the count.
    """
    # "peak k−min_n_peaks lies < max_peak_distance behind the current peak"
    # ⇔ the trailing window (i−D, i] contains ≥ min_n_peaks+1 peaks: the
    # peaks in that window are exactly the last count[i]−count[i−D] ones, and
    # the (count−min_n_peaks)-th peak sits inside it iff that count exceeds
    # min_n_peaks. One moving sum — no position table, no data-dependent
    # scatter/gather.
    peaks_in_window = moving_sum(
        mask.astype(jnp.float32), max_peak_distance
    )
    return mask & (peaks_in_window > min_n_peaks)


def detect_frames(
    cfg: OFDMConfig,
    x: cx.CArray,
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    max_frames: int = 8,
    ignore_gap: int | None = None,
    strict_runs: bool = False,
    own_window: tuple[int, int] | None = None,
) -> Detections:
    """Find STF plateaus in a 1-D sample block.

    Default (reference parity): a trigger fires at the (min_n_peaks+1)-th
    suprathreshold sample (thr < cor < 2) within ``MAX_PEAK_DISTANCE =
    2·(fft+cp)`` of the first (lib/frame_detector_impl.cc:57,89-134) —
    robust to noise dips inside the plateau. ``strict_runs=True`` selects
    the stricter consecutive-run variant (cheaper, needs clean plateaus).
    Triggers within ``ignore_gap`` samples of a previous trigger are
    suppressed (lib/frame_detector_impl.cc:184-188).
    """
    if ignore_gap is None:
        ignore_gap = (cfg.n_sync_words + cfg.n_tx) * cfg.sym_len
    x = cx.from_complex(x)
    a, cor = autocorrelation(cfg, x)
    mask = (cor > threshold) & (cor < 2.0)
    n = x.shape[-1]
    max_peak_distance = 2 * cfg.sym_len
    if strict_runs:
        runs = _run_lengths(mask)
        trigger = runs == min_n_peaks  # fires exactly once per plateau entry
    else:
        trigger = _gap_tolerant_triggers(mask, min_n_peaks, max_peak_distance)
    # sparsify to one candidate per trigger cluster (every further peak of a
    # plateau also satisfies the window condition; a strict-run re-entry
    # after a noise dip re-fires inside the same STF): keep only triggers
    # with no other trigger in the preceding window. ignore_gap (≥ the STF
    # span) would suppress the merged triggers downstream anyway.
    tf = trigger.astype(jnp.float32)
    trigger = trigger & (moving_sum(tf, max_peak_distance) - tf == 0)

    # pull the K earliest candidate triggers (K small), then run the
    # near-trigger suppression scan over only those K — keeps the sequential
    # part O(max_frames), not O(n_samples). Extraction is one first-trigger
    # reduce per 128-sample segment (exact: sparsified triggers are
    # ≥ max_peak_distance > 128 apart, so a segment holds at most one) plus
    # a small sort to compact — NOT top_k over the block and NOT a
    # rank-scatter over every sample.
    assert max_peak_distance > SEG
    n_seg = -(-n // SEG)
    tpad = jnp.pad(trigger, [(0, 0)] * (trigger.ndim - 1) + [(0, n_seg * SEG - n)])
    tseg = tpad.reshape(*trigger.shape[:-1], n_seg, SEG)
    seg_has = jnp.any(tseg, axis=-1)
    seg_first = jnp.argmax(tseg, axis=-1).astype(jnp.int32)
    seg_base = jnp.arange(n_seg, dtype=jnp.int32) * SEG
    cand_all = jnp.where(seg_has, seg_base + seg_first, n)
    k_cand = max_frames * 4
    cand = jnp.sort(cand_all, axis=-1)[..., :k_cand]  # ascending positions

    def keep_scan(last_kept, i):
        keep = (i < n) & (i >= last_kept + ignore_gap)
        return jnp.where(keep, i, last_kept), keep

    _, keep = jax.lax.scan(keep_scan, jnp.int32(-(10**9)), cand)
    kept_idx = jnp.where(keep, cand, n)
    if own_window is not None:
        # ``own_window=(lo, length)``: report only triggers inside the
        # caller's ownership span, BEFORE truncating to max_frames —
        # history/halo candidates still drive the suppression scan above
        # but must not evict owned frames from the slot budget
        w_lo, w_len = own_window
        kept_idx = jnp.where(
            (kept_idx >= w_lo) & (kept_idx < w_lo + w_len), kept_idx, n)
    starts = jnp.sort(kept_idx)[:max_frames]
    valid = starts < n
    starts = jnp.where(valid, starts, -1)
    cfo = cx.angle(a[jnp.clip(starts, 0, n - 1)]) / (cfg.fft_len // 4)
    cfo = jnp.where(valid, cfo, 0.0).astype(jnp.float32)
    n_candidates = jnp.sum(trigger.astype(jnp.int32), axis=-1)
    return Detections(
        start=starts, coarse_cfo=cfo, valid=valid, n_candidates=n_candidates
    )


def detect_frames_stream(
    cfg: OFDMConfig,
    x: cx.CArray,  # flat [left-pad | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,  # ownership of block b = [own_lo + b·block_len, +block_len)
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    max_frames: int = 8,
    ignore_gap: int | None = None,
) -> Detections:
    """Block-batched detection over ONE flat pass of the stream.

    Equivalent to running :func:`detect_frames` per ``[history | block |
    halo]`` window (the scan_rx/sharded ownership rule) but with the
    autocorrelation, trigger logic, and segment candidates computed once over
    the unduplicated stream — the windowed form recomputes every overlap
    region and pays a large stacked copy. History is implicit: the global
    moving sums see the true left context of every block. Candidates from
    the ``ignore_gap`` span left of each block are fed to the suppression
    scan (exactly the cross-boundary re-trigger behavior of the windowed
    form); halo-region candidates beyond the ownership end are not — they
    can never suppress an earlier-owned trigger.

    Returns Detections with leading (n_blocks,) axis; ``start`` is global
    (flat-stream coordinates), −1 when invalid. ``own_lo`` and ``block_len``
    must be multiples of SEG.
    """
    if ignore_gap is None:
        ignore_gap = (cfg.n_sync_words + cfg.n_tx) * cfg.sym_len
    assert own_lo % SEG == 0 and block_len % SEG == 0, (own_lo, block_len)
    x = cx.from_complex(x)
    n = x.shape[-1]
    max_peak_distance = 2 * cfg.sym_len
    assert max_peak_distance > SEG
    n_seg = -(-n // SEG)

    a, cor = autocorrelation(cfg, x)
    mask = (cor > threshold) & (cor < 2.0)
    trigger = _gap_tolerant_triggers(mask, min_n_peaks, max_peak_distance)
    tf = trigger.astype(jnp.float32)
    trigger = trigger & (moving_sum(tf, max_peak_distance) - tf == 0)

    # one first-trigger candidate per segment (exact: sparsified
    # triggers are ≥ max_peak_distance > SEG apart)
    tpad = jnp.pad(trigger, (0, n_seg * SEG - n))
    tseg = tpad.reshape(n_seg, SEG)
    seg_has = jnp.any(tseg, axis=-1)
    seg_first = jnp.argmax(tseg, axis=-1).astype(jnp.int32)
    cand_all = jnp.where(
        seg_has, jnp.arange(n_seg, dtype=jnp.int32) * SEG + seg_first, n
    )
    own_span = trigger[own_lo : own_lo + n_blocks * block_len]
    n_candidates = jnp.sum(
        own_span.reshape(n_blocks, block_len).astype(jnp.int32), axis=-1
    )

    # per block: the block's own segments plus the ignore_gap span before it
    s_blk = block_len // SEG
    s_ext = -(-ignore_gap // SEG)
    base0 = own_lo // SEG - s_ext
    cand_pad = jnp.concatenate(
        [jnp.full(max(0, -base0), n, jnp.int32), cand_all]
    )
    # strided sliding windows via one small gather (the python-loop
    # dynamic-slice stack compiled O(n_blocks) HLO — 100 s of compile at
    # 256 blocks; this index table is (n_blocks, s_blk+s_ext) int32, tiny)
    win_idx = (
        max(0, -base0) + base0
        + jnp.arange(n_blocks, dtype=jnp.int32)[:, None] * s_blk
        + jnp.arange(s_blk + s_ext, dtype=jnp.int32)[None, :]
    )
    cand_b = cand_pad[win_idx]  # (n_blocks, s_blk + s_ext), ascending per block

    k_cand = max_frames * 4
    cand = jnp.sort(cand_b, axis=-1)[:, :k_cand]

    def keep_scan(last_kept, i):
        keep = (i < n) & (i >= last_kept + ignore_gap)
        return jnp.where(keep, i, last_kept), keep

    def per_block(c):
        _, keep = jax.lax.scan(keep_scan, jnp.int32(-(10**9)), c)
        return keep

    keep = jax.vmap(per_block)(cand)
    kept_idx = jnp.where(keep, cand, n)
    # drop non-owned candidates BEFORE truncating to max_frames: the
    # ignore_gap pre-span candidates exist only to drive the suppression
    # scan — sorted first, they would otherwise evict owned frames from a
    # block at max_frames capacity (silent frame loss)
    lo = own_lo + jnp.arange(n_blocks, dtype=jnp.int32)[:, None] * block_len
    kept_idx = jnp.where((kept_idx >= lo) & (kept_idx < lo + block_len),
                         kept_idx, n)
    starts = jnp.sort(kept_idx, axis=-1)[:, :max_frames]  # (n_blocks, mf)
    valid = starts < n
    starts = jnp.where(valid, starts, -1)
    cfo = cx.angle(a[jnp.clip(starts, 0, n - 1)]) / (cfg.fft_len // 4)
    cfo = jnp.where(valid, cfo, 0.0).astype(jnp.float32)
    return Detections(
        start=starts, coarse_cfo=cfo, valid=valid, n_candidates=n_candidates
    )


def gather_rows(x: cx.CArray, starts: jax.Array, width: int) -> cx.CArray:
    """(2-channel) row gather: out[b] = x[starts[b] : starts[b] + width].

    ``starts`` are clamped to [0, N − width] (dynamic-slice semantics). Each
    row is one contiguous dynamic slice, so the reads coalesce.
    """
    n = x.shape[-1]
    if n < width:
        raise ValueError(
            f"gather_rows: stream length {n} < requested width {width}")
    starts = jnp.clip(starts.astype(jnp.int32), 0, n - width)
    return jax.vmap(
        lambda s: cx.dynamic_slice_in_dim(x, s, width, axis=-1)
    )(starts)


class SyncResult(NamedTuple):
    frame_start: jax.Array  # int32, offset into the derotated window
    fine_cfo: jax.Array  # float32 rad/sample (derotation already per reference sign)
    found: jax.Array  # bool: a peak pair at lag fft_len(±1) existed


def ltf_correlate(cfg: OFDMConfig, x: cx.CArray) -> cx.CArray:
    """Matched-filter correlation: corr[n] = Σ_k conj(ltf_t[k])·x[n+k].

    Computed as fft_len static shifted slices × scalar taps, accumulated —
    pure slice+FMA work that XLA fuses into one pass, with no (n, fft_len)
    sliding-window tensor."""
    x = cx.from_complex(x)
    taps = np.conj(np.asarray(cfg.lltf_time))  # (fft_len,) numpy constants
    n = x.shape[-1] - cfg.fft_len + 1
    acc_re = jnp.zeros((*x.shape[:-1], n), x.re.dtype)
    acc_im = jnp.zeros_like(acc_re)
    for k in range(cfg.fft_len):
        xr = x.re[..., k : k + n]
        xi = x.im[..., k : k + n]
        tr, ti = float(taps[k].real), float(taps[k].imag)
        if tr != 0.0:
            acc_re = acc_re + tr * xr
            acc_im = acc_im + tr * xi
        if ti != 0.0:
            acc_re = acc_re - ti * xi
            acc_im = acc_im + ti * xr
    return cx.CArray(acc_re, acc_im)


def search_frame_start(cfg: OFDMConfig, corr: cx.CArray) -> SyncResult:
    """Top-4 |corr|² peak-pair search at index gap fft_len (±1).

    Mirrors lib/frame_sync_impl.cc:230-285 including the preference for an
    exact-gap pair (returns immediately) over ±1 pairs (keeps last found).
    """
    corr = cx.from_complex(corr)
    n = corr.shape[-1]
    mag2 = cx.abs2(corr)
    _, top_idx = jax.lax.top_k(mag2, 4)  # descending magnitude
    top_val = corr[top_idx]

    best_start = jnp.int32(n)  # sentinel: reference uses SYNC_LENGTH
    best_cfo = jnp.float32(0.0)
    found = jnp.bool_(False)
    exact_found = jnp.bool_(False)
    for i in range(3):
        for k in range(i + 1, 4):
            ii, kk = top_idx[i], top_idx[k]
            vi, vk = top_val[i], top_val[k]
            first = cx.where(ii > kk, vk, vi)
            second = cx.where(ii > kk, vi, vk)
            diff = jnp.abs(ii - kk)
            start = jnp.minimum(ii, kk)
            for gap in (cfg.fft_len, cfg.fft_len - 1, cfg.fft_len + 1):
                hit = (diff == gap) & (~exact_found)
                cfo = cx.angle(cx.mul_conj(first, second)) / gap
                best_start = jnp.where(hit, start, best_start)
                best_cfo = jnp.where(hit, cfo, best_cfo)
                found = found | hit
                if gap == cfg.fft_len:
                    exact_found = exact_found | hit
    return SyncResult(
        frame_start=best_start.astype(jnp.int32),
        fine_cfo=best_cfo.astype(jnp.float32),
        found=found,
    )


def symbol_sample_offsets(cfg: OFDMConfig, n_sym: int) -> np.ndarray:
    """(n_sym, fft_len) static sample indices relative to frame start.

    Symbols 0,1 are the raw back-to-back LTF copies; symbols ≥2 skip each
    cp_len prefix (the reference's COPY condition, lib/frame_sync_impl.cc:189).
    """
    offs = np.zeros((n_sym, cfg.fft_len), np.int32)
    for s in range(n_sym):
        if s < 2:
            base = s * cfg.fft_len
        else:
            base = 2 * cfg.fft_len + (s - 2) * cfg.sym_len + cfg.cp_len
        offs[s] = base + np.arange(cfg.fft_len)
    return offs


def extract_frame(
    cfg: OFDMConfig,
    x: cx.CArray,
    trigger: jax.Array,
    coarse_cfo: jax.Array,
    n_sym: int,
    sync_length: int | None = None,
):
    """Full sync for one detected frame: derotate from the trigger, find the
    LTF peak pair, apply fine derotation, gather CP-stripped symbols.

    Returns (symbols (n_sym, fft_len) time-domain pair, total_cfo, found).
    ``n_sym`` counts from the first LTF copy (2 LTFs + SIG + ...).
    """
    if sync_length is None:
        sync_length = cfg.n_sync_words * cfg.sym_len
    x = cx.from_complex(x)

    # correlate only over the prefix the peak search reads — derotating the
    # whole frame window here and again after fine CFO was 2× the work
    need_corr = sync_length + cfg.fft_len - 1
    w_corr = cx.dynamic_slice_in_dim(x, trigger, need_corr, axis=-1)
    w_corr = w_corr * cx.expj(
        -coarse_cfo * jnp.arange(need_corr, dtype=jnp.float32)
    )
    sr = search_frame_start(cfg, ltf_correlate(cfg, w_corr)[..., :sync_length])

    # symbol region: one dynamic slice from the LTF start, then the CP strip
    # is a reshape+slice (symbols are sym_len-periodic after the two raw LTF
    # copies), not an (n_sym, fft_len) data-dependent gather.
    # Combined derotation phase (fine − coarse)·n with n counted from the
    # trigger as the reference does (lib/frame_sync_impl.cc:175-197);
    # total_cfo tag per lib/frame_sync_impl.cc:182-186.
    assert cfg.sym_len == cfg.fft_len + cfg.cp_len
    need_sym = 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len
    w_sym = cx.dynamic_slice_in_dim(x, trigger + sr.frame_start, need_sym, axis=-1)
    phase = (sr.fine_cfo - coarse_cfo) * (
        sr.frame_start.astype(jnp.float32)
        + jnp.arange(need_sym, dtype=jnp.float32)
    )
    w_sym = w_sym * cx.expj(phase)
    ltf = w_sym[..., : 2 * cfg.fft_len].reshape(2, cfg.fft_len)
    rest = w_sym[..., 2 * cfg.fft_len :].reshape(n_sym - 2, cfg.sym_len)
    symbols = cx.concatenate([ltf, rest[..., cfg.cp_len :]], axis=0)
    total_cfo = coarse_cfo - sr.fine_cfo
    return symbols, total_cfo, sr.found


def extract_frames_batch(
    cfg: OFDMConfig,
    x: cx.CArray,  # flat sample stream
    triggers: jax.Array,  # (B,) int32
    coarse_cfos: jax.Array,  # (B,) float32
    n_sym: int,
    sync_length: int | None = None,
):
    """Batched :func:`extract_frame` over all detected frames of a capture.

    Same math, but the two per-frame window reads are batched contiguous
    row reads (:func:`gather_rows`). Returns
    (symbols (B, n_sym, fft), total_cfo (B,), found (B,)).
    """
    if sync_length is None:
        sync_length = cfg.n_sync_words * cfg.sym_len
    x = cx.from_complex(x)

    need_corr = sync_length + cfg.fft_len - 1
    w_corr = gather_rows(x, triggers, need_corr)  # (B, need_corr)
    nvec = jnp.arange(need_corr, dtype=jnp.float32)
    w_corr = w_corr * cx.expj(-coarse_cfos[:, None] * nvec[None, :])
    corr = ltf_correlate(cfg, w_corr)[..., :sync_length]
    sr = jax.vmap(lambda c: search_frame_start(cfg, c))(corr)

    assert cfg.sym_len == cfg.fft_len + cfg.cp_len
    need_sym = 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len
    w_sym = gather_rows(x, triggers + sr.frame_start, need_sym)
    b = w_sym.shape[0]
    phase = (sr.fine_cfo - coarse_cfos)[:, None] * (
        sr.frame_start.astype(jnp.float32)[:, None]
        + jnp.arange(need_sym, dtype=jnp.float32)[None, :]
    )
    w_sym = w_sym * cx.expj(phase)
    ltf = w_sym[..., : 2 * cfg.fft_len].reshape(b, 2, cfg.fft_len)
    rest = w_sym[..., 2 * cfg.fft_len :].reshape(b, n_sym - 2, cfg.sym_len)
    symbols = cx.concatenate([ltf, rest[..., cfg.cp_len :]], axis=1)
    total_cfo = coarse_cfos - sr.fine_cfo
    return symbols, total_cfo, sr.found
