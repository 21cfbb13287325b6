#!/usr/bin/env python3
"""Time each hand-written kernel against the plain XLA form on one GPU.

    python scripts/time_kernels.py [--out chiprun_out/time_kernels.json]

At the bench geometry (2^15-sample blocks × 256, 2417 QPSK-3/4 64-B frames,
3072 frame slots):

* Viterbi alone: the Triton kernel, the scan (``unroll=8``) and the
  chunk-parallel scan, at B=3072 and T=576 (static spec) / 840 (dynamic
  96-B envelope);
* static and dynamic receivers end to end with ``viterbi_backend='pallas'``
  against ``'scan'``, runs interleaved;
* the detection front end and the frame-window gather (plain XLA) against
  the bytes they move, beside a large device copy.

Times are host-clock medians around ``block_until_ready`` after a warm-up
call. Needs a GPU; prints the card's name and power limit beside the
numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jrc.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc.models import capture, streaming  # noqa: E402
from jrc.ops import cplx as cx, dynamic_rx, sync, viterbi  # noqa: E402
from jrc.ops.encoder import FrameSpec  # noqa: E402
from jrc.ops.viterbi_pallas import viterbi_decode_pallas  # noqa: E402

BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 1 << 15, 256, 12
VITERBI_B = N_BLOCKS * MAX_FRAMES  # frame slots of the bench capture
DYN_MAX_PAYLOAD = 96
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def median_s(fn, *args, n: int = 10) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def interleaved_s(fns: dict, *args, n: int = 10) -> dict:
    """Medians of runs taken in turns, so drift hits every variant."""
    for f in fns.values():
        jax.block_until_ready(f(*args))
    ts = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            ts[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in ts.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out/time_kernels.json")
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"time_kernels: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; device_kind {dev.device_kind}", flush=True)
    out = {"card": card, "device_kind": dev.device_kind}

    # ---- Viterbi alone
    rng = np.random.default_rng(0)
    for t in (576, 840):
        vals = rng.normal(0, 1, (VITERBI_B, 2 * t)).astype(np.float32)
        v = jax.device_put(vals, dev)
        ts = interleaved_s({
            "triton": jax.jit(viterbi_decode_pallas),
            "scan": jax.jit(viterbi.viterbi_decode),
            "chunked": jax.jit(viterbi.viterbi_decode_chunked),
        }, v)
        out[f"viterbi_T{t}_ms"] = {k: 1e3 * s for k, s in ts.items()}
        print(f"viterbi B={VITERBI_B} T={t}: " + ", ".join(
            f"{k} {1e3 * s:.3f} ms" for k, s in ts.items()), flush=True)

    # ---- receivers end to end, kernel vs scan
    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    n = BLOCK_LEN * N_BLOCKS
    halo = max(streaming.frame_window_samples(cfg, spec),
               streaming.frame_window_samples_dynamic(cfg, DYN_MAX_PAYLOAD)
               ) + cfg.fft_len
    cap = capture.impaired_capture(cfg, spec, n, halo=halo)
    x = jax.device_put(cx.CArray(np.ascontiguousarray(cap.samples.real),
                                 np.ascontiguousarray(cap.samples.imag)), dev)

    def static(backend):
        return jax.jit(lambda xx: streaming.scan_rx(
            cfg, spec, xx, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
            viterbi_backend=backend).crc_ok.sum())

    def dynamic(backend):
        return jax.jit(lambda xx: streaming.scan_rx_dynamic(
            cfg, xx, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
            max_payload=DYN_MAX_PAYLOAD, viterbi_backend=backend).crc_ok.sum())

    for name, build in (("static", static), ("dynamic", dynamic)):
        fns = {b: build(b) for b in ("pallas", "scan")}
        crc = {b: int(f(x)) for b, f in fns.items()}
        ts = interleaved_s(fns, x)
        out[f"{name}_rx_ms"] = {b: 1e3 * s for b, s in ts.items()}
        out[f"{name}_rx_msps"] = {b: n / s / 1e6 for b, s in ts.items()}
        out[f"{name}_rx_crc_ok"] = crc
        print(f"{name} receiver, {cap.n_frames} frames: " + ", ".join(
            f"viterbi {b} {1e3 * s:.3f} ms = {n / s / 1e6:.1f} Msps "
            f"(crc_ok {crc[b]})" for b, s in ts.items()), flush=True)

    # ---- detection front end and frame-window gather, plain XLA
    left = streaming.left_history_samples(cfg)
    xp = cx.concatenate([cx.zeros(left), x], axis=-1)
    det = jax.jit(lambda s: sync.detect_frames_stream(
        cfg, s, BLOCK_LEN, N_BLOCKS, left, max_frames=MAX_FRAMES).start)
    t_det = median_s(det, xp)
    det_bytes = 8 * n  # the fc32 capture, read once
    out["detect_ms"] = 1e3 * t_det
    out["detect_GBps"] = det_bytes / t_det / 1e9
    print(f"detect front end: {1e3 * t_det:.3f} ms, {det_bytes / 1e6:.0f} MB "
          f"read -> {det_bytes / t_det / 1e9:.1f} GB/s "
          f"({100 * det_bytes / t_det / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)",
          flush=True)

    sync_len = cfg.n_sync_words * cfg.sym_len
    n_slots = N_BLOCKS * MAX_FRAMES
    starts = jax.device_put(
        np.sort(rng.integers(0, n, n_slots)).astype(np.int32), dev)
    for name, n_sym in (
        ("static", 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym),
        ("dynamic", 2 + 1 + cfg.n_ltf
         + dynamic_rx.max_symbols(DYN_MAX_PAYLOAD, cfg.n_data_carriers)),
    ):
        widths = (sync_len + cfg.fft_len - 1,
                  2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len)
        g = jax.jit(lambda s, st, w=widths: [
            sync.gather_rows(s, st, wi) for wi in w])
        t_g = median_s(g, xp, starts)
        rows = 8 * n_slots * sum(widths)  # fc32 rows written (and read)
        out[f"gather_{name}_ms"] = 1e3 * t_g
        out[f"gather_{name}_GBps"] = 2 * rows / t_g / 1e9
        print(f"gather {name}: {n_slots} slots x widths {widths}: "
              f"{1e3 * t_g:.3f} ms, {rows / 1e6:.1f} MB of rows, read + write "
              f"{2 * rows / t_g / 1e9:.1f} GB/s "
              f"({100 * 2 * rows / t_g / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)",
              flush=True)

    big = jax.device_put(np.ones(1 << 28, np.float32), dev)  # 1 GiB
    t_copy = median_s(jax.jit(lambda a: a + 1.0), big)
    out["copy_GBps"] = 2 * big.nbytes / t_copy / 1e9
    print(f"plain 1 GiB read+write: {out['copy_GBps']:.1f} GB/s", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
