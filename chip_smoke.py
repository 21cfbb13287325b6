#!/usr/bin/env python3
"""Smoke test of the system's main paths on an NVIDIA GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the time-sharded stream on 4 cards

One card, at bench size (2^15-sample blocks × 256 = 8.39 Msamples, 2417
QPSK-3/4 64-B frames, CFO 0.02/fft_len, 25 dB AWGN):

* device — JAX devices, the card's name and power limit (nvidia-smi, in a
  child process), native IQ ring or its numpy fallback;
* static / dynamic receiver — ``scan_rx`` and ``scan_rx_dynamic``: every
  frame found, every CRC good, every payload byte as sent;
* radar dwell — ``radar_frame`` on a 12 m / 25° target: peak within one
  bin; range-angle map and channel estimate against the CPU backend;
* JRC loop — 8 ``jrc_step`` dwells of ``__graft_entry__.entry()``: CRC good
  from the second dwell on;
* streamer — ``BlockStreamer`` on the fc32 and sc16 wires, two superblocks
  each: at least 2·frames − 1 CRCs (the last frame may wait for more data);
* kernels (run first) — the Triton Viterbi kernel against the scan decoder
  at bench widths (3072 frames × 576 and × 840 trellis steps), bit for bit;
* precision — every matmul of the static step asks for HIGHEST (no TF32);
* memory — the static step's ``memory_analysis()`` and the peak in use.

``--four-cards`` runs only ``sharded_rx`` over a 1-D ``time`` mesh of four
cards on a 4 × 8.39 Msample capture, and single-device ``scan_rx`` on the
same capture: frames, CRCs and payloads must be identical.

Any failed check raises, so the exit code is non-zero and the last line is
not the JSON result. Without a GPU the script exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.io.stream import BlockStreamer
from jrc.models import capture, radar_chain, streaming
from jrc.ops import channel, cplx as cx, radar
from jrc.ops.encoder import FrameSpec, make_payload
from jrc.ops.viterbi import viterbi_decode
from jrc.ops.viterbi_pallas import viterbi_decode_pallas
from jrc.parallel import streaming as pstream
from jrc.runtime import load_library

DYN_MAX_PAYLOAD = 96  # the dynamic receiver's length envelope


class Geometry(NamedTuple):
    block_len: int
    n_blocks: int
    max_frames: int  # slots per block

    @property
    def n_samples(self) -> int:
        return self.block_len * self.n_blocks


BENCH = Geometry(block_len=1 << 15, n_blocks=256, max_frames=12)
CFG = OFDMConfig()
SPEC = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    """Card name and power limit (one ``; ``-joined entry per card), read
    by a child process off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split("\n")
    cards = [ln.strip() for ln in out if ln.strip()]
    if not cards:
        raise RuntimeError("nvidia-smi printed nothing")
    return "; ".join(cards)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def make_capture(geo: Geometry, gap: int = 2111) -> capture.Capture:
    halo = max(streaming.frame_window_samples(CFG, SPEC),
               streaming.frame_window_samples_dynamic(CFG, DYN_MAX_PAYLOAD)
               ) + CFG.fft_len
    return capture.impaired_capture(CFG, SPEC, geo.n_samples, halo=halo, gap=gap)


def straddles(starts, frame_len: int, bounds) -> list[int]:
    """Number of frames that cross each boundary."""
    return [int(((starts < b) & (starts + frame_len > b)).sum()) for b in bounds]


def straddling_gap(n: int, bounds, frame_len: int, gap: int = 2111) -> int:
    """The first gap ≥ ``gap`` that puts a frame across every boundary."""
    while True:
        starts = np.arange(500, n - 100 - frame_len, frame_len + gap)
        if all(straddles(starts, frame_len, bounds)):
            return gap
        gap += 1


def to_device(samples: np.ndarray, dev) -> cx.CArray:
    return jax.device_put(cx.CArray(
        np.ascontiguousarray(samples.real), np.ascontiguousarray(samples.imag)
    ), dev)


def check_frames(phase, cap, valid, crc_ok, payload) -> None:
    valid, crc_ok = np.asarray(valid), np.asarray(crc_ok)
    payload = np.asarray(payload)[valid][:, : cap.payload.size]
    n_valid, n_crc = int(valid.sum()), int(crc_ok.sum())
    log(phase, f"frames {n_valid}/{cap.n_frames} crc_ok {n_crc}/{cap.n_frames}")
    check(n_valid == cap.n_frames and n_crc == cap.n_frames,
          f"{phase}: {n_valid} frames, {n_crc} CRCs, {cap.n_frames} sent")
    # decoded bytes must equal the transmitted ones exactly
    check(bool((payload == cap.payload[None]).all()),
          f"{phase}: decoded payload bytes differ from the transmitted ones")
    log(phase, f"payload bytes match on all {n_valid} frames")


def phase_device(dev) -> None:
    log("device", f"jax.devices() = {jax.devices()}")
    log("device", f"platform {dev.platform}, device_kind {dev.device_kind}")
    log("device", f"nvidia-smi: {nvidia_smi_line()}")
    ring = "native C++ ring" if load_library() is not None else "numpy fallback"
    log("device", f"IQ ring: {ring}")


def phase_static(geo, cap, x):
    fn = jax.jit(lambda xx: streaming.scan_rx(
        CFG, SPEC, xx, geo.block_len, geo.n_blocks,
        max_frames_per_block=geo.max_frames, viterbi_backend="auto"))
    t0 = time.perf_counter()
    compiled = fn.lower(x).compile()
    log("static", f"compile {time.perf_counter() - t0:.1f} s")
    res, dt = timed(compiled, x)
    log("static", f"first run {dt * 1e3:.2f} ms")
    check_frames("static", cap, res.valid, res.crc_ok, res.payload)
    return compiled


def phase_dynamic(geo, cap, x) -> None:
    fn = jax.jit(lambda xx: streaming.scan_rx_dynamic(
        CFG, xx, geo.block_len, geo.n_blocks,
        max_frames_per_block=geo.max_frames, max_payload=DYN_MAX_PAYLOAD))
    res, dt = timed(fn, x)
    log("dynamic", f"compile + first run {dt:.1f} s")
    plen = np.asarray(res.payload_len)[np.asarray(res.valid)]
    check(bool((plen == SPEC.payload_bytes).all()),
          f"dynamic: SIG lengths {sorted(set(plen.tolist()))}")
    check_frames("dynamic", cap, res.valid, res.crc_ok, res.payload)


def phase_radar(dev) -> None:
    targets = channel.Targets(
        ranges=(12.0,), velocities=(5.0,), azimuths=(25.0,), rcs=(10.0,))
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    payload = make_payload(spec, bytes([2]) + b"bench jrc")

    def dwell(p, k):
        r = radar_chain.radar_frame(CFG, spec, p, targets, key=k)
        return r.estimate, r.ra_map, r.chan

    outs = {}
    for d in (dev, jax.devices("cpu")[0]):
        with jax.default_device(d):
            args = (jnp.asarray(payload), jax.random.key(0))
            outs[d.platform] = jax.device_get(jax.jit(dwell)(*args))
    est, ra_map, chan = outs[dev.platform]
    rng_axis = radar.range_axis(CFG.fft_len, CFG.sample_rate, 8)
    ang_axis = CFG.angle_axis(16)
    i = int(est.angle_idx)
    ang_bin = float(np.max(np.abs(np.diff(ang_axis[max(i - 1, 0): i + 2]))))
    rng_bin = float(rng_axis[1] - rng_axis[0])
    log("radar", f"detected {bool(est.detected)} range {float(est.range_m):.3f} m "
        f"(bin {rng_bin:.3f}) angle {float(est.angle_deg):.3f} deg "
        f"(bin {ang_bin:.3f}) snr {float(est.snr_db):.1f} dB")
    check(bool(est.detected), "radar: target not detected")
    check(abs(float(est.range_m) - 12.0) <= rng_bin, "radar: range off by > 1 bin")
    check(abs(float(est.angle_deg) - 25.0) <= ang_bin, "radar: angle off by > 1 bin")
    # GPU vs CPU: rtol 1e-4, atol 1e-4·max|ref|. Both backends compute in
    # float32 at HIGHEST matmul precision, but sum in different orders
    # (~1e-6 relative); 1e-4 would catch a TF32 product (~1e-3) while
    # leaving room for that reordering. atol is scaled to the map's peak so
    # near-empty cells do not demand a relative match.
    _, ra_ref, chan_ref = outs["cpu"]
    for name, got, ref in (("range-angle map", ra_map, ra_ref),
                           ("channel estimate", chan, chan_ref)):
        for part in ("re", "im"):
            g, r = np.asarray(getattr(got, part)), np.asarray(getattr(ref, part))
            scale = float(np.max(np.abs(r)))
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"radar: {name}.{part} GPU vs CPU")
        log("radar", f"{name} matches the CPU backend (rtol 1e-4, atol 1e-4·peak)")


def phase_jrc() -> None:
    import __graft_entry__

    step, (state, payload, key) = __graft_entry__.entry()
    f = jax.jit(step)
    crc = []
    for i in range(8):
        r = f(state, payload, jax.random.fold_in(key, i))
        state = r.state
        crc.append(bool(r.comm.decoded.crc_ok))
    log("jrc", f"8 dwells, crc_ok per dwell {crc}, radar detected "
        f"{bool(r.radar_est.detected)}")
    # dwell 1 runs before the radar-aided loop closes (tests/test_jrc.py)
    check(all(crc[1:]), "jrc: crc_ok failed after the first dwell")


def phase_streamer(dev, geo, cap) -> None:
    n = geo.n_samples
    for wire in ("fc32", "sc16"):
        s = BlockStreamer(CFG, SPEC, block_len=geo.block_len, n_blocks=geo.n_blocks,
                          max_frames=geo.max_frames, device=dev, pipeline_depth=2,
                          ring_capacity=4 * n, wire=wire)
        s.push(cap.samples)  # warm superblock: compile + first transfer
        for _ in s.process_available():
            pass
        before = s.stats.crc_ok
        t0 = time.perf_counter()
        s.push(cap.samples[:n])
        s.push(cap.samples[:n])
        for _ in s.process_available():
            pass
        dt = time.perf_counter() - t0
        crc = s.stats.crc_ok - before
        log("streamer", f"{wire}: 2 superblocks, crc_ok {crc} "
            f"(need >= {2 * cap.n_frames - 1}), {dt:.2f} s")
        check(crc >= 2 * cap.n_frames - 1, f"streamer {wire}: {crc} CRCs")


def phase_kernels(dev, n_frames: int = 3072) -> None:
    rng = np.random.default_rng(1)
    for t in (576, 840):
        vals = rng.normal(0, 1, (n_frames, 2 * t)).astype(np.float32)
        vals[rng.random(vals.shape) < 0.2] = 0.0  # erasures, as depunctured
        v = jax.device_put(vals, dev)
        ref = np.asarray(jax.jit(viterbi_decode)(v))
        out = np.asarray(jax.jit(viterbi_decode_pallas)(v))
        # decoded bits must match exactly
        n_diff = int((out != ref).sum())
        log("kernels", f"viterbi triton vs scan, B={n_frames} T={t}: "
            f"{n_diff} differing bits of {ref.size}")
        check(n_diff == 0, "kernels: Viterbi kernel differs from the scan")


def phase_precision(compiled) -> None:
    """Every dot of the optimized static step must carry HIGHEST operand
    precision: a DEFAULT float32 dot may run in TF32 on the card."""
    dots = [ln for ln in compiled.as_text().splitlines()
            if " dot(" in ln or "gemm" in ln]
    highest = [ln for ln in dots if "highest" in ln.lower()]
    log("precision", f"{len(dots)} dot/gemm ops in the static step, "
        f"{len(highest)} at HIGHEST precision")
    check(len(dots) == len(highest), "precision: a dot without HIGHEST "
          "precision: " + next((ln.strip()[:200] for ln in dots
                                if ln not in highest), ""))


def phase_memory(dev, compiled) -> None:
    log("memory", f"static step memory_analysis: {compiled.memory_analysis()}")
    stats = dev.memory_stats() or {}
    log("memory", f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def run_one_card(dev, geo: Geometry = BENCH) -> None:
    t0 = time.perf_counter()
    cap = make_capture(geo)
    log("capture", f"{geo.n_samples} samples, {cap.n_frames} frames, "
        f"built in {time.perf_counter() - t0:.1f} s")
    phase_kernels(dev)  # first: a kernel the card refuses fails fast
    x = to_device(cap.samples, dev)
    compiled = phase_static(geo, cap, x)
    phase_dynamic(geo, cap, x)
    del x
    phase_radar(dev)
    phase_jrc()
    phase_streamer(dev, geo, cap)
    phase_precision(compiled)
    phase_memory(dev, compiled)


def run_four_cards(devs, geo: Geometry = BENCH) -> None:
    n_dev = 4
    check(len(devs) >= n_dev, f"four-cards: {len(devs)} devices")
    whole = geo._replace(n_blocks=geo.n_blocks * n_dev)
    n = whole.n_samples
    bounds = [b * n // n_dev for b in range(1, n_dev)]
    frame_len = make_capture(Geometry(geo.block_len, 1, 1)).frame_len
    cap = make_capture(whole, straddling_gap(n, bounds, frame_len))
    straddle = straddles(cap.starts, cap.frame_len, bounds)
    log("four-cards", f"{n} samples, {cap.n_frames} frames; frames straddling "
        f"the {len(bounds)} device boundaries: {straddle}")
    check(all(straddle), "four-cards: a device boundary has no straddling frame")

    mesh = pstream.make_time_mesh(n_dev, devs[:n_dev])
    ids = [d.id for d in mesh.devices.flat]
    log("four-cards", f"mesh {dict(mesh.shape)} over device ids {ids}")
    check(len(set(ids)) == n_dev, "four-cards: mesh repeats a device")
    # every device block holds ~cap.n_frames/4 frames
    slots = -(-cap.n_frames // n_dev) + 64
    res, dt = timed(lambda c: pstream.sharded_rx(
        CFG, SPEC, mesh, c, max_frames_per_block=slots), cap.samples[:n])
    shard_devs = sorted(s.device.id for s in res.payload.addressable_shards)
    log("four-cards", f"sharded_rx compile + run {dt:.1f} s; result shards on "
        f"devices {shard_devs}")
    check(len(set(shard_devs)) == n_dev, "four-cards: shards share a device")

    x0 = to_device(cap.samples, devs[0])
    ref, dt = timed(jax.jit(lambda xx: streaming.scan_rx(
        CFG, SPEC, xx, whole.block_len, whole.n_blocks,
        max_frames_per_block=whole.max_frames)), x0)
    log("four-cards", f"single-device scan_rx compile + run {dt:.1f} s")

    def frames(r):
        valid = np.asarray(r.valid).reshape(-1)
        order = np.argsort(np.asarray(r.start).reshape(-1)[valid])
        pick = lambda a: np.asarray(a).reshape(valid.size, -1)[valid][order]
        return (pick(r.start)[:, 0], pick(r.crc_ok)[:, 0], pick(r.payload))

    s_start, s_crc, s_pay = frames(res)
    r_start, r_crc, r_pay = frames(ref)
    log("four-cards", f"frames sharded {s_start.size} single {r_start.size}; "
        f"crc_ok sharded {int(s_crc.sum())} single {int(r_crc.sum())}; "
        f"psum totals {int(res.n_frames)}/{int(res.n_crc_ok)}")
    check(s_start.size == r_start.size == cap.n_frames, "four-cards: frame counts")
    check(bool((s_start == r_start).all()), "four-cards: frame starts differ")
    check(int(s_crc.sum()) == int(r_crc.sum()) == cap.n_frames, "four-cards: CRCs")
    check(bool((s_pay == r_pay).all()), "four-cards: payload bytes differ")
    log("four-cards", "sharded and single-device results identical")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the time-sharded stream over 4 GPUs")
    args = p.parse_args(argv)
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    phase_device(dev)
    if args.four_cards:
        run_four_cards(devs)
    else:
        run_one_card(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
