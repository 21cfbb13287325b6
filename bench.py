"""Benchmark: IQ samples/s through the full JRC RX chain on one GPU.

Builds a long impaired IQ capture containing many complete frames
(jrc.models.capture), then times the jitted receivers — frame detection,
LTF sync, CP-strip/FFT, channel estimation/equalization, Viterbi decode,
CRC — plus the radar dwell, the closed JRC loop and the ingest-inclusive
streamer, all on the first GPU. Prints the card's name and power limit,
then ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

vs_baseline is measured against the BASELINE north-star target of
100 Msamples/s/chip through the full RX chain (the reference's own operating
point is 125 Msps real-time on a host CPU for the streaming graph,
examples/usrp/mimo_ofdm_jrc_TRX.grc `samp_rate`).

Runs in one process on the GPU, or fails: there is no CPU fallback.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_SPS = 100e6  # north-star: 100 Msamples/s/chip full RX chain
DYN_MAX_PAYLOAD = 96  # SIG-driven secondary measurement's length envelope
BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 1 << 15, 256, 12


def _log(msg: str) -> None:
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.monotonic()


def _counts(res):
    import jax.numpy as jnp

    return jnp.stack([jnp.sum(res.valid.astype(jnp.int32)),
                      jnp.sum(res.crc_ok.astype(jnp.int32))])


def _time(fn, *args, n_iter: int) -> float:
    import numpy as np

    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    np.asarray(out)  # the sync that closes the timing loop
    return (time.perf_counter() - t0) / n_iter


def bench_rx(x, cap, cfg, spec, n_iter=10):
    """Static and SIG-driven dynamic receivers over the whole capture."""
    import jax
    import numpy as np

    from jrc.models import streaming

    n_samples = BLOCK_LEN * N_BLOCKS
    f = jax.jit(lambda xx: _counts(streaming.scan_rx(
        cfg, spec, xx, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES)))
    t0 = time.perf_counter()
    n_valid, n_crc = (int(v) for v in np.asarray(f(x)))
    compile_s = time.perf_counter() - t0
    _log(f"static compile+first-run {compile_s:.1f}s, {n_valid}/{cap.n_frames} "
         f"frames, crc {n_crc}")
    dt = _time(f, x, n_iter=n_iter)
    _log(f"static {dt * 1e3:.3f} ms/iter")

    fd = jax.jit(lambda xx: _counts(streaming.scan_rx_dynamic(
        cfg, xx, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
        max_payload=DYN_MAX_PAYLOAD)))
    d_valid, d_crc = (int(v) for v in np.asarray(fd(x)))
    dyn_dt = _time(fd, x, n_iter=max(2, n_iter // 2))
    _log(f"dynamic {dyn_dt * 1e3:.3f} ms/iter, {d_valid} frames, crc {d_crc}")
    return {
        "sps": n_samples / dt,
        "compile_s": compile_s,
        "n_valid": n_valid,
        "n_crc": n_crc,
        "correct": n_valid == cap.n_frames and n_crc == cap.n_frames,
        "dynamic_sps": n_samples / dyn_dt,
        "dynamic_crc_ok": d_crc,
        "dynamic_correct": d_valid == cap.n_frames and d_crc == cap.n_frames,
    }


def bench_radar_jrc(dev, n_iter=20):
    """Radar dwell rate and JRC closed-loop rate on the device (reference
    operating point: 25 Hz, TRX grc update_period=0.04)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import jrc_trx, radar_chain
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    targets = channel.Targets(
        ranges=(12.0,), velocities=(5.0,), azimuths=(25.0,), rcs=(10.0,))
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    payload = jax.device_put(
        jnp.asarray(make_payload(spec, bytes([2]) + b"bench jrc")), dev)
    key = jax.random.key(0)

    def dwell(k):
        r = radar_chain.radar_frame(cfg, spec, payload, targets, key=k)
        return jnp.stack([r.estimate.detected.astype(jnp.float32),
                          r.estimate.range_m])

    fd = jax.jit(dwell)
    d0 = np.asarray(fd(key))
    dwell_s = _time(fd, key, n_iter=n_iter)

    def loop_step(state, k):
        r = jrc_trx.jrc_step(cfg, state, spec, payload, targets, key=k,
                             comm_noise_var=1e-4)
        return r.state, jnp.stack([r.radar_est.detected.astype(jnp.float32),
                                   r.comm.decoded.crc_ok.astype(jnp.float32)])

    fj = jax.jit(loop_step)
    state, _ = fj(jrc_trx.init_state(cfg), key)  # compile + dwell 1
    t0 = time.perf_counter()
    for _ in range(n_iter):
        state, out = fj(state, key)
    jlast = np.asarray(out)
    loop_s = (time.perf_counter() - t0) / n_iter
    return {
        "radar_dwell_hz": 1.0 / dwell_s,
        "jrc_loop_hz": 1.0 / loop_s,
        "radar_detected": bool(d0[0] > 0),
        # steady-state link: dwell 1 runs on the Fourier fallback before the
        # radar-aided loop closes (same contract as tests/test_jrc.py)
        "jrc_crc_ok": bool(jlast[1] > 0),
    }


def bench_sustained(dev, cap, cfg, spec):
    """Ingest-inclusive sustained throughput: IQ ring → h2d → flat RX
    kernel, double-buffered (ingest of superblock k+1 overlaps compute of
    superblock k), on both wire formats: fc32 (float32 (re, im), 8 B/sample,
    the reference's host format) and sc16 (int16 (re, im), 4 B/sample, UHD's
    native OTW format, dequantized on the device)."""
    import jax
    import numpy as np

    from jrc.io.stream import BlockStreamer
    from jrc.ops import cplx as cx

    n_samples = BLOCK_LEN * N_BLOCKS
    samples = cap.samples[:n_samples]
    out = {}
    for wire in ("fc32", "sc16"):
        streamer = BlockStreamer(
            cfg, spec, block_len=BLOCK_LEN, n_blocks=N_BLOCKS,
            max_frames=MAX_FRAMES, device=dev, pipeline_depth=2,
            ring_capacity=4 * n_samples, wire=wire,
        )
        streamer.push(cap.samples)  # warm pass: compile + first h2d
        for _ in streamer.process_available():
            pass

        # isolated h2d rate of one superblock (the pipeline's transfer leg)
        if wire == "sc16":
            staged = np.clip(np.rint(samples.view(np.float32) * 32767.0),
                             -32767, 32767).astype(np.int16).reshape(-1, 2)
            bytes_per_sample = 4
        else:
            staged = cx.CArray(np.ascontiguousarray(samples.real),
                               np.ascontiguousarray(samples.imag))
            bytes_per_sample = 8
        jax.block_until_ready(jax.device_put(staged, dev))
        t0 = time.perf_counter()
        jax.block_until_ready(jax.device_put(staged, dev))
        t_h2d = time.perf_counter() - t0

        # timed: two superblocks through the full pipeline, pushes included
        crc_before = streamer.stats.crc_ok
        t0 = time.perf_counter()
        streamer.push(samples)
        streamer.push(samples)
        for _ in streamer.process_available():
            pass
        wall = time.perf_counter() - t0
        crc = streamer.stats.crc_ok - crc_before
        tag = "" if wire == "fc32" else "_sc16"
        out[f"sustained{tag}_sps"] = 2 * n_samples / wall
        out[f"sustained{tag}_crc_ok"] = int(crc)
        # the ring's trailing halo keeps the final straddling frame pending
        # until more samples arrive (exactly-once streaming ownership), so
        # up to one boundary frame is legitimately still queued
        out[f"sustained{tag}_ok"] = int(crc) >= 2 * cap.n_frames - 1
        out[f"h2d{tag}_MBps"] = n_samples * bytes_per_sample / 1e6 / t_h2d
    out["sustained_frames_expected"] = 2 * cap.n_frames
    return out


def main() -> int:
    import jax
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import capture, streaming
    from jrc.ops import cplx as cx
    from jrc.ops.encoder import FrameSpec
    from jrc.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    halo = max(streaming.frame_window_samples(cfg, spec),
               streaming.frame_window_samples_dynamic(cfg, DYN_MAX_PAYLOAD)
               ) + cfg.fft_len
    cap = capture.impaired_capture(cfg, spec, BLOCK_LEN * N_BLOCKS, halo=halo)
    x = jax.device_put(cx.CArray(np.ascontiguousarray(cap.samples.real),
                                 np.ascontiguousarray(cap.samples.imag)), dev)
    res = bench_rx(x, cap, cfg, spec)
    res.update(bench_radar_jrc(dev))
    res.update(bench_sustained(dev, cap, cfg, spec))

    out = {
        "metric": "jrc_rx_chain_throughput",
        "value": res.pop("sps"),
        "unit": "samples/s/chip",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "frames_per_capture": cap.n_frames,
        "frames_decoded": res.pop("n_valid"),
        "crc_ok": res.pop("n_crc"),
        "impairments": "cfo 0.02/fft_len + awgn 25 dB SNR",
        "dynamic_max_payload": DYN_MAX_PAYLOAD,
        **res,
    }
    out["vs_baseline"] = out["value"] / BASELINE_SPS
    print(json.dumps(out))
    ok = (out["correct"] and out["dynamic_correct"] and out["jrc_crc_ok"]
          and out["sustained_ok"] and out["sustained_sc16_ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
