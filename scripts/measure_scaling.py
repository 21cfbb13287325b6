"""Scaling measurement for the time-block sharded streaming RX, written
to chiprun_out/scaling.json.

Weak scaling on the virtual CPU mesh: one 32k-sample block per device, so
ideal scaling keeps step time constant as devices are added. Each mesh size
runs in its own subprocess (the CPU device count is fixed at backend init).

## Method (what each number means)

This host has 2 physical cores, so WALL-clock time beyond 2 virtual devices
measures scheduler time-sharing, not hardware scaling — wall columns are
reported for transparency but are not the headline.

The headline is derived from per-device WORK time (process CPU time), which
time-sharing cannot distort because CPU time is additive across time-shared
threads. Round-5 methodology fixes (r4's point estimates were noisy enough
to produce efficiency > 1 and negative halo shares):

* **Same-program baseline.** Efficiency is referenced to the N=1 *sharded*
  step (`shard_map` over a 1-device mesh), not a separately-compiled
  standalone program — the r4 baseline mixed two compilations of the same
  math, and their code-generation differences exceeded the effect being
  measured. The standalone single-block program is still reported
  (`cpu_standalone_ms`) as a sanity column.
* **Jitted step only, pre-staged input.** The timed loop calls the cached
  jitted executable on an input already placed with its P('time')
  sharding; per-call host staging (re/im split + device_put) amortizes
  differently with N and contaminated r4's per-device CPU accounting.
* **Medians ± IQR over POOLED passes.** ``PASSES`` interleaved sweeps,
  each mesh size in a fresh subprocess per pass, all per-batch samples
  pooled per size (r4 used best-of-3 in one process; subprocess-level
  variance — turbo state, page cache, compile residue — dominated
  single-pass medians). Spread is propagated into an efficiency error bar.
* **Thread discipline.** Multi-threaded Eigen kernels are disabled in the
  children (`--xla_cpu_multi_thread_eigen=false`) and dispatch is
  synchronous (`jax_cpu_enable_async_dispatch=False`), so each device's
  work executes on one thread and CPU time attribution is per-device.

Definitions (medians):

* ``cpu_per_device_ms = cpu_sharded_ms / N``
* ``work_efficiency(N) = cpu_per_device_ms(1) / cpu_per_device_ms(N)``
  (1.0 = the mesh adds no per-device work; must be ≤ 1 + noise)
* ``collective_halo_share(N) = 1 − work_efficiency(N)`` — the per-device
  CPU-time fraction spent on halo exchange/psum machinery. XLA:CPU worker
  threads spin-wait at collective barriers, so waiting counts as work:
  both numbers are UPPER bounds on true mesh cost; on real multi-chip
  hardware the exchange rides the interconnect while the core computes.

Usage: python scripts/measure_scaling.py            # driver, writes JSON
       python scripts/measure_scaling.py --one N    # single mesh size
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK_LEN = 1 << 15
N_ITER = 16
N_BATCH = 7


def _med_iqr(xs):
    xs = sorted(xs)
    med = statistics.median(xs)
    n = len(xs)
    iqr = xs[(3 * n) // 4] - xs[n // 4]
    return med, iqr


def run_one(n_dev: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n_dev)
    try:  # synchronous dispatch: removes queueing jitter from CPU-time
        jax.config.update("jax_cpu_enable_async_dispatch", False)
    except Exception:
        pass

    import numpy as np
    import jax.numpy as jnp

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import comm_link, streaming
    from jrc.ops import channel, cplx as cx
    from jrc.ops.encoder import FrameSpec, make_payload
    from jrc.parallel import streaming as pstream
    from jrc.utils.cache import enable_compile_cache

    enable_compile_cache()
    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"scaling"))
    tx = comm_link.tx_frame(cfg, spec, payload, 1)
    frame = np.asarray(
        channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0)
    )
    rng = np.random.default_rng(0)
    cap = (
        rng.normal(0, 1e-4, (n_dev * BLOCK_LEN, 2)).view(np.complex128)[:, 0]
    ).astype(np.complex64)
    for d in range(n_dev):  # 3 frames per block
        for k in range(3):
            pos = d * BLOCK_LEN + 600 + k * ((BLOCK_LEN - len(frame) - 700) // 3)
            cap[pos : pos + len(frame)] += frame

    mesh = pstream.make_time_mesh(n_dev)
    x = jnp.asarray(cap)

    # sharded step (halo exchange + psum over the mesh)
    res = pstream.sharded_rx(cfg, spec, mesh, x, max_frames_per_block=6)
    assert int(np.asarray(res.n_frames)) == 3 * n_dev, int(np.asarray(res.n_frames))
    assert int(np.asarray(res.n_crc_ok)) == 3 * n_dev

    # time ONLY the jitted step on a pre-staged sharded input: per-call host
    # staging (re/im split + device_put of the whole capture) amortizes
    # differently with N and contaminated the r4 per-device CPU accounting
    # (efficiency > 1 at some N). The cached jitted executable is the same
    # object sharded_rx dispatches.
    from jax.sharding import NamedSharding, PartitionSpec as P

    jitted = pstream._build_sharded_rx(
        cfg, spec, mesh, BLOCK_LEN, 6, 0.6, 10, "ls", False, 0)
    xs = jax.device_put(cx.from_complex(x), NamedSharding(mesh, P("time")))
    jax.block_until_ready(jitted(xs))
    t_batches, c_batches = [], []
    for _ in range(N_BATCH):
        t0, c0 = time.time(), time.process_time()
        for _ in range(N_ITER):
            out = jitted(xs)
        jax.block_until_ready(out[-1])
        t_batches.append((time.time() - t0) / N_ITER)
        c_batches.append((time.process_time() - c0) / N_ITER)
    t_med, t_iqr = _med_iqr(t_batches)
    c_med, c_iqr = _med_iqr(c_batches)

    # sanity column: standalone per-device program (the shard_map body's
    # flat_rx over one [left-hist | block | halo] window, no collectives)
    halo = streaming.frame_window_samples(cfg, spec) + cfg.fft_len
    lh = streaming.left_history_samples(cfg)
    blk = np.concatenate(
        [np.zeros(lh, np.complex64), cap[:BLOCK_LEN],
         np.zeros(halo, np.complex64)]
    )
    fn = jax.jit(
        lambda v: streaming.flat_rx(
            cfg, spec, v, BLOCK_LEN, 1, lh, max_frames=6,
        ).crc_ok.sum()
    )
    xb = cx.from_complex(jnp.asarray(blk))
    assert int(np.asarray(fn(xb))) == 3
    cs_batches = []
    for _ in range(N_BATCH):
        c0 = time.process_time()
        for _ in range(N_ITER):
            out = fn(xb)
        jax.block_until_ready(out)
        cs_batches.append((time.process_time() - c0) / N_ITER)
    cs_med, cs_iqr = _med_iqr(cs_batches)

    print(json.dumps({
        "n_devices": n_dev,
        "t_sharded_ms": round(t_med * 1e3, 2),
        "t_sharded_iqr_ms": round(t_iqr * 1e3, 2),
        "cpu_sharded_ms": round(c_med * 1e3, 2),
        "cpu_sharded_iqr_ms": round(c_iqr * 1e3, 2),
        "cpu_standalone_ms": round(cs_med * 1e3, 2),
        "cpu_standalone_iqr_ms": round(cs_iqr * 1e3, 2),
        "samples_per_s": round(n_dev * BLOCK_LEN / t_med, 1),
        "frames": 3 * n_dev,
        "batches": N_BATCH,
        "iters_per_batch": N_ITER,
        # raw per-batch samples so the driver can POOL across passes
        # (subprocess-level variance — turbo state, page cache, compile
        # residue — dominates single-process medians)
        "t_batches_ms": [round(t * 1e3, 3) for t in t_batches],
        "cpu_batches_ms": [round(c * 1e3, 3) for c in c_batches],
        "cpu_standalone_batches_ms": [round(c * 1e3, 3) for c in cs_batches],
    }))
    return 0


PASSES = 3  # interleaved sweeps: fresh subprocess per (pass, N), samples
#             POOLED per N — subprocess-level variance (turbo, page cache)
#             dominated single-pass medians


def main() -> int:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # children never open a GPU
    flags = env.get("XLA_FLAGS", "")
    # one thread per device program: CPU-time attribution is per-device
    env["XLA_FLAGS"] = (flags + " --xla_cpu_multi_thread_eigen=false").strip()
    sizes = (1, 2, 4, 8)
    pooled = {n: {"t": [], "cpu": [], "standalone": []} for n in sizes}
    for _pass in range(PASSES):
        for n in sizes:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", str(n)],
                capture_output=True, text=True, timeout=1800, env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
            line = [l for l in p.stdout.splitlines() if l.startswith("{")]
            if not line:
                print(json.dumps({"n_devices": n, "error": p.stderr[-300:]}))
                continue
            row = json.loads(line[-1])
            pooled[n]["t"] += row["t_batches_ms"]
            pooled[n]["cpu"] += row["cpu_batches_ms"]
            pooled[n]["standalone"] += row["cpu_standalone_batches_ms"]
            print(json.dumps({k: row[k] for k in (
                "n_devices", "cpu_sharded_ms", "t_sharded_ms")}), flush=True)

    rows = []
    for n in sizes:
        t_med, t_iqr = _med_iqr(pooled[n]["t"])
        c_med, c_iqr = _med_iqr(pooled[n]["cpu"])
        cs_med, cs_iqr = _med_iqr(pooled[n]["standalone"])
        rows.append({
            "n_devices": n,
            "t_sharded_ms": round(t_med, 2),
            "t_sharded_iqr_ms": round(t_iqr, 2),
            "cpu_sharded_ms": round(c_med, 2),
            "cpu_sharded_iqr_ms": round(c_iqr, 2),
            "cpu_standalone_ms": round(cs_med, 2),
            "cpu_standalone_iqr_ms": round(cs_iqr, 2),
            "samples_per_s": round(n * BLOCK_LEN / (t_med / 1e3), 1),
            "frames": 3 * n,
            "batches": PASSES * N_BATCH,
            "iters_per_batch": N_ITER,
        })
        print(json.dumps(rows[-1]), flush=True)

    base = rows[0]
    base_pd = base["cpu_sharded_ms"] / base["n_devices"]
    base_rel_err = base["cpu_sharded_iqr_ms"] / max(base["cpu_sharded_ms"], 1e-9)
    for r in rows:
        n = r["n_devices"]
        r["cpu_per_device_ms"] = round(r["cpu_sharded_ms"] / n, 2)
    best_pd = min(r["cpu_per_device_ms"] for r in rows)
    for r in rows:
        eff = base_pd / max(r["cpu_per_device_ms"], 1e-9)
        rel_err = (base_rel_err
                   + r["cpu_sharded_iqr_ms"] / max(r["cpu_sharded_ms"], 1e-9))
        r["work_efficiency"] = round(eff, 3)
        r["work_efficiency_err"] = round(eff * rel_err, 3)
        # conservative, physical-by-construction view: anchored at the
        # cleanest (lowest) per-device work observed, so values are ≤ 1.0
        # and 1 − eff_vs_best bounds the mesh cost relative to the best
        # observed per-device work
        r["eff_vs_best"] = round(
            best_pd / max(r["cpu_per_device_ms"], 1e-9), 3)
        r["collective_halo_share_ub"] = round(1.0 - r["eff_vs_best"], 3)
        # wall columns kept for transparency (time-shared beyond 2 cores)
        r["weak_scaling_wall"] = round(
            base["t_sharded_ms"] / r["t_sharded_ms"], 3
        )
    monotone = all(
        rows[i]["work_efficiency"] + rows[i]["work_efficiency_err"]
        >= rows[i + 1]["work_efficiency"] - rows[i + 1]["work_efficiency_err"]
        for i in range(len(rows) - 1)
    )
    pds = [r["cpu_per_device_ms"] for r in rows]
    out = {
        "metric": "sharded_rx_weak_scaling",
        "block_len": BLOCK_LEN,
        "physical_cores": os.cpu_count(),
        "method": (
            "work_efficiency(N) = [cpu_sharded(1)/1] / [cpu_sharded(N)/N]: "
            "median process-CPU-time of the SAME shard_map program (cached "
            "jitted executable, pre-staged P('time') input) at mesh size 1 "
            "vs N, POOLED over {p} interleaved passes x {b} batches x {i} "
            "steps (fresh subprocess per pass+size: subprocess-level "
            "variance dominated single-pass medians), IQR propagated into "
            "work_efficiency_err — additive across time-shared threads, so "
            "oversubscription of the {c}-core host cannot distort it. "
            "CAVEAT (why raw efficiency can read > 1): at N=1 the XLA:CPU "
            "thread pool runs at low occupancy and its idle/handoff spin "
            "counts as CPU time, inflating the baseline; at larger N that "
            "spin is displaced by other devices' real work. eff_vs_best "
            "anchors at the lowest observed per-device work instead — it "
            "is ≤ 1.0 by construction and collective_halo_share_ub = "
            "1 − eff_vs_best upper-bounds the mesh cost. "
            "cpu_standalone_ms sanity-checks the per-device program without "
            "collectives. Wall columns for transparency only."
        ).format(p=PASSES, b=N_BATCH, i=N_ITER, c=os.cpu_count()),
        "efficiency_monotone_within_error": monotone,
        "per_device_cpu_ms_range": [min(pds), max(pds)],
        "per_device_cpu_flat_within_pct": round(
            100.0 * (max(pds) - min(pds)) / min(pds), 1),
        "points": rows,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chiprun_out", "scaling.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # preserve sections owned by other measurement scripts (multihost)
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            for k in ("multihost",):
                if k in prev:
                    out[k] = prev[k]
        except (json.JSONDecodeError, OSError):
            pass
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(int(sys.argv[2])))
    sys.exit(main())
