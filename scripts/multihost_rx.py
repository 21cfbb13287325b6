#!/usr/bin/env python3
"""Multi-host streaming RX: one process per "host", joined by jax.distributed.

Executes the SURVEY §5 distribution bullet end-to-end: each process calls
``parallel.mesh.init_distributed`` (the coordinator/rank entry a real
multi-host deployment uses), forms a global mesh over every process's
devices, and runs the time-block sharded streaming RX with ppermute halo
exchange crossing the process boundary. On this rig the "hosts" are
localhost processes with CPU devices — the same code path, with gRPC
standing in for the inter-host network.

Run one process per rank (the test harness spawns both):

    python scripts/multihost_rx.py --coordinator 127.0.0.1:9876 \
        --num-processes 2 --process-id 0
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=2)
    p.add_argument("--block-len", type=int, default=16384)
    p.add_argument("--dynamic", action="store_true",
                   help="also run the SIG-driven dynamic executor")
    p.add_argument("--bench", type=int, default=0, metavar="BATCHES",
                   help="after the correctness pass, time the jitted step "
                        "(16 iters/batch, medians reported per rank) — the "
                        "N>=2-hosts measurement point of BASELINE.md")
    args = p.parse_args(argv)

    import jax

    # CPU backend with N virtual devices per process, set before first use
    # so a spawned child never opens a GPU
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_process)

    from jrc.parallel.mesh import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    assert jax.process_count() == args.num_processes, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == args.num_processes * args.devices_per_process
    print(f"[rank {args.process_id}] {n_local} local / {n_global} global "
          f"devices", flush=True)

    import jax.numpy as jnp
    import numpy as np

    from jrc.config import MCS, OFDMConfig, PacketType
    from jrc.models import comm_link
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload
    from jrc.parallel import streaming as pstream

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=16,
                     packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"multihost"))
    tx = comm_link.tx_frame(cfg, spec, payload, 1)
    frame = np.asarray(channel.comm_channel(
        tx.samples, angle_deg=0.0, path_loss=5.0, noise_var=0.0))

    # identical capture on every rank (deterministic), one frame per device
    # block. ODD blocks place the frame so its tail crosses into the next
    # block (the trigger stays owned by block d): decoding those frames
    # REQUIRES the ppermute'd right-halo — including, at d = devices/proc−1,
    # halo data shipped across the process boundary. A broken
    # cross-process halo therefore fails the count assertions below.
    block_len = args.block_len
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (n_global * block_len, 2)) @ [1, 1j]
           ).astype(np.complex64)
    assert block_len > 2 * len(frame)
    for d in range(n_global):
        if d % 2 == 1 and d < n_global - 1:
            pos = (d + 1) * block_len - len(frame) // 3  # straddles d → d+1
        else:
            pos = d * block_len + (d * 977) % (block_len - len(frame) - 8)
        cap[pos : pos + len(frame)] += frame

    mesh = pstream.make_time_mesh(n_global)
    res = pstream.sharded_rx(cfg, spec, mesh, jnp.asarray(cap),
                             max_frames_per_block=4)
    # n_frames / n_crc_ok are psum-reduced and fully replicated — every
    # rank can read them without a cross-process gather
    n_frames = int(np.asarray(res.n_frames))
    n_ok = int(np.asarray(res.n_crc_ok))
    assert n_frames == n_global, (n_frames, n_global)
    assert n_ok == n_global, (n_ok, n_global)

    if args.dynamic:
        res_d = pstream.sharded_rx_dynamic(
            cfg, mesh, jnp.asarray(cap), max_frames_per_block=4,
            max_payload=32)
        nf_d = int(np.asarray(res_d.n_frames))
        ok_d = int(np.asarray(res_d.n_crc_ok))
        assert nf_d == n_global and ok_d == n_global, (nf_d, ok_d)

    print(f"MULTIHOST_OK rank={args.process_id} n_frames={n_frames} "
          f"crc_ok={n_ok} dynamic={bool(args.dynamic)}", flush=True)

    if args.bench:
        import statistics
        import time

        from jax.sharding import NamedSharding, PartitionSpec as P
        from jrc.ops import cplx as cx

        # time the cached jitted step on pre-staged input (the same
        # methodology as scripts/measure_scaling.py): per-rank process CPU
        # time is additive across this rank's device threads, so
        # cpu_ms / devices_per_process is the per-device work INCLUDING the
        # cross-process halo leg
        jitted = pstream._build_sharded_rx(
            cfg, spec, mesh, block_len, 4, 0.6, 10, "ls", False, 0)
        xs = jax.device_put(cx.from_complex(jnp.asarray(cap)),
                            NamedSharding(mesh, P("time")))
        jax.block_until_ready(jitted(xs))
        n_iter = 16
        t_b, c_b = [], []
        for _ in range(args.bench):
            t0, c0 = time.time(), time.process_time()
            for _ in range(n_iter):
                out = jitted(xs)
            jax.block_until_ready(out[-1])
            t_b.append((time.time() - t0) / n_iter)
            c_b.append((time.process_time() - c0) / n_iter)
        t_med = statistics.median(t_b)
        c_med = statistics.median(c_b)
        sps = n_global * block_len / t_med
        print(f"MULTIHOST_BENCH rank={args.process_id} "
              f"t_ms={t_med * 1e3:.2f} cpu_ms={c_med * 1e3:.2f} "
              f"cpu_per_device_ms={c_med * 1e3 / n_local:.2f} "
              f"samples_per_s={sps:.0f}", flush=True)

    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
