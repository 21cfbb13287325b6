"""Multi-host path: 2 localhost processes through jax.distributed.

Executes ``parallel.mesh.init_distributed`` and the time-block sharded streaming RX over a
global mesh whose ppermute halo exchange crosses the process boundary.
"""
import os
import subprocess
import sys

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "multihost_rx.py")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_rx():
    port = _free_port()
    env = dict(os.environ)
    # the children pick their own platform/device config; drop any
    # test-harness XLA_FLAGS forcing a different device count
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"  # children never open a GPU
    procs = [
        subprocess.Popen(
            [sys.executable, SCRIPT,
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(rank),
             "--devices-per-process", "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert f"MULTIHOST_OK rank={rank} n_frames=4 crc_ok=4" in out, out[-2000:]
