"""Mesh construction helpers: single-host, multi-host, batch sharding.

The distribution layer the reference never had (single process; SURVEY §2.3):
meshes over the cards of one host and across hosts via ``jax.distributed``.
The cards of a host reach each other all to all, so a mesh follows the
algorithm alone (a 1-D ``time`` axis for the sharded stream).
"""
from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op when single-process."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        # leave None when unset: jax.distributed auto-detects the world
        # size where the cluster environment provides it — forcing 1 would
        # make every host a rank-0 single-process world
        num_processes = int(env) if env is not None else None
    if process_id is None:  # explicit rank 0 must not fall through to env
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env is not None else None
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def time_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over time blocks (sequence-parallel streaming)."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), ("time",))


def batch_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over independent dwells/captures (data parallel)."""
    devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), ("batch",))


def grid_mesh(n_time: int, n_batch: int) -> Mesh:
    """2-D (batch, time) mesh: batches of captures, each time-sharded."""
    devices = np.asarray(jax.devices()[: n_time * n_batch]).reshape(n_batch, n_time)
    return Mesh(devices, ("batch", "time"))


def shard_batch(mesh: Mesh, x, axis_name: str = "batch"):
    """Place a leading-batch array with P(axis_name) sharding."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
