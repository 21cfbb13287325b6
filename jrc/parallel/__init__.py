"""Device-mesh parallelism: time-block sharded streaming with halo exchange.

The reference's concurrency model (GNU Radio thread-per-block pipeline over
ring buffers, SURVEY §2.3) maps to a ``jax.sharding.Mesh`` + ``shard_map``
design: a continuous RX capture is sharded along time across devices, frame
straddles are resolved by a right-neighbor halo exchanged with
``lax.ppermute`` between devices, and per-block results are gathered with XLA
collectives instead of NCCL/MPI.
"""
