"""jrc — a JAX-native MIMO-OFDM joint radar-communication framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``ceyhunozkaptan/gr-mimo-ofdm-jrc`` (GNU Radio 3.8 / C++): an 802.11a-like
OFDM PHY with 4-TX MIMO precoding that simultaneously carries data and acts
as a MIMO OFDM radar, including radar-assisted precoding.

Layout:
    config    — typed static configuration (OFDM numerology, sequences, MCS)
    ops       — pure-functional batched DSP kernels (jit/vmap/shard_map ready)
    models    — the five system configurations as composed pipelines
    parallel  — device-mesh sharding: time-block streaming, halo exchange
    utils     — bits/CRC helpers, rolling stats, logging
    io        — host ingest boundary (simulated TRX, UDP PDU parity)
    viz       — offline heatmap / time-scatter rendering
"""

from jrc.config import MCS, OFDMConfig, PacketType, DEFAULT_CONFIG

__version__ = "0.1.0"

__all__ = ["MCS", "OFDMConfig", "PacketType", "DEFAULT_CONFIG", "__version__"]
