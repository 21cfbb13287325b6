"""Throughput counters and profiler hooks.

Device-side replacement for GNU Radio's performance counters
(pc_work_time/pc_*_buffers_full, SURVEY §5): explicit samples/s and frames/s
tracking around the jitted kernels plus a thin wrapper over ``jax.profiler``
for trace capture.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass
class Throughput:
    """Rolling throughput counter (samples and frames per second)."""

    samples: int = 0
    frames: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, n_samples: int = 0, n_frames: int = 0):
        assert self._t0 is not None
        self.seconds += time.perf_counter() - self._t0
        self.samples += n_samples
        self.frames += n_frames
        self._t0 = None

    @contextlib.contextmanager
    def measure(self, n_samples: int = 0, n_frames: int = 0):
        self.start()
        try:
            yield
        finally:
            self.stop(n_samples, n_frames)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return (f"{self.samples_per_sec/1e6:.2f} Msamp/s, "
                f"{self.frames_per_sec:.1f} frames/s over {self.seconds:.2f}s")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
