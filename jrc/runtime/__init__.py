"""Native host runtime: C++ SPSC IQ ring buffer + overlapped block framer.

The JAX-native counterpart of GNU Radio's C++ runtime layer (thread-per-block
scheduler over single-writer circular buffers, SURVEY §1 L0). The shared
library is built on first import with g++ (cached by source mtime); a pure
numpy fallback keeps the framework functional without a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CC_DIR = os.path.join(os.path.dirname(__file__), "cc")
_SRC = os.path.join(_CC_DIR, "jrc_runtime.cc")
_SO = os.path.join(_CC_DIR, "libjrc_runtime.so")

_lib = None
_lib_err: str | None = None
_build_lock = threading.Lock()


def _build() -> None:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", _SO, _SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load_library():
    """Load (building if needed) the native runtime; None on failure."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
            lib.jrc_ring_create.restype = ctypes.c_void_p
            lib.jrc_ring_create.argtypes = [ctypes.c_size_t]
            lib.jrc_ring_destroy.argtypes = [ctypes.c_void_p]
            lib.jrc_ring_capacity.restype = ctypes.c_size_t
            lib.jrc_ring_capacity.argtypes = [ctypes.c_void_p]
            lib.jrc_ring_available.restype = ctypes.c_size_t
            lib.jrc_ring_available.argtypes = [ctypes.c_void_p]
            lib.jrc_ring_dropped.restype = ctypes.c_uint64
            lib.jrc_ring_dropped.argtypes = [ctypes.c_void_p]
            lib.jrc_ring_push.restype = ctypes.c_size_t
            lib.jrc_ring_push.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            lib.jrc_ring_pop_block.restype = ctypes.c_int
            lib.jrc_ring_pop_block.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
            lib.jrc_mean_power.restype = ctypes.c_float
            lib.jrc_mean_power.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            lib.jrc_ring16_create.restype = ctypes.c_void_p
            lib.jrc_ring16_create.argtypes = [ctypes.c_size_t]
            lib.jrc_ring16_destroy.argtypes = [ctypes.c_void_p]
            lib.jrc_ring16_capacity.restype = ctypes.c_size_t
            lib.jrc_ring16_capacity.argtypes = [ctypes.c_void_p]
            lib.jrc_ring16_available.restype = ctypes.c_size_t
            lib.jrc_ring16_available.argtypes = [ctypes.c_void_p]
            lib.jrc_ring16_dropped.restype = ctypes.c_uint64
            lib.jrc_ring16_dropped.argtypes = [ctypes.c_void_p]
            lib.jrc_ring16_push.restype = ctypes.c_size_t
            lib.jrc_ring16_push.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t]
            lib.jrc_ring16_push_fc32.restype = ctypes.c_size_t
            lib.jrc_ring16_push_fc32.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t, ctypes.c_float]
            lib.jrc_ring16_pop_block.restype = ctypes.c_int
            lib.jrc_ring16_pop_block.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
            _lib = lib
        except (subprocess.CalledProcessError, OSError) as e:
            _lib_err = str(e)
    return _lib


def _as_float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _RingBase:
    """Shared ctypes wrapper + numpy fallback for the SPSC rings — one
    implementation of the push/pop/history-reservation semantics, mirroring
    the C++ side's single Ring<T> template. Subclasses set ``_prefix`` (the
    extern-C symbol family) and the fallback item layout, and provide the
    format-specific push/pop entry points.
    """

    _prefix = ""

    def __init__(self, capacity: int):
        self._lib = load_library()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._fn("create")(capacity))
            if not self._h:
                raise MemoryError(f"{self._prefix}_create failed")
            self.capacity = int(self._fn("capacity")(self._h))
        else:  # numpy fallback (single-threaded semantics)
            self.capacity = 1
            while self.capacity < capacity:
                self.capacity *= 2
            self._buf = self._alloc_fallback(self.capacity)
            self._head = 0
            self._pos = 0
            self._dropped = 0
            self._hist_keep = 0  # left-history reservation (set by pop_block)
            self._h = None

    def _fn(self, name: str):
        return getattr(self._lib, f"{self._prefix}_{name}")

    @property
    def native(self) -> bool:
        return self._h is not None

    def available(self) -> int:
        if self._h is not None:
            return int(self._fn("available")(self._h))
        return self._head - self._pos

    def dropped(self) -> int:
        if self._h is not None:
            return int(self._fn("dropped")(self._h))
        return self._dropped

    def _push_fallback(self, items: np.ndarray) -> int:
        """Append item rows, reserving the consumer's left-history region
        like the native ring (jrc_runtime.cc tail = consumer_pos −
        left_hist): without it a full ring overwrites samples a later pop
        re-reads as history."""
        tail = max(self._pos - self._hist_keep, 0)
        free = self.capacity - (self._head - tail)
        n = min(len(items), free)
        self._dropped += len(items) - n
        idx = self._head % self.capacity
        first = min(self.capacity - idx, n)
        self._buf[idx : idx + first] = items[:first]
        if n > first:
            self._buf[: n - first] = items[first:n]
        self._head += n
        return n

    def _pop_fallback(self, out: np.ndarray, block_len: int, halo: int,
                      left_hist: int) -> np.ndarray | None:
        if self._head - self._pos < block_len + halo:
            return None
        self._hist_keep = max(self._hist_keep, left_hist)
        idx = self._pos - left_hist + np.arange(len(out))
        valid = idx >= 0
        if out.ndim > 1:
            valid = valid[:, None]
        out[...] = np.where(valid, self._buf[idx % self.capacity], 0)
        self._pos += block_len
        return out

    def close(self):
        if self._h is not None:
            self._fn("destroy")(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IQRing(_RingBase):
    """SPSC complex64 ring buffer with overlapped block pop.

    ``pop_block`` returns ``[left_hist | block_len | halo]`` complex samples —
    exactly the layout the streaming RX kernel consumes (left history for
    plateau run-length continuity, right halo for frame straddles). A numpy
    fallback is used when the native library is unavailable.
    """

    _prefix = "jrc_ring"

    @staticmethod
    def _alloc_fallback(capacity: int) -> np.ndarray:
        return np.zeros(capacity, np.complex64)

    def push(self, samples: np.ndarray) -> int:
        x = np.ascontiguousarray(samples, np.complex64)
        if self._h is not None:
            return int(self._fn("push")(
                self._h, _as_float_ptr(x.view(np.float32)), len(x)))
        return self._push_fallback(x)

    def pop_block(self, block_len: int, halo: int, left_hist: int) -> np.ndarray | None:
        n_out = left_hist + block_len + halo
        out = np.empty(n_out, np.complex64)
        if self._h is not None:
            ok = self._fn("pop_block")(
                self._h, _as_float_ptr(out.view(np.float32)),
                block_len, halo, left_hist)
            return out if ok else None
        return self._pop_fallback(out, block_len, halo, left_hist)


#: sc16 full-scale convention (UHD: float ±1.0 ↔ int16 ±32767)
SC16_SCALE = 32767.0


class IQRing16(_RingBase):
    """SPSC sc16 (int16 re,im) ring buffer with overlapped block pop.

    The quantized wire path (4 B/sample vs the fc32 ring's 8): radios
    deliver sc16 natively (UHD's OTW format — the reference converts to
    fc32 host-side at lib/usrp_mimo_trx_impl.cc:219-238); keeping samples
    quantized through the ring AND the host→device transfer halves ingest
    bandwidth, with dequantization fused into the head of the RX kernel.

    ``pop_block`` returns an (n_out, 2) int16 array laid out
    ``[left_hist | block_len | halo]``; dequantize with
    ``x = q.astype(float32) / (SC16_SCALE / full_scale)``.
    """

    _prefix = "jrc_ring16"

    def __init__(self, capacity: int, full_scale: float = 1.0):
        self.full_scale = float(full_scale)
        self._q_scale = SC16_SCALE / self.full_scale
        super().__init__(capacity)

    @staticmethod
    def _alloc_fallback(capacity: int) -> np.ndarray:
        return np.zeros((capacity, 2), np.int16)

    def push(self, samples: np.ndarray) -> int:
        """Quantize complex64 (or float (n, 2)) samples onto the wire."""
        if np.iscomplexobj(samples):
            x = np.ascontiguousarray(samples, np.complex64).view(np.float32)
        else:
            x = np.ascontiguousarray(samples, np.float32).reshape(-1)
        n = len(x) // 2
        if self._h is not None:
            return int(self._fn("push_fc32")(
                self._h, _as_float_ptr(x), n, ctypes.c_float(self._q_scale)))
        q = np.clip(np.rint(x * self._q_scale), -32767, 32767).astype(np.int16)
        return self._push_fallback(q.reshape(-1, 2))

    def push_sc16(self, samples: np.ndarray) -> int:
        """Push already-quantized int16 samples ((n, 2) or interleaved)."""
        q = np.ascontiguousarray(samples, np.int16).reshape(-1, 2)
        if self._h is not None:
            return int(self._fn("push")(
                self._h,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                q.shape[0]))
        return self._push_fallback(q)

    def pop_block(self, block_len: int, halo: int, left_hist: int) -> np.ndarray | None:
        n_out = left_hist + block_len + halo
        out = np.empty((n_out, 2), np.int16)
        if self._h is not None:
            ok = self._fn("pop_block")(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                block_len, halo, left_hist)
            return out if ok else None
        return self._pop_fallback(out, block_len, halo, left_hist)


def mean_power(samples: np.ndarray) -> float:
    """Fast host-side mean |x|² (squelch helper)."""
    x = np.ascontiguousarray(samples, np.complex64)
    lib = load_library()
    if lib is not None:
        return float(lib.jrc_mean_power(_as_float_ptr(x.view(np.float32)), len(x)))
    return float(np.mean(np.abs(x) ** 2)) if len(x) else 0.0
