// jrc_runtime — native host-side runtime for the JRC framework.
//
// Plays the role GNU Radio's C++ runtime plays for the reference
// (single-writer circular buffers + scheduler, SURVEY §1 L0): a lock-free
// SPSC ring buffer for continuous complex64 IQ ingest and an overlapped
// block framer that emits fixed-size device-upload blocks with halo/history
// regions for the time-block streaming executor
// (jrc/parallel/streaming.py). The producer side (file reader, UDP,
// radio driver) and the consumer side (jax.device_put + jitted RX) run on
// different threads without locks.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libjrc_runtime.so jrc_runtime.cc
//
// All sizes are in complex64 samples (8 bytes each).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>

namespace {

// One ring template serves both wire formats: fc32 (float re,im — the
// reference's host-side format, lib/usrp_mimo_trx_impl.cc:219-238 streams
// fc32) and sc16 (int16 re,im — UHD's native over-the-wire format, half the
// bytes/sample; dequantization happens on-device at the head of the RX
// kernel).
template <typename T>
struct Ring {
  T* data = nullptr;          // interleaved re,im — capacity*2 elements
  size_t capacity = 0;        // samples, power of two
  size_t mask = 0;
  std::atomic<uint64_t> head{0};  // written samples (producer)
  // Producer-visible reclaim point. Lags the consumer position by the
  // history reservation so already-consumed samples re-read as left history
  // cannot be overwritten by a racing producer.
  std::atomic<uint64_t> tail{0};
  uint64_t consumer_pos = 0;  // consumer-private logical read position
  std::atomic<uint64_t> dropped{0};
};

inline size_t round_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T>
Ring<T>* ring_create(size_t capacity_samples) {
  Ring<T>* r = new (std::nothrow) Ring<T>();
  if (!r) return nullptr;
  r->capacity = round_pow2(capacity_samples);
  r->mask = r->capacity - 1;
  r->data = static_cast<T*>(std::malloc(r->capacity * 2 * sizeof(T)));
  if (!r->data) {
    delete r;
    return nullptr;
  }
  return r;
}

template <typename T>
void ring_destroy(Ring<T>* r) {
  if (!r) return;
  std::free(r->data);
  delete r;
}

template <typename T>
size_t ring_push(Ring<T>* r, const T* iq, size_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_samples = r->capacity - static_cast<size_t>(head - tail);
  size_t accept = n < free_samples ? n : free_samples;
  if (accept < n)
    r->dropped.fetch_add(n - accept, std::memory_order_relaxed);
  size_t idx = static_cast<size_t>(head) & r->mask;
  size_t first = r->capacity - idx;
  if (first > accept) first = accept;
  std::memcpy(r->data + 2 * idx, iq, first * 2 * sizeof(T));
  if (accept > first)
    std::memcpy(r->data, iq + 2 * first, (accept - first) * 2 * sizeof(T));
  r->head.store(head + accept, std::memory_order_release);
  return accept;
}

template <typename T>
int ring_pop_block(Ring<T>* r, T* out, size_t block_len, size_t halo,
                   size_t left_hist) {
  if (left_hist >= r->capacity) return 0;
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t pos0 = r->consumer_pos;
  if (static_cast<size_t>(head - pos0) < block_len + halo) return 0;

  size_t n_out = left_hist + block_len + halo;
  for (size_t i = 0; i < n_out; ++i) {
    int64_t pos = static_cast<int64_t>(pos0) -
                  static_cast<int64_t>(left_hist) + static_cast<int64_t>(i);
    if (pos < 0) {  // before stream start: zero history
      out[2 * i] = 0;
      out[2 * i + 1] = 0;
    } else {
      size_t idx = static_cast<size_t>(pos) & r->mask;
      out[2 * i] = r->data[2 * idx];
      out[2 * i + 1] = r->data[2 * idx + 1];
    }
  }
  r->consumer_pos = pos0 + block_len;
  uint64_t reserve = r->consumer_pos > left_hist
                         ? r->consumer_pos - left_hist
                         : 0;
  r->tail.store(reserve, std::memory_order_release);
  return 1;
}

using RingF = Ring<float>;
using RingS16 = Ring<int16_t>;

}  // namespace

extern "C" {

// ---- fc32 ring (float re,im) -------------------------------------------

void* jrc_ring_create(size_t capacity_samples) {
  return ring_create<float>(capacity_samples);
}

void jrc_ring_destroy(void* h) { ring_destroy(static_cast<RingF*>(h)); }

size_t jrc_ring_capacity(void* h) { return static_cast<RingF*>(h)->capacity; }

uint64_t jrc_ring_dropped(void* h) {
  return static_cast<RingF*>(h)->dropped.load(std::memory_order_relaxed);
}

// Samples currently readable by the consumer.
size_t jrc_ring_available(void* h) {
  RingF* r = static_cast<RingF*>(h);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->consumer_pos);
}

// Producer: push n complex samples (interleaved float re,im). Returns the
// number accepted; excess is dropped (congestion behaves like the
// reference's matrix_transpose frame-drop backpressure hack,
// lib/matrix_transpose_impl.cc:86-89 — bounded loss, never blocking).
size_t jrc_ring_push(void* h, const float* iq, size_t n) {
  return ring_push(static_cast<RingF*>(h), iq, n);
}

// Consumer: pop one streaming block into out:
//   [ left_hist | block_len | halo ]
// left_hist samples re-read from already-consumed history (zeros if not yet
// available), halo samples peeked beyond the block without consuming them.
// Consumes exactly block_len samples. Returns 1 on success, 0 if fewer than
// block_len + halo samples are buffered.
int jrc_ring_pop_block(void* h, float* out, size_t block_len, size_t halo,
                       size_t left_hist) {
  return ring_pop_block(static_cast<RingF*>(h), out, block_len, halo,
                        left_hist);
}

// ---- sc16 ring (int16 re,im — UHD's native OTW format, 4 B/sample) ------
//
// The quantized wire path: radios hand the host sc16 (the reference's
// fc32 streamer boundary, lib/usrp_mimo_trx_impl.cc:219-238, converts it on
// the host — this ring skips that conversion AND halves host→device bytes);
// the RX kernel dequantizes on-device.

void* jrc_ring16_create(size_t capacity_samples) {
  return ring_create<int16_t>(capacity_samples);
}

void jrc_ring16_destroy(void* h) { ring_destroy(static_cast<RingS16*>(h)); }

size_t jrc_ring16_capacity(void* h) {
  return static_cast<RingS16*>(h)->capacity;
}

uint64_t jrc_ring16_dropped(void* h) {
  return static_cast<RingS16*>(h)->dropped.load(std::memory_order_relaxed);
}

size_t jrc_ring16_available(void* h) {
  RingS16* r = static_cast<RingS16*>(h);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->consumer_pos);
}

// Push native sc16 samples (interleaved int16 re,im) — zero-copy-convert
// path for radio drivers that already deliver sc16.
size_t jrc_ring16_push(void* h, const int16_t* iq, size_t n) {
  return ring_push(static_cast<RingS16*>(h), iq, n);
}

// Push float IQ with host-side quantization (round-to-nearest, saturating):
// the producer-side conversion a simulated/file source needs. `scale` maps
// float full-scale to int16 full-scale (UHD convention: ±1.0 ↔ ±32767).
size_t jrc_ring16_push_fc32(void* h, const float* iq, size_t n, float scale) {
  RingS16* r = static_cast<RingS16*>(h);
  // quantize in bounded chunks on the stack, then reuse the common push
  constexpr size_t kChunk = 4096;
  int16_t buf[2 * kChunk];
  size_t accepted = 0;
  for (size_t off = 0; off < n; off += kChunk) {
    size_t m = n - off < kChunk ? n - off : kChunk;
    for (size_t i = 0; i < 2 * m; ++i) {
      float v = iq[2 * off + i] * scale;
      v = v > 32767.f ? 32767.f : (v < -32767.f ? -32767.f : v);
      buf[i] = static_cast<int16_t>(std::lrintf(v));
    }
    size_t got = ring_push(r, buf, m);
    accepted += got;
    if (got < m) {  // ring full: count the untouched remainder as dropped
      r->dropped.fetch_add(n - off - m, std::memory_order_relaxed);
      break;
    }
  }
  return accepted;
}

int jrc_ring16_pop_block(void* h, int16_t* out, size_t block_len, size_t halo,
                         size_t left_hist) {
  return ring_pop_block(static_cast<RingS16*>(h), out, block_len, halo,
                        left_hist);
}

// Bulk convenience: deinterleave/copy float32 IQ from a file-like buffer is
// handled in Python; here we only provide a fast power computation used by
// host-side squelch (mean |x|^2 over n samples).
float jrc_mean_power(const float* iq, size_t n) {
  double acc = 0.0;
  for (size_t i = 0; i < n; ++i) {
    double re = iq[2 * i], im = iq[2 * i + 1];
    acc += re * re + im * im;
  }
  return n ? static_cast<float>(acc / n) : 0.f;
}

}  // extern "C"
