"""Batched Viterbi decoder for the K=7, rate-1/2 convolutional code.

Batched replacement for the reference's SSE2 implementation
(``lib/viterbi_decoder.cc:99-294``). Instead of SIMD butterflies over one
frame, the add-compare-select recursion runs as a ``lax.scan`` over time with
all 64 path metrics of every frame in one array and an arbitrary leading
batch dimension (frames × symbols): every step is a (B, 64, 2) gather + min.
This is the plain reference and the CPU path; the GPU runs the same
recursion as one Triton kernel (ops/viterbi_pallas.py).

Design points:

* unified branch metrics: the decoder consumes *channel values* ``v`` with
  sign convention ``v > 0 ⇒ bit 1``; hard bits map to ±1 and punctured
  (erased) positions to 0, so depuncturing (reference
  ``lib/viterbi_decoder.cc:38-96``) is just a scatter of values into zeros —
  soft-decision decoding falls out for free.
* decisions are stored per step as two packed uint32 words per batch element
  (64 states × 1 bit) instead of 64 bytes — 8× less device-memory traffic for the
  traceback tensor.
* full traceback from the best end state (the reference zero-terminates only
  the pre-pad tail, so the trellis does not end in state 0; argmin over final
  metrics is the optimal truncated-sequence choice).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import CONV_POLY_A, CONV_POLY_B, MCS
from jrc.ops.coding import depuncture

N_STATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for k in range(7):
        out ^= (x >> k) & 1
    return out


@lru_cache(maxsize=1)
def _trellis():
    """Static trellis tables.

    prev[s', j]  : predecessor state j∈{0,1} of next-state s'
    sign_a/b[s', j] : ±1 expected-output signs (2·e−1) for polys 0o155/0o117
    """
    s_next = np.arange(N_STATES)
    j = np.arange(2)
    prev = (s_next[:, None] >> 1) + 32 * j[None, :]  # (64, 2)
    full7 = (prev << 1) | (s_next[:, None] & 1)  # 7-bit register
    e_a = _parity(full7 & CONV_POLY_A)
    e_b = _parity(full7 & CONV_POLY_B)
    return (
        prev.astype(np.int32),
        (2 * e_a - 1).astype(np.float32),
        (2 * e_b - 1).astype(np.float32),
    )


def hard_to_values(bits: jax.Array) -> jax.Array:
    """Hard bits {0,1} → channel values {−1,+1} (float32)."""
    return (2.0 * bits.astype(jnp.float32)) - 1.0


def viterbi_decode(
    values: jax.Array, n_out: int | None = None, unroll: int = 8
) -> jax.Array:
    """Decode (..., 2·T) channel values → (..., T) bits.

    ``values`` follow the ``v > 0 ⇒ bit 1`` convention with 0 = erasure.
    ``n_out`` optionally truncates the returned bit count (default T).
    ``unroll`` amortizes per-step loop overhead over several trellis steps
    (the scan body is tiny, so per-step dispatch dominates otherwise).
    """
    prev_np, sa_np, sb_np = _trellis()
    prev = jnp.asarray(prev_np)
    sign_a = jnp.asarray(sa_np)
    sign_b = jnp.asarray(sb_np)

    batch_shape = values.shape[:-1]
    n_steps = values.shape[-1] // 2
    v = values.reshape(-1, n_steps, 2).astype(jnp.float32)  # (B, T, 2)
    B = v.shape[0]

    pm0 = jnp.full((B, N_STATES), 1e9, jnp.float32).at[:, 0].set(0.0)
    state_weights = jnp.asarray(
        (1 << (np.arange(N_STATES) % 32)).astype(np.uint32)
    )

    def acs(pm, v_t):
        va = v_t[:, 0][:, None, None]
        vb = v_t[:, 1][:, None, None]
        # branch cost: −(2e−1)·v  (negative when the value agrees with e)
        bm = -(sign_a[None] * va + sign_b[None] * vb)  # (B, 64, 2)
        cand = pm[:, prev] + bm  # (B, 64, 2)
        dec = cand[..., 1] < cand[..., 0]  # (B, 64) True ⇒ take j=1
        new_pm = jnp.where(dec, cand[..., 1], cand[..., 0])
        # renormalize so metrics stay bounded for arbitrarily long frames
        new_pm = new_pm - jnp.min(new_pm, axis=-1, keepdims=True)
        # pack 64 decision bits → 2 uint32 words per batch element
        bits = jnp.where(dec, state_weights[None], jnp.uint32(0))
        w0 = jnp.bitwise_or.reduce(bits[:, :32], axis=-1)
        w1 = jnp.bitwise_or.reduce(bits[:, 32:], axis=-1)
        return new_pm, (w0, w1)

    v_t = jnp.moveaxis(v, 1, 0)  # (T, B, 2)
    pm_final, (w0s, w1s) = jax.lax.scan(acs, pm0, v_t, unroll=unroll)

    end_state = jnp.argmin(pm_final, axis=-1).astype(jnp.int32)  # (B,)

    def traceback(state, words):
        w0, w1 = words  # (B,) uint32 each
        word = jnp.where(state < 32, w0, w1)
        j = (word >> (state % 32).astype(jnp.uint32)) & 1
        bit = (state & 1).astype(jnp.uint8)
        prev_state = (state >> 1) + 32 * j.astype(jnp.int32)
        return prev_state, bit

    _, bits_rev = jax.lax.scan(
        traceback, end_state, (w0s, w1s), reverse=True, unroll=unroll
    )
    bits = jnp.moveaxis(bits_rev, 0, 1)  # (B, T)
    bits = bits.reshape(*batch_shape, n_steps)
    if n_out is not None:
        bits = bits[..., :n_out]
    return bits


def viterbi_decode_chunked(
    values: jax.Array,
    n_out: int | None = None,
    chunk_len: int = 128,
) -> jax.Array:
    """Chunk-parallel Viterbi: identical output to :func:`viterbi_decode`,
    ~4·L+2·T/L sequential steps instead of 2·T.

    The trellis is cut into C chunks of L steps. Min-plus transfer matrices
    per chunk (computed with (B,C,64,64) lanes), a short scan combines them
    into per-chunk entry metrics, ACS re-runs inside all chunks in parallel
    to record decisions, backpointer maps compose within chunks to give
    exit→entry state maps, and a C-step scan pins the survivor path's chunk
    boundary states before a final parallel within-chunk traceback. Trades
    ~32× more arithmetic for ~L× fewer sequential steps (the reference's
    SSE2 decoder is sample-serial, lib/viterbi_decoder.cc:99-294).
    """
    prev_np, sa_np, sb_np = _trellis()
    prev = jnp.asarray(prev_np)  # (64, 2)
    sign_a = jnp.asarray(sa_np)
    sign_b = jnp.asarray(sb_np)

    batch_shape = values.shape[:-1]
    t_steps = values.shape[-1] // 2
    L = chunk_len
    C = -(-t_steps // L)
    pad = C * L - t_steps
    v = values.reshape(-1, t_steps, 2).astype(jnp.float32)
    B = v.shape[0]
    if pad:
        v = jnp.pad(v, ((0, 0), (0, pad), (0, 0)))  # zero = erasure

    # branch metrics bm[t, b, s', j]
    va = v[..., 0]
    vb = v[..., 1]
    bm = -(sign_a[None, None] * va[..., None, None]
           + sign_b[None, None] * vb[..., None, None])  # (B, C·L, 64, 2)
    bm = bm.reshape(B, C, L, N_STATES, 2)
    bm_l = jnp.moveaxis(bm, 2, 0)  # (L, B, C, 64, 2)

    inf = jnp.float32(1e9)

    # ---- phase A: per-chunk transfer matrices (B, C, 64_entry, 64_exit)
    eye0 = jnp.where(jnp.eye(N_STATES, dtype=bool), 0.0, inf)
    m0 = jnp.broadcast_to(eye0, (B, C, N_STATES, N_STATES))

    def a_step(m, bm_t):
        # m[..., i, s]; new[..., i, s'] = min_j m[..., i, prev[s', j]] + bm_t[..., s', j]
        cand = m[..., prev] + bm_t[:, :, None, :, :]  # (B, C, 64, 64, 2)
        new = jnp.min(cand, axis=-1)
        return new - jnp.min(new, axis=(-2, -1), keepdims=True), None

    m_chunks, _ = jax.lax.scan(a_step, m0, bm_l)

    # ---- phase B: chunk entry metrics
    pm0 = jnp.full((B, N_STATES), inf).at[:, 0].set(0.0)

    def b_step(pm, m_c):  # m_c (B, 64, 64)
        entry = pm
        nxt = jnp.min(pm[:, :, None] + m_c, axis=1)
        nxt = nxt - jnp.min(nxt, axis=-1, keepdims=True)
        return nxt, entry

    pm_final, entries = jax.lax.scan(b_step, pm0, jnp.moveaxis(m_chunks, 1, 0))
    entries = jnp.moveaxis(entries, 0, 1)  # (B, C, 64)

    # ---- phase C: in-chunk ACS from entry metrics, recording decisions
    def c_step(pm, bm_t):  # pm (B, C, 64)
        cand = pm[..., prev] + bm_t  # (B, C, 64, 2)
        dec = cand[..., 1] < cand[..., 0]
        new = jnp.where(dec, cand[..., 1], cand[..., 0])
        new = new - jnp.min(new, axis=-1, keepdims=True)
        return new, dec

    _, decs = jax.lax.scan(c_step, entries, bm_l)  # decs (L, B, C, 64) bool

    # ---- phase D/E: compose backpointer maps within chunks (exit → entry)
    id_map = jnp.broadcast_to(jnp.arange(N_STATES)[None, None, :], (B, C, N_STATES))

    def e_step(maps, dec_t):
        p = (jnp.arange(N_STATES)[None, None, :] >> 1) + 32 * dec_t.astype(jnp.int32)
        new = jnp.take_along_axis(p, maps, axis=-1)
        return new, None

    exit_to_entry, _ = jax.lax.scan(e_step, id_map, decs, reverse=True)

    # chunk boundary states, sequential (C steps): exit of chunk c
    end_state = jnp.argmin(pm_final, axis=-1).astype(jnp.int32)  # (B,)

    def bound_step(exit_next, maps_c):  # maps_c (B, 64)
        entry = jnp.take_along_axis(maps_c, exit_next[:, None], axis=-1)[:, 0]
        return entry, exit_next

    _, exits = jax.lax.scan(
        bound_step, end_state, jnp.moveaxis(exit_to_entry, 1, 0), reverse=True
    )  # exits (C, B): exit state of each chunk

    # ---- phase F: parallel within-chunk traceback
    exits_bc = jnp.moveaxis(exits, 0, 1)  # (B, C)

    def f_step(state, dec_t):  # state (B, C)
        d = jnp.take_along_axis(dec_t, state[..., None], axis=-1)[..., 0]
        bit = (state & 1).astype(jnp.uint8)
        prev_state = (state >> 1) + 32 * d.astype(jnp.int32)
        return prev_state, bit

    _, bits_rev = jax.lax.scan(f_step, exits_bc, decs, reverse=True)
    bits = jnp.moveaxis(bits_rev, 0, -1)  # (B, C, L)
    bits = bits.reshape(B, C * L)[:, :t_steps]
    bits = bits.reshape(*batch_shape, t_steps)
    if n_out is not None:
        bits = bits[..., :n_out]
    return bits


def decode_bits(rx_bits: jax.Array, mcs: MCS, n_data_bits: int) -> jax.Array:
    """Hard-decision decode of punctured coded bits.

    Mirrors reference ``viterbi_decoder::decode`` (lib/viterbi_decoder.cc:294):
    depuncture (erasures as 0-valued channel values) then Viterbi.
    ``rx_bits``: (..., n_punctured) bits; returns (..., n_data_bits).
    """
    values = depuncture(hard_to_values(rx_bits), mcs, 2 * n_data_bits, erasure=0.0)
    return viterbi_decode(values, n_out=n_data_bits)
