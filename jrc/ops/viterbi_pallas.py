"""Pallas (Triton route) Viterbi kernel for Hopper GPUs.

The ``lax.scan`` decoder (ops/viterbi.py) runs the add-compare-select
recursion as T sequential steps of tiny XLA kernels plus a reverse
traceback scan of the same length, so every trellis step pays launch
latency. Here one program owns a tile of ``BLOCK_B`` frames, one frame per
thread, and runs the whole trellis inside a loop:

* forward ACS: the 64 path metrics of a frame live in registers as 64
  separate (BLOCK_B,) vectors. The butterfly's state permutation
  (predecessors of s' are s'>>1 and (s'>>1)+32) is then a renaming of those
  vectors at trace time: no shuffle is executed. Branch costs take only four
  values (±va ± vb), built once per step. The 64 decision bits of a step are
  packed into two uint32 words and stored to global memory (8 B per step per
  frame, L2-resident at bench widths). The loop runs ``UNROLL`` steps per
  iteration and loads the next iteration's branch values before this one's
  stores;
* traceback: after a block barrier the same program walks the packed
  words backwards from the best end state (prefetched the same way) and
  writes one bit per step.

Frames sit on threads, so a frame never exchanges data with another thread:
the per-step work is elementwise over the tile. Bit-identical to
ops.viterbi.viterbi_decode (tests/test_viterbi.py, tests/test_pallas_interpret.py)
modulo equal-metric ties.

Replaces the reference's sample-serial SSE2 decoder
(lib/viterbi_decoder.cc:99-294) on the GPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from jrc.ops.viterbi import N_STATES, _trellis

BLOCK_B = 32  # frames per program: one warp, one frame per thread
UNROLL = 4  # trellis steps per loop iteration: fastest of 1/2/4/8 on the H100,
#             and compiles in seconds (16 took minutes)


def _or_tree(xs):
    while len(xs) > 1:
        xs = [xs[i] | xs[i + 1] for i in range(0, len(xs) - 1, 2)] + (
            [xs[-1]] if len(xs) % 2 else [])
    return xs[0]


def _viterbi_kernel(va_ref, vb_ref, dec_ref, bits_ref, *, n_chunks: int,
                    unroll: int, barrier: bool):
    """va/vb (T', B') values, dec (T', 2, B') packed decisions (scratch
    output), bits (T', B') decoded bits; this program owns BLOCK_B columns."""
    cols = pl.ds(pl.program_id(0) * BLOCK_B, BLOCK_B)
    prev, sa, sb = _trellis()

    def acs(t, pm, va, vb):
        p = va + vb
        m = va - vb
        # branch cost −(sa·va + sb·vb), exactly as the scan computes it
        cost = {(1.0, 1.0): -p, (1.0, -1.0): -m, (-1.0, 1.0): m, (-1.0, -1.0): p}
        new, dec = [], []
        for s in range(N_STATES):
            c0 = pm[prev[s, 0]] + cost[(float(sa[s, 0]), float(sb[s, 0]))]
            c1 = pm[prev[s, 1]] + cost[(float(sa[s, 1]), float(sb[s, 1]))]
            d = c1 < c0
            new.append(jnp.where(d, c1, c0))
            dec.append(d)
        for w in range(2):
            words = [jnp.where(dec[32 * w + k], jnp.uint32(1 << k), jnp.uint32(0))
                     for k in range(32)]
            dec_ref[t, w, cols] = _or_tree(words)
        return tuple(new)

    # Loads of chunk c+1 are issued before chunk c's stores (carried in the
    # loop state): the compiler cannot move a load above a store to another
    # ref, so loading at the point of use would expose its latency per step.
    def load_values(c):
        return tuple((va_ref[c * unroll + u, cols], vb_ref[c * unroll + u, cols])
                     for u in range(unroll))

    def chunk(c, carry):
        pm, vals = carry
        nxt = load_values(jnp.minimum(c + 1, n_chunks - 1))
        for u in range(unroll):
            pm = acs(c * unroll + u, pm, *vals[u])
        # a uniform shift never changes decisions; keeps metrics bounded
        lo = pm[0]
        for x in pm[1:]:
            lo = jnp.minimum(lo, x)
        return tuple(x - lo for x in pm), nxt

    zero = jnp.zeros((BLOCK_B,), jnp.float32)
    pm0 = (zero,) + tuple(zero + 1e9 for _ in range(N_STATES - 1))
    pm, _ = jax.lax.fori_loop(0, n_chunks, chunk, (pm0, load_values(0)))

    # best end state (first index on ties, as jnp.argmin)
    best, state = pm[0], jnp.zeros((BLOCK_B,), jnp.int32)
    for s in range(1, N_STATES):
        better = pm[s] < best
        best = jnp.where(better, pm[s], best)
        state = jnp.where(better, jnp.int32(s), state)

    if barrier:  # decision words written above are read by the same block
        pltriton.debug_barrier()

    def load_words(c):  # chunk c of the reversed walk, prefetched likewise
        t0 = (n_chunks - 1 - c) * unroll
        return tuple((dec_ref[t0 + u, 0, cols], dec_ref[t0 + u, 1, cols])
                     for u in range(unroll))

    def back(c, carry):
        state, words = carry
        nxt = load_words(jnp.minimum(c + 1, n_chunks - 1))
        for u in reversed(range(unroll)):
            t = (n_chunks - 1 - c) * unroll + u
            word = jnp.where(state < 32, *words[u])
            j = (word >> (state & 31).astype(jnp.uint32)) & jnp.uint32(1)
            bits_ref[t, cols] = (state & 1).astype(jnp.uint8)
            state = (state >> 1) + 32 * j.astype(jnp.int32)
        return state, nxt

    jax.lax.fori_loop(0, n_chunks, back, (state, load_words(0)))


def viterbi_decode_pallas(
    values: jax.Array,
    n_out: int | None = None,
    *,
    unroll: int = UNROLL,
    interpret: bool = False,
) -> jax.Array:
    """Full Viterbi decode in one Pallas Triton kernel.

    (…, 2T) channel values → (…, T) bits; same conventions and output as
    ops.viterbi.viterbi_decode. The trellis is zero-padded (zero = erasure)
    to an ``unroll`` multiple and the batch to a BLOCK_B multiple; erasure
    steps leave the optimal path and the decoded bits of real steps intact.
    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests only, where a smaller ``unroll`` keeps XLA:CPU compiles short).
    """
    batch_shape = values.shape[:-1]
    t_steps = values.shape[-1] // 2
    v = values.reshape(-1, t_steps, 2).astype(jnp.float32)
    b = v.shape[0]
    n_chunks = -(-t_steps // unroll)
    t_pad = n_chunks * unroll
    b_pad = -(-b // BLOCK_B) * BLOCK_B
    v = jnp.pad(v, ((0, b_pad - b), (0, t_pad - t_steps), (0, 0)))
    va = jnp.transpose(v[:, :, 0])  # (T', B'): one coalesced row per step
    vb = jnp.transpose(v[:, :, 1])

    _, bits = pl.pallas_call(
        partial(_viterbi_kernel, n_chunks=n_chunks, unroll=unroll,
                barrier=not interpret),
        grid=(b_pad // BLOCK_B,),
        out_shape=[
            jax.ShapeDtypeStruct((t_pad, 2, b_pad), jnp.uint32),
            jax.ShapeDtypeStruct((t_pad, b_pad), jnp.uint8),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=BLOCK_B // 32,
                                                num_stages=1),
        interpret=interpret,
        name="viterbi_acs_traceback",
    )(va, vb)

    bits = jnp.transpose(bits[:t_steps, :b]).reshape(*batch_shape, t_steps)
    if n_out is not None:
        bits = bits[..., :n_out]
    return bits
