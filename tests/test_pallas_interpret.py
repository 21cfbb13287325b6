"""The GPU kernel, its plain references, and the choice between them.

* The Triton Viterbi kernel (`ops/viterbi_pallas.py`) runs here through the
  Pallas interpreter (`interpret=True`) and must match the scan decoder
  bit-for-bit; the ``gpu``-marked case compiles it for the card.
* The detection front end and the frame-window gather are plain XLA on
  every backend; they are checked against numpy loops and slices.
* `viterbi_backend='auto'` picks the kernel on 'gpu', the scan on 'cpu', and
  refuses any other platform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import OFDMConfig
from jrc.models import streaming
from jrc.ops import cplx as cx, sync
from jrc.ops.sync import gather_rows
from jrc.ops.viterbi import viterbi_decode
from jrc.ops.viterbi_pallas import viterbi_decode_pallas

CFG = OFDMConfig()


def _random_values(b, t, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0  # erasures
    return vals


# (3, 576) runs the production unroll; the others a shorter one, which
# keeps the interpreter's XLA:CPU compile short
@pytest.mark.parametrize("b,t,unroll", [(5, 100, 2), (3, 576, 4), (2, 864, 2)])
def test_viterbi_pallas_matches_scan(b, t, unroll):
    vals = _random_values(b, t, b * 1000 + t)
    ref = np.asarray(viterbi_decode(vals))
    out = np.asarray(viterbi_decode_pallas(vals, unroll=unroll, interpret=True))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.gpu
def test_viterbi_pallas_on_gpu_matches_scan(gpu):
    """The kernel as compiled for the card, at a bench-like tile count."""
    vals = _random_values(200, 576, 5)
    ref = np.asarray(jax.jit(viterbi_decode)(vals))
    out = np.asarray(jax.jit(viterbi_decode_pallas)(vals))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("backend,expect", [
    ("cpu", viterbi_decode),
    ("gpu", viterbi_decode_pallas),
    ("rocm", RuntimeError),
])
def test_auto_viterbi_backend_choice(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is RuntimeError:
        with pytest.raises(RuntimeError, match="no Viterbi formulation"):
            streaming._viterbi_backend("auto")
    else:
        assert streaming._viterbi_backend("auto") is expect


def _numpy_front_end(x, threshold, min_n_peaks, mpd):
    """Sample-by-sample float64 loop over the detector chain: lag-16
    autocorrelation over a 32-sample window, 48-sample power, the
    gap-tolerant trigger, the sparsifier and the per-segment first trigger."""
    lag, win = CFG.fft_len // 4, CFG.fft_len // 2
    pwin = int(1.5 * win)
    n = len(x)
    xx = x.astype(np.complex128)
    a = np.zeros(n, np.complex128)
    cor = np.zeros(n)
    for i in range(n):
        k = np.arange(max(0, i - win + 1), i + 1)
        k = k[k - lag >= 0]
        a[i] = np.sum(xx[k] * np.conj(xx[k - lag]))
        p = np.sum(np.abs(xx[max(0, i - pwin + 1): i + 1]) ** 2) / 1.5
        cor[i] = np.abs(a[i]) / max(p, 1e-12)
    mask = (cor > threshold) & (cor < 2.0)
    trig = np.zeros(n, bool)
    for i in range(n):
        trig[i] = mask[i] and mask[max(0, i - mpd + 1): i + 1].sum() > min_n_peaks
    sparse = np.zeros(n, bool)
    for i in range(n):
        sparse[i] = trig[i] and not trig[max(0, i - mpd + 1): i].any()
    n_seg = -(-n // sync.SEG)
    first = np.full(n_seg, sync.SEG, np.int32)
    for i in np.flatnonzero(sparse):
        first[i // sync.SEG] = min(first[i // sync.SEG], i % sync.SEG)
    return a, cor, first


def _xla_front_end(x: cx.CArray, threshold, min_n_peaks, mpd):
    """The ops.sync formulation the receivers run."""
    n = x.shape[-1]
    a, cor = sync.autocorrelation(CFG, x)
    mask = (cor > threshold) & (cor < 2.0)
    trigger = sync._gap_tolerant_triggers(mask, min_n_peaks, mpd)
    tf = trigger.astype(jnp.float32)
    trigger = trigger & (sync.moving_sum(tf, mpd) - tf == 0)
    n_seg = -(-n // sync.SEG)
    tseg = jnp.pad(trigger, (0, n_seg * sync.SEG - n)).reshape(n_seg, sync.SEG)
    first = jnp.where(jnp.any(tseg, axis=-1),
                      jnp.argmax(tseg, axis=-1).astype(jnp.int32), sync.SEG)
    return a, first


@pytest.mark.parametrize("n", [8192, 16384])
def test_detect_front_end_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 0.1, n) + 1j * rng.normal(0, 0.1, n)
    # lag-16-periodic plateaus (STF-like) so real triggers fire, one of them
    # straddling the middle of the stream
    block = rng.normal(0, 1, 16) + 1j * rng.normal(0, 1, 16)
    for pos in (1000, n // 2 - 200, n // 2 + 1500, n - 1500):
        x[pos : pos + 800] = np.tile(block, 50)
    x = x.astype(np.complex64)

    mpd = 2 * CFG.sym_len
    a_ref, cor_ref, first_ref = _numpy_front_end(x, 0.6, 10, mpd)
    # exact mask comparison needs no sample within float32 rounding of a
    # threshold (a property of these inputs, checked rather than assumed)
    assert np.min(np.abs(cor_ref - 0.6)) > 1e-4
    assert np.min(np.abs(cor_ref - 2.0)) > 1e-4
    a, first = _xla_front_end(cx.from_complex(jnp.asarray(x)), 0.6, 10, mpd)

    assert int((first_ref < sync.SEG).sum()) >= 4  # the plateaus did trigger
    np.testing.assert_array_equal(np.asarray(first), first_ref)
    # float32 moving sums vs a float64 loop: 1e-4 covers float32 rounding
    # of 32-term sums at unit scale
    np.testing.assert_allclose(np.asarray(a.re), a_ref.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.im), a_ref.imag, rtol=1e-4, atol=1e-4)


def test_gather_rows_matches_slices():
    rng = np.random.default_rng(7)
    n, b, width = 8192, 11, 300
    xs = rng.normal(0, 1, (2, n)).astype(np.float32)
    x = cx.CArray(jnp.asarray(xs[0]), jnp.asarray(xs[1]))
    starts = rng.integers(0, n - width, b).astype(np.int32)  # unaligned
    out = gather_rows(x, jnp.asarray(starts), width)
    ref = np.stack([xs[:, s : s + width] for s in starts])
    np.testing.assert_array_equal(np.asarray(out.re), ref[:, 0])
    np.testing.assert_array_equal(np.asarray(out.im), ref[:, 1])


def test_gather_rows_clamps_like_dynamic_slice():
    rng = np.random.default_rng(8)
    n, width = 2048, 256
    xs = rng.normal(0, 1, (2, n)).astype(np.float32)
    x = cx.CArray(jnp.asarray(xs[0]), jnp.asarray(xs[1]))
    starts = jnp.asarray([-5, n - 10, n + 100, 0], jnp.int32)
    out = gather_rows(x, starts, width)
    clamped = np.clip(np.asarray(starts), 0, n - width)
    ref = np.stack([xs[:, s : s + width] for s in clamped])
    np.testing.assert_array_equal(np.asarray(out.re), ref[:, 0])
    np.testing.assert_array_equal(np.asarray(out.im), ref[:, 1])
