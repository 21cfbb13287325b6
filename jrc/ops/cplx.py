"""Complex-free complex arithmetic: (re, im) float pairs + DFT-as-matmul.

Why this module exists
======================
The receive and radar chains are written against one pair form so every
stage runs the same arithmetic on every backend:

* a complex multiply is 4 mul + 2 add, elementwise work that XLA fuses
  into its neighbours;
* an N-point FFT at the sizes this framework uses (64 / 128 / 512) is a
  dense DFT **matmul**, batched over OFDM symbols — and fftshift /
  ifftshift / zero-padding fuse into the constant matrix for free,
  removing three separate ops per transform that the reference pays for
  with dedicated GNU Radio blocks (shifted ``fft_vxx``, ``matrix_transpose``
  zero-pad, lib/mimo_ofdm_radar_impl.cc:303-315).

Whether native complex64 and cuFFT beat the pair form on the GPU has not
been measured yet.

``CArray`` is a registered pytree of two equal-shaped float arrays, with
operator overloads implementing complex arithmetic, so DSP code written
against this module reads like the textbook math. Helper functions dispatch
on type and also accept native complex jax arrays, which keeps host-side
(CPU) code and tests interoperable during I/O.

The framework-wide convention: **everything on-device is a CArray**; numpy
``complex64`` appears only at host I/O boundaries (file/UDP ingest, plots).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CArray", "carray", "from_complex", "to_complex", "is_carray",
    "zeros", "full_like", "conj", "real", "imag", "abs2", "cabs", "angle",
    "expj", "mul_conj", "where", "concatenate", "stack", "broadcast_to",
    "sum", "mean", "einsum", "matmul", "dft_mats", "apply_dft",
]


def _as_pair(other):
    """Coerce a scalar / real array / complex value into (re, im) operands."""
    if isinstance(other, CArray):
        return other.re, other.im
    if isinstance(other, complex):
        return jnp.float32(other.real), jnp.float32(other.imag)
    arr = jnp.asarray(other)
    if jnp.issubdtype(arr.dtype, jnp.complexfloating):
        return jnp.real(arr), jnp.imag(arr)
    return arr, None  # purely real


@jax.tree_util.register_pytree_node_class
class CArray:
    """Complex array as a (re, im) pair of real arrays (pytree leaf pair)."""

    __slots__ = ("re", "im")
    # win ufunc/operator dispatch against np/jnp arrays on the left
    __array_priority__ = 100.0

    def __init__(self, re, im):
        self.re = re
        self.im = im

    # -- pytree -----------------------------------------------------------
    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- shape protocol ----------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.re)

    @property
    def ndim(self):
        return jnp.ndim(self.re)

    @property
    def dtype(self):
        return jnp.asarray(self.re).dtype

    def __len__(self):
        return self.shape[0]

    def astype(self, dtype) -> "CArray":
        return CArray(jnp.asarray(self.re, dtype), jnp.asarray(self.im, dtype))

    def reshape(self, *shape) -> "CArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return CArray(jnp.reshape(self.re, shape), jnp.reshape(self.im, shape))

    def swapaxes(self, a, b) -> "CArray":
        return CArray(jnp.swapaxes(self.re, a, b), jnp.swapaxes(self.im, a, b))

    def transpose(self, *axes) -> "CArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        axes = axes or None
        return CArray(jnp.transpose(self.re, axes), jnp.transpose(self.im, axes))

    @property
    def T(self) -> "CArray":
        return self.transpose()

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def __array__(self, dtype=None, copy=None):
        """numpy conversion protocol → complex ndarray in ONE device transfer.

        Without this, ``np.asarray(carray)`` silently falls back to numpy's
        generic-sequence path: one JAX gather dispatch per element — minutes
        for a frame of samples instead of microseconds."""
        out = np.asarray(self.re) + 1j * np.asarray(self.im)
        if dtype is None:
            # preserve float64 pairs as complex128; don't silently downcast
            dtype = np.result_type(out.dtype, np.complex64)
            return out.astype(dtype, copy=False)
        # explicit dtype: let numpy's own casting rules (ComplexWarning /
        # ValueError on complex→real) surface instead of masking them
        return out.astype(dtype)

    # -- functional updates -------------------------------------------------
    @property
    def at(self) -> "_At":
        return _At(self)

    # -- arithmetic ---------------------------------------------------------
    def __neg__(self):
        return CArray(-self.re, -self.im)

    def __add__(self, o):
        ore, oim = _as_pair(o)
        return CArray(self.re + ore, self.im if oim is None else self.im + oim)

    __radd__ = __add__

    def __sub__(self, o):
        ore, oim = _as_pair(o)
        return CArray(self.re - ore, self.im if oim is None else self.im - oim)

    def __rsub__(self, o):
        return (-self).__add__(o)

    def __mul__(self, o):
        ore, oim = _as_pair(o)
        if oim is None:
            return CArray(self.re * ore, self.im * ore)
        return CArray(
            self.re * ore - self.im * oim, self.re * oim + self.im * ore
        )

    __rmul__ = __mul__

    def __truediv__(self, o):
        ore, oim = _as_pair(o)
        if oim is None:
            return CArray(self.re / ore, self.im / ore)
        d = ore * ore + oim * oim
        return CArray(
            (self.re * ore + self.im * oim) / d,
            (self.im * ore - self.re * oim) / d,
        )

    def __rtruediv__(self, o):
        ore, oim = _as_pair(o)
        num = CArray(ore, jnp.zeros_like(ore) if oim is None else oim)
        return num.__truediv__(self)

    def conj(self) -> "CArray":
        return CArray(self.re, -self.im)

    def __abs__(self):
        return cabs(self)

    def __repr__(self):
        return f"CArray(re={self.re!r}, im={self.im!r})"


class _At:
    def __init__(self, base: CArray):
        self._b = base

    def __getitem__(self, idx):
        return _AtIdx(self._b, idx)


class _AtIdx:
    def __init__(self, base: CArray, idx):
        self._b, self._i = base, idx

    def set(self, val) -> CArray:
        vre, vim = _as_pair(val)
        if vim is None:
            vim = jnp.zeros_like(jnp.asarray(vre))
        return CArray(
            self._b.re.at[self._i].set(vre), self._b.im.at[self._i].set(vim)
        )

    def add(self, val) -> CArray:
        vre, vim = _as_pair(val)
        re = self._b.re.at[self._i].add(vre)
        im = self._b.im if vim is None else self._b.im.at[self._i].add(vim)
        return CArray(re, im)

    def multiply(self, val) -> CArray:
        vre, vim = _as_pair(val)
        if vim is None:
            return CArray(
                self._b.re.at[self._i].multiply(vre),
                self._b.im.at[self._i].multiply(vre),
            )
        cur = self._b[self._i]
        return self.set(cur * CArray(vre, vim))


# ---------------------------------------------------------------------------
# constructors / converters
# ---------------------------------------------------------------------------

def carray(re, im) -> CArray:
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    re, im = jnp.broadcast_arrays(re, im)
    return CArray(re, im)


def is_carray(x) -> bool:
    return isinstance(x, CArray)


def from_complex(x) -> CArray:
    """numpy/jax complex (or real, or CArray) → CArray float32 pair."""
    if isinstance(x, CArray):
        return x
    if isinstance(x, (list, tuple)) or not hasattr(x, "dtype"):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return CArray(
            jnp.asarray(np.ascontiguousarray(x.real), jnp.float32),
            jnp.asarray(np.ascontiguousarray(x.imag), jnp.float32),
        )
    xr = jnp.real(x).astype(jnp.float32)
    xi = (
        jnp.imag(x).astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.complexfloating)
        else jnp.zeros_like(xr)
    )
    return CArray(xr, xi)


def to_complex(x) -> jax.Array:
    """CArray (or complex array) → native complex64 (host/CPU boundary only)."""
    if isinstance(x, CArray):
        return jnp.asarray(x.re, jnp.complex64) + 1j * jnp.asarray(
            x.im, jnp.complex64
        )
    return jnp.asarray(x, jnp.complex64)


def zeros(shape, dtype=jnp.float32) -> CArray:
    if isinstance(shape, int):
        shape = (shape,)
    return CArray(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def full_like(x: CArray, val: complex) -> CArray:
    return CArray(
        jnp.full_like(x.re, complex(val).real),
        jnp.full_like(x.im, complex(val).imag),
    )


# ---------------------------------------------------------------------------
# elementwise helpers (dispatch: CArray or native complex)
# ---------------------------------------------------------------------------

def conj(x):
    return x.conj() if isinstance(x, CArray) else jnp.conj(x)


def real(x):
    return x.re if isinstance(x, CArray) else jnp.real(x)


def imag(x):
    return x.im if isinstance(x, CArray) else jnp.imag(x)


def abs2(x):
    """|x|² as a real array (single fused elementwise op, no sqrt)."""
    if isinstance(x, CArray):
        return x.re * x.re + x.im * x.im
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.complexfloating):
        return jnp.real(x) ** 2 + jnp.imag(x) ** 2
    return jnp.square(x)


def cabs(x):
    if isinstance(x, CArray):
        return jnp.sqrt(abs2(x))
    return jnp.abs(x)


def angle(x):
    if isinstance(x, CArray):
        return jnp.arctan2(x.im, x.re)
    return jnp.angle(x)


def expj(theta) -> CArray:
    """exp(j·theta) for real theta — always returns the pair form."""
    theta = jnp.asarray(theta, jnp.float32)
    return CArray(jnp.cos(theta), jnp.sin(theta))


def mul_conj(a, b):
    """a · conj(b) — the correlation kernel primitive."""
    if isinstance(a, CArray) or isinstance(b, CArray):
        a = from_complex(a) if not isinstance(a, CArray) else a
        b = from_complex(b) if not isinstance(b, CArray) else b
        return CArray(
            a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im
        )
    return a * jnp.conj(b)


def where(cond, a, b):
    if isinstance(a, CArray) or isinstance(b, CArray):
        a = from_complex(a) if not isinstance(a, CArray) else a
        b = from_complex(b) if not isinstance(b, CArray) else b
        return CArray(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))
    return jnp.where(cond, a, b)


def _lift(fname):
    f = getattr(jnp, fname)

    def g(xs, *a, **k):
        if isinstance(xs, CArray):
            return CArray(f(xs.re, *a, **k), f(xs.im, *a, **k))
        if isinstance(xs, (list, tuple)) and any(isinstance(x, CArray) for x in xs):
            xs = [from_complex(x) if not isinstance(x, CArray) else x for x in xs]
            return CArray(f([x.re for x in xs], *a, **k), f([x.im for x in xs], *a, **k))
        return f(xs, *a, **k)

    g.__name__ = fname
    return g


concatenate = _lift("concatenate")
stack = _lift("stack")
flip = _lift("flip")
roll = _lift("roll")
pad = _lift("pad")
tile = _lift("tile")
repeat = _lift("repeat")
sum = _lift("sum")  # noqa: A001 - mirrors jnp.sum for CArray
mean = _lift("mean")
cumsum = _lift("cumsum")


def broadcast_to(x, shape):
    if isinstance(x, CArray):
        return CArray(jnp.broadcast_to(x.re, shape), jnp.broadcast_to(x.im, shape))
    return jnp.broadcast_to(x, shape)


def take(x, idx, axis=-1):
    if isinstance(x, CArray):
        return CArray(jnp.take(x.re, idx, axis), jnp.take(x.im, idx, axis))
    return jnp.take(x, idx, axis)


def dynamic_slice_in_dim(x, start, size, axis=-1):
    if isinstance(x, CArray):
        return CArray(
            jax.lax.dynamic_slice_in_dim(x.re, start, size, axis),
            jax.lax.dynamic_slice_in_dim(x.im, start, size, axis),
        )
    return jax.lax.dynamic_slice_in_dim(x, start, size, axis)


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------

def einsum(spec: str, a, b, precision=jax.lax.Precision.HIGHEST):
    """Complex einsum over pair operands (4 real einsums → 3 after CSE).

    Default precision is HIGHEST: a float32 product may otherwise run in
    TF32 on the GPU, which is too coarse for channel-estimation
    contractions."""
    if not (isinstance(a, CArray) or isinstance(b, CArray)):
        return jnp.einsum(spec, a, b, precision=precision)
    a = a if isinstance(a, CArray) else from_complex(a)
    b = b if isinstance(b, CArray) else from_complex(b)
    es = partial(jnp.einsum, spec, precision=precision)
    return CArray(
        es(a.re, b.re) - es(a.im, b.im), es(a.re, b.im) + es(a.im, b.re)
    )


def matmul(a, b, precision=jax.lax.Precision.HIGHEST):
    return einsum("...ij,...jk->...ik", a, b, precision=precision)


# ---------------------------------------------------------------------------
# DFT as matmul — fftshift / zero-pad fused into the constant matrix
# ---------------------------------------------------------------------------

def dft_mats(
    n_in: int,
    n_out: int | None = None,
    *,
    inverse: bool = False,
    norm: str = "ortho",
    shift_in: bool = False,
    shift_out: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(C, S) float32 matrices with out = x @ (C + jS), |x| = n_in.

    * ``n_out > n_in`` implements transform-of-zero-padded-input without
      materializing the zeros (the radar interp trick,
      lib/mimo_ofdm_radar_impl.cc:303-315 / matrix_transpose zero-pad).
    * ``shift_in`` composes a prior ifftshift of the (padded) input;
      ``shift_out`` composes a posterior fftshift of the output. Both are
      row/column permutations of the constant matrix — free at runtime.
    * ``norm``: 'ortho' (1/√N both ways, framework standard), 'backward'
      (forward unscaled / inverse 1/N, numpy default), 'forward'.
    """
    N = n_out or n_in
    sign = 2j * np.pi / N if inverse else -2j * np.pi / N
    n_idx = np.arange(n_in)
    if shift_in:
        # input vector is laid out pre-ifftshift: logical index of slot n
        n_idx = (n_idx - (n_in // 2)) % N if n_in == N else n_idx
        if n_in != N:
            raise ValueError("shift_in requires n_in == n_out")
    k_idx = np.arange(N)
    if shift_out:
        k_idx = (k_idx + (N - N // 2)) % N  # out slot k holds bin (k - N//2) mod N
    W = np.exp(sign * np.outer(n_idx, k_idx))
    if norm == "ortho":
        W = W / np.sqrt(N)
    elif norm == "backward":
        if inverse:
            W = W / N
    elif norm == "forward":
        if not inverse:
            W = W / N
    else:
        raise ValueError(norm)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def _best_split(n: int) -> int:
    """Divisor of n closest to √n from below (1 when n is prime) — balances
    the two matmul stages of a Cooley-Tukey step."""
    for d in range(int(np.sqrt(n)), 1, -1):
        if n % d == 0:
            return d
    return 1


def _twiddle(n1: int, n2: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """tw[b, k1] = exp(±2πi·b·k1/(n1·n2)), shape (n2, n1)."""
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / (n1 * n2))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def dft(x, *, inverse: bool = False, norm: str = "backward") -> CArray:
    """General last-axis DFT of arbitrary length as matmuls.

    Direct constant-matrix product for n ≤ 1024; one Cooley-Tukey split
    (reshape → stage-1 matmul → twiddle → stage-2 matmul) for longer
    composite n — everything stays a real matmul, no complex HLO. Used by the
    target-simulator channel where transform length = frame length.

    Derivation (N = n1·n2, n = n2·a + b, k = k1 + n1·k2):
    X[k1 + n1·k2] = Σ_b W_{n2}^{b·k2} · tw(b,k1) · Σ_a x[n2·a+b] W_{n1}^{a·k1}
    """
    x = x if isinstance(x, CArray) else from_complex(x)
    n = x.shape[-1]
    n1 = _best_split(n) if n > 1024 else 1
    if n1 == 1:
        return apply_dft(x, dft_mats(n, inverse=inverse, norm=norm))
    n2 = n // n1
    stage_norm = "forward" if inverse else "backward"  # both ⇒ unscaled stages
    xr = x.reshape(*x.shape[:-1], n1, n2)  # xr[a, b] = x[n2·a + b]
    # stage 1: DFT over a → S[b, k1]
    s1 = apply_dft(xr.swapaxes(-1, -2), dft_mats(n1, inverse=inverse, norm=stage_norm))
    s1 = s1 * CArray(*(jnp.asarray(m) for m in _twiddle(n1, n2, inverse)))
    # stage 2: DFT over b → out[k1, k2]
    s2 = apply_dft(s1.swapaxes(-1, -2), dft_mats(n2, inverse=inverse, norm=stage_norm))
    out = s2.swapaxes(-1, -2).reshape(*x.shape[:-1], n)  # [k2, k1] → k1 + n1·k2
    if norm == "ortho":
        out = out * np.float32(1.0 / np.sqrt(n))
    elif (norm == "backward" and inverse) or (norm == "forward" and not inverse):
        out = out * np.float32(1.0 / n)
    return out


def fftfreq(n: int, d: float = 1.0) -> np.ndarray:
    return np.fft.fftfreq(n, d).astype(np.float32)


def apply_dft(x, mats: tuple, precision=jax.lax.Precision.HIGHEST) -> CArray:
    """Last-axis DFT of a CArray via two constant matrices (4 matmuls).

    (..., n_in) → (..., n_out); batched leading dims ride the matmul.
    Default HIGHEST precision keeps f32 accuracy (not TF32)."""
    C, S = (jnp.asarray(m) for m in mats)
    x = x if isinstance(x, CArray) else from_complex(x)
    mm = partial(jnp.matmul, precision=precision)
    return CArray(mm(x.re, C) - mm(x.im, S), mm(x.re, S) + mm(x.im, C))
