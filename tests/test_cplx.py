"""cplx pair-arithmetic core: must match numpy complex semantics exactly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jrc.ops import cplx as cx


def rnd(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )


def assert_close(ca, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(cx.to_complex(ca)), ref, atol=tol, rtol=tol)


def test_roundtrip():
    x = rnd((3, 5))
    assert_close(cx.from_complex(x), x)
    assert cx.from_complex(x).shape == (3, 5)


def test_arithmetic_matches_numpy():
    a, b = rnd((4, 7), 1), rnd((4, 7), 2)
    A, B = cx.from_complex(a), cx.from_complex(b)
    assert_close(A + B, a + b)
    assert_close(A - B, a - b)
    assert_close(A * B, a * b)
    assert_close(A / B, a / b)
    assert_close(-A, -a)
    assert_close(A.conj(), a.conj())
    assert_close(A * 2.0, a * 2)
    assert_close(2.0 * A, 2 * a)
    assert_close(A + 1.5, a + 1.5)
    assert_close(A * (1 + 2j), a * (1 + 2j))
    assert_close((1 + 2j) * A, a * (1 + 2j))
    assert_close(1.0 / A, 1.0 / a)
    assert_close(A / 2.0, a / 2)
    # real-array operand
    r = np.arange(7, dtype=np.float32)
    assert_close(A * r, a * r)
    assert_close(A + r, a + r)


def test_elementwise_helpers():
    a = rnd((6,), 3)
    A = cx.from_complex(a)
    np.testing.assert_allclose(np.asarray(cx.abs2(A)), np.abs(a) ** 2, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cx.cabs(A)), np.abs(a), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cx.angle(A)), np.angle(a), rtol=1e-4, atol=1e-5)
    th = np.linspace(-3, 3, 11).astype(np.float32)
    assert_close(cx.expj(th), np.exp(1j * th), tol=1e-6)
    b = rnd((6,), 4)
    assert_close(cx.mul_conj(A, cx.from_complex(b)), a * b.conj())


def test_indexing_and_at():
    a = rnd((5, 8), 5)
    A = cx.from_complex(a)
    assert_close(A[2], a[2])
    assert_close(A[:, 3:5], a[:, 3:5])
    idx = np.array([1, 4, 6])
    assert_close(A[..., idx], a[..., idx])
    v = rnd((3,), 6)
    ref = a.copy()
    ref[0, idx] = v
    assert_close(A.at[(0, idx)].set(cx.from_complex(v)), ref)
    ref2 = a.copy()
    ref2[:, 0] += 2.0
    assert_close(A.at[(slice(None), 0)].add(2.0), ref2)


def test_structural_ops():
    a = rnd((2, 6), 7)
    A = cx.from_complex(a)
    assert_close(A.reshape(3, 4), a.reshape(3, 4))
    assert_close(A.T, a.T)
    assert_close(cx.concatenate([A, A], axis=0), np.concatenate([a, a]))
    assert_close(cx.stack([A, A]), np.stack([a, a]))
    assert_close(cx.sum(A, axis=0), a.sum(0))
    assert_close(cx.mean(A, axis=-1), a.mean(-1))
    assert_close(cx.flip(A, axis=-1), np.flip(a, -1))
    assert_close(cx.broadcast_to(A, (3, 2, 6)), np.broadcast_to(a, (3, 2, 6)))
    assert_close(cx.where(np.asarray([True, False])[:, None], A, -A),
                 np.where([[True], [False]], a, -a))


def test_einsum_matmul():
    a, b = rnd((3, 4), 8), rnd((4, 5), 9)
    assert_close(cx.matmul(cx.from_complex(a), cx.from_complex(b)), a @ b)
    assert_close(
        cx.einsum("ij,ij->j", cx.from_complex(a), cx.from_complex(a).conj()),
        np.einsum("ij,ij->j", a, a.conj()),
    )


@pytest.mark.parametrize("norm", ["ortho", "backward"])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matches_numpy(norm, inverse):
    x = rnd((5, 64), 10)
    f = np.fft.ifft if inverse else np.fft.fft
    ref = f(x, norm=norm)
    got = cx.apply_dft(cx.from_complex(x), cx.dft_mats(64, inverse=inverse, norm=norm))
    assert_close(got, ref, tol=2e-5)


def test_dft_shift_out():
    x = rnd((3, 64), 11)
    ref = np.fft.fftshift(np.fft.fft(x, norm="ortho"), axes=-1)
    got = cx.apply_dft(cx.from_complex(x), cx.dft_mats(64, shift_out=True))
    assert_close(got, ref, tol=2e-5)


def test_dft_shift_in():
    x = rnd((3, 64), 12)
    ref = np.fft.ifft(np.fft.ifftshift(x, axes=-1), norm="ortho")
    got = cx.apply_dft(
        cx.from_complex(x), cx.dft_mats(64, inverse=True, shift_in=True)
    )
    assert_close(got, ref, tol=2e-5)


def test_dft_zero_pad():
    """n_out > n_in = transform of zero-padded input, no zeros materialized."""
    x = rnd((2, 64), 13)
    xp = np.concatenate([x, np.zeros((2, 512 - 64), np.complex64)], -1)
    ref = np.fft.ifft(xp, norm="backward")
    got = cx.apply_dft(
        cx.from_complex(x), cx.dft_mats(64, 512, inverse=True, norm="backward")
    )
    assert_close(got, ref, tol=2e-5)


def test_pytree_transparency():
    """CArray flows through jit / vmap / scan as a pytree."""
    a = rnd((4, 16), 14)
    A = cx.from_complex(a)

    @jax.jit
    def f(z):
        return cx.sum(z * z.conj(), axis=-1)

    np.testing.assert_allclose(
        np.asarray(cx.to_complex(f(A))), (a * a.conj()).sum(-1), rtol=1e-5, atol=1e-5
    )

    g = jax.vmap(lambda z: z * 2.0)(A)
    assert_close(g, a * 2)

    def body(c, z):
        return c + cx.sum(z), None

    out, _ = jax.lax.scan(body, cx.zeros(()), A)
    assert_close(out, a.sum(), tol=1e-4)
