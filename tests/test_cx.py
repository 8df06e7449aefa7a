"""Split-complex (CX) arithmetic and matmul-FFT vs numpy oracles."""

import numpy as np
import pytest

from supersdr_jax.ops import cx


def _rand_cx(rng, shape):
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
         ).astype(np.complex64)
    return z, cx.as_cx(z)


def test_arithmetic(rng):
    a_np, a = _rand_cx(rng, (4, 33))
    b_np, b = _rand_cx(rng, (4, 33))
    np.testing.assert_allclose(cx.to_numpy(a * b), a_np * b_np, rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cx.to_numpy(a + b), a_np + b_np, rtol=1e-6)
    np.testing.assert_allclose(cx.to_numpy(a.conj()), a_np.conj())
    np.testing.assert_allclose(np.asarray(a.abs2()), np.abs(a_np) ** 2,
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(cx.to_numpy(a * 2.5), a_np * 2.5, rtol=1e-6)


@pytest.mark.parametrize("n", [8, 100, 256, 640, 1024, 2560, 4096, 12000,
                               16384])
def test_fft_matches_numpy(rng, n):
    z_np, z = _rand_cx(rng, (3, n))
    got = cx.to_numpy(cx.fft(z))
    want = np.fft.fft(z_np, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5)


@pytest.mark.parametrize("n", [256, 2560, 16384])
def test_ifft_roundtrip(rng, n):
    z_np, z = _rand_cx(rng, (2, n))
    back = cx.to_numpy(cx.ifft(cx.fft(z)))
    np.testing.assert_allclose(back, z_np, atol=2e-5)


def test_fft_axis_argument(rng):
    z_np, z = _rand_cx(rng, (64, 5))
    got = cx.to_numpy(cx.fft(z, axis=0))
    want = np.fft.fft(z_np, axis=0)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_prime_size_rejected():
    with pytest.raises(ValueError, match="prime"):
        cx.fft(cx.zeros((4, 1009)))


def test_real_input_promoted(rng):
    x = rng.normal(size=(2, 128)).astype(np.float32)
    got = cx.to_numpy(cx.fft(cx.as_cx(x)))
    want = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_exp_i(rng):
    ph = rng.normal(size=(7, 16)).astype(np.float32)
    np.testing.assert_allclose(cx.to_numpy(cx.exp_i(ph)),
                               np.exp(1j * ph), rtol=1e-5, atol=1e-6)


def test_fft_rotate_and_ifft_major(rng):
    """The layout-rotating FFT pair (round 3): forward [b, n] → [n, b]
    matches numpy in natural order; the major-axis inverse round-trips."""
    for b, n in [(4, 2048), (3, 128), (2, 16384)]:
        z = (rng.normal(size=(b, n))
             + 1j * rng.normal(size=(b, n))).astype(np.complex64)
        import jax
        import jax.numpy as jnp
        Xr, Xi = jax.jit(cx.fft_rotate)(jnp.asarray(z.real),
                                        jnp.asarray(z.imag))
        X = np.asarray(Xr) + 1j * np.asarray(Xi)
        want = np.fft.fft(z, axis=-1).T
        np.testing.assert_allclose(X, want,
                                   atol=3e-3 * np.abs(want).max())
        zr, zi = jax.jit(cx.ifft_major)(Xr, Xi)
        back = (np.asarray(zr) + 1j * np.asarray(zi)).T
        np.testing.assert_allclose(back, z, atol=2e-4 * np.abs(z).max())
