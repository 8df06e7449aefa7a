import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import firdesign, resample


def reference_upsample(x, L, taps, old_buffer):
    """Reference play_buffer interpolation verbatim semantics
    (utils_supersdr.py:1128-1134): zero-stuff, prepend carry, valid
    convolve, ×L. Returns (y, new_old_buffer)."""
    n = len(x)
    buf = np.zeros(int(L * n))
    buf[::L] = x
    buf = np.concatenate([old_buffer, buf])
    new_old = buf[-(len(taps) - 1):]
    y = np.convolve(buf, taps, mode="valid") * L
    return y, new_old


def test_interp_matches_reference_zero_stuff(rng):
    kiwi_rate, audio_rate = 12000, 48000
    plan, P = resample.design_interp(kiwi_rate, audio_rate)
    taps = firdesign.lowpass_taps(kiwi_rate / 2, audio_rate)
    assert plan.L == 4 and plan.n_taps == 33 and plan.per == 9

    x = rng.normal(size=2048).astype(np.float64)
    old = np.zeros(len(taps) - 1)
    carry = resample.init_carry(plan)
    block = 512
    ours_all, ref_all = [], []
    for i in range(0, len(x), block):
        xb = x[i:i + block]
        ref, old = reference_upsample(xb, 4, taps, old)
        carry, y = resample.interpolate(plan, jnp.asarray(P),
                                        carry, jnp.asarray(xb, jnp.float32))
        ours_all.append(np.asarray(y))
        ref_all.append(ref)
    np.testing.assert_allclose(np.concatenate(ours_all),
                               np.concatenate(ref_all), atol=1e-4)


def test_interp_tone_spectrum(rng):
    # a 1 kHz tone at 12 kHz upsampled to 48 kHz must stay a clean 1 kHz tone
    plan, P = resample.design_interp(12000, 48000)
    fs = 12000
    n = 12000
    x = np.sin(2 * np.pi * 1000 * np.arange(n) / fs).astype(np.float32)
    carry = resample.init_carry(plan)
    carry, y = resample.interpolate(plan, jnp.asarray(P), carry, jnp.asarray(x))
    y = np.asarray(y)[4000:]  # skip transient
    S = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    f = np.fft.rfftfreq(len(y), 1 / 48000)
    peak = f[np.argmax(S)]
    assert abs(peak - 1000) < 5
    # image rejection: power near 11/13/23/25 kHz images must be tiny
    img = S[(f > 10500)].max() / S.max()
    assert img < 10 ** (-50 / 20)


def test_batched_interp(rng):
    plan, P = resample.design_interp(12000, 48000)
    x = rng.normal(size=(5, 256)).astype(np.float32)
    carry = resample.init_carry(plan, (5,))
    carry, y = resample.interpolate(plan, jnp.asarray(P), carry, jnp.asarray(x))
    assert y.shape == (5, 1024)
    # each batch row equals the single-channel result
    c0 = resample.init_carry(plan)
    _, y0 = resample.interpolate(plan, jnp.asarray(P), c0, jnp.asarray(x[0]))
    np.testing.assert_allclose(np.asarray(y)[0], np.asarray(y0), atol=1e-6)


def test_rational_20k_to_48k(rng):
    # 20 kHz kiwi → 48 kHz: L/M = 12/5 (utils_supersdr.py:1126 resample_poly)
    plan, taps = resample.plan_rational(20000, 48000)
    assert (plan.L, plan.M) == (12, 5)
    fs = 20000
    n = 4000
    x = np.sin(2 * np.pi * 1000 * np.arange(n) / fs).astype(np.float32)
    carry = jnp.zeros(plan.history, jnp.float32)
    carry, y = resample.rational_resample_block(plan, jnp.asarray(taps), carry,
                                               jnp.asarray(x))
    y = np.asarray(y)
    assert len(y) == n * 12 // 5
    y = y[2000:]
    S = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    f = np.fft.rfftfreq(len(y), 1 / 48000)
    assert abs(f[np.argmax(S)] - 1000) < 10
    assert y.max() > 0.8  # amplitude preserved


def test_rational_streaming_continuity(rng):
    plan, taps = resample.plan_rational(20000, 48000)
    x = np.sin(2 * np.pi * 997 * np.arange(4000) / 20000).astype(np.float32)
    # full-signal result
    c = jnp.zeros(plan.history, jnp.float32)
    _, y_full = resample.rational_resample_block(plan, jnp.asarray(taps), c,
                                                 jnp.asarray(x))
    # two-block streaming result (block divisible by M=5)
    c = jnp.zeros(plan.history, jnp.float32)
    c, y1 = resample.rational_resample_block(plan, jnp.asarray(taps), c,
                                             jnp.asarray(x[:2000]))
    _, y2 = resample.rational_resample_block(plan, jnp.asarray(taps), c,
                                             jnp.asarray(x[2000:]))
    np.testing.assert_allclose(np.concatenate([y1, y2]), np.asarray(y_full),
                               atol=1e-5)


def test_interpolate_impls_agree(rng):
    """The einsum and broadcast-FMA formulations are the same math; their
    outputs must agree to float accumulation order."""
    import jax.numpy as jnp

    from supersdr_jax.ops import resample
    plan, P = resample.design_interp(12000, 48000)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    carry = resample.init_carry(plan, (3,))
    _, a = resample.interpolate(plan, jnp.asarray(P, jnp.float32), carry, x,
                                "einsum")
    _, b = resample.interpolate(plan, jnp.asarray(P, jnp.float32), carry, x,
                                "fma")
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-5, atol=2e-6)
