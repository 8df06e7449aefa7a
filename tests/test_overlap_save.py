import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import firdesign, overlap_save


def reference_stream_filter(taps, x, block):
    """The reference's streaming convolution: carry n_tap-1 samples, then
    np.convolve(concat(old, x), h, mode='valid') per block
    (utils_supersdr.py:1005,1128-1133)."""
    old = np.zeros(len(taps) - 1, dtype=np.result_type(taps, x))
    out = []
    for i in range(0, len(x), block):
        seg = np.concatenate([old, x[i:i + block]])
        out.append(np.convolve(seg, taps, mode="valid"))
        old = seg[-(len(taps) - 1):]
    return np.concatenate(out)


def test_streaming_matches_reference_convolve(rng):
    taps = firdesign.lowpass_taps(6000, 48000)  # 33 taps
    x = rng.normal(size=4096).astype(np.float32)
    block = 512
    plan = overlap_save.plan_for(block, len(taps))
    H = overlap_save.taps_to_freq(plan, taps)
    carry = overlap_save.init_carry(plan)
    ys = []
    for i in range(0, len(x), block):
        carry, y = overlap_save.overlap_save(plan, H, carry, jnp.asarray(x[i:i + block]))
        ys.append(np.asarray(y.real))
    ours = np.concatenate(ys)
    ref = reference_stream_filter(taps, x, block)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_complex_bandpass_streaming(rng):
    taps = firdesign.complex_bandpass_taps(300, 2700, 12000)
    n = 8192
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    block = 1024
    plan = overlap_save.plan_for(block, len(taps))
    H = overlap_save.taps_to_freq(plan, taps)
    carry = overlap_save.init_carry(plan)
    ys = []
    for i in range(0, n, block):
        carry, y = overlap_save.overlap_save(plan, H, carry, jnp.asarray(x[i:i + block]))
        ys.append(np.asarray(y))
    ours = np.concatenate(ys)
    ref = reference_stream_filter(taps.astype(np.complex64), x, block)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-4)


def test_batch_equals_streaming(rng):
    taps = firdesign.lowpass_taps(3000, 24000)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    block = 512
    plan = overlap_save.plan_for(block, len(taps))
    H = overlap_save.taps_to_freq(plan, taps)
    blocks = jnp.asarray(x.reshape(3, -1, block))
    head = overlap_save.init_carry(plan, (3,))
    y_batch = np.asarray(overlap_save.overlap_save_batch(plan, H, head, blocks))
    carry = overlap_save.init_carry(plan, (3,))
    ys = []
    for b in range(x.shape[1] // block):
        carry, y = overlap_save.overlap_save(
            plan, H, carry, jnp.asarray(x[:, b * block:(b + 1) * block]))
        ys.append(np.asarray(y))
    y_stream = np.stack(ys, axis=1)
    np.testing.assert_allclose(y_batch, y_stream, atol=1e-5)


def test_filter_signal_matches_numpy(rng):
    taps = firdesign.lowpass_taps(6000, 48000)
    x = rng.normal(size=5000).astype(np.float32)
    ours = np.asarray(overlap_save.filter_signal(taps, x, block=1024))
    # valid-with-zero-history == full convolution truncated to len(x)
    ref = np.convolve(np.concatenate([np.zeros(len(taps) - 1), x]), taps,
                      mode="valid")
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_tone_passes_noise_band_rejected():
    fs = 12000.0
    taps = firdesign.complex_bandpass_taps(300, 2700, fs)
    n = 12000
    t = np.arange(n) / fs
    tone_in = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)
    tone_out = np.exp(2j * np.pi * -2000 * t).astype(np.complex64)
    y_in = np.asarray(overlap_save.filter_signal(taps, tone_in, block=2048))
    y_out = np.asarray(overlap_save.filter_signal(taps, tone_out, block=2048))
    # steady-state (skip transient)
    assert np.abs(y_in[2000:]).mean() > 0.95
    assert np.abs(y_out[2000:]).mean() < 1e-3
