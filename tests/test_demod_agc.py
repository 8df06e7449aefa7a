import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import agc as agc_ops
from supersdr_jax.ops import demod as demod_ops


def tone_snr_db(x, freq, fs):
    """Fit A·cos+B·sin at `freq`; SNR = fit power / residual power."""
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t),
                      np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    sig = np.mean((fit - fit.mean()) ** 2)
    noise = np.mean((x - fit) ** 2)
    return 10 * np.log10(sig / max(noise, 1e-30))


def test_am_envelope(rng):
    fs = 12000
    n = 24000
    t = np.arange(n) / fs
    m = 0.5 * np.cos(2 * np.pi * 1000 * t)
    iq = ((1 + m) * np.exp(2j * np.pi * 100 * t)).astype(np.complex64)
    st = demod_ops.init_state()
    st, audio = demod_ops.demod_am(st, jnp.asarray(iq))
    audio = np.asarray(audio)[12000:]  # past the DC-blocker transient
    assert tone_snr_db(audio, 1000, fs) > 40


def test_ssb_real_part(rng):
    fs = 12000
    t = np.arange(12000) / fs
    iq = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)
    st = demod_ops.init_state()
    st, audio = demod_ops.demod_ssb(st, jnp.asarray(iq))
    np.testing.assert_allclose(np.asarray(audio), np.cos(2 * np.pi * 1000 * t),
                               atol=1e-4)


def test_nbfm_discriminator(rng):
    fs = 12000
    n = 12000
    t = np.arange(n) / fs
    fm, dev = 1000.0, 2500.0
    phase = (dev / fm) * np.sin(2 * np.pi * fm * t)
    iq = np.exp(1j * phase).astype(np.complex64)
    st = demod_ops.init_state()
    st, audio = demod_ops.demod_nbfm(st, jnp.asarray(iq), fs, max_dev_hz=dev)
    audio = np.asarray(audio)[100:]
    # instantaneous freq = dev*cos(2π fm t) → audio ≈ cos tone, amplitude 1
    snr = tone_snr_db(audio, fm, fs)
    assert snr > 30
    assert 0.9 < np.abs(audio).max() < 1.1


def test_nbfm_streaming_continuity(rng):
    fs = 12000
    t = np.arange(2048) / fs
    iq = np.exp(2j * np.pi * 300 * t).astype(np.complex64)
    st = demod_ops.init_state()
    _, full = demod_ops.demod_nbfm(st, jnp.asarray(iq), fs)
    st = demod_ops.init_state()
    st, a1 = demod_ops.demod_nbfm(st, jnp.asarray(iq[:1024]), fs)
    _, a2 = demod_ops.demod_nbfm(st, jnp.asarray(iq[1024:]), fs)
    np.testing.assert_allclose(np.concatenate([np.asarray(a1), np.asarray(a2)]),
                               np.asarray(full), atol=1e-5)


def test_agc_brings_weak_signal_to_target(rng):
    fs = 12000
    t = np.arange(24000) / fs
    x = (0.001 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)  # -60 dBFS
    p = agc_ops.make_params(fs, thresh_db=-80, decay_ms=1000, target_db=-10)
    st = agc_ops.init_state()
    st, y = agc_ops.apply(p, st, jnp.asarray(x))
    tail = np.asarray(y)[12000:]
    peak_db = 20 * np.log10(np.abs(tail).max())
    assert -13 < peak_db < -7   # leveled to ~target


def test_agc_strong_signal_attenuated(rng):
    fs = 12000
    t = np.arange(24000) / fs
    x = (2.0 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)  # +6 dBFS
    p = agc_ops.make_params(fs, thresh_db=-80, decay_ms=1000, target_db=-10)
    st = agc_ops.init_state()
    st, y = agc_ops.apply(p, st, jnp.asarray(x))
    tail = np.asarray(y)[12000:]
    peak_db = 20 * np.log10(np.abs(tail).max())
    assert -14 < peak_db < -6


def test_agc_manual_gain_unity_at_default(rng):
    fs = 12000
    x = rng.normal(size=4096).astype(np.float32) * 0.1
    p = agc_ops.make_params(fs, on=False, man_gain_db=50.0)
    st = agc_ops.init_state()
    st, y = agc_ops.apply(p, st, jnp.asarray(x))
    # after attack settles the gain is exactly unity
    np.testing.assert_allclose(np.asarray(y)[2000:], x[2000:], atol=1e-3)


def test_agc_decay_rate(rng):
    # after signal drop, gain recovers following the decay time constant
    fs = 12000
    strong = np.sin(2 * np.pi * 700 * np.arange(6000) / fs)
    silence = np.zeros(24000)
    x = np.concatenate([strong, silence]).astype(np.float32) * 0.5
    p = agc_ops.make_params(fs, decay_ms=1000, target_db=-10, thresh_db=-80)
    st = agc_ops.init_state()
    st, y = agc_ops.apply(p, st, jnp.asarray(x))
    # peak tracker should have decayed ~60 dB over 1000 ms of silence
    assert float(st.peak_db) < -55


def test_agc_streaming_continuity(rng):
    fs = 12000
    x = rng.normal(size=8192).astype(np.float32) * 0.01
    p = agc_ops.make_params(fs)
    st = agc_ops.init_state()
    _, y_full = agc_ops.apply(p, st, jnp.asarray(x))
    st = agc_ops.init_state()
    st, y1 = agc_ops.apply(p, st, jnp.asarray(x[:4096]))
    _, y2 = agc_ops.apply(p, st, jnp.asarray(x[4096:]))
    np.testing.assert_allclose(
        np.concatenate([np.asarray(y1), np.asarray(y2)]),
        np.asarray(y_full), rtol=1e-3, atol=1e-5)


def test_agc_hang_holds_gain(rng):
    fs = 12000
    t = np.arange(3000) / fs
    burst = np.sin(2 * np.pi * 700 * t)
    x = np.concatenate([burst, np.zeros(3000)]).astype(np.float32)
    p_nohang = agc_ops.make_params(fs, hang=False, decay_ms=400)
    p_hang = agc_ops.make_params(fs, hang=True, decay_ms=400)
    hw = agc_ops.hang_samples(fs, 500.0)
    _, y_nh = agc_ops.apply(p_nohang, agc_ops.init_state(), jnp.asarray(x))
    _, y_h = agc_ops.apply(p_hang, agc_ops.init_state(), jnp.asarray(x),
                           hang_window=hw)
    # with hang, gain stays low (peak held) during early silence → quieter
    seg = slice(3100, 4500)
    assert np.abs(np.asarray(y_h)[seg]).max() <= np.abs(np.asarray(y_nh)[seg]).max() + 1e-6
