"""Golden-file tests against an independent scipy oracle (SURVEY.md §4):
synthesize modulated IQ, write/read it through the KiwiSDR WAV path, demod
with the device chain, and compare against a scipy implementation of the
documented semantics within the 40 dB SNR bound (BASELINE.md)."""

import numpy as np
import pytest
import scipy.signal as sps

from supersdr_jax.io import wav
from supersdr_jax.runtime import chain

FS = 12000
AGC_OFF = dict(on=False)


def scipy_ssb_demod(z, lc, hc, fs=FS):
    """Oracle: complex bandpass via scipy firwin-style filtering, then Re."""
    n_taps = 513
    proto = sps.firwin(n_taps, (hc - lc) / 2, fs=fs)
    m = np.arange(n_taps) - (n_taps - 1) / 2
    taps = proto * np.exp(2j * np.pi * ((lc + hc) / 2) / fs * m)
    y = sps.lfilter(taps, 1.0, z)
    return np.real(y)


def scipy_am_demod(z, cut, fs=FS):
    n_taps = 513
    proto = sps.firwin(n_taps, cut, fs=fs)
    y = sps.lfilter(proto, 1.0, z)
    env = np.abs(y)
    return env - env.mean()


def upsample_ref(audio12):
    """Send the 12 kHz oracle audio through the same reference
    interpolation semantics the chain uses (zero-stuff ×4 + the 33-tap
    Blackman-sinc, utils_supersdr.py:1128-1134), so both signals share the
    interpolator and compare at 48 kHz."""
    import jax.numpy as jnp

    from supersdr_jax.ops import resample

    plan, P = resample.design_interp(FS, 4 * FS)
    carry = resample.init_carry(plan)
    _, y = resample.interpolate(plan, jnp.asarray(P), carry,
                                jnp.asarray(audio12, jnp.float32))
    return np.asarray(y)


def snr_db(test, ref, max_lag=64):
    """Align by small lag search (both paths share filter delays to within
    a few samples), compare the steady-state overlap."""
    n = min(len(test), len(ref))
    test, ref = test[:n], ref[:n]
    best_snr = -np.inf
    for lag in range(-max_lag, max_lag + 1):
        if lag >= 0:
            a, b = test[lag:], ref[: n - lag]
        else:
            a, b = test[: n + lag], ref[-lag:]
        # trim past the AM DC-blocker settling tail (~2 s @48k) and remove
        # each side's residual DC (ours: streaming high-pass; oracle:
        # whole-signal mean incl. warmup — different DC bookkeeping)
        a = a[100000:-4000]
        b = b[100000:-4000]
        a = a - a.mean()
        b = b - b.mean()
        g = np.dot(a, b) / max(np.dot(b, b), 1e-30)
        err = a - g * b
        s = 10 * np.log10(np.dot(g * b, g * b) / max(np.dot(err, err), 1e-30))
        if s > best_snr:
            best_snr = s
    return best_snr


def multitone(rng, freqs, fs=FS, n=FS * 4):
    t = np.arange(n) / fs
    sig = sum(a * np.cos(2 * np.pi * f * t + p) for f, a, p in freqs)
    return t, sig


def test_usb_matches_scipy_oracle(tmp_path, rng):
    # USB signal: analytic multi-tone voice-band message
    t, msg = multitone(rng, [(400, 0.5, 0.1), (1100, 0.4, 1.3),
                             (1900, 0.3, 2.1), (2500, 0.2, 0.7)])
    analytic = sps.hilbert(msg)
    z = (0.3 * analytic).astype(np.complex64)
    path = tmp_path / "usb.wav"
    wav.write_kiwi_iq_wav(path, z, FS)
    _, z2 = wav.read_kiwi_iq_wav(path)

    cfg = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    params = chain.make_params(cfg, agc_kwargs=AGC_OFF)
    _, audio, _ = chain.run_offline(cfg, params, z2.astype(np.complex64))

    ref = upsample_ref(scipy_ssb_demod(z2, 30, 3000))
    assert snr_db(audio, ref) > 40


def test_am_matches_scipy_oracle(tmp_path, rng):
    t, msg = multitone(rng, [(300, 0.3, 0.0), (800, 0.25, 0.8),
                             (2000, 0.2, 1.9)])
    z = (0.4 * (1.0 + msg)).astype(np.complex64)
    path = tmp_path / "am.wav"
    wav.write_kiwi_iq_wav(path, z, FS)
    _, z2 = wav.read_kiwi_iq_wav(path)

    cfg = chain.ChainConfig(mode="AM", chunk=4096, os_block=4096)
    params = chain.make_params(cfg, agc_kwargs=AGC_OFF)
    _, audio, _ = chain.run_offline(cfg, params, z2.astype(np.complex64))

    ref = upsample_ref(scipy_am_demod(z2, 5900))
    assert snr_db(audio, ref) > 40


def test_lsb_matches_scipy_oracle(tmp_path, rng):
    t, msg = multitone(rng, [(500, 0.5, 0.4), (1500, 0.35, 2.2)])
    analytic = np.conj(sps.hilbert(msg))  # lower sideband
    z = (0.3 * analytic).astype(np.complex64)
    cfg = chain.ChainConfig(mode="LSB", chunk=4096, os_block=4096)
    params = chain.make_params(cfg, agc_kwargs=AGC_OFF)
    _, audio, _ = chain.run_offline(cfg, params, z)
    ref = upsample_ref(scipy_ssb_demod(z, -3000, -30))
    assert snr_db(audio, ref) > 40
