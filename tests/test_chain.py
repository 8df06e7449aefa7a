"""End-to-end receiver chain tests: synthetic modulated IQ → audio, SNR
bound vs the ideal message (the 40 dB bound from BASELINE.md)."""

import numpy as np
import jax.numpy as jnp

from supersdr_jax.runtime import chain


def tone_snr_db(x, freq, fs):
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


AGC_OFF = dict(on=False, man_gain_db=50.0)  # unity gain, deterministic


def run(cfg, iq, **mkparams):
    params = chain.make_params(cfg, **mkparams)
    _, audio, rssi = chain.run_offline(cfg, params, iq)
    return audio, rssi


def test_am_chain_snr():
    fs = 12000
    n = 48000
    t = np.arange(n) / fs
    m = 0.5 * np.cos(2 * np.pi * 1000 * t)
    iq = ((1.0 + m) * 0.5).astype(np.complex64)  # carrier at 0 (centered)
    cfg = chain.ChainConfig(mode="AM", chunk=4096, os_block=4096)
    audio, rssi = run(cfg, iq, agc_kwargs=AGC_OFF)
    tail = audio[8 * 4096:]
    assert tone_snr_db(tail, 1000, 48000) > 40
    assert rssi.mean() > -40  # strong signal


def test_usb_chain_snr():
    fs = 12000
    n = 48000
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)  # 1 kHz audio tone
    cfg = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert tone_snr_db(audio[8 * 4096:], 1000, 48000) > 40


def test_lsb_chain_snr():
    fs = 12000
    n = 48000
    t = np.arange(n) / fs
    iq = np.exp(-2j * np.pi * 1000 * t).astype(np.complex64)
    cfg = chain.ChainConfig(mode="LSB", chunk=4096, os_block=4096)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert tone_snr_db(audio[8 * 4096:], 1000, 48000) > 40


def test_lsb_rejects_usb_side():
    fs = 12000
    n = 24000
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)  # USB-side tone
    cfg = chain.ChainConfig(mode="LSB", chunk=4096, os_block=4096)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert np.abs(audio[8192:]).max() < 2e-3  # >50 dB rejection


def test_cw_chain_pitch():
    # dial convention: carrier appears at +CW_PITCH = 600 Hz
    fs = 12000
    n = 24000
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * 600 * t).astype(np.complex64)
    cfg = chain.ChainConfig(mode="CW", chunk=4096, os_block=4096)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert tone_snr_db(audio[8192:], 600, 48000) > 40


def test_nbfm_chain():
    fs = 12000
    n = 24000
    t = np.arange(n) / fs
    fm, dev = 800.0, 2500.0
    phase = (dev / fm) * np.sin(2 * np.pi * fm * t)
    iq = np.exp(1j * phase).astype(np.complex64)
    cfg = chain.ChainConfig(mode="NBFM", chunk=4096, os_block=4096,
                            max_dev_hz=dev)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert tone_snr_db(audio[8192:], fm, 48000) > 25


def test_freq_offset_tuning():
    # receiver offset +2 kHz inside the span: tone at 2 kHz + 1 kHz audio
    fs = 12000
    n = 24000
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * 3000 * t).astype(np.complex64)
    cfg = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    audio, _ = run(cfg, iq, freq_offset_hz=2000.0, agc_kwargs=AGC_OFF)
    assert tone_snr_db(audio[8192:], 1000, 48000) > 40


def test_chunk_size_invariance():
    # identical results regardless of how the stream is chunked
    fs = 12000
    rng = np.random.default_rng(1)
    n = 16384
    t = np.arange(n) / fs
    iq = (np.exp(2j * np.pi * 1000 * t)
          + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    cfg_big = chain.ChainConfig(mode="USB", chunk=16384, os_block=2048)
    cfg_small = chain.ChainConfig(mode="USB", chunk=2048, os_block=2048)
    a_big, _ = run(cfg_big, iq, agc_kwargs=AGC_OFF)
    a_small, _ = run(cfg_small, iq, agc_kwargs=AGC_OFF)
    np.testing.assert_allclose(a_big, a_small, atol=2e-4)


def test_multichannel_vmap():
    # two channels with different tunings in one batched call
    fs = 12000
    n = 8192
    t = np.arange(n) / fs
    iq = np.stack([np.exp(2j * np.pi * 1000 * t),
                   np.exp(2j * np.pi * 2500 * t)]).astype(np.complex64)
    cfg = chain.ChainConfig(mode="USB", chunk=8192, os_block=2048)
    params = chain.make_params(cfg, freq_offset_hz=np.array([0.0, 1500.0]),
                               agc_kwargs=AGC_OFF)
    state = chain.init_state(cfg, (2,))
    state, out = chain.process(cfg, params, state, jnp.asarray(iq))
    # both channels should hear a 1 kHz tone
    for c in range(2):
        assert tone_snr_db(np.asarray(out.audio)[c][8192:], 1000, 48000) > 35


def test_rssi_tracks_level():
    fs = 12000
    n = 8192
    t = np.arange(n) / fs
    loud = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)
    cfg = chain.ChainConfig(mode="USB", chunk=8192, os_block=2048)
    _, r_loud = run(cfg, loud, agc_kwargs=AGC_OFF)
    _, r_quiet = run(cfg, 0.01 * loud, agc_kwargs=AGC_OFF)
    assert 38 < (r_loud[-1] - r_quiet[-1]) < 42  # 40 dB level difference


def test_rational_rate_chain_20250():
    """20.25 kHz kiwis (3-channel mode) reach 48 kHz audio through the
    rational L/M resampler (reference: resample_poly at
    utils_supersdr.py:1126). Tone frequency must survive exactly."""
    fs = 20250
    n = fs * 4
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)
    # chunk must be a multiple of M=27 (20250/750)
    cfg = chain.ChainConfig(mode="USB", iq_rate=fs, audio_rate=48000,
                            chunk=4050, os_block=4050)
    assert cfg.is_rational and cfg.resample_LM == (64, 27)
    audio, _ = run(cfg, iq, agc_kwargs=AGC_OFF)
    assert len(audio) == n * 64 // 27
    assert tone_snr_db(audio[len(audio) // 2:], 1000, 48000) > 40


def test_rational_chunk_invariance():
    """Streaming state keeps the rational resampler continuous across
    chunk boundaries: different chunkings give identical audio."""
    fs = 20250
    rng = np.random.default_rng(3)
    n = 16200
    t = np.arange(n) / fs
    iq = (np.exp(2j * np.pi * 800 * t)
          + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
          ).astype(np.complex64)
    cfg_big = chain.ChainConfig(mode="USB", iq_rate=fs, audio_rate=48000,
                                chunk=16200, os_block=2025)
    cfg_small = chain.ChainConfig(mode="USB", iq_rate=fs, audio_rate=48000,
                                  chunk=2025, os_block=2025)
    a_big, _ = run(cfg_big, iq, agc_kwargs=AGC_OFF)
    a_small, _ = run(cfg_small, iq, agc_kwargs=AGC_OFF)
    np.testing.assert_allclose(a_big, a_small, atol=2e-4)


def test_rational_chunk_must_divide_M():
    import pytest
    with pytest.raises(ValueError):
        chain.ChainConfig(mode="USB", iq_rate=20250, audio_rate=48000,
                          chunk=2048, os_block=2048)


def test_fftmxu_passband_matches_fft_streaming(rng):
    """passband_impl='fftmxu' (layout-rotating matmul overlap-save) is
    sample-equivalent to the plain fft path across streamed chunks,
    including the carried filter history."""
    from supersdr_jax.runtime import chain as chain_mod
    n, chunk = 4096, 2048
    iq = ((rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))) * 0.1
          ).astype(np.complex64)
    outs = {}
    for impl in ("fft", "fftmxu"):
        cfg = chain_mod.ChainConfig(mode="AM", chunk=chunk, os_block=chunk,
                                    n_taps=257, passband_impl=impl)
        p = chain_mod.make_params(cfg)
        s = chain_mod.init_state(cfg, (3,))
        parts = []
        for i in range(0, n, chunk):
            s, out = chain_mod.process(cfg, p, s, iq[:, i:i + chunk])
            parts.append(np.asarray(out.audio))
        outs[impl] = np.concatenate(parts, axis=-1)
    err = np.abs(outs["fftmxu"] - outs["fft"]).max()
    assert err < 1e-4 * np.abs(outs["fft"]).max()
