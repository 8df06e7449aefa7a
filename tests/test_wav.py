import numpy as np
import pytest

from supersdr_jax.io import wav


def test_kiwi_iq_wav_roundtrip(tmp_path, rng):
    fs = 12000
    n = 8192
    z = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
         ).astype(np.complex64)
    path = tmp_path / "test.wav"
    wav.write_kiwi_iq_wav(path, z, fs)
    t, z2 = wav.read_kiwi_iq_wav(path)
    # the reference reader drops unsettled frames (first 2)
    n_dropped = 2 * 512
    assert len(z2) == n - n_dropped
    np.testing.assert_allclose(z2, z[n_dropped:], atol=1.0 / 65535)
    # timestamps monotonic at ~1/fs
    dt = np.diff(t)
    np.testing.assert_allclose(dt, 1 / fs, rtol=1e-2)


def test_kiwi_iq_wav_rate_estimation(tmp_path, rng):
    # GNSS timestamps reveal the true (drifting) sample rate
    fs_nominal, fs_true = 12000, 12010.0
    z = (rng.normal(size=512 * 24) * 0.1).astype(np.complex64)
    path = tmp_path / "drift.wav"
    wav.write_kiwi_iq_wav(path, z, fs_nominal, true_rate=fs_true)
    frames = list(wav.KiwiIQWavReader(path))
    assert abs(frames[-1].samplerate - fs_true) < 1.0


def test_kiwi_iq_wav_rejects_non_kiwi(tmp_path):
    p = tmp_path / "x.wav"
    p.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk\x04\x00\x00\x00abcd")
    with pytest.raises(wav.KiwiIQWavError):
        wav.KiwiIQWavReader(p)


def test_audio_recorder(tmp_path, rng):
    rec = wav.AudioRecorder(48000)
    rec.start(str(tmp_path / "rec.wav"))
    x = (rng.normal(size=4096) * 0.2).astype(np.float32)
    rec.append(x[:2048])
    rec.append(x[2048:])
    out = rec.stop()
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000
    assert len(data) == 4096
    np.testing.assert_allclose(data / 32767.0, x, atol=1e-3)


def test_audio_recorder_stereo(tmp_path):
    from supersdr_jax.io import wav
    rec = wav.AudioRecorder(48000)
    rec.start(str(tmp_path / "st.wav"))
    rec.append(np.stack([np.ones(100) * 0.5, -np.ones(100) * 0.5], axis=-1))
    rec.stop()
    data, rate = wav.read_audio_wav(tmp_path / "st.wav")
    assert data.shape == (100, 2)
    assert data[0, 0] > 16000 and data[0, 1] < -16000
