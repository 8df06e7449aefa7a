"""End-to-end: CLI subcommands on synthetic KiwiSDR IQ WAVs, and the live
session app against the fake Kiwi server (BASELINE configs 1-3)."""

import numpy as np
import pytest

from supersdr_jax import cli
from supersdr_jax.io import wav


def make_am_wav(path, fs=12000, seconds=3.0, audio_freq=800.0, depth=0.6):
    n = int(fs * seconds) // 512 * 512
    t = np.arange(n) / fs
    m = depth * np.cos(2 * np.pi * audio_freq * t)
    z = (0.3 * (1 + m)).astype(np.complex64)  # carrier at capture center
    wav.write_kiwi_iq_wav(path, z, fs)
    return n


def tone_snr_db(x, freq, fs):
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t), np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    return 10 * np.log10(np.mean((fit - fit.mean()) ** 2)
                         / max(np.mean((x - fit) ** 2), 1e-30))


def test_cli_demod_am(tmp_path):
    src = tmp_path / "am.wav"
    out = tmp_path / "audio.wav"
    make_am_wav(src)
    rc = cli.main(["demod", str(src), "-o", str(out), "--mode", "AM",
                   "--agc-off"])
    assert rc == 0
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000
    audio = data.astype(np.float64) / 32767.0
    snr = tone_snr_db(audio[len(audio) // 2:], 800.0, rate)
    assert snr > 35


def test_cli_demod_usb(tmp_path):
    fs = 12000
    n = 512 * 60
    t = np.arange(n) / fs
    z = (0.3 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    src = tmp_path / "usb.wav"
    wav.write_kiwi_iq_wav(src, z, fs)
    out = tmp_path / "usb_audio.wav"
    rc = cli.main(["demod", str(src), "-o", str(out), "--mode", "USB",
                   "--agc-off"])
    assert rc == 0
    data, rate = wav.read_audio_wav(out)
    audio = data.astype(np.float64) / 32767.0
    assert tone_snr_db(audio[len(audio) // 2:], 1000.0, rate) > 35


def test_cli_waterfall(tmp_path):
    src = tmp_path / "wf.wav"
    make_am_wav(src, seconds=4.0)
    out = tmp_path / "wf.png"
    rc = cli.main(["waterfall", str(src), "-o", str(out), "--avg", "4"])
    assert rc == 0
    from supersdr_jax.display.png import read_png_size
    w, h = read_png_size(out)
    assert w == 1024 and h > 100


def test_cli_wideband(tmp_path):
    fs = 96000
    n_chan = 8
    n = fs  # 1 s
    t = np.arange(n) / fs
    from supersdr_jax.ops import channelizer
    plan, _ = channelizer.design(n_chan, 8)
    freqs = channelizer.channel_center_freqs(plan, fs)
    m = 0.6 * np.cos(2 * np.pi * 500 * t)
    z = (0.4 * (1 + m) * np.exp(2j * np.pi * freqs[3] * t)).astype(np.complex64)
    src = tmp_path / "wide.wav"
    wav.write_kiwi_iq_wav(src, z, fs)
    outdir = tmp_path / "chans"
    rc = cli.main(["wideband", str(src), "-o", str(outdir),
                   "--n-chan", str(n_chan), "--top", "2"])
    assert rc == 0
    written = sorted(outdir.glob("*.wav"))
    assert len(written) == 2
    assert any("chan_003" in w.name for w in written)


def test_live_kiwi_session_records_audio(tmp_path):
    """Full stack: fake Kiwi serves IQ; session demodulates natively and
    records the audio."""
    from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer

    fs = 12000
    t = np.arange(512 * 64) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=48,
                                           audio_rate_true=12000.0)).start()
    out = tmp_path / "live.wav"
    try:
        rc = cli.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                       "-f", "14200", "--mode", "USB", "-o", str(out),
                       "--frames", "40", "-b", "4"])
        assert rc == 0
    finally:
        server.stop()
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000
    assert len(data) > 4 * 2048  # several chunks of audio made it through
    audio = data.astype(np.float64) / 32767.0
    tail = audio[len(audio) // 2:]
    assert tone_snr_db(tail, 1000.0, rate) > 20
