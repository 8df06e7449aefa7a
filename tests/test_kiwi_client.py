"""Integration tests: KiwiClient against the fake KiwiSDR server
(protocol tests without a real Kiwi, SURVEY.md §4)."""

import numpy as np
import pytest

from supersdr_jax.io import kiwi_protocol as kp
from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
from supersdr_jax.io.kiwi_client import (KiwiBadPasswordError, KiwiClient,
                                         KiwiServerTerminatedConnection,
                                         KiwiTooBusyError)


def test_snd_audio_stream(rng):
    audio = (1000 * np.sin(2 * np.pi * 700 * np.arange(16384) / 12000)
             ).astype(np.int16)
    server = FakeKiwiServer(FakeKiwiConfig(audio_source=audio,
                                           n_frames=8)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port, stream_type="SND")
        c.connect()
        c.setup_sound("USB", 30, 3000, 14200.0)
        frame = c.wait_for_stream()
        assert c.info.audio_rate == 12000
        assert abs(c.info.audio_rate_true - 12001.15) < 0.01
        kind, gps, samples = c.snd_samples(frame)
        assert kind == "audio"
        assert len(samples) == 512
        assert samples.dtype == np.int16
        # server recorded our control burst
        assert server.wait_state("mod") == "usb"
        assert server.wait_state("low_cut") == "30"
        assert server.wait_state("agc") == "1"
        c.close()
    finally:
        server.stop()


def test_snd_iq_stream(rng):
    z = (0.1 * np.exp(2j * np.pi * 1000 * np.arange(8192) / 12000)
         ).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=z, n_frames=6)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port)
        c.connect()
        c.setup_sound("IQ", -5000, 5000, 14200.0)
        frame = c.wait_for_stream()
        kind, gps, z2 = c.snd_samples(frame)
        assert kind == "iq"
        assert len(z2) == 512
        assert "gpssec" in gps
        c.close()
    finally:
        server.stop()


def test_adpcm_compressed_audio(rng):
    t = np.arange(16384) / 12000
    audio = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    server = FakeKiwiServer(FakeKiwiConfig(audio_source=audio,
                                           n_frames=8)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port)
        c.connect()
        c.setup_sound("AM", -6000, 6000, 1000.0, compression=True)
        got = []
        for _ in range(8):
            f = c.wait_for_stream()
            kind, _, samples = c.snd_samples(f)
            got.append(samples)
        dec = np.concatenate(got).astype(np.float64)
        ref = audio[: len(dec)].astype(np.float64)
        err = dec - ref
        snr = 10 * np.log10(ref.var() / max(err.var(), 1e-9))
        assert snr > 20  # lossy but intelligible
        c.close()
    finally:
        server.stop()


def test_waterfall_stream(rng):
    rows = rng.integers(100, 240, (10, 1024), dtype=np.uint8)
    server = FakeKiwiServer(FakeKiwiConfig(wf_source=rows,
                                           n_frames=10)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port, stream_type="W/F")
        c.connect()
        c.setup_waterfall(zoom=7, counter=123456)
        f = c.wait_for_stream()
        assert c.info.wf_bins == 1024
        assert c.info.max_zoom == 14
        assert c.info.max_freq_khz == 30000.0
        np.testing.assert_array_equal(c.wf_bins(f), rows[f.seq])
        assert server.wait_state("zoom") == "7"
        assert server.wait_state("wf_speed") == "4"
        c.close()
    finally:
        server.stop()


def test_too_busy_raises():
    server = FakeKiwiServer(FakeKiwiConfig(too_busy=True)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port)
        c.connect()
        with pytest.raises(KiwiTooBusyError):
            for _ in range(5):
                c.read()
    finally:
        server.stop()


def test_bad_password_raises():
    server = FakeKiwiServer(FakeKiwiConfig(password="secret")).start()
    try:
        c = KiwiClient("127.0.0.1", server.port, password="wrong")
        c.connect()
        with pytest.raises(KiwiBadPasswordError):
            for _ in range(5):
                c.read()
    finally:
        server.stop()


def test_server_close_raises_terminated(rng):
    server = FakeKiwiServer(FakeKiwiConfig(n_frames=2)).start()
    try:
        c = KiwiClient("127.0.0.1", server.port)
        c.connect()
        c.setup_sound("AM", -6000, 6000, 1000.0)
        with pytest.raises(KiwiServerTerminatedConnection):
            for _ in range(50):
                c.read()
    finally:
        server.stop()
