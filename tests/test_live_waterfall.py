"""Live session with a concurrent W/F stream and IQ recording against the
fake Kiwi (the dual-socket session structure of the reference app)."""

import numpy as np

from supersdr_jax import cli
from supersdr_jax.io import wav
from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer


def test_session_waterfall_and_iq_record(tmp_path, rng):
    fs = 12000
    t = np.arange(512 * 48) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    rows = rng.integers(120, 230, (40, 1024), dtype=np.uint8)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, wf_source=rows,
                                           n_frames=40,
                                           audio_rate_true=12000.0)).start()
    out = tmp_path / "a.wav"
    wf_png = tmp_path / "wf.png"
    iq_wav = tmp_path / "iq.wav"
    try:
        rc = cli.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                       "-f", "14200", "--mode", "USB", "-o", str(out),
                       "--frames", "32", "-b", "4",
                       "--waterfall-png", str(wf_png),
                       "--record-iq", str(iq_wav)])
        assert rc == 0
    finally:
        server.stop()

    from supersdr_jax.display.png import read_png_size
    w, h = read_png_size(wf_png)
    assert w == 1024 and h > 10

    t2, z2 = wav.read_kiwi_iq_wav(iq_wav)
    assert len(z2) > 512 * 20
    # recorded IQ round-trips the original tone (16-bit quantized)
    ref = iq[1024: 1024 + len(z2)]
    corr = np.abs(np.vdot(z2, ref)) / (np.linalg.norm(z2)
                                       * np.linalg.norm(ref) + 1e-12)
    assert corr > 0.99
