"""Pump tests for the wideband monitor app (SURVEY §7 / VERDICT r4 #7):
the channelized band view — per-channel RSSI table, squelch-gated
activity list, select-channel-to-audio — driven live against the
fake-Kiwi wideband IQ loopback and headless against synthetic chunks.

Reference capability being generalized: the two-receiver ceiling at
/root/reference/supersdr.py:624-639 (BASELINE config 5: ≥100 channels
from one capture)."""

import argparse
import wave

import numpy as np

from supersdr_jax.apps.monitor import MonitorCore, run_monitor
from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
from supersdr_jax.runtime import wideband

N_CHAN = 8
FS = 12_000                      # wideband capture rate (8 × 1.5 kHz)


def _wideband_iq(n, fs=FS):
    """Two AM carriers at channel centers (+1.5 kHz, −3.0 kHz; 200 /
    350 Hz program tones) over a −50 dB noise floor."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs
    z = (0.35 * (1 + 0.6 * np.sin(2 * np.pi * 200.0 * t))
         * np.exp(2j * np.pi * 1500.0 * t))
    z = z + (0.18 * (1 + 0.6 * np.sin(2 * np.pi * 350.0 * t))
             * np.exp(-2j * np.pi * 3000.0 * t))
    z = z + 0.003 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return z.astype(np.complex64)


def test_monitor_core_activity_and_selection(tmp_path):
    """Headless core: RSSI rows are row-aligned through channel_freqs,
    the squelch gate opens exactly on the carrier channels, and the
    selected channel's recorded audio carries its program tone."""
    cfg = wideband.WidebandConfig(fs_in=FS, n_chan=N_CHAN,
                                  chunk_in=FS // 4, mode="AM",
                                  audio_rate=4 * FS // N_CHAN)
    core = MonitorCore(cfg, thresh_db=-40.0)
    z = _wideband_iq(FS * 2)
    core.select_freq(1500.0)
    rec = str(tmp_path / "sel.wav")
    core.start_recording(rec)
    for i in range(0, len(z), cfg.chunk_in):
        core.push(z[i:i + cfg.chunk_in])
    act = core.activity()
    freqs = sorted(round(f) for _, f, _ in act)
    assert freqs == [-3000, 1500], act
    # strongest first
    assert round(act[0][1]) == 1500
    core.stop_recording()
    w = wave.open(rec)
    a = np.frombuffer(w.readframes(w.getnframes()), np.int16
                      ).astype(np.float32)
    w.close()
    a = a[len(a) // 2:]
    sp = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1.0 / cfg.audio_rate)
    peak = f[10 + np.argmax(sp[10:])]
    assert abs(peak - 200.0) < 15.0, peak


def test_monitor_keys_and_hysteresis():
    """j/k walk the activity list; the gate holds between thresh and
    thresh − hyst (no flapping when RSSI sits inside the hysteresis
    band)."""
    cfg = wideband.WidebandConfig(fs_in=FS, n_chan=N_CHAN,
                                  chunk_in=FS // 4, mode="AM",
                                  audio_rate=4 * FS // N_CHAN)
    core = MonitorCore(cfg, thresh_db=-40.0, hyst_db=10.0)
    z = _wideband_iq(FS)
    for i in range(0, len(z), cfg.chunk_in):
        core.push(z[i:i + cfg.chunk_in])
    rows = [r for r, _, _ in core.activity()]
    core.select_row(rows[0])
    assert core.handle_key("j")
    assert core.selected == rows[1 % len(rows)]
    assert core.handle_key("k")
    assert core.selected == rows[0]
    assert not core.handle_key("q")
    # hysteresis: raise thresh just above the weak carrier's RSSI —
    # an OPEN channel inside [thresh-hyst, thresh) must stay open
    weak_rssi = core.rssi_rows[rows[-1]]
    core.thresh_db = weak_rssi + 3.0
    for i in range(0, len(z), cfg.chunk_in):
        core.push(z[i:i + cfg.chunk_in])
    assert rows[-1] in [r for r, _, _ in core.activity()]
    # render does not crash and mentions the active count
    lines = core.render_lines()
    assert any("active" in ln for ln in lines)


def test_monitor_live_against_fake_kiwi(tmp_path):
    """End-to-end pump: fake-Kiwi wideband IQ loopback → run_monitor
    headless with --select/--record — the activity table finds the
    carriers and the selected channel records its tone (BASELINE
    config 5 above the raw-library level)."""
    iq = _wideband_iq(FS * 3)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=64,
                                           audio_rate=FS)).start()
    rec = str(tmp_path / "live.wav")
    args = argparse.Namespace(
        input=None, n_chan=N_CHAN, mode="AM", thresh=-40.0,
        select=1.5, record=rec, headless=True, max_chunks=6,
        print_every=100, rate=FS // N_CHAN, frames=64,
        kiwiserver="127.0.0.1", kiwiport=server.port, password="",
        freq=10000.0)
    try:
        rc = run_monitor(args)
    finally:
        server.stop()
    assert rc == 0
    w = wave.open(rec)
    a = np.frombuffer(w.readframes(w.getnframes()), np.int16
                      ).astype(np.float32)
    w.close()
    assert len(a) > 3000
    a = a[len(a) // 2:]
    sp = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), N_CHAN / (4.0 * FS))
    peak = f[10 + np.argmax(sp[10:])]
    assert abs(peak - 200.0) < 15.0, peak


def test_monitor_over_mesh_process():
    """The monitor runs unmodified over the MESH-sharded pipeline:
    sharded_wideband.build's process fn (3-tuple return, rows in bin
    order) plugs into MonitorCore and the activity list finds
    the same carriers — BASELINE config 5, sharded, above the library
    level."""
    import jax

    from supersdr_jax.parallel import sharded_wideband

    # chunk divisible by d*n_chan (the mesh constraint)
    cfg = wideband.WidebandConfig(fs_in=FS, n_chan=N_CHAN,
                                  chunk_in=3072, mode="AM",
                                  audio_rate=4 * FS // N_CHAN)
    mesh = sharded_wideband.make_mesh(jax.devices()[:4])
    proc = sharded_wideband.build(cfg, mesh)
    params = wideband.make_params(cfg)

    core = MonitorCore(cfg, params=params, process_fn=proc,
                       thresh_db=-40.0)
    z = _wideband_iq(FS)
    n = (len(z) // cfg.chunk_in) * cfg.chunk_in
    for i in range(0, n, cfg.chunk_in):
        core.push(z[i:i + cfg.chunk_in])
    freqs = sorted(round(f) for _, f, _ in core.activity())
    assert freqs == [-3000, 1500], core.activity()
