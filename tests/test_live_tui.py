"""Live interactive session: keyboard tuning, waterfall, dual RX — driven
deterministically with synthetic IQ and scripted keys (the reference's
main-loop UX, /root/reference/supersdr.py:179-1073, headless)."""

import numpy as np
import pytest

from supersdr_jax.apps.live_tui import LiveTui
from supersdr_jax.control.panadapter import Panadapter
from supersdr_jax.control.receiver import Receiver
from supersdr_jax.runtime import chain

FS = 12000
AGC_OFF = dict(on=False, gain=50)


def make_session(freq=14200.0, mode="USB", chunk=2048):
    cfg = chain.ChainConfig(mode=mode, iq_rate=FS, audio_rate=48000,
                            chunk=chunk, os_block=chunk)
    rx = Receiver(cfg=cfg, center_freq_khz=freq, freq=freq, radio_mode=mode)
    rx.set_agc_params(on=False)
    pan = Panadapter(zoom=10, freq_khz=freq)
    return LiveTui.create(rx, pan, width=80, wf_height=8)


def tone_iq(freq_offset_hz, n, amp=0.3):
    t = np.arange(n) / FS
    return (amp * np.exp(2j * np.pi * freq_offset_hz * t)).astype(np.complex64)


def tone_snr_db(x, freq, fs):
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t), np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    return 10 * np.log10(np.mean((fit - fit.mean()) ** 2)
                         / max(np.mean((x - fit) ** 2), 1e-30))


def test_keys_drive_tune_mode_zoom():
    s = make_session()
    frames = []
    # "x" first: disable auto-mode so the band plan doesn't override the
    # manual LSB selection on the next tune (reference auto-mode semantics)
    key_script = iter([["x"], ["RIGHT"], ["RIGHT"], ["l"], ["UP"], [">"],
                       ["q"]])

    def keys():
        return next(key_script, [])

    src = (tone_iq(1000, 2048) for _ in range(10))
    s.run(src, keys=keys, render=frames.append, fps=1000.0)
    # two +1 kHz steps, one +10 (links route; span follows), mode switched
    assert s.rx.freq == pytest.approx(14200.0 + 1 + 1 + 10)
    assert s.rx.radio_mode == "LSB"
    assert s.pan.zoom == 11
    assert frames and any("LSB" in ln for ln in frames[-1])
    # waterfall history populated from native FFT rows
    assert len(s.model.history) > 0


def test_step_produces_stereo_audio_and_rssi():
    s = make_session()
    out = s.step(tone_iq(1000, 2048))
    assert out.shape == (2048 * 4, 2)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    assert s.rx.rssi > -40


def test_dual_rx_mix_and_balance():
    """SUB RX demodulates a second station; balance separates them in the
    stereo mix (supersdr.py:575-584 key semantics)."""
    s = make_session(freq=14200.0)
    # main hard left
    s.handle_key("5")
    s.handle_key("5")
    assert s.rx.audio_balance == -1.0
    # pan center to a second station 5 kHz up (outside main's passband),
    # enable sub there
    s.pan.set_freq_zoom(14205.0, s.pan.zoom)
    s.handle_key("y")
    assert s.rx_sub is not None
    assert s.rx_sub.freq == pytest.approx(s.pan.freq_khz)
    s.rx_sub.set_agc_params(on=False)
    s.rx_sub.audio_balance = 1.0   # sub hard right

    # capture contains both stations: +1 kHz audio on main (14200),
    # +5 kHz carrier + 700 Hz USB tone on sub (14205) — one continuous
    # stream sliced into chunks (phase must not restart per chunk)
    n = 2048
    sig = tone_iq(1000, 8 * n, 0.3) + tone_iq(5000 + 700, 8 * n, 0.3)
    outs = [s.step(sig[i * n:(i + 1) * n]) for i in range(8)]
    out = np.concatenate(outs[4:], axis=0)
    left, right = out[:, 0], out[:, 1]
    # left = main (1 kHz tone at 14201); right = sub hears 700 Hz
    assert tone_snr_db(left, 1000.0, 48000) > 15
    assert tone_snr_db(right, 700.0, 48000) > 15


def test_dual_rx_single_device_program():
    """MAIN+SUB run as ONE batched device program with one jit signature
    across SUB add / drop / mode+tune changes (VERDICT r2 #4: channels
    are an array axis, not separate dispatches)."""
    from supersdr_jax.runtime import chain as chain_mod

    s = make_session(freq=14200.0)
    n = 2048
    sig = tone_iq(1000, 8 * n, 0.3)

    s.step(sig[:n])                       # compile the [2, chunk] program
    cache0 = chain_mod._process_cx._cache_size()
    s.handle_key("y")                     # SUB on
    s.rx_sub.set_agc_params(on=False)
    s.step(sig[n:2 * n])
    s.handle_key("y")                     # swap MAIN/SUB
    s.step(sig[2 * n:3 * n])
    s.model.handle_key("a")               # mode change (→ AM)
    s.step(sig[3 * n:4 * n])
    s.model.handle_key("RIGHT")           # retune
    s.step(sig[4 * n:5 * n])
    s.handle_key("Y")                     # SUB off
    s.step(sig[5 * n:6 * n])
    assert chain_mod._process_cx._cache_size() == cache0, \
        "dual-RX surface retraced on an add/drop/mode/tune event"

    # SUB contributes only while enabled
    s2 = make_session(freq=14200.0)
    out_solo = s2.step(tone_iq(1000, n))
    assert out_solo.shape == (n * 4, 2)
    s = make_session(freq=14200.0)
    s.handle_key("y")           # enable sub at span center
    sub = s.rx_sub
    main = s.rx
    s.handle_key("y")           # switch MAIN<->SUB
    assert s.rx is sub and s.rx_sub is main and s.main_is_sub
    assert s.model.rx is sub and s.links.rx is sub
    s.handle_key("n")           # sub (old main) to span center
    assert s.rx_sub.freq == pytest.approx(s.pan.freq_khz)
    sub_freq, sub_mode = s.rx.freq, s.rx.radio_mode
    s.handle_key("Y")           # disable: transfers tuning back to main
    assert s.rx_sub is None and not s.main_is_sub
    assert s.rx is main
    assert s.rx.freq == pytest.approx(sub_freq)
    assert s.rx.radio_mode == sub_mode


def test_kiwi_tui_against_fake_server(tmp_path):
    """Full stack: `kiwi --tui` against the fake Kiwi, keys injected,
    audio recorded, frames rendered."""
    from supersdr_jax import cli
    from supersdr_jax.io import wav
    from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    import supersdr_jax.apps.live_tui as lt

    t = np.arange(512 * 64) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=48,
                                           audio_rate_true=12000.0)).start()
    out = tmp_path / "tui.wav"
    key_script = iter([["RIGHT"], ["a"], ["LEFT"]])
    rendered = []
    orig = lt.ansi_render
    lt.ansi_render = rendered.append
    try:
        args = cli.build_parser().parse_args(
            ["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
             "-f", "14200", "--mode", "USB", "-o", str(out),
             "--frames", "40", "--tui"])
        args.inject_keys = lambda: next(key_script, [])
        from supersdr_jax.apps.kiwi_session import run_kiwi_tui
        rc = run_kiwi_tui(args)
        assert rc == 0
    finally:
        lt.ansi_render = orig
        server.stop()
    assert rendered, "TUI rendered no frames"
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000 and len(data) > 2048


def test_freq_entry_and_recording_and_clip_keys(tmp_path, monkeypatch):
    """Reference F/E/,/./W keys: direct frequency entry, audio recording
    toggle, waterfall clip deltas, memory save (supersdr.py:653-719,
    help table)."""
    import os
    monkeypatch.chdir(tmp_path)
    s = make_session()
    # F entry: digits then Enter
    for k in ["f", "7", "0", "7", "4", ".", "5", "\r"]:
        assert s.handle_key(k)
    assert s.rx.freq == pytest.approx(7074.5)
    # auto-mode retuned the band-plan mode (40m -> LSB)
    assert s.rx.radio_mode == "LSB"
    # ESC cancels
    s.handle_key("f"); s.handle_key("1"); s.handle_key("ESC")
    assert s.model.freq_entry is None

    # E: record a couple of chunks, then stop -> WAV on disk
    s.handle_key("E")
    assert s.model.recording
    sig = tone_iq(1000, 4096)
    s.step(sig[:2048]); s.step(sig[2048:])
    s.handle_key("E")
    s.step(sig[:2048])          # triggers save
    wavs = [f for f in os.listdir(tmp_path) if f.endswith(".wav")]
    assert len(wavs) == 1
    from supersdr_jax.io import wav as wav_io
    data, rate = wav_io.read_audio_wav(tmp_path / wavs[0])
    assert rate == 48000 and data.shape[1] == 2 and len(data) == 2 * 8192

    # clip level keys shift the autolevel window
    s.handle_key(".")
    s.handle_key(".")
    assert s.model.wf_delta_high_db == 2.0
    s.handle_key(";")
    assert s.model.wf_delta_low_db == -1.0

    # W saves memories to disk (after storing one)
    s.handle_key("w")
    s.handle_key("W")
    assert os.path.exists(s.model.memories.path)


def test_kiwi_tui_uses_server_waterfall(tmp_path):
    """With a W/F-capable server the TUI shows the wide-span server
    waterfall (kiwi_byte_to_db + autolevel) instead of native IQ rows,
    and zoom keys re-tune the W/F stream (SET zoom=.. start=..)."""
    from supersdr_jax import cli
    from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    import supersdr_jax.apps.live_tui as lt

    t = np.arange(512 * 80) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    rows = np.tile((np.linspace(0, 255, 1024)).astype(np.uint8), (64, 1))
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, wf_source=rows,
                                           n_frames=64,
                                           audio_rate_true=12000.0)).start()
    key_script = iter([["UP"]])
    rendered = []
    orig = lt.ansi_render
    lt.ansi_render = rendered.append
    try:
        args = cli.build_parser().parse_args(
            ["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
             "-f", "14200", "--mode", "USB", "-o", str(tmp_path / "a.wav"),
             "--frames", "56", "--tui"])
        args.inject_keys = lambda: next(key_script, [])
        from supersdr_jax.apps.kiwi_session import run_kiwi_tui
        assert run_kiwi_tui(args) == 0
    finally:
        lt.ansi_render = orig
        server.stop()
    assert rendered
    # zoom key propagated to the W/F stream
    zooms = [c for c in server.commands if "zoom=" in c]
    assert any("zoom=9" in z for z in zooms), zooms[-3:]  # default -z 8, UP -> 9


def test_parse_escape_sequences():
    from supersdr_jax.apps.live_tui import parse_escape
    assert parse_escape("[A") == "UP"
    assert parse_escape("[5~") == "PGUP"
    assert parse_escape("[<0;41;7M") == ("MOUSE", "press", 40, 6, False)
    assert parse_escape("[<64;10;2M") == ("MOUSE", "wheel_up", 9, 1, False)
    assert parse_escape("[<65;10;2M") == ("MOUSE", "wheel_down", 9, 1, False)
    assert parse_escape("[<0;41;7m") == ("MOUSE", "release", 40, 6, False)
    assert parse_escape("[<32;12;7M") == ("MOUSE", "drag", 11, 6, False)
    assert parse_escape("[<4;12;7M") == ("MOUSE", "press", 11, 6, True)
    assert parse_escape("[<36;13;7M") == ("MOUSE", "drag", 12, 6, True)
    # unrecognized sequences are ignored, NOT treated as ESC (a stray
    # function-key report must not cancel freq entry — ADVICE r2)
    assert parse_escape("[Z") is None
    assert parse_escape("OA") is None
    assert parse_escape("[<2;5;5M") is None          # right button unused


def test_mouse_drag_gestures():
    """Drag-tune in the waterfall, span pan on the spectrum row, and
    SHIFT-drag passband edges (reference supersdr.py:703-719 zones +
    passband steps :307-373)."""
    s = make_session()
    m = s.model
    for _ in range(10):
        m.push_row(np.full(100, 128.0))
    s.render_lines()                       # establishes row geometry
    spec_row, wf_row = m._spectrum_row, m._wf_row0

    # drag-tune: press in the waterfall, drag right
    m.handle_key(("MOUSE", "press", 40, wf_row + 2, False))
    f0 = s.rx.freq
    m.handle_key(("MOUSE", "drag", 60, wf_row + 2, False))
    assert s.rx.freq > f0
    expect = m._col_to_khz(60)
    assert abs(s.rx.freq - expect) < 1e-6
    m.handle_key(("MOUSE", "release", 60, wf_row + 2, False))
    assert m.drag is None

    # span pan: press on the spectrum row, drag left → span moves right
    center0 = s.pan.freq_khz
    m.handle_key(("MOUSE", "press", 50, spec_row, False))
    m.handle_key(("MOUSE", "drag", 30, spec_row, False))
    assert s.pan.freq_khz > center0        # dragged left ⇒ span slides up
    m.handle_key(("MOUSE", "release", 30, spec_row, False))

    # SHIFT-drag near the high edge widens/narrows the passband
    hc0 = s.rx.hc
    col_hi = m._col(s.rx.freq + s.rx.hc / 1000.0)
    m.handle_key(("MOUSE", "press", col_hi, wf_row + 1, True))
    assert m.drag is not None and m.drag[0] == "pb"
    m.handle_key(("MOUSE", "drag", col_hi + 3, wf_row + 1, True))
    assert s.rx.hc > hc0                   # dragged right: high edge up
    m.handle_key(("MOUSE", "drag", col_hi - 2, wf_row + 1, True))
    assert s.rx.hc < hc0 + 3 * 100 + 1     # dragged back: stepped down
    m.handle_key(("MOUSE", "release", col_hi, wf_row + 1, True))


def test_interactive_server_switch_and_revert(tmp_path):
    """`K` opens the server book; switching to a good server re-streams
    from it, switching to a busy one keeps the live server playing
    (reference connect_new + revert flow, supersdr.py:743-796)."""
    from supersdr_jax import cli
    from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    import supersdr_jax.apps.live_tui as lt

    t = np.arange(512 * 200) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    srv_a = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=80,
                                          audio_rate_true=12000.0)).start()
    srv_b = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=80,
                                          audio_rate_true=12000.0)).start()
    srv_busy = FakeKiwiServer(FakeKiwiConfig(iq_source=iq,
                                             too_busy=True)).start()
    book = tmp_path / "kiwi.list"
    book.write_text("KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS\n"
                    f"127.0.0.1;{srv_busy.port};;busy one\n"
                    f"127.0.0.1;{srv_b.port};;good one\n")

    # script: open the book, pick the busy server (must revert), open
    # again, pick the good server (must switch), keep streaming
    key_script = iter([[], ["K"], ["1"], [], [], ["K"], ["2"], [], []])
    rendered, messages = [], []
    orig = lt.ansi_render
    lt.ansi_render = rendered.append
    try:
        args = cli.build_parser().parse_args(
            ["kiwi", "-s", "127.0.0.1", "-p", str(srv_a.port),
             "-f", "14200", "--mode", "USB",
             "-o", str(tmp_path / "sw.wav"), "--frames", "60", "--tui"])
        args.kiwi_list = str(book)

        session_box = {}

        def keys():
            ks = next(key_script, [])
            if "session" in session_box:
                messages.append(session_box["session"].model.message)
            return ks

        args.inject_keys = keys
        import supersdr_jax.apps.kiwi_session as ks_mod
        orig_create = lt.LiveTui.create

        def create_spy(*a, **kw):
            s = orig_create(*a, **kw)
            session_box["session"] = s
            return s
        lt.LiveTui.create = create_spy
        try:
            rc = ks_mod.run_kiwi_tui(args)
        finally:
            lt.LiveTui.create = orig_create
        assert rc == 0
    finally:
        lt.ansi_render = orig
        srv_a.stop()
        srv_b.stop()
        srv_busy.stop()
    joined = "\n".join(messages)
    assert "staying" in joined or "refused" in joined, messages
    assert f"switched to 127.0.0.1:{srv_b.port}" in joined, messages
    # audio kept flowing across both the failed and successful switches
    from supersdr_jax.io import wav as wav_io
    data, rate = wav_io.read_audio_wav(tmp_path / "sw.wav")
    assert rate == 48000 and len(data) > 4096
    # the good server actually served our SND stream after the switch
    assert any(b"SET" in c if isinstance(c, bytes) else "SET" in c
               for c in srv_b.commands)


def test_server_menu_renders_book(tmp_path):
    s = make_session()
    from supersdr_jax.control.kiwilist import KiwiList
    book = tmp_path / "kiwi.list"
    book.write_text("KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS\n"
                    "kiwi1.example;8073;;alpha\nkiwi2.example;8074;;beta\n")
    s.server_book = KiwiList(book)
    calls = []
    s.switch_server = lambda e: (calls.append(e) or (True, "ok"))
    s.handle_key("K")
    assert s.server_menu
    lines = s.render_lines()
    assert any("kiwi1.example:8073" in ln for ln in lines)
    assert any("beta" in ln for ln in lines)
    s.handle_key("2")
    assert not s.server_menu and calls and calls[0][0] == "kiwi2.example"
    # ESC closes without connecting
    s.handle_key("K")
    s.handle_key("ESC")
    assert not s.server_menu and len(calls) == 1


def test_mouse_click_outside_surface_ignored():
    """Clicks on the status/span lines or past the rendered width must
    not retune (ADVICE r2: gate on the waterfall surface)."""
    s = make_session()
    m = s.model
    for _ in range(6):
        m.push_row(np.full(100, 90.0))
    s.render_lines()
    f0 = s.rx.freq
    m.handle_key(("MOUSE", "press", 10, 0, False))       # status line
    m.handle_key(("MOUSE", "press", 10, 1, False))       # span line
    m.handle_key(("MOUSE", "press", 200, m._wf_row0, False))  # past width
    assert s.rx.freq == f0
    z0 = s.pan.zoom
    m.handle_key(("MOUSE", "wheel_up", 10, 0, False))    # wheel on status
    assert s.pan.zoom == z0


def test_mouse_click_tunes_and_wheel_zooms(tmp_path):
    """Click on the span tunes the RX to the clicked frequency (reference
    click_freq, supersdr.py:836-873); wheel zooms."""
    from supersdr_jax.apps import tui
    from supersdr_jax.control.panadapter import Panadapter
    from supersdr_jax.control.receiver import Receiver
    from supersdr_jax.runtime import chain

    cfg = chain.ChainConfig(mode="USB", chunk=2048, os_block=2048,
                            n_taps=129)
    rx = Receiver(cfg=cfg, center_freq_khz=14200.0, freq=14200.0,
                  radio_mode="USB")
    pan = Panadapter(zoom=8, freq_khz=14200.0)
    m = tui.TuiModel(rx=rx, pan=pan, width=100)
    # click at 3/4 of the span
    m.handle_key(("MOUSE", "click", 75, 5))
    expect = pan.start_f_khz + 75.5 / 100 * pan.span_khz
    assert abs(rx.freq - expect) < pan.span_khz / 100
    z0 = pan.zoom
    m.handle_key(("MOUSE", "wheel_up", 10, 1))
    assert pan.zoom == z0 + 1
    m.handle_key(("MOUSE", "wheel_down", 10, 1))
    assert pan.zoom == z0
