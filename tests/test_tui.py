import numpy as np

from supersdr_jax.apps import tui
from supersdr_jax.control.panadapter import Panadapter
from supersdr_jax.control.receiver import Receiver
from supersdr_jax.runtime import chain


def make_model(tmp_path):
    cfg = chain.ChainConfig(mode="USB", chunk=2048, os_block=2048,
                            n_taps=129)
    rx = Receiver(cfg=cfg, center_freq_khz=14200.0, freq=14200.0,
                  radio_mode="USB")
    pan = Panadapter(zoom=8, freq_khz=14200.0)
    from supersdr_jax.control.memories import MemoryBank
    return tui.TuiModel(rx=rx, pan=pan, width=80,
                        memories=MemoryBank(tmp_path / "m.json"))


def test_key_table(tmp_path):
    m = make_model(tmp_path)
    assert m.handle_key("RIGHT")
    assert m.rx.freq == 14201.0
    m.handle_key("<")
    assert m.rx.freq == 14191.0
    m.handle_key("c")
    assert m.rx.radio_mode == "CW"
    m.handle_key("a")
    assert m.rx.radio_mode == "AM"
    m.handle_key("k")
    m.handle_key("v")
    assert m.rx.volume == 110
    m.handle_key("m")
    assert m.rx.muted
    m.handle_key("UP")
    assert m.pan.zoom == 9
    m.handle_key("g")
    assert m.averaging_n == 2
    m.handle_key("w")
    m.handle_key("r")
    assert not m.handle_key("q")


def test_memory_recall_restores(tmp_path):
    m = make_model(tmp_path)
    m.handle_key("w")                       # store 14200 USB
    m.handle_key("RIGHT"); m.handle_key("RIGHT")
    m.handle_key("c")
    m.handle_key("w")                       # store 14202 CW
    m.handle_key("r")                       # cyclic recall
    assert (m.rx.freq, m.rx.radio_mode) in ((14200.0, "USB"),
                                            (14202.0, "CW"))


def test_render_rows(tmp_path, rng):
    m = make_model(tmp_path)
    for _ in range(5):
        m.push_row(rng.uniform(0, 255, 1024))
    lines = m.render()
    assert len(lines) == 2 + 1 + 5  # status, span, spectrum, waterfall
    assert "kHz" in lines[0] and "S" in lines[0]
    assert "span" in lines[1]
    assert "\x1b[48;5;" in lines[3]  # ANSI colored waterfall
    # spectrum line uses block glyphs at terminal width
    assert len(lines[2]) == 80


def test_resample_bins_preserves_peaks(rng):
    row = np.zeros(1024)
    row[500] = 250.0
    r = tui.resample_bins(row, 64)
    assert r.max() == 250.0
    assert len(r) == 64


def test_smeter_text():
    s9 = tui.smeter_text(-73.0)
    assert "S9" in s9
    weak = tui.smeter_text(-121.0)
    assert "S1" in weak


def test_eibi_overlay_lines():
    """'i' toggles EIBI overlay; markers and legend appear for stations
    inside the span (shipped data file, utils:1693-1729 behavior)."""
    from supersdr_jax.apps.tui import TuiModel
    from supersdr_jax.control.panadapter import Panadapter
    from supersdr_jax.control.receiver import Receiver
    from supersdr_jax.runtime import chain

    cfg = chain.ChainConfig(mode="AM", chunk=2048, os_block=2048)
    rx = Receiver(cfg=cfg, center_freq_khz=6000.0, freq=6000.0,
                  radio_mode="AM")
    pan = Panadapter(zoom=5, freq_khz=6000.0)  # ~937 kHz span: 49/41m bands
    m = TuiModel(rx=rx, pan=pan, width=100, wf_height=4)
    assert m.handle_key("i")
    assert m.show_eibi and m.eibi is not None and m.eibi.loaded
    lines = m.overlay_lines()
    assert len(lines) >= 1 and "▼" in lines[0]
    assert len(lines) == 2 and "|" in lines[1] or len(lines[1]) > 0
    # render includes the overlay rows
    assert any("▼" in ln for ln in m.render())
    # toggle off
    m.handle_key("i")
    assert not m.show_eibi


def test_eibi_ships_with_package():
    from supersdr_jax.control.eibi import DEFAULT_EIBI_PATH, EibiDb
    assert DEFAULT_EIBI_PATH.exists()
    db = EibiDb()
    assert db.loaded
    # the 49m broadcast band is dense with schedule entries
    assert len(db.get_stations(5900, 6200)) > 50


def test_help_screen_toggle():
    from supersdr_jax.apps.tui import HELP_LINES, TuiModel
    from supersdr_jax.control.panadapter import Panadapter
    from supersdr_jax.control.receiver import Receiver
    from supersdr_jax.runtime import chain

    cfg = chain.ChainConfig(mode="USB", chunk=2048, os_block=2048)
    m = TuiModel(rx=Receiver(cfg=cfg), pan=Panadapter(zoom=8), width=80)
    assert m.handle_key("?") and m.show_help
    assert HELP_LINES[0] in m.render()
    assert m.handle_key("?") and not m.show_help


def test_qso_logger_keys(tmp_path):
    """0/9: add a QSO via the callsign entry line, then find it with the
    search entry (reference logger dialogs, utils:1829-2093)."""
    from supersdr_jax.control.logbook import Logbook
    m = make_model(tmp_path)
    m.logbook = Logbook(tmp_path / "log.sdr")
    m.handle_key("0")
    assert m.text_entry == ("qso_add", "")
    for ch in "IK1ABC":
        m.handle_key(ch)
    m.handle_key("ENTER")
    assert m.text_entry is None
    assert len(m.logbook) == 1
    assert m.logbook.qsos[0].callsign == "IK1ABC"
    assert m.logbook.qsos[0].freq_khz == 14200.0

    m.handle_key("9")
    for ch in "ik1":
        m.handle_key(ch)
    m.handle_key("\r")
    assert "1 QSO(s) IK1" in m.message
    # persisted: a fresh book reloads it
    assert len(Logbook(tmp_path / "log.sdr")) == 1


def test_agc_keys(tmp_path):
    m = make_model(tmp_path)
    t0 = m.rx.agc.thresh
    m.handle_key("1")
    assert m.rx.agc.thresh == t0 - 5
    m.handle_key("2")
    assert m.rx.agc.thresh == t0
    d0 = m.rx.agc.decay
    m.handle_key("@")
    assert m.rx.agc.decay == d0 + 200
    m.handle_key("!")
    assert m.rx.agc.decay == d0


def test_wf_autoscale_and_fill_keys(tmp_path):
    m = make_model(tmp_path)
    m.handle_key(",")
    m.handle_key("'")
    assert m.wf_delta_high_db != 0.0 and m.wf_delta_low_db != 0.0
    m.handle_key("3")
    assert m.wf_delta_high_db == 0.0 and m.wf_delta_low_db == 0.0
    assert m.spectrum_fill
    m.handle_key("4")
    assert not m.spectrum_fill
    row = np.linspace(0, 255, 64)
    assert tui.spectrum_row_text(row, 32, fill=False) != \
        tui.spectrum_row_text(row, 32, fill=True)
