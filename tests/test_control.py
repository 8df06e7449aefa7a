import numpy as np
from datetime import datetime, timezone

from supersdr_jax.control import bandplan, beacons, dxcluster, eibi
from supersdr_jax.control.kiwilist import KiwiList
from supersdr_jax.control.logbook import Logbook, QSO
from supersdr_jax.control.memories import MemoryBank
from supersdr_jax.control.panadapter import Panadapter


# ------------------------------------------------------------- band plan

def test_auto_mode_tables():
    assert bandplan.get_auto_mode(14250) == "USB"
    assert bandplan.get_auto_mode(7100) == "LSB"
    assert bandplan.get_auto_mode(7030) == "CW"
    assert bandplan.get_auto_mode(1000) == "AM"
    assert bandplan.get_auto_mode(5000) == "AM"
    # generic fallback
    assert bandplan.get_auto_mode(9000) == "LSB"
    assert bandplan.get_auto_mode(22000) == "USB"


# ------------------------------------------------------------ panadapter

def test_zoom_span_math():
    pan = Panadapter(zoom=0, freq_khz=14200)
    assert pan.span_khz == 30000
    assert pan.freq_khz == 15000  # zoom 0 forces center
    pan.set_freq_zoom(14200, 7)
    assert abs(pan.span_khz - 30000 / 128) < 1e-9
    assert pan.start_f_khz < 14200 < pan.end_f_khz


def test_counter_quantization():
    pan = Panadapter(zoom=7, freq_khz=14200)
    counter, actual = pan.start_frequency_to_counter(14100.0)
    # actual start frequency snaps to the 2^14*1024 grid
    assert abs(actual - 14100.0) < 30000 / (2 ** 14 * 1024) + 1e-9
    assert counter == round(14100 / 30000 * 2 ** 14 * 1024)


def test_edge_clamping():
    pan = Panadapter(zoom=4, freq_khz=100)   # span 1875, half = 937.5
    assert pan.freq_khz == pan.span_khz / 2
    pan.set_freq_zoom(29990, 4)
    assert pan.freq_khz == 30000 - pan.span_khz / 2


def test_bins_roundtrip():
    pan = Panadapter(zoom=10, freq_khz=7040)
    f = pan.bins_to_khz(512)
    assert abs(f - (pan.start_f_khz + pan.span_khz / 2)) < 0.05
    assert abs(pan.offset_to_bin(f - pan.start_f_khz) - 512) < 1e-6


def test_cw_click_pitch_offset():
    pan = Panadapter(zoom=10, freq_khz=7025)
    f_cw = pan.click_to_dial_khz(512, "CW")
    f_usb = pan.click_to_dial_khz(512, "USB")
    assert abs((f_usb - f_cw) - 0.6) < 1e-9


def test_follow_and_page():
    pan = Panadapter(zoom=8, freq_khz=14200)
    span = pan.span_khz
    assert not pan.follow(14200)
    moved = pan.follow(pan.end_f_khz + 10)
    assert moved
    start = pan.freq_khz
    pan.page(+1)
    assert abs(pan.freq_khz - (start + span / 4)) < 0.01


def test_gen_div_ticks():
    pan = Panadapter(zoom=10, freq_khz=7040)
    div, subdiv = pan.gen_div()
    assert div or subdiv
    assert all(0 <= b <= 1024 for b in div)


# -------------------------------------------------------------- memories

def test_memory_bank_cycle(tmp_path):
    m = MemoryBank(tmp_path / "mem.json")
    for f in (7040, 14200, 3573):
        m.write_mem(f, "USB", 0, 0)
    assert len(m) == 3
    seen = {m.recall_mem()[0] for _ in range(6)}
    assert seen == {7040, 14200, 3573}
    m.save_to_disk()
    m2 = MemoryBank(tmp_path / "mem.json")
    m2.load_from_disk()
    assert len(m2) == 3


def test_memory_depth_limit(tmp_path):
    m = MemoryBank(tmp_path / "mem.json")
    for i in range(15):
        m.write_mem(7000 + i, "LSB", 0, 0)
    assert len(m) == 10  # cyclic 10-deep


# --------------------------------------------------------------- beacons

def test_beacon_schedule():
    t0 = datetime(2026, 1, 1, 0, 0, 5, tzinfo=timezone.utc)   # slot 0
    b = beacons.which_beacons(t0)
    assert b[14] == "4U1UN"
    t1 = datetime(2026, 1, 1, 0, 0, 15, tzinfo=timezone.utc)  # slot 1
    b = beacons.which_beacons(t1)
    assert b[14] == "VE8AT"
    assert b[18] == "4U1UN"
    # full cycle length: 18 slots of 10 s over 3 minutes
    t2 = datetime(2026, 1, 1, 0, 3, 5, tzinfo=timezone.utc)
    assert beacons.which_beacons(t2)[14] == "4U1UN"


# ------------------------------------------------------------- dxcluster

SPOT_LINES = (
    "DX de EA5XYZ:    14025.0  W1AW         CW 25 dB                  1200Z\n"
    "DX de DL1ABC:     7074.0  IK2XYZ       FT8                       1201Z\n"
)


def test_dxcluster_feed_and_query():
    dx = dxcluster.DxCluster("TEST0CALL")
    n = dx.feed(SPOT_LINES)
    assert n == 2
    vis = dx.get_stations(14000, 14350)
    assert len(vis) == 1
    call, qrg, utc, spotter = dx.spot(vis[0])
    assert call == "W1AW" and qrg == 14025.0 and spotter == "EA5XYZ"


def test_dxcluster_dedup_keeps_newest():
    dx = dxcluster.DxCluster("TEST0CALL")
    old = datetime(2026, 1, 1, 10, 0, tzinfo=timezone.utc)
    new = datetime(2026, 1, 1, 10, 5, tzinfo=timezone.utc)
    dx.feed("DX de AA1AA:    14020.0  W1AW         CW\n", now=old)
    dx.feed("DX de BB1BB:    14022.0  W1AW         CW\n", now=new)
    vis = dx.get_stations(14000, 14350)
    assert len(vis) == 1
    assert dx.spot(vis[0])[3] == "BB1BB"


def test_dxcluster_ttl_expiry():
    dx = dxcluster.DxCluster("TEST0CALL")
    old = datetime(2026, 1, 1, 8, 0, tzinfo=timezone.utc)
    dx.feed(SPOT_LINES, now=old)
    dx.clean_old_spots(datetime(2026, 1, 1, 10, 0, tzinfo=timezone.utc))
    assert len(dx.spot_dict) == 0


def test_age_colors():
    assert dxcluster.age_color(0) == "green"
    assert dxcluster.age_color(700) == "yellow"
    assert dxcluster.age_color(2500) == "grey"


# ------------------------------------------------------------------ eibi

def test_eibi_db(tmp_path):
    csv = tmp_path / "eibi.csv"
    csv.write_text("kHz:75;Time(UTC):93;Days:59;ITU:49;Station:201;Lng:49\n"
                   "7040;0000-2400;;USA;Test Station A;E\n"
                   "7040.5;0800-1000;;D;Morning Show;D\n"
                   "14210;0000-2400;;F;Autre Station;F\n",
                   encoding="latin-1")
    db = eibi.EibiDb(csv)
    assert db.loaded
    vis = db.get_stations(7000, 7100)
    assert 7040.0 in vis and 7040.5 in vis and 14210.0 not in vis
    assert db.get_names(7040.0) == ["Test Station A"]
    noon = datetime(2026, 1, 1, 12, 0, tzinfo=timezone.utc)
    on_air = db.get_on_air(7000, 7100, noon)
    assert (7040.0, "Test Station A") in on_air
    assert all(f != 7040.5 for f, _ in on_air)  # 0800-1000 is off at noon


# -------------------------------------------------------------- kiwilist

def test_kiwilist_roundtrip(tmp_path):
    path = tmp_path / "kiwi.list"
    kl = KiwiList(path)
    assert len(kl) == 0
    kl.add("kiwi.example.com:8074:pass", comments="fast one")
    kl.add("other.example.com")
    assert len(kl) == 2
    assert kl.servers[0] == ("kiwi.example.com", 8074, "pass", "fast one")
    assert kl.servers[1] == ("other.example.com", 8073, "", "")
    kl2 = KiwiList(path)
    assert kl2.servers == kl.servers


# --------------------------------------------------------------- logbook

def test_logbook(tmp_path):
    lb = Logbook(tmp_path / "log.sdr")
    lb.add(QSO(callsign="W1AW", freq_khz=14025.0, mode="CW"))
    lb.add(QSO(callsign="IK2ABC", freq_khz=7074.0, mode="FT8",
               comment="nice sig"))
    lb2 = Logbook(tmp_path / "log.sdr")
    assert len(lb2) == 2
    hits = lb2.search("ik2")
    assert len(hits) == 1 and hits[0].freq_khz == 7074.0
