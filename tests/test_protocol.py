import numpy as np

from supersdr_jax.io import kiwi_protocol as kp
from supersdr_jax.io.status import KiwiStatus, KiwiBusy, KiwiOffline
import pytest


def test_snd_frame_roundtrip(rng):
    samples = rng.integers(-30000, 30000, 512).astype(np.int16)
    raw = kp.build_snd_audio(seq=42, rssi=-73.0, samples=samples)
    f = kp.parse(raw)
    assert isinstance(f, kp.SndFrame)
    assert f.seq == 42
    assert abs(f.rssi - (-73.0)) < 0.1
    assert not f.adc_overflow
    np.testing.assert_array_equal(f.audio_int16(), samples)


def test_snd_adc_overflow_flag():
    raw = kp.build_snd_audio(0, -60, np.zeros(4, np.int16),
                             flags=kp.ADC_OVERFLOW_FLAG)
    f = kp.parse(raw)
    assert f.adc_overflow


def test_snd_iq_roundtrip(rng):
    z = (rng.normal(size=256) + 1j * rng.normal(size=256)) * 1000
    raw = kp.build_snd_iq(7, -80.0, z, gpssec=123, gpsnsec=456)
    f = kp.parse(raw)
    gps, z2 = f.iq_samples()
    assert gps["gpssec"] == 123 and gps["gpsnsec"] == 456
    np.testing.assert_allclose(z2.real, np.round(z.real), atol=0.5)
    np.testing.assert_allclose(z2.imag, np.round(z.imag), atol=0.5)


def test_wf_frame_roundtrip(rng):
    bins = rng.integers(0, 255, 1024).astype(np.uint8)
    raw = kp.build_wf(seq=5, bins=bins, x_bin=100, flags_zoom=7)
    f = kp.parse(raw)
    assert isinstance(f, kp.WfFrame)
    assert (f.seq, f.x_bin, f.flags_zoom) == (5, 100, 7)
    np.testing.assert_array_equal(f.bins_uint8(), bins)
    assert len(raw) == 16 + 1024  # reference strips msg[16:] (utils:783)


def test_msg_parse():
    m = kp.parse(kp.build_msg(audio_init="0", audio_rate="12000",
                              sample_rate="12001.150"))
    assert isinstance(m, kp.Msg)
    assert m.params["audio_rate"] == "12000"
    assert m.params["sample_rate"] == "12001.150"


def test_command_builders_match_reference_grammar():
    # exact strings the reference sends (utils_supersdr.py:741-742,976-983)
    assert kp.auth("pw") == "SET auth t=kiwi p=pw ipl=pw"
    assert kp.set_mod("USB", 30, 3000, 14200.0) == \
        "SET mod=usb low_cut=30 high_cut=3000 freq=14200.000"
    assert kp.set_agc(True, False, -80, 0, 4000, 50) == \
        "SET agc=1 hang=0 thresh=-80 slope=0 decay=4000 manGain=50"
    assert kp.set_zoom_start(7, 123456) == "SET zoom=7 start=123456"
    assert kp.set_maxdb_mindb(-10, -110) == "SET maxdb=-10 mindb=-110"
    assert kp.set_wf_speed(4) == "SET wf_speed=4"
    assert kp.set_wf_comp(False) == "SET wf_comp=0"
    assert kp.set_wf_interp(13) == "SET interp=13"
    assert kp.set_compression(False) == "SET compression=0"
    assert kp.set_ar_ok(12000, 48000) == "SET AR OK in=12000 out=48000"
    assert kp.keepalive() == "SET keepalive"
    assert kp.set_inactivity_override() == "SET OVERRIDE inactivity_timeout=1000"


STATUS_TEXT = """\
status=active
offline=no
name=Test Kiwi
sdr_hw=KiwiSDR v1.2
users=2
users_max=4
gps=(45.00, 9.00)
asl=200
loc=JN45
bands=0-30000
antenna=dipole
freq_offset=0
"""


def test_status_parse():
    st = KiwiStatus.from_text(STATUS_TEXT)
    assert st.users == 2 and st.users_max == 4
    assert st.active and not st.offline
    assert st.gps == (45.0, 9.0)
    assert st.max_freq_khz == 30000.0
    st.gate()  # no raise


def test_status_gate_busy():
    st = KiwiStatus.from_text(STATUS_TEXT.replace("users=2", "users=4"))
    with pytest.raises(KiwiBusy):
        st.gate()


def test_status_gate_offline():
    st = KiwiStatus.from_text(STATUS_TEXT.replace("offline=no", "offline=yes"))
    with pytest.raises(KiwiOffline):
        st.gate()
