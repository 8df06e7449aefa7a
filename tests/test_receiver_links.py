import numpy as np

from supersdr_jax.control.links import LinkController
from supersdr_jax.control.panadapter import Panadapter
from supersdr_jax.control.receiver import AGCSettings, Flags, Receiver
from supersdr_jax.runtime import chain


def small_cfg(mode="USB"):
    return chain.ChainConfig(mode=mode, chunk=2048, os_block=2048, n_taps=129)


def make_rx(mode="USB", freq=14200.0):
    return Receiver(cfg=small_cfg(mode), center_freq_khz=freq, freq=freq,
                    radio_mode=mode)


def test_receiver_passband_adjust():
    rx = make_rx("USB")
    assert (rx.lc, rx.hc) == (30, 3000)
    assert rx.adjust_passband("high")          # K: +100 on high cut
    assert (rx.lc, rx.hc) == (30, 3100)
    assert rx.adjust_passband("low")           # J: -100 on low cut
    assert (rx.lc, rx.hc) == (-70, 3100)
    assert rx.adjust_passband("low", shift=True)
    assert (rx.lc, rx.hc) == (30, 3100)


def test_receiver_passband_width_clamp():
    rx = make_rx("CW")
    # CW step is 20 Hz; default width 400; narrow until the 50 Hz floor
    for _ in range(12):
        rx.adjust_passband("high", shift=True)  # -20 each
    width = rx.hc - rx.lc
    assert width >= 50
    changed = rx.adjust_passband("high", shift=True)
    if width - 20 < 50:
        assert not changed


def test_receiver_mode_switch_decay_memory():
    rx = make_rx("USB")
    assert rx.agc.decay == 4000
    rx.set_mode("CW")
    assert rx.agc.decay == 1000
    rx.agc.change_delay(-200, "CW")
    assert rx.agc.decay == 800
    rx.set_mode("USB")
    assert rx.agc.decay == 4000
    rx.set_mode("CW")
    assert rx.agc.decay == 800


def test_receiver_agc_delay_clamp():
    a = AGCSettings()
    a.decay = 500
    a.change_delay(-200, "USB")
    assert a.decay == 300  # steps below min only when above it
    a.change_delay(-200, "USB")
    assert a.decay == 300
    a.decay = 7900
    a.change_delay(200, "USB")
    assert a.decay == 8100
    a.change_delay(200, "USB")
    assert a.decay == 8100


def test_receiver_demodulates():
    rx = make_rx("USB")
    fs = 12000
    t = np.arange(8192) / fs
    # modest level: a full-scale tone would (correctly) trip the TX-mute
    iq = (0.05 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    audio = np.concatenate([rx.process(iq[:2048]), rx.process(iq[2048:4096])])
    assert audio.shape == (2 * 2048 * 4,)
    assert np.abs(audio[4096:]).max() > 0.02
    assert -60 < rx.rssi < -25


def test_receiver_tx_mute():
    rx = make_rx("USB")
    fs = 12000
    t = np.arange(2048) / fs
    loud = (30.0 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    audio = rx.process(loud)
    assert rx.rssi > -20
    assert np.abs(audio).max() == 0.0  # muted during TX


def test_receiver_tunable_rig_interface():
    rx = make_rx("USB")
    rx.set_mod("cw", None, None, 7030.0)
    assert rx.radio_mode == "CW"
    assert rx.freq == 7030.0
    assert (rx.get_lowcut(), rx.get_highcut()) == (400, 800)


def test_links_manual_tune_follow():
    rx = make_rx("USB")
    pan = Panadapter(zoom=8, freq_khz=14200)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(wf_snd_link=False,
                                                   auto_mode=True))
    lc.manual_tune(14250.0)
    assert rx.freq == 14250.0
    assert rx.radio_mode == "USB"
    # tune out of span: span shifts to the edge
    out_freq = pan.end_f_khz + 50
    lc.manual_tune(out_freq)
    assert pan.contains(rx.freq) or abs(pan.freq_khz - rx.freq) < pan.span_khz


def test_links_auto_mode_switches():
    rx = make_rx("USB", freq=14200.0)
    pan = Panadapter(zoom=6, freq_khz=7100)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=True))
    lc.manual_tune(7100.0)
    assert rx.radio_mode == "LSB"
    lc.manual_tune(7030.0)
    assert rx.radio_mode == "CW"
    lc.manual_tune(1000.0)
    assert rx.radio_mode == "AM"


def test_links_click_cw_pitch():
    rx = make_rx("CW", freq=7025.0)
    pan = Panadapter(zoom=10, freq_khz=7025)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.click_tune(512)
    expected = pan.bins_to_khz(512) - 0.6
    assert abs(rx.freq - expected) < 1e-9


class FakeCat:
    def __init__(self):
        self.freq = 14200.0
        self.radio_mode = "USB"
        self.set_calls = []

    def set_freq(self, f):
        self.set_calls.append(("F", f))
        self.freq = f

    def set_mode(self, m):
        self.set_calls.append(("M", m))
        self.radio_mode = m

    def get_mode(self):
        return self.radio_mode

    def get_freq(self):
        return self.freq


def test_links_cat_push_cw_pitch():
    rx = make_rx("CW", freq=7030.0)
    pan = Panadapter(zoom=8, freq_khz=7030)
    cat = FakeCat()
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.cat = cat
    lc.manual_tune(7030.0)
    # CAT gets dial + CW pitch (supersdr.py:879)
    assert ("F", 7030.6) in cat.set_calls


def test_links_cat_poll_reverse():
    rx = make_rx("USB", freq=14200.0)
    pan = Panadapter(zoom=8, freq_khz=14200)
    cat = FakeCat()
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.cat = cat
    assert not lc.poll_cat()  # first poll just records the baseline
    cat.freq = 14210.0        # user turned the VFO
    assert lc.poll_cat()
    assert rx.freq == 14210.0
