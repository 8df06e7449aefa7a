"""Dual-RX scenario (BASELINE config 4): two simultaneous chains — SSB and
narrow CW — sharing one capture/waterfall, with S-meter dB readout. Plus
profiling utilities."""

import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import smeter, spectrum
from supersdr_jax.runtime import chain
from supersdr_jax.utils.profiling import BlockTimer, ThroughputMeter


def tone_snr_db(x, freq, fs):
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t), np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    return 10 * np.log10(np.mean((fit - fit.mean()) ** 2)
                         / max(np.mean((x - fit) ** 2), 1e-30))


def test_dual_rx_ssb_plus_cw():
    fs = 12000
    n = 32768
    t = np.arange(n) / fs
    # capture: USB voice-band tone at +1.4 kHz from RX1 dial, CW carrier at
    # RX2 dial + 600 Hz pitch, RX2 dial offset +3 kHz in the span
    usb_tone = 0.4 * np.exp(2j * np.pi * 1400 * t)
    cw_carrier = 0.1 * np.exp(2j * np.pi * (3000 + 600) * t)
    iq = (usb_tone + cw_carrier).astype(np.complex64)
    iq2 = np.stack([iq, iq])

    cfg = chain.ChainConfig(mode="USB", chunk=8192, os_block=8192)
    cw_cfg = chain.ChainConfig(mode="CW", chunk=8192, os_block=8192)
    p_usb = chain.make_params(cfg, freq_offset_hz=0.0,
                              agc_kwargs=dict(on=False))
    p_cw = chain.make_params(cw_cfg, freq_offset_hz=3000.0,
                             agc_kwargs=dict(on=False))

    s1 = chain.init_state(cfg)
    s2 = chain.init_state(cw_cfg)
    a_usb, a_cw, r_usb, r_cw = [], [], [], []
    for i in range(0, n, 8192):
        blk = jnp.asarray(iq[i:i + 8192])
        s1, o1 = chain.process(cfg, p_usb, s1, blk)
        s2, o2 = chain.process(cw_cfg, p_cw, s2, blk)
        a_usb.append(np.asarray(o1.audio))
        a_cw.append(np.asarray(o2.audio))
        r_usb.append(np.asarray(o1.rssi))
        r_cw.append(np.asarray(o2.rssi))
    au = np.concatenate(a_usb)[-32768:]
    ac = np.concatenate(a_cw)[-32768:]
    # MAIN hears its 1.4 kHz tone; SUB hears the 600 Hz CW pitch
    assert tone_snr_db(au, 1400, 48000) > 30
    assert tone_snr_db(ac, 600, 48000) > 30
    # independent S-meters: USB sees the strong tone, CW the weak carrier
    rssi_usb = np.concatenate(r_usb)[-1]
    rssi_cw = np.concatenate(r_cw)[-1]
    assert rssi_usb > rssi_cw + 8
    # s-units mapping sane
    assert 0 < float(smeter.s_units(jnp.asarray(rssi_usb))) < 20

    # shared waterfall shows both signals
    rows = spectrum.segment_rows(jnp.asarray(iq), 1024)
    db = spectrum.power_spectrum_db(rows, spectrum.spectrum_window(1024))
    mean_db = np.asarray(db).mean(axis=0)
    freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1 / fs))
    def bin_at(f):
        return np.argmin(np.abs(freqs - f))
    floor = np.median(mean_db)
    assert mean_db[bin_at(1400)] > floor + 30
    assert mean_db[bin_at(3600)] > floor + 20


def test_block_timer_and_meter():
    bt = BlockTimer()
    for _ in range(5):
        with bt.stage("demod"):
            sum(range(1000))
    st = bt.stats("demod")
    assert st["n"] == 5 and st["mean_ms"] >= 0
    assert "demod" in bt.report()

    tm = ThroughputMeter()
    tm.update(1000)
    import time
    time.sleep(0.01)
    rate = tm.update(1000)
    assert rate > 0
