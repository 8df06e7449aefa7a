import numpy as np

from supersdr_jax.ops import firdesign


def reference_filtering_taps(fl, fs):
    """The reference design verbatim (utils_supersdr.py:333-348 semantics)."""
    b = fl / fs
    N = int(np.ceil((4 / b)))
    if not N % 2:
        N += 1
    h = np.sinc(2. * fl / fs * (np.arange(N) - (N - 1) / 2.))
    w = np.blackman(N)
    h = h * w
    return h / np.sum(h)


def test_lowpass_matches_reference_design():
    for fl, fs in [(6000, 48000), (10000, 240000), (3000, 12000)]:
        ours = firdesign.lowpass_taps(fl, fs)
        ref = reference_filtering_taps(fl, fs)
        assert len(ours) == len(ref)
        np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_lowpass_12_to_48_is_33_taps():
    # The reference's audio interpolator: filtering(KIWI_RATE/2, AUDIO_RATE)
    taps = firdesign.lowpass_taps(6000, 48000)
    assert len(taps) == 33
    np.testing.assert_allclose(taps.sum(), 1.0, rtol=1e-12)


def test_complex_bandpass_response():
    fs = 12000.0
    taps = firdesign.complex_bandpass_taps(300, 2700, fs)
    f = np.fft.fftfreq(8192, 1 / fs)
    H = np.abs(np.fft.fft(taps, 8192))
    # the reference design rule (N=ceil(4/b)) gives a wide transition band;
    # test flatness in the central region and rejection well past the edges
    inband = H[(f > 1000) & (f < 2000)]
    stop_neg = H[(f < -800)]
    stop_hi = H[(f > 4500)]
    np.testing.assert_allclose(inband, 1.0, atol=0.01)
    assert stop_neg.max() < 1e-3   # >60 dB rejection of the other sideband
    assert stop_hi.max() < 1e-3


def test_complex_bandpass_negative_band():
    fs = 12000.0
    taps = firdesign.complex_bandpass_taps(-2700, -300, fs)
    f = np.fft.fftfreq(8192, 1 / fs)
    H = np.abs(np.fft.fft(taps, 8192))
    assert H[(f < -1000) & (f > -2000)].min() > 0.99
    assert H[f > 800].max() < 1e-3


def test_brickwall_mask_edges():
    mask = firdesign.brickwall_mask(4096, 12000, 300, 2700, transition=100)
    f = np.fft.fftfreq(4096, 1 / 12000)
    assert mask[(f > 500) & (f < 2500)].min() > 0.999
    assert mask[(f < 100) | (f > 2900)].max() < 1e-6


def test_polyphase_decompose_roundtrip():
    taps = firdesign.lowpass_taps(6000, 48000)
    P = firdesign.polyphase_decompose(taps, 4)
    assert P.shape == (9, 4)
    flat = P.reshape(-1)[: len(taps)]
    np.testing.assert_allclose(flat, taps)
