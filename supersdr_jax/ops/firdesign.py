"""FIR filter design (host-side, numpy, runs once per retune).

Design happens on the host in float64 and produces tap vectors / frequency
responses that are shipped to the device as parameters — changing the
passband never triggers an XLA retrace, because the taps are data, not
structure.

The lowpass prototype reproduces the reference's design semantics
(/root/reference/utils_supersdr.py:333-348 `filtering.__init__`): a
windowed-sinc with Blackman window, N = ceil(4 / (fl/fs)) forced odd, taps
normalized to unity DC gain. Complex bandpass taps for arbitrary (and
possibly negative / asymmetric) low/high cuts are built by modulating the
prototype to the passband center — this is how the adjustable passband of
the KiwiSDR server DSP (controlled via `SET mod=... low_cut=... high_cut=...`,
utils_supersdr.py:976-980) is realised client-free on the device.
"""

from __future__ import annotations

import numpy as np


def lowpass_taps(fl: float, fs: float) -> np.ndarray:
    """Blackman-windowed-sinc lowpass, reference design rule.

    fl: cutoff in Hz, fs: sample rate in Hz. Tap count N = ceil(4/(fl/fs)),
    forced odd; unity DC gain.
    """
    b = fl / fs
    n = int(np.ceil(4.0 / b))
    if n % 2 == 0:
        n += 1
    h = np.sinc(2.0 * fl / fs * (np.arange(n) - (n - 1) / 2.0))
    h *= np.blackman(n)
    h /= np.sum(h)
    return h.astype(np.float64)


def lowpass_taps_n(fl: float, fs: float, n: int) -> np.ndarray:
    """Same design rule with an explicit (odd) tap count."""
    if n % 2 == 0:
        raise ValueError("tap count must be odd")
    h = np.sinc(2.0 * fl / fs * (np.arange(n) - (n - 1) / 2.0))
    h *= np.blackman(n)
    h /= np.sum(h)
    return h.astype(np.float64)


def complex_bandpass_taps(low_cut: float, high_cut: float, fs: float,
                          n: int | None = None) -> np.ndarray:
    """Complex (analytic) bandpass taps passing low_cut..high_cut Hz.

    Cuts may be negative (LSB) or straddle zero (AM); the filter is a
    lowpass prototype of half the passband width modulated to the passband
    center, so its response is one-sided in general: exactly the shape the
    KiwiSDR server applies for SSB/CW/AM channel selection.
    """
    if high_cut <= low_cut:
        raise ValueError(f"high_cut ({high_cut}) must exceed low_cut ({low_cut})")
    center = 0.5 * (low_cut + high_cut)
    half_width = 0.5 * (high_cut - low_cut)
    proto = lowpass_taps(half_width, fs) if n is None else lowpass_taps_n(
        half_width, fs, n)
    m = np.arange(len(proto)) - (len(proto) - 1) / 2.0
    shift = np.exp(2j * np.pi * center / fs * m)
    return (proto * shift).astype(np.complex128)


def freq_response(taps: np.ndarray, fft_size: int) -> np.ndarray:
    """Zero-padded DFT of the taps — the H used by overlap-save kernels."""
    return np.fft.fft(taps, n=fft_size)


def brickwall_mask(fft_size: int, fs: float, low_cut: float, high_cut: float,
                   transition: float = 100.0) -> np.ndarray:
    """Frequency-domain passband mask with raised-cosine edges.

    The 'fused mask' alternative to designed FIR taps: applied directly to
    the overlap-save spectrum, zero extra FLOPs over the transform itself.
    `transition` is the edge width in Hz. Bin ordering matches np.fft.fftfreq.
    """
    f = np.fft.fftfreq(fft_size, d=1.0 / fs)

    def edge(x):  # 0 below -transition, 1 above +transition, cosine between
        t = np.clip((x / max(transition, 1e-9)) * 0.5 + 0.5, 0.0, 1.0)
        return 0.5 - 0.5 * np.cos(np.pi * t)

    mask = edge(f - low_cut) * edge(high_cut - f)
    return mask.astype(np.float64)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def polyphase_decompose(taps: np.ndarray, n_branches: int) -> np.ndarray:
    """Reshape prototype taps into [n_taps_per_branch, n_branches] polyphase
    matrix (zero-padded), branch p holding taps[p::n_branches]."""
    n = len(taps)
    per = int(np.ceil(n / n_branches))
    padded = np.zeros(per * n_branches, dtype=taps.dtype)
    padded[:n] = taps
    return padded.reshape(per, n_branches)
