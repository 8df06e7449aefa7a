"""Generate the committed off-air-style KiwiSDR IQ WAV fixture.

The environment has no network access, so the BASELINE "recorded
KiwiSDR IQ WAV" clause is closed with a SYNTHESIZED capture that has
the statistical features of a real off-air recording (reference format:
/root/reference/kiwi/wavreader.py:88-112):

  * an AM broadcast-style signal: carrier + deterministic multi-tone
    program audio (500/900/1700 Hz at known depths),
  * slow two-path fading on the carrier envelope,
  * band noise at ~-40 dB and an adjacent-channel SSB-ish interferer
    at the passband edge,
  * int16 quantization through the 16-bit wire format,
  * REAL clock drift: the ADC runs at 12000.6 Hz while the header
    claims 12000 (the reference's KIWI_RATE_TRUE situation), and
  * GPS timestamp jitter: ±2 µs white jitter per frame on the GNSS
    solution, which the reader's EWMA rate estimator must smooth out.

Deterministic (seeded): re-running reproduces the committed bytes.
Run:  python tests/fixtures/make_kiwi_fixture.py
"""

import os

import numpy as np

FS_CLAIMED = 12_000
FS_TRUE = 12_000.6
SECONDS = 3.0
# a whole number of 512-sample frames: the reference reader's EWMA
# computes instantaneous rate per frame interval, and a short tail
# frame would skew the final estimate
N = (int(SECONDS * FS_CLAIMED) // 512 + 1) * 512

TONES = ((500.0, 0.35), (900.0, 0.25), (1700.0, 0.15))


def program_audio(t: np.ndarray) -> np.ndarray:
    a = np.zeros_like(t)
    for f, depth in TONES:
        a += depth * np.sin(2 * np.pi * f * t)
    return a


def main(path: str) -> None:
    rng = np.random.default_rng(2025)
    t = np.arange(N) / FS_CLAIMED
    # AM carrier at baseband center with slow two-path fading
    fade = 1.0 + 0.15 * np.sin(2 * np.pi * 0.7 * t + 0.3)
    am = 0.28 * fade * (1.0 + program_audio(t))
    z = am.astype(np.complex128)
    # adjacent interferer: a 2-tone SSB-ish signal 4.5 kHz up
    adj = 0.02 * (np.exp(2j * np.pi * 4500.0 * t)
                  * (np.sin(2 * np.pi * 300.0 * t)
                     + 0.6 * np.sin(2 * np.pi * 800.0 * t)))
    z = z + adj
    # band noise ~ -40 dB
    z = z + 0.003 * (rng.normal(size=N) + 1j * rng.normal(size=N))
    z = (z / np.abs(z).max() * 0.35).astype(np.complex64)

    n_frames = -(-N // 512)
    jitter = rng.normal(scale=2e-6, size=n_frames)   # ±2 µs GPS jitter

    from supersdr_jax.io import wav
    wav.write_kiwi_iq_wav(path, z, FS_CLAIMED, frame_len=512,
                          gps_start=1234.0, true_rate=FS_TRUE,
                          gps_jitter_s=jitter)
    print(f"wrote {path}: {N} samples, header {FS_CLAIMED} Hz, "
          f"true {FS_TRUE} Hz, {n_frames} GNSS frames")


if __name__ == "__main__":
    main(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "kiwi_am_offair_12k.wav"))
