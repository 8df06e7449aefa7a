import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import spectrum


def reference_db2col(wf_bytes, zoom, auto=True, low_clip=-120., high_clip=-60.,
                     delta_low=0., delta_high=0.):
    """Reference spectrum_db2col semantics (utils_supersdr.py:787-813)."""
    wf = wf_bytes.astype(np.float32)
    wf = -(255 - wf)
    wf_db = wf - 13 + 3 * zoom
    wf_db[0] = wf_db[1]
    if auto:
        low_clip = np.percentile(wf_db, 40.0)
        high_clip = np.percentile(wf_db, 100.0)
    dyn = max(high_clip - low_clip, 40.0)
    color = (wf_db - (low_clip + delta_low)) / ((dyn + delta_high) - delta_low)
    color = np.clip(color, 0.0, 1.0) * 254
    return np.clip(color, 0, 255)


def test_autolevel_matches_reference_oracle(rng):
    for zoom in (0, 7, 14):
        wf_bytes = rng.integers(100, 240, 1024).astype(np.uint8)
        db = spectrum.kiwi_byte_to_db(jnp.asarray(wf_bytes), zoom)
        res = spectrum.autolevel(db)
        ref = reference_db2col(wf_bytes, zoom)
        np.testing.assert_allclose(np.asarray(res.color), ref, atol=1e-2)


def test_autolevel_fixed_clip(rng):
    wf_bytes = rng.integers(50, 250, 1024).astype(np.uint8)
    db = spectrum.kiwi_byte_to_db(jnp.asarray(wf_bytes), 5)
    res = spectrum.autolevel(db, auto=False, low_clip_db=-110.0,
                             high_clip_db=-50.0, delta_low_db=3.0,
                             delta_high_db=-2.0)
    ref = reference_db2col(wf_bytes, 5, auto=False, low_clip=-110.,
                           high_clip=-50., delta_low=3., delta_high=-2.)
    np.testing.assert_allclose(np.asarray(res.color), ref, atol=1e-2)


def test_min_dynamic_range_enforced(rng):
    # nearly flat spectrum → dynamic range clamps at 40 dB
    wf_bytes = np.full(1024, 180, np.uint8)
    wf_bytes[::50] = 183
    db = spectrum.kiwi_byte_to_db(jnp.asarray(wf_bytes), 0)
    res = spectrum.autolevel(db)
    assert float(res.dyn_range) == 40.0


def test_power_spectrum_tone_bin():
    fs = 12000.0
    nfft = 1024
    n = nfft
    t = np.arange(n) / fs
    f0 = 1500.0
    iq = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
    w = spectrum.spectrum_window(nfft)
    db = np.asarray(spectrum.power_spectrum_db(jnp.asarray(iq), w, cal_db=0.0))
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / fs))
    peak_bin = np.argmax(db)
    assert abs(freqs[peak_bin] - f0) < fs / nfft
    assert abs(db[peak_bin]) < 1.0   # ~0 dBFS for a full-scale tone
    # noise floor well below
    far = np.abs(freqs - f0) > 500
    assert db[far].max() < -60


def test_segment_rows_shapes():
    iq = jnp.arange(4096, dtype=jnp.complex64)
    rows = spectrum.segment_rows(iq, 1024)
    assert rows.shape == (4, 1024)
    rows_hop = spectrum.segment_rows(iq, 1024, hop=512)
    assert rows_hop.shape == (7, 1024)
    np.testing.assert_array_equal(np.asarray(rows_hop)[2, :5],
                                  np.arange(1024, 1029))


def test_time_binned_average_reduces_variance(rng):
    rows = rng.normal(-90, 5, size=(40, 256)).astype(np.float32)
    avg = np.asarray(spectrum.time_binned_average(jnp.asarray(rows), 10))
    assert avg.shape == (4, 256)
    assert avg.std() < rows.std() / 2


def test_scroll_and_scope():
    hist = jnp.zeros((10, 8))
    row = jnp.ones(8)
    h2 = spectrum.scroll(hist, row)
    assert float(h2[0, 0]) == 1.0 and float(h2[1, 0]) == 0.0
    scope = spectrum.spectrum_scope_row(h2, n_rows=5)
    np.testing.assert_allclose(np.asarray(scope), 0.2)
