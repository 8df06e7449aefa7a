import numpy as np

from supersdr_jax.io.gnss import GnssTimekeeper


def feed_frames(tk, true_rate, n_frames, frame=512, start=1000.0):
    ts = []
    gps = start
    for _ in range(n_frames):
        sec = int(gps)
        nsec = int((gps - sec) * 1e9)
        t = tk.update(sec, nsec, frame)
        ts.append(t)
        gps += frame / true_rate
    return ts


def test_rate_estimation_converges():
    tk = GnssTimekeeper(nominal_rate=12000)
    feed_frames(tk, 12010.0, 50)
    assert abs(tk.rate - 12010.0) < 0.5
    assert abs(tk.drift_ppm - 833.0) < 50


def test_timestamps_continuous():
    tk = GnssTimekeeper(nominal_rate=12000)
    ts = feed_frames(tk, 12000.0, 10)
    assert ts[0] is None and ts[1] is None
    assert ts[2] is not None
    t_all = np.concatenate([t for t in ts if t is not None])
    dt = np.diff(t_all)
    np.testing.assert_allclose(dt, 1 / 12000.0, rtol=1e-3)


def test_gps_week_wrap():
    tk = GnssTimekeeper(nominal_rate=12000)
    week = 7 * 24 * 3600
    # two frames just before the wrap, then wrapped values near 0
    tk.update(week - 1, 0, 512)
    tk.update(week - 1, int(512 / 12000 * 1e9), 512)
    t = tk.update(0, int((2 * 512 / 12000 - 1) * 1e9 % 1e9), 512)
    assert tk.rate > 0
    assert t is not None
    assert t[0] > week - 2  # time keeps increasing across the wrap
