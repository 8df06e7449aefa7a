import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import scans


def ref_linear(a, b, y0):
    y = np.empty_like(b)
    prev = y0
    for i in range(len(b)):
        prev = a[i] * prev + b[i]
        y[i] = prev
    return y


def ref_maxplus(a, b, y0):
    y = np.empty_like(b)
    prev = y0
    for i in range(len(b)):
        prev = max(prev + a[i], b[i])
        y[i] = prev
    return y


def test_linear_scan_matches_sequential(rng):
    a = rng.uniform(0.5, 0.999, 257).astype(np.float32)
    b = rng.normal(size=257).astype(np.float32)
    y = scans.linear_scan(jnp.asarray(a), jnp.asarray(b), 0.7)
    np.testing.assert_allclose(np.asarray(y), ref_linear(a, b, 0.7),
                               rtol=1e-5, atol=1e-5)


def test_linear_scan_batched(rng):
    a = rng.uniform(0.5, 0.999, (3, 64)).astype(np.float32)
    b = rng.normal(size=(3, 64)).astype(np.float32)
    y0 = np.array([0.1, -0.5, 2.0], np.float32)
    y = scans.linear_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0))
    for i in range(3):
        np.testing.assert_allclose(np.asarray(y)[i],
                                   ref_linear(a[i], b[i], y0[i]),
                                   rtol=1e-5, atol=1e-5)


def test_maxplus_scan_matches_sequential(rng):
    a = np.full(100, -0.01, np.float32)
    b = rng.normal(size=100).astype(np.float32) * 30 - 60
    y = scans.maxplus_scan(jnp.asarray(a), jnp.asarray(b), -120.0)
    np.testing.assert_allclose(np.asarray(y), ref_maxplus(a, b, -120.0),
                               rtol=1e-5, atol=1e-4)


def test_one_pole(rng):
    x = rng.normal(size=50).astype(np.float32)
    c = 0.9
    y = scans.one_pole(jnp.asarray(x), c, 0.0)
    ref = ref_linear(np.full(50, c, np.float32), (1 - c) * x, 0.0)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-5)


def test_dc_block_removes_dc(rng):
    x = (rng.normal(size=4096) + 5.0).astype(np.float32)
    y, (lx, ly) = scans.dc_block(jnp.asarray(x), 0.995, 0.0, 0.0)
    assert abs(float(np.mean(np.asarray(y)[2000:]))) < 0.05
    assert float(lx) == x[-1]


def test_dc_block_streaming_equals_batch(rng):
    x = rng.normal(size=512).astype(np.float32)
    y_full, _ = scans.dc_block(jnp.asarray(x), 0.99, 0.0, 0.0)
    y1, (lx, ly) = scans.dc_block(jnp.asarray(x[:256]), 0.99, 0.0, 0.0)
    y2, _ = scans.dc_block(jnp.asarray(x[256:]), 0.99, lx, ly)
    np.testing.assert_allclose(np.concatenate([y1, y2]), np.asarray(y_full),
                               rtol=1e-4, atol=1e-5)


def test_sliding_max_matches_naive(rng):
    x = rng.normal(size=200).astype(np.float32)
    for w in (1, 2, 3, 7, 16, 50):
        y = np.asarray(scans.sliding_max(jnp.asarray(x), w))
        ref = np.array([x[max(0, i - w + 1): i + 1].max()
                        for i in range(len(x))])
        np.testing.assert_allclose(y, ref, rtol=1e-6)


def test_linear_scan_const_matches_general(rng):
    import jax.numpy as jnp
    from supersdr_jax.ops import scans
    b = rng.normal(size=(3, 1024)).astype(np.float32)
    for a in (0.999, 0.9, 0.5):
        ref = scans.linear_scan(np.full_like(b, a), b, 0.25)
        got = scans.linear_scan_const(jnp.float32(a), jnp.asarray(b), 0.25)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)
    # non-multiple length falls back
    b2 = rng.normal(size=(2, 1000)).astype(np.float32)
    ref = scans.linear_scan(np.full_like(b2, 0.99), b2, 0.0)
    got = scans.linear_scan_const(jnp.float32(0.99), jnp.asarray(b2), 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_maxplus_scan_const_matches_general(rng):
    import jax.numpy as jnp
    from supersdr_jax.ops import scans
    b = (20 * rng.normal(size=(2, 2048)) - 60).astype(np.float32)
    for d in (0.00125, 0.0125, 0.2):
        a = np.full_like(b, -d)
        ref = scans.maxplus_scan(a, b, -120.0)
        got = scans.maxplus_scan_const(jnp.float32(-d), jnp.asarray(b),
                                       -120.0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=2e-3)
