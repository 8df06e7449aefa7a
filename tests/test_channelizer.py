import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import channelizer


def direct_channelize(proto, M, hop, x, m):
    """Direct (slow) evaluation of one channel: downconvert, filter,
    decimate — the definition the PFB must match."""
    n = len(x)
    down = x * np.exp(-2j * np.pi * m * np.arange(n) / M)
    filt = np.convolve(np.concatenate([np.zeros(len(proto) - 1), down]),
                       proto, mode="valid")
    s = np.arange(hop - 1, n, hop)
    return filt[s]


def test_pfb_matches_direct_evaluation(rng):
    M, K = 16, 6
    plan, proto = channelizer.design(M, K)
    W = channelizer.taps_matrix(plan, proto)
    n = M * 32
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    carry = channelizer.init_carry(plan)
    carry, ch = channelizer.channelize(plan, W, carry, jnp.asarray(x))
    ch = np.asarray(ch)
    assert ch.shape == (M, n // M)
    for m in (0, 1, 5, 8, 15):
        ref = direct_channelize(proto, M, plan.hop, x, m)
        np.testing.assert_allclose(ch[m], ref, atol=2e-4)


def test_pfb_streaming_continuity(rng):
    M, K = 8, 4
    plan, proto = channelizer.design(M, K)
    W = channelizer.taps_matrix(plan, proto)
    n = M * 64
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    carry = channelizer.init_carry(plan)
    _, full = channelizer.channelize(plan, W, carry, jnp.asarray(x))
    carry = channelizer.init_carry(plan)
    carry, p1 = channelizer.channelize(plan, W, carry, jnp.asarray(x[:n // 2]))
    _, p2 = channelizer.channelize(plan, W, carry, jnp.asarray(x[n // 2:]))
    got = np.concatenate([np.asarray(p1), np.asarray(p2)], axis=-1)
    np.testing.assert_allclose(got, np.asarray(full), atol=1e-5)


def test_pfb_tone_lands_in_right_channel(rng):
    M, K = 64, 8
    fs = 1_200_000.0
    plan, proto = channelizer.design(M, K)
    W = channelizer.taps_matrix(plan, proto)
    freqs = channelizer.channel_center_freqs(plan, fs)
    n = M * 128
    t = np.arange(n) / fs
    target = 10  # channel index
    x = np.exp(2j * np.pi * freqs[target] * t).astype(np.complex64)
    carry = channelizer.init_carry(plan)
    _, ch = channelizer.channelize(plan, W, carry, jnp.asarray(x))
    ch = np.asarray(ch)[:, 2 * K:]  # skip the filter startup transient
    power = np.mean(np.abs(ch) ** 2, axis=-1)
    assert power.argmax() == target
    # on-center tone decimates to DC with ~unity gain
    assert abs(np.abs(ch[target]).mean() - 1.0) < 0.05
    # steady-state adjacent-channel rejection (prototype stopband ~-75 dB)
    others = np.delete(power, target)
    assert 10 * np.log10(power[target] / others.max()) > 70


def test_pfb_oversampled(rng):
    M, K = 16, 6
    plan, proto = channelizer.design(M, K, osr=2)
    assert plan.hop == M // 2
    W = channelizer.taps_matrix(plan, proto)
    n = M * 32
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    carry = channelizer.init_carry(plan)
    carry, ch = channelizer.channelize(plan, W, carry, jnp.asarray(x))
    assert np.asarray(ch).shape == (M, n // plan.hop)
    for m in (0, 3, 9):
        ref = direct_channelize(proto, M, plan.hop, x, m)
        np.testing.assert_allclose(np.asarray(ch)[m], ref, atol=2e-4)


def test_pfb_batched(rng):
    M, K = 8, 4
    plan, proto = channelizer.design(M, K)
    W = channelizer.taps_matrix(plan, proto)
    x = (rng.normal(size=(3, M * 16)) + 1j * rng.normal(size=(3, M * 16))
         ).astype(np.complex64)
    carry = channelizer.init_carry(plan, (3,))
    carry, ch = channelizer.channelize(plan, W, carry, jnp.asarray(x))
    assert np.asarray(ch).shape == (3, M, 16)
    c0 = channelizer.init_carry(plan)
    _, ch0 = channelizer.channelize(plan, W, c0, jnp.asarray(x[0]))
    np.testing.assert_allclose(np.asarray(ch)[0], np.asarray(ch0), atol=1e-6)


def test_mxu2_matches_legacy_all_sizes(rng):
    """The lane-layout DIF channelizer (mxu2) is numerically equivalent
    to channelize_c across direct (M ≤ 256) and two-stage factorings,
    fold impls, and the f16 fold dtype (within its ~74 dB floor)."""
    import jax
    import jax.numpy as jnp
    from supersdr_jax.ops import channelizer as ch

    for M, K, nf in [(16, 8, 64), (256, 4, 16), (640, 8, 8), (2560, 8, 4)]:
        plan, proto = ch.design(M, K)
        W = ch.taps_matrix(plan, proto)
        carry = jnp.zeros(plan.history, jnp.complex64)
        x = jnp.asarray((rng.normal(size=M * nf)
                         + 1j * rng.normal(size=M * nf)).astype(np.complex64))
        _, ref = ch.channelize_c(plan, W, carry, x)
        for fold, fd, tol in [("slices", jnp.float32, 1e-5),
                              ("conv", jnp.float32, 1e-5),
                              ("slices", jnp.float16, 1e-3)]:
            _, got = jax.jit(lambda c, xx: ch.channelize_mxu2_c(
                plan, W, c, xx, fold_impl=fold, fold_dtype=fd))(carry, x)
            err = float(np.linalg.norm(np.asarray(got) - np.asarray(ref))
                        / np.linalg.norm(np.asarray(ref)))
            assert err < tol, (M, fold, str(fd), err)


def test_mxu2_streaming_continuity(rng):
    """Two consecutive mxu2 chunks equal one big chunk (carry exact)."""
    import jax
    import jax.numpy as jnp
    from supersdr_jax.ops import channelizer as ch

    M, K = 640, 8
    plan, proto = ch.design(M, K)
    W = ch.taps_matrix(plan, proto)
    x = jnp.asarray((rng.normal(size=M * 16)
                     + 1j * rng.normal(size=M * 16)).astype(np.complex64))
    c0 = jnp.zeros(plan.history, jnp.complex64)
    f = jax.jit(lambda c, xx: ch.channelize_mxu2_c(plan, W, c, xx))
    _, yfull = f(c0, x)
    ca, ya = f(c0, x[: M * 8])
    _, yb = f(ca, x[M * 8:])
    y2 = np.concatenate([np.asarray(ya), np.asarray(yb)], axis=-1)
    assert np.abs(y2 - np.asarray(yfull)).max() < 1e-5
