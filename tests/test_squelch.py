import numpy as np
import jax.numpy as jnp

from supersdr_jax.ops import squelch
from supersdr_jax.runtime import chain


def test_squelch_gates_weak_signal():
    p = squelch.make_squelch(enabled=True, thresh_db=-60, ramp_samples=10)
    st = squelch.init_squelch()
    audio = jnp.ones(1000, jnp.float32)
    # strong: stays open
    st, out = squelch.apply_squelch(p, st, audio, jnp.asarray(-40.0))
    assert float(np.abs(np.asarray(out)).mean()) > 0.9
    # weak: closes (ramping down)
    st, out = squelch.apply_squelch(p, st, audio, jnp.asarray(-90.0))
    assert float(np.asarray(out)[-1]) == 0.0
    assert float(st.open_) == 0.0
    # hysteresis: -63 (between close=-66 and open=-60) keeps it closed
    st, out = squelch.apply_squelch(p, st, audio, jnp.asarray(-63.0))
    assert float(st.open_) == 0.0
    # strong again: reopens with ramp
    st, out = squelch.apply_squelch(p, st, audio, jnp.asarray(-50.0))
    o = np.asarray(out)
    assert o[-1] == 1.0 and o[0] < 1.0


def test_squelch_disabled_passthrough(rng):
    p = squelch.make_squelch(enabled=False)
    st = squelch.init_squelch()
    audio = jnp.asarray(rng.normal(size=512).astype(np.float32))
    st, out = squelch.apply_squelch(p, st, audio, jnp.asarray(-120.0))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(audio))


def test_blanker_removes_impulse(rng):
    fs = 12000
    t = np.arange(4096) / fs
    clean = 0.2 * np.exp(2j * np.pi * 1000 * t)
    iq = clean.copy()
    iq[1000] += 50.0       # impulse
    iq[2500] -= 40.0j
    p = squelch.make_blanker(enabled=True, thresh_ratio=6.0)
    out = np.asarray(squelch.apply_blanker(p, jnp.asarray(iq, jnp.complex64)))
    assert np.abs(out[1000]) < 1.0
    assert np.abs(out[2500]) < 1.0
    # clean samples survive
    untouched = np.abs(out[100:900] - clean[100:900].astype(np.complex64))
    assert untouched.max() < 1e-6


def test_blanker_disabled_passthrough(rng):
    iq = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    p = squelch.make_blanker(enabled=False)
    out = np.asarray(squelch.apply_blanker(p, jnp.asarray(iq)))
    np.testing.assert_array_equal(out, iq)


def test_chain_with_squelch_and_blanker():
    fs = 12000
    n = 16384
    t = np.arange(n) / fs
    iq = (0.001 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)  # weak
    iq[5000] += 30.0  # impulse
    cfg = chain.ChainConfig(mode="USB", chunk=8192, os_block=8192,
                            blanker_enabled=True, squelch_enabled=True)
    params = chain.make_params(
        cfg, agc_kwargs=dict(on=False),
        squelch_kwargs=dict(enabled=True, thresh_db=-40.0),
        blanker_kwargs=dict(enabled=True))
    _, audio, rssi = chain.run_offline(cfg, params, iq)
    # weak signal below squelch threshold: audio gated to silence
    assert np.abs(audio[8192:]).max() < 1e-4
