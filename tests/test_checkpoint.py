"""Stream-state checkpoint/resume: kill mid-capture, reload, continue
sample-exactly."""

import numpy as np
import jax.numpy as jnp

from supersdr_jax.runtime import chain, checkpoint, wideband


def test_chain_resume_sample_exact(tmp_path):
    fs = 12000
    n = 16384
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)
    iq = (np.exp(2j * np.pi * 1000 * t)
          + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
          ).astype(np.complex64)
    cfg = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    params = chain.make_params(cfg)

    # continuous run
    st = chain.init_state(cfg)
    audio_ref = []
    for i in range(0, n, 4096):
        st, out = chain.process(cfg, params, st, jnp.asarray(iq[i:i + 4096]))
        audio_ref.append(np.asarray(out.audio))

    # checkpoint after 2 chunks, reload into a fresh template, continue
    st = chain.init_state(cfg)
    audio_a = []
    for i in range(0, 8192, 4096):
        st, out = chain.process(cfg, params, st, jnp.asarray(iq[i:i + 4096]))
        audio_a.append(np.asarray(out.audio))
    ckpt = tmp_path / "state.npz"
    checkpoint.save_state(ckpt, st, meta={"sample_pos": 8192})
    assert checkpoint.checkpoint_meta(ckpt)["sample_pos"] == 8192

    st2 = checkpoint.load_state(ckpt, chain.init_state(cfg))
    audio_b = []
    for i in range(8192, n, 4096):
        st2, out = chain.process(cfg, params, st2, jnp.asarray(iq[i:i + 4096]))
        audio_b.append(np.asarray(out.audio))

    got = np.concatenate(audio_a + audio_b)
    ref = np.concatenate(audio_ref)
    np.testing.assert_array_equal(got, ref)


def test_wideband_state_roundtrip(tmp_path):
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=16384,
                                  mode="AM")
    st = wideband.init_state(cfg)
    p = tmp_path / "wb.npz"
    checkpoint.save_state(p, st)
    st2 = checkpoint.load_state(p, wideband.init_state(cfg))
    for a, b in zip(__import__("jax").tree.leaves(st),
                    __import__("jax").tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shape_mismatch_rejected(tmp_path):
    cfg_a = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096)
    cfg_b = chain.ChainConfig(mode="USB", chunk=4096, os_block=4096,
                              n_taps=129)
    p = tmp_path / "s.npz"
    checkpoint.save_state(p, chain.init_state(cfg_a))
    import pytest
    with pytest.raises(ValueError):
        checkpoint.load_state(p, chain.init_state(cfg_b))
