import numpy as np
import jax
import jax.numpy as jnp
import pytest

from supersdr_jax.runtime import chain, wideband
from supersdr_jax.parallel import sharded_wideband

AGC_OFF = dict(on=False, man_gain_db=50.0)


def tone_snr_db(x, freq, fs):
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t),
                      np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    sig = np.mean((fit - fit.mean()) ** 2)
    return 10 * np.log10(sig / max(np.mean((x - fit) ** 2), 1e-30))


def mw_band(cfg, stations, n, seed=0):
    """Synthesize AM stations at given (channel_index, audio_freq)."""
    rng = np.random.default_rng(seed)
    freqs = wideband.channel_freqs(cfg)
    t = np.arange(n) / cfg.fs_in
    x = 0.002 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for ch, af in stations:
        m = 0.6 * np.cos(2 * np.pi * af * t)
        x = x + 0.4 * (1 + m) * np.exp(2j * np.pi * freqs[ch] * t)
    return x.astype(np.complex64)


def test_wideband_demodulates_many_stations():
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=32768,
                                  mode="AM", taps_per=8)
    assert cfg.iq_rate == 12000
    stations = [(1, 400.0), (3, 700.0), (6, 1100.0)]
    n = cfg.chunk_in * 2
    iq = mw_band(cfg, stations, n)
    params = wideband.make_params(cfg, agc_kwargs=AGC_OFF)
    state = wideband.init_state(cfg)
    audio_parts = []
    for i in range(0, n, cfg.chunk_in):
        state, out = wideband.process(cfg, params, state,
                                      jnp.asarray(iq[i:i + cfg.chunk_in]))
        audio_parts.append(np.asarray(out.audio))
    audio = np.concatenate(audio_parts, axis=-1)
    assert audio.shape == (8, n // 8 * 4)
    skip = audio.shape[1] // 2
    for ch, af in stations:
        snr = tone_snr_db(audio[ch, skip:], af, 48000)
        assert snr > 30, f"channel {ch}: {snr:.1f} dB"
    # empty channel is quiet
    assert np.abs(audio[5, skip:]).max() < 0.1


def test_sharded_wideband_equals_serial():
    n_dev = 8
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8,
                                  chunk_in=8 * 8 * 512, mode="AM",
                                  taps_per=8)
    stations = [(2, 500.0), (7, 900.0)]
    iq = mw_band(cfg, stations, cfg.chunk_in * 2, seed=1)

    params = wideband.make_params(cfg, agc_kwargs=AGC_OFF)
    state = wideband.init_state(cfg)
    mesh = sharded_wideband.make_mesh()
    proc = sharded_wideband.build(cfg, mesh)
    sstate = wideband.init_state(cfg)

    for i in range(0, len(iq), cfg.chunk_in):
        blk = jnp.asarray(iq[i:i + cfg.chunk_in])
        state, out_ref = wideband.process(cfg, params, state, blk)
        sstate, audio_sh, rssi_sh = proc(params, sstate, blk)
        np.testing.assert_allclose(np.asarray(audio_sh),
                                   np.asarray(out_ref.audio),
                                   rtol=2e-3, atol=3e-4)
        np.testing.assert_allclose(np.asarray(rssi_sh),
                                   np.asarray(out_ref.rssi), atol=0.01)


def test_process_many_matches_sequential_calls():
    """process_many (scan of chunks in one program) is sample-exact vs the
    same chunks fed through process() one call at a time."""
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=16384,
                                  mode="AM", taps_per=8)
    stations = [(1, 400.0), (6, 1100.0)]
    n_chunks = 3
    iq = mw_band(cfg, stations, cfg.chunk_in * n_chunks, seed=7)
    params = wideband.make_params(cfg, agc_kwargs=AGC_OFF)

    state = wideband.init_state(cfg)
    seq = []
    for i in range(n_chunks):
        state, out = wideband.process(
            cfg, params, state,
            jnp.asarray(iq[i * cfg.chunk_in:(i + 1) * cfg.chunk_in]))
        seq.append(np.asarray(out.audio))
    seq = np.stack(seq)

    st2, audio = wideband.process_many(
        cfg, params, wideband.init_state(cfg),
        jnp.asarray(iq.reshape(n_chunks, cfg.chunk_in)))
    np.testing.assert_allclose(np.asarray(audio), seq, rtol=0, atol=1e-5)
    # carried state also matches
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                atol=1e-5),
        st2, state)


@pytest.mark.parametrize("profile", ["fast", "quality"])
def test_legacy_channelizer_equals_mxu2(profile):
    """The two XLA channelizer routes, fold-then-FFT ("legacy") and the
    matmul DFT ("mxu2"), give the same audio through the whole pipeline
    at each profile's precision."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 256,
                mode="AM", taps_per=4, n_taps=129,
                **{**wideband.PROFILES[profile],
                   "chan_precision": "highest"})
    rng = np.random.default_rng(7)
    iq = ((rng.normal(size=(2, base["chunk_in"]))
           + 1j * rng.normal(size=(2, base["chunk_in"]))) * 0.05
          ).astype(np.complex64)
    outs = {}
    for impl in ("legacy", "mxu2"):
        cfg = wideband.WidebandConfig(**{**base, "chan_impl": impl})
        _, audio = wideband.process_many(cfg, wideband.make_params(cfg),
                                         wideband.init_state(cfg), iq)
        outs[impl] = np.asarray(audio, np.float32)
    assert _snr(outs["legacy"], outs["mxu2"]) > 90


def _snr(ref, got):
    num = np.linalg.norm(ref)
    den = np.linalg.norm(got - ref)
    return 20 * np.log10(num / max(den, 1e-30))


def test_time_major_fused_equals_chan_major(kernel_tail):
    """Time-major audio (the profiles' layout, written directly by the
    kernel tail) is the transpose of the channel-major audio, state-
    chained over two chunks, RSSI included."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="AM", taps_per=4, n_taps=129)
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major")
    cfg_c = wideband.WidebandConfig(**base, **prof)
    cfg_t = wideband.WidebandConfig(**base, **prof, time_major=True)
    assert chain.kernel_tail_ok(cfg_t.chain_cfg, (512,))
    p = wideband.make_params(cfg_c)
    rng = np.random.default_rng(11)
    iq = ((rng.normal(size=(2, cfg_c.chunk_in))
           + 1j * rng.normal(size=(2, cfg_c.chunk_in))) * 0.05
          ).astype(np.complex64)
    st_c = wideband.init_state(cfg_c)
    st_t = wideband.init_state(cfg_t)
    for k in range(2):
        st_c, out_c = wideband.process(cfg_c, p, st_c, iq[k])
        st_t, out_t = wideband.process(cfg_t, p, st_t, iq[k])
        np.testing.assert_array_equal(np.asarray(out_t.audio).T,
                                      np.asarray(out_c.audio))
        np.testing.assert_array_equal(np.asarray(out_t.rssi),
                                      np.asarray(out_c.rssi))


def test_time_major_fallback_keeps_contract(kernel_tail):
    """Configs the kernel tail can't serve (here 520 frames per chunk, not
    whole kernel tiles) take the XLA tail but keep the time-major output
    contract."""
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major", None)
    cfg = wideband.WidebandConfig(fs_in=192_000, n_chan=16,
                                  chunk_in=16 * 520, mode="AM",
                                  taps_per=4, n_taps=129, **prof,
                                  time_major=True)
    assert not chain.kernel_tail_ok(cfg.chain_cfg, (16,))
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(5)
    iq = ((rng.normal(size=cfg.chunk_in)
           + 1j * rng.normal(size=cfg.chunk_in)) * 0.05
          ).astype(np.complex64)
    _, out = wideband.process(cfg, p, wideband.init_state(cfg), iq)
    assert np.asarray(out.audio).shape == (520 * 4, 16)


def test_audio_dtype_f16_quantizes_only():
    """audio_dtype='f16' returns float16 audio within the f16
    quantization floor of the f32 path."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="AM", taps_per=4, n_taps=129)
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major", None)
    prof.pop("audio_dtype", None)
    cfg32 = wideband.WidebandConfig(**base, **prof, time_major=True)
    cfg16 = wideband.WidebandConfig(**base, **prof, time_major=True,
                                    audio_dtype="f16")
    p = wideband.make_params(cfg32)
    rng = np.random.default_rng(13)
    iq = ((rng.normal(size=cfg32.chunk_in)
           + 1j * rng.normal(size=cfg32.chunk_in)) * 0.05
          ).astype(np.complex64)
    _, out32 = wideband.process(cfg32, p, wideband.init_state(cfg32), iq)
    _, out16 = wideband.process(cfg16, p, wideband.init_state(cfg16), iq)
    a32 = np.asarray(out32.audio, np.float64)
    a16 = np.asarray(out16.audio, np.float64)
    assert np.asarray(out16.audio).dtype == np.float16
    num = np.linalg.norm(a32)
    den = np.linalg.norm(a16 - a32)
    snr = 20 * np.log10(num / max(den, 1e-30))
    assert snr > 60, f"f16 audio SNR {snr:.1f} dB"


def test_time_major_ssb_matches_plain(kernel_tail):
    """USB through the time-major kernel tail matches the plain-path
    implementation at the quality precision tier — the serial form of
    the bench's MID-SSB gate."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="USB", taps_per=4, n_taps=129)
    prof = dict(wideband.PROFILES["quality"])
    cfg_t = wideband.WidebandConfig(**base, **prof)
    cfg_p = wideband.WidebandConfig(**base)      # plain f32 FFT path
    assert chain.kernel_tail_ok(cfg_t.chain_cfg, (512,))
    p_t = wideband.make_params(cfg_t)
    p_p = wideband.make_params(cfg_p)
    rng = np.random.default_rng(21)
    iq = ((rng.normal(size=cfg_t.chunk_in)
           + 1j * rng.normal(size=cfg_t.chunk_in)) * 0.05
          ).astype(np.complex64)
    _, out_t = wideband.process(cfg_t, p_t, wideband.init_state(cfg_t), iq)
    _, out_p = wideband.process(cfg_p, p_p, wideband.init_state(cfg_p), iq)
    a_t = np.asarray(out_t.audio).T
    a_p = np.asarray(out_p.audio)
    assert _snr(a_p, a_t) > 50, _snr(a_p, a_t)


def test_layout_switch_mid_stream():
    """The SAME WidebandState threads across a time-major chunk followed
    by a chan-major chunk (and vice versa): state packing is layout-
    independent, so an impl switch mid-stream stays sample-continuous."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="AM", taps_per=4, n_taps=129)
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major", None)
    prof.update(passband_precision="high", chan_precision="high")
    cfg_c = wideband.WidebandConfig(**base, **prof)
    cfg_t = wideband.WidebandConfig(**base, **prof, time_major=True)
    p = wideband.make_params(cfg_c)
    rng = np.random.default_rng(23)
    iq = ((rng.normal(size=(2, cfg_c.chunk_in))
           + 1j * rng.normal(size=(2, cfg_c.chunk_in))) * 0.05
          ).astype(np.complex64)
    # reference: two chan-major chunks
    st = wideband.init_state(cfg_c)
    st, _ = wideband.process(cfg_c, p, st, iq[0])
    _, out_ref = wideband.process(cfg_c, p, st, iq[1])
    # switched: time-major chunk 0, chan-major chunk 1
    st = wideband.init_state(cfg_t)
    st, _ = wideband.process(cfg_t, p, st, iq[0])
    _, out_sw = wideband.process(cfg_c, p, st, iq[1])
    a_ref = np.asarray(out_ref.audio)
    a_sw = np.asarray(out_sw.audio)
    assert _snr(a_ref, a_sw) > 70, _snr(a_ref, a_sw)


def test_channel_map_is_row_aligned():
    """A carrier at channel_freqs(cfg)[i] must demodulate into audio ROW
    i at the fast profile — the channel map the CLI and sinks use is
    row-aligned."""
    prof = dict(wideband.PROFILES["fast"])
    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=512 * 512, mode="AM",
                                  taps_per=4, n_taps=129, **prof)
    freqs = wideband.channel_freqs(cfg)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(31)
    rows = [7, 300]
    t = np.arange(cfg.chunk_in) / cfg.fs_in
    z = 0.02 * (rng.normal(size=cfg.chunk_in)
                + 1j * rng.normal(size=cfg.chunk_in))
    for r in rows:
        z = z + 0.5 * (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) \
            * np.exp(2j * np.pi * freqs[r] * t)
    st = wideband.init_state(cfg)
    st, out = wideband.process(cfg, p, st, z.astype(np.complex64))
    st, out = wideband.process(cfg, p, st, z.astype(np.complex64))
    rssi = np.asarray(out.rssi)[:, -1]
    top = set(np.argsort(rssi)[::-1][:2])
    assert top == set(rows), (sorted(top), rows)


def test_i16_ingest_matches_dequantized_f32():
    """process_i16 (dequantize fused into the channelizer's first pass)
    equals the f32 pipeline fed the dequantized planes."""
    rng = np.random.default_rng(41)
    for n_chan, chunk in ((512, 512 * 512), (16, 16 * 512)):
        cfg = wideband.WidebandConfig(fs_in=n_chan * 12_000,
                                      n_chan=n_chan, chunk_in=chunk,
                                      mode="AM", taps_per=4, n_taps=129,
                                      **wideband.PROFILES["fast"])
        p = wideband.make_params(cfg)
        re16 = (rng.normal(size=chunk) * 1600).astype(np.int16)
        im16 = (rng.normal(size=chunk) * 1600).astype(np.int16)
        st_a = wideband.init_state(cfg)
        st_b = wideband.init_state(cfg)
        from supersdr_jax.ops import cx as cxm
        deq = cxm.CX(jnp.asarray(re16, jnp.float32) / 32768.0,
                     jnp.asarray(im16, jnp.float32) / 32768.0)
        for _ in range(2):
            st_a, out_a = wideband.process_i16(cfg, p, st_a, (re16, im16))
            st_b, out_b = wideband.process(cfg, p, st_b, deq)
            a = np.asarray(out_a.audio, np.float32)
            b = np.asarray(out_b.audio, np.float32)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_time_major_short_filter_matches_chan_major():
    """A short passband filter (33 taps) in the time-major layout matches
    the chan-major pipeline."""
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="AM", taps_per=4, n_taps=33)
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major", None)
    prof.update(passband_precision="high", chan_precision="high")
    cfg_t = wideband.WidebandConfig(**base, **prof, time_major=True)
    cfg_c = wideband.WidebandConfig(**base, **prof)
    p = wideband.make_params(cfg_t)
    rng = np.random.default_rng(51)
    iq = ((rng.normal(size=cfg_t.chunk_in)
           + 1j * rng.normal(size=cfg_t.chunk_in)) * 0.05
          ).astype(np.complex64)
    _, out_t = wideband.process(cfg_t, p, wideband.init_state(cfg_t), iq)
    _, out_c = wideband.process(cfg_c, p, wideband.init_state(cfg_c), iq)
    a_t = np.asarray(out_t.audio).T
    a_c = np.asarray(out_c.audio)
    assert _snr(a_c, a_t) > 75, _snr(a_c, a_t)


def test_process_n_matches_serial_calls():
    """process_n (tuple-output multi-chunk, the bench N_SCAN=2 form)
    equals N serial process calls sample-exactly, for CX and i16
    chunks."""
    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=512 * 512, mode="AM",
                                  taps_per=4, n_taps=129,
                                  **wideband.PROFILES["fast"])
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(61)
    iq = ((rng.normal(size=(2, cfg.chunk_in))
           + 1j * rng.normal(size=(2, cfg.chunk_in))) * 0.05
          ).astype(np.complex64)
    st, outs = wideband.process_n(cfg, p, wideband.init_state(cfg),
                                  [iq[0], iq[1]])
    st2 = wideband.init_state(cfg)
    st2, o1 = wideband.process(cfg, p, st2, iq[0])
    st2, o2 = wideband.process(cfg, p, st2, iq[1])
    np.testing.assert_array_equal(np.asarray(outs[0]),
                                  np.asarray(o1.audio))
    np.testing.assert_array_equal(np.asarray(outs[1]),
                                  np.asarray(o2.audio))

    # i16 chunks through the same entry
    r16 = (rng.normal(size=(2, cfg.chunk_in)) * 1600).astype(np.int16)
    i16 = (rng.normal(size=(2, cfg.chunk_in)) * 1600).astype(np.int16)
    stn, outsn = wideband.process_n(
        cfg, p, wideband.init_state(cfg),
        [(r16[0], i16[0]), (r16[1], i16[1])])
    sts = wideband.init_state(cfg)
    sts, s1 = wideband.process_i16(cfg, p, sts, (r16[0], i16[0]))
    sts, s2 = wideband.process_i16(cfg, p, sts, (r16[1], i16[1]))
    np.testing.assert_array_equal(np.asarray(outsn[0]),
                                  np.asarray(s1.audio))
    np.testing.assert_array_equal(np.asarray(outsn[1]),
                                  np.asarray(s2.audio))


def test_i16_pair_dtype_guard():
    """A plain (re, im) float tuple must raise instead of being silently
    quantized to int16 (ADVICE r4); int16 pairs still pass."""
    import jax.numpy as jnp
    import pytest
    from supersdr_jax.runtime import wideband

    re = np.zeros(64, np.float32)
    with pytest.raises(TypeError, match="int16"):
        wideband._is_i16_pair((re, re))
    assert wideband._is_i16_pair((re.astype(np.int16),
                                  re.astype(np.int16)))
    assert not wideband._is_i16_pair(jnp.zeros(4))
