"""Multi-chip correctness without a pod (SURVEY.md §4): the mesh-sharded
chain must equal the single-device chain sample-exactly on a virtual
8-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from supersdr_jax.parallel import mesh as mesh_mod
from supersdr_jax.parallel import sharded_chain
from supersdr_jax.runtime import chain, wideband

AGC_ON = dict(on=True, thresh_db=-80, decay_ms=1000)


def make_iq(n, n_chan=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 12000
    out = []
    for c in range(n_chan):
        tone = np.exp(2j * np.pi * (800 + 400 * c) * t)
        noise = 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        out.append(tone + noise)
    return np.stack(out).astype(np.complex64)


@pytest.mark.parametrize("mode", ["USB", "AM", "NBFM", "CW"])
def test_time_sharded_equals_serial(mode):
    n_dev = 8
    local = 2048
    n = local * n_dev
    iq = make_iq(n, n_chan=1)

    # single-device reference
    cfg_ref = chain.ChainConfig(mode=mode, chunk=n, os_block=local)
    p_ref = chain.make_params(cfg_ref, freq_offset_hz=np.zeros(1),
                              agc_kwargs=AGC_ON)
    s_ref = chain.init_state(cfg_ref, (1,))
    _, out_ref = chain.process(cfg_ref, p_ref, s_ref, jnp.asarray(iq))

    # 8-way time-sharded
    m = mesh_mod.time_mesh()
    cfg_sh = chain.ChainConfig(mode=mode, chunk=local, os_block=local)
    proc = sharded_chain.build(cfg_sh, m)
    p_sh = sharded_chain.make_params(cfg_sh, n_chan=1, agc_kwargs=AGC_ON)
    s_sh = sharded_chain.init_state(cfg_sh, 1)
    _, out_sh = proc(p_sh, s_sh, jnp.asarray(iq))

    np.testing.assert_allclose(np.asarray(out_sh.audio),
                               np.asarray(out_ref.audio),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out_sh.rssi),
                               np.asarray(out_ref.rssi), atol=0.01)


def test_chan_time_grid_sharded():
    n_dev_chan, n_dev_time = 2, 4
    local = 2048
    n = local * n_dev_time
    n_chan = 4
    iq = make_iq(n, n_chan=n_chan)
    offsets = np.array([0.0, 200.0, -150.0, 500.0])

    cfg_ref = chain.ChainConfig(mode="USB", chunk=n, os_block=local)
    p_ref = chain.make_params(cfg_ref, freq_offset_hz=offsets,
                              agc_kwargs=AGC_ON)
    s_ref = chain.init_state(cfg_ref, (n_chan,))
    _, out_ref = chain.process(cfg_ref, p_ref, s_ref, jnp.asarray(iq))

    m = mesh_mod.make_mesh(n_chan=n_dev_chan, n_time=n_dev_time)
    cfg_sh = chain.ChainConfig(mode="USB", chunk=local, os_block=local)
    proc = sharded_chain.build(cfg_sh, m)
    p_sh = sharded_chain.make_params(cfg_sh, n_chan=n_chan,
                                     freq_offsets_hz=offsets,
                                     agc_kwargs=AGC_ON)
    s_sh = sharded_chain.init_state(cfg_sh, n_chan)
    _, out_sh = proc(p_sh, s_sh, jnp.asarray(iq))

    np.testing.assert_allclose(np.asarray(out_sh.audio),
                               np.asarray(out_ref.audio),
                               rtol=2e-3, atol=2e-4)


def test_streaming_state_chains_across_calls():
    """Two consecutive sharded chunks == one long serial run."""
    n_dev = 8
    local = 1024
    n_chunk = local * n_dev
    iq = make_iq(2 * n_chunk, n_chan=1, seed=3)

    cfg_ref = chain.ChainConfig(mode="AM", chunk=2 * n_chunk, os_block=local)
    p_ref = chain.make_params(cfg_ref, freq_offset_hz=np.zeros(1),
                              agc_kwargs=AGC_ON)
    s_ref = chain.init_state(cfg_ref, (1,))
    _, out_ref = chain.process(cfg_ref, p_ref, s_ref, jnp.asarray(iq))

    m = mesh_mod.time_mesh()
    cfg_sh = chain.ChainConfig(mode="AM", chunk=local, os_block=local)
    proc = sharded_chain.build(cfg_sh, m)
    p_sh = sharded_chain.make_params(cfg_sh, n_chan=1, agc_kwargs=AGC_ON)
    state = sharded_chain.init_state(cfg_sh, 1)
    state, out1 = proc(p_sh, state, jnp.asarray(iq[:, :n_chunk]))
    state, out2 = proc(p_sh, state, jnp.asarray(iq[:, n_chunk:]))
    audio = np.concatenate([np.asarray(out1.audio), np.asarray(out2.audio)],
                           axis=-1)
    # scan re-association across chunk boundaries shifts float32 rounding
    np.testing.assert_allclose(audio, np.asarray(out_ref.audio),
                               rtol=2e-3, atol=1e-3)


def test_sharded_scan_primitives():
    """Direct check of the cross-shard scan machinery on an 8-device mesh."""
    from jax.sharding import PartitionSpec as P
    from supersdr_jax.ops import scans

    devs = jax.devices()
    m = jax.sharding.Mesh(np.asarray(devs), ("t",))
    rng = np.random.default_rng(0)
    n = 8 * 64
    a = rng.uniform(0.8, 0.999, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)

    ref = scans.linear_scan(jnp.asarray(a), jnp.asarray(b), 0.5)

    def body(al, bl):
        return scans.linear_scan(al, bl, 0.5, axis_name="t")

    got = jax.jit(jax.shard_map(body, mesh=m, in_specs=(P("t"), P("t")),
                                out_specs=P("t"), check_vma=False))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)

    ref2 = scans.maxplus_scan(jnp.asarray(-np.abs(a)), jnp.asarray(b), -50.0)

    def body2(al, bl):
        return scans.maxplus_scan(al, bl, -50.0, axis_name="t")

    got2 = jax.jit(jax.shard_map(body2, mesh=m, in_specs=(P("t"), P("t")),
                                 out_specs=P("t"), check_vma=False))(
        jnp.asarray(-np.abs(a)), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref2),
                               rtol=1e-4, atol=1e-4)

    # sliding max across shard boundaries
    x = rng.normal(size=n).astype(np.float32)
    ref3 = scans.sliding_max(jnp.asarray(x), 48)

    def body3(xl):
        return scans.sliding_max(xl, 48, axis_name="t")

    got3 = jax.jit(jax.shard_map(body3, mesh=m, in_specs=P("t"),
                                 out_specs=P("t"), check_vma=False))(
        jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got3), np.asarray(ref3))


def test_time_sharded_rational_rate_equals_serial():
    """20250→48000 rational resampling under time sharding: the stuffed-
    domain halo reconstruction must match the serial carry exactly."""
    n_dev = 8
    local = 2025  # multiple of M=27
    n = local * n_dev
    rng = np.random.default_rng(5)
    t = np.arange(n) / 20250
    iq = (np.exp(2j * np.pi * 900 * t)
          + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
          )[None].astype(np.complex64)

    cfg_ref = chain.ChainConfig(mode="USB", iq_rate=20250, audio_rate=48000,
                                chunk=n, os_block=local)
    p_ref = chain.make_params(cfg_ref, freq_offset_hz=np.zeros(1),
                              agc_kwargs=AGC_ON)
    s_ref = chain.init_state(cfg_ref, (1,))
    _, out_ref = chain.process(cfg_ref, p_ref, s_ref, jnp.asarray(iq))

    m = mesh_mod.time_mesh()
    cfg_sh = chain.ChainConfig(mode="USB", iq_rate=20250, audio_rate=48000,
                               chunk=local, os_block=local)
    proc = sharded_chain.build(cfg_sh, m)
    p_sh = sharded_chain.make_params(cfg_sh, n_chan=1, agc_kwargs=AGC_ON)
    s_sh = sharded_chain.init_state(cfg_sh, 1)
    _, out_sh = proc(p_sh, s_sh, jnp.asarray(iq))

    np.testing.assert_allclose(np.asarray(out_sh.audio),
                               np.asarray(out_ref.audio),
                               rtol=2e-3, atol=2e-4)


def test_sharded_wideband_fast_profile_matches_serial():
    """The mesh honors the shipped fast-profile channelizer tuning
    (mxu2 DIF + f16 fold + matmul passband/resampler): the 8-device
    sharded wideband equals the serial pipeline on the same config."""
    import numpy as np
    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8,
                                  chunk_in=8 * 8 * 512, mode="AM",
                                  taps_per=8, n_taps=129,
                                  **wideband.PROFILES["fast"])
    m = sharded_wideband.make_mesh()
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(0)
    iq = ((rng.normal(size=cfg.chunk_in)
           + 1j * rng.normal(size=cfg.chunk_in)) * 0.05
          ).astype(np.complex64)
    _, audio, _ = proc(p, wideband.init_state(cfg), iq)
    _, out = wideband.process(cfg, p, wideband.init_state(cfg), iq)
    got = np.asarray(audio)
    want = np.asarray(out.audio)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_sharded_wideband_runs_pallas_kernels_on_mesh(kernel_tail):
    """The mesh runs the same kernel tail the serial pipeline ships, per
    shard (256 channels each on a 2-device mesh), interpreted here; the
    identical call graph compiles to the Triton kernel on a GPU mesh.
    Rows are in bin order on both sides."""
    import numpy as np
    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import chain as chain_mod
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=2 * 512 * 128, mode="AM",
                                  taps_per=4, n_taps=129,
                                  **wideband.PROFILES["fast"])
    assert chain_mod.kernel_tail_ok(cfg.chain_cfg, (512 // 2,))
    m = sharded_wideband.make_mesh(jax.devices()[:2])
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(3)
    iq = ((rng.normal(size=(2, cfg.chunk_in))
           + 1j * rng.normal(size=(2, cfg.chunk_in))) * 0.05
          ).astype(np.complex64)
    sstate = wideband.init_state(cfg)
    state = wideband.init_state(cfg)
    for k in range(2):     # two chunks: carried state must thread right
        sstate, audio, rssi = proc(p, sstate, iq[k])
        state, out = wideband.process(cfg, p, state, iq[k])
        got = np.asarray(audio)
        want = np.asarray(out.audio)
        assert np.abs(got - want).max() < 1e-4 * max(np.abs(want).max(),
                                                     1e-9)
        np.testing.assert_allclose(np.asarray(rssi)[:, 0],
                                   np.asarray(out.rssi)[:, 0], atol=0.01)


def test_pallas_tail_pads_non_lane_batches(kernel_tail):
    """A 300-channel batch (not whole 32-channel kernel programs) runs
    the kernel tail with the channel axis zero-padded to 320 and matches
    the XLA tail."""
    import dataclasses

    cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                            chunk=1024, os_block=1024, n_taps=129,
                            nco_enabled=False)
    assert chain.kernel_tail_ok(cfg, (300,))
    cfg_x = dataclasses.replace(cfg, tail_impl="xla")
    p = chain.make_params(cfg)
    rng = np.random.default_rng(7)
    iq = ((rng.normal(size=(300, cfg.chunk))
           + 1j * rng.normal(size=(300, cfg.chunk))) * 0.1
          ).astype(np.complex64)
    st_p = chain.init_state(cfg, (300,))
    st_x = chain.init_state(cfg_x, (300,))
    for _ in range(2):
        st_p, out_p = chain.process(cfg, p, st_p, iq)
        st_x, out_x = chain.process(cfg_x, p, st_x, iq)
        np.testing.assert_allclose(np.asarray(out_p.audio),
                                   np.asarray(out_x.audio),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("d,n_chan", [(2, 512), (4, 512), (8, 2560)])
def test_sharded_wideband_matches_serial_in_bin_order(d, n_chan):
    """The mesh program (time-sharded channelizer, all_to_all, channel-
    sharded chains) equals the serial pipeline at the fast profile, rows
    in PFB bin order on both sides, state chained over two chunks."""
    from supersdr_jax.parallel import sharded_wideband

    prof = dict(wideband.PROFILES["fast"])
    prof.update(passband_precision="high")
    cfg = wideband.WidebandConfig(fs_in=n_chan * 12_000, n_chan=n_chan,
                                  chunk_in=n_chan * 128, mode="AM",
                                  taps_per=4, n_taps=65, **prof)
    m = sharded_wideband.make_mesh(jax.devices()[:d])
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(5)
    iq = ((rng.normal(size=(2, cfg.chunk_in))
           + 1j * rng.normal(size=(2, cfg.chunk_in))) * 0.05
          ).astype(np.complex64)
    mstate, sstate = wideband.init_state(cfg), wideband.init_state(cfg)
    for k in range(2):
        mstate, audio, rssi = proc(p, mstate, iq[k])
        sstate, out = wideband.process(cfg, p, sstate, iq[k])
        got = np.asarray(audio)
        want = np.asarray(out.audio)
        err = np.abs(got - want).max()
        assert err < 2e-4 * np.abs(want).max(), (k, err)
        np.testing.assert_allclose(np.asarray(rssi)[:, 0],
                                   np.asarray(out.rssi)[:, 0], atol=0.02)


def test_sharded_wideband_i16_ingest_matches_dequantized():
    """Mesh i16 ingest: int16 IQ pairs stream into the per-shard
    channelizers and match the dequantized-f32 mesh run."""
    import numpy as np
    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=512 * 256, mode="AM",
                                  taps_per=4, n_taps=129,
                                  **wideband.PROFILES["fast"])
    m = sharded_wideband.make_mesh(jax.devices()[:4])
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(7)
    re16 = (rng.normal(size=cfg.chunk_in) * 0.05 * 32768).astype(np.int16)
    im16 = (rng.normal(size=cfg.chunk_in) * 0.05 * 32768).astype(np.int16)
    from supersdr_jax.ops import cx
    deq = cx.CX(jnp.asarray(re16, jnp.float32) / 32768.0,
                jnp.asarray(im16, jnp.float32) / 32768.0)
    _, a16, r16 = proc(p, wideband.init_state(cfg), (re16, im16))
    _, af, rf = proc(p, wideband.init_state(cfg), deq)
    num = np.linalg.norm(np.asarray(af, np.float32))
    den = np.linalg.norm(np.asarray(a16, np.float32)
                         - np.asarray(af, np.float32))
    snr = 20 * np.log10(max(num, 1e-30) / max(den, 1e-30))
    assert snr > 80.0, snr


def test_sharded_wideband_process_n_matches_serial_calls():
    """Mesh N-chunk dispatch (VERDICT r4 #2): one mesh program running
    two consecutive chunks equals two chained single-chunk mesh calls
    exactly (tuple outputs, threaded state), including a mixed
    CX + i16 chunk sequence."""
    import numpy as np
    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=512 * 256, mode="AM",
                                  taps_per=4, n_taps=129,
                                  **wideband.PROFILES["fast"])
    m = sharded_wideband.make_mesh(jax.devices()[:4])
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    rng = np.random.default_rng(8)
    iq = ((rng.normal(size=(2, cfg.chunk_in))
           + 1j * rng.normal(size=(2, cfg.chunk_in))) * 0.05
          ).astype(np.complex64)
    st = wideband.init_state(cfg)
    st_n, audios, rssi_n = proc.process_n(p, st, (iq[0], iq[1]))
    st_1 = wideband.init_state(cfg)
    st_1, a0, _ = proc(p, st_1, iq[0])
    st_1, a1, rssi_1 = proc(p, st_1, iq[1])
    np.testing.assert_array_equal(np.asarray(audios[0]), np.asarray(a0))
    np.testing.assert_array_equal(np.asarray(audios[1]), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(rssi_n), np.asarray(rssi_1))
    # mixed kinds: i16 first chunk, CX second — one program, no error
    re16 = (np.asarray(iq[0].real) * 32768).astype(np.int16)
    im16 = (np.asarray(iq[0].imag) * 32768).astype(np.int16)
    _, audios2, _ = proc.process_n(p, wideband.init_state(cfg),
                                   ((re16, im16), iq[1]))
    assert np.isfinite(np.asarray(audios2[0], np.float32)).all()


def test_sharded_wideband_fused_controls_on_mesh(kernel_tail):
    """NBFM, squelch and AGC hang survive the mesh: with the kernel tail
    per shard they match the serial pipeline (same kernel per shard)."""
    import numpy as np
    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import wideband

    rng = np.random.default_rng(12)
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 256,
                taps_per=4, n_taps=129)
    iq = ((rng.normal(size=base["chunk_in"])
           + 1j * rng.normal(size=base["chunk_in"])) * 0.05
          ).astype(np.complex64)
    for extra in (dict(mode="NBFM"),
                  dict(mode="AM", squelch_enabled=True),
                  dict(mode="AM", hang_enabled=True, hang_ms=40.0)):
        cfg = wideband.WidebandConfig(**base, **extra,
                                      **wideband.PROFILES["fast"])
        m = sharded_wideband.make_mesh(jax.devices()[:2])
        proc = sharded_wideband.build(cfg, m)
        p = wideband.make_params(cfg)
        _, audio, _ = proc(p, wideband.init_state(cfg), iq)
        _, out = wideband.process(cfg, p, wideband.init_state(cfg), iq)
        got = np.asarray(audio, np.float32)
        want = np.asarray(out.audio, np.float32)
        err = np.abs(got - want).max()
        assert err < 1e-4 * max(np.abs(want).max(), 1e-9), (extra, err)
