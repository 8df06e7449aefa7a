"""NBFM, squelch and AGC hang through the GPU tail kernel (run by the
Pallas interpreter here, `kernel_tail` fixture) against the XLA tail.

Reference capabilities being covered natively:
  NBFM mode    — /root/reference/kiwi/client.py:221-245 mode table
  SET squelch  — /root/reference/kiwi/client.py:254-255
  SET agc hang — /root/reference/utils_supersdr.py:1022-1029
"""

import numpy as np

from supersdr_jax.ops import agc as agc_ops
from supersdr_jax.ops.pallas import chain_tail
from supersdr_jax.runtime import chain, wideband


def _snr(ref, got):
    num = np.linalg.norm(ref)
    den = np.linalg.norm(np.asarray(got) - np.asarray(ref))
    return 20.0 * np.log10(max(num, 1e-30) / max(den, 1e-30))


CHAIN_BASE = dict(iq_rate=12000, audio_rate=48000, chunk=512,
                  os_block=512, n_taps=129, passband_impl="matmul",
                  nco_enabled=False)


def _run_chain(cfg, iq, n_chunks=3, agc_kwargs=None):
    p = chain.make_params(cfg, agc_kwargs=agc_kwargs)
    st = chain.init_state(cfg, iq.shape[:-1])
    parts = []
    for _ in range(n_chunks):
        st, out = chain.process(cfg, p, st, iq)
        parts.append(np.asarray(out.audio))
    return np.concatenate(parts, axis=-1)


def test_nbfm_fused_matches_xla_chain(kernel_tail):
    """The kernel's quadrature discriminator (with the mute floor)
    matches the XLA demod_nbfm through AGC + resample, state-chained
    across chunks."""
    rng = np.random.default_rng(0)
    C = 128
    iq = ((rng.normal(size=(C, 512)) + 1j * rng.normal(size=(C, 512)))
          * 0.1).astype(np.complex64)
    outs = {}
    for tail in ("xla", "auto"):
        cfg = chain.ChainConfig(**CHAIN_BASE, mode="NBFM", tail_impl=tail)
        if tail == "auto":
            assert chain.kernel_tail_ok(cfg, (C,))
        outs[tail] = _run_chain(cfg, iq)
    assert _snr(outs["xla"], outs["auto"]) > 80


def test_nbfm_wideband_kernel_tail(kernel_tail):
    """Wideband NBFM at the fast profile with the kernel tail matches
    the plain-path pipeline (FFT passband, XLA tail, full precision)."""
    rng = np.random.default_rng(1)
    base = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
                mode="NBFM", taps_per=4, n_taps=129)
    prof = dict(wideband.PROFILES["fast"])
    prof.update(passband_precision="highest", resample_precision="highest")
    cfg_f = wideband.WidebandConfig(**base, **prof)
    assert chain.kernel_tail_ok(cfg_f.chain_cfg, (512,))
    cfg_r = wideband.WidebandConfig(**base)
    iq = ((rng.normal(size=(2, base["chunk_in"]))
           + 1j * rng.normal(size=(2, base["chunk_in"]))) * 0.05
          ).astype(np.complex64)
    _, ref = wideband.process_many(cfg_r, wideband.make_params(cfg_r),
                                   wideband.init_state(cfg_r), iq)
    _, got = wideband.process_many(cfg_f, wideband.make_params(cfg_f),
                                   wideband.init_state(cfg_f), iq)
    got_bin = np.swapaxes(np.asarray(got, np.float32), -1, -2)
    assert _snr(np.asarray(ref, np.float32), got_bin) > 70


def test_squelch_keeps_fused_tier_and_matches(kernel_tail):
    """squelch_enabled keeps the kernel tail (the gate ramp is applied in
    the kernel before the resampler, as the XLA chain applies it): open,
    closed and half-open gates match the XLA tail."""
    rng = np.random.default_rng(2)
    base = dict(fs_in=64 * 12_000, n_chan=64, chunk_in=64 * 512,
                mode="AM", taps_per=4, n_taps=129, squelch_enabled=True,
                **wideband.PROFILES["quality"])
    cfg_k = wideband.WidebandConfig(**base)
    assert chain.kernel_tail_ok(cfg_k.chain_cfg, (64,))
    cfg_x = wideband.WidebandConfig(**base, tail_impl="xla")
    # channel levels spread over ±40 dB, so a mid threshold opens some
    # gates and closes others
    level = np.exp(rng.normal(size=64) * 2.0)
    chans = ((rng.normal(size=(2, 64, 512))
              + 1j * rng.normal(size=(2, 64, 512))) * 0.01
             * level[None, :, None])
    iq = np.fft.ifft(chans, axis=1).transpose(0, 2, 1).reshape(2, -1)
    iq = iq.astype(np.complex64)
    for thresh in (-200.0, 100.0, -80.0):
        kw = dict(squelch_kwargs=dict(enabled=True, thresh_db=thresh))
        _, out_k = wideband.process_many(cfg_k, wideband.make_params(
            cfg_k, **kw), wideband.init_state(cfg_k), iq)
        _, out_x = wideband.process_many(cfg_x, wideband.make_params(
            cfg_x, **kw), wideband.init_state(cfg_x), iq)
        out_k = np.asarray(out_k, np.float32)
        out_x = np.asarray(out_x, np.float32)
        if thresh == 100.0:
            # gate closed: audio fully muted after the ramp
            assert np.abs(out_k[-1, -1000:, :]).max() == 0.0
        else:
            assert _snr(out_x, out_k) > 70, thresh


def _burst_iq(C, n, fs, strong_until, weak_db=-40.0, am=True):
    """Per-channel carrier: strong tone, then a weak tail. am=False
    emits a bare +1 kHz complex tone (USB probe — no DC-block
    transient to contaminate release-onset detection)."""
    t = np.arange(n) / fs
    tone = ((1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) if am
            else np.exp(2j * np.pi * 1000.0 * t))
    amp = np.where(np.arange(n) < strong_until, 0.3,
                   0.3 * 10 ** (weak_db / 20.0))
    z = (amp * tone).astype(np.complex64)
    return np.broadcast_to(z, (C, n)).copy()


def test_hang_fused_steady_matches_xla(kernel_tail):
    """With a steady signal the hang window is irrelevant — the kernel's
    block ring must be transparent (tight equality with the XLA sliding
    max)."""
    C = 128
    iq = _burst_iq(C, 512, 12000, strong_until=512)
    outs = {}
    for tail in ("xla", "auto"):
        cfg = chain.ChainConfig(**CHAIN_BASE, mode="AM", tail_impl=tail,
                                hang_enabled=True, hang_ms=40.0)
        if tail == "auto":
            assert chain.kernel_tail_ok(cfg, (C,))
        outs[tail] = _run_chain(cfg, iq, n_chunks=4,
                                agc_kwargs=dict(hang=True))
    assert _snr(outs["xla"], outs["auto"]) > 70


def test_hang_fused_ballistics_bound(kernel_tail):
    """Burst signal: after the strong burst ends, the AGC release (and
    with it the weak-signal audio rise) must start no EARLIER than the
    XLA hang window W and no later than W + 2 hang blocks — the
    documented block-granular deviation envelope."""
    big = dict(CHAIN_BASE, chunk=8192, os_block=8192)
    cfg_x = chain.ChainConfig(**big, mode="USB", tail_impl="xla",
                              hang_enabled=True, hang_ms=150.0)
    cfg_p = chain.ChainConfig(**big, mode="USB", tail_impl="auto",
                              hang_enabled=True, hang_ms=150.0)
    C = 32
    W = agc_ops.hang_samples(12000, 150.0)
    T = chain_tail.hang_block(8192)
    burst_end = 2048
    iq = _burst_iq(C, 8192, 12000, strong_until=burst_end, am=False)
    ups = 4

    def release_onset(audio):
        # smoothed |audio| of channel 0 at the audio rate
        env = np.convolve(np.abs(audio[0]), np.ones(256) / 256, "same")
        lo = env[(burst_end + 256) * ups]     # held (pre-release) level
        hi = env[-256 * ups]                  # fully released level
        after = env[(burst_end + 256) * ups:]
        idx = np.argmax(after > lo + 0.25 * (hi - lo))
        return idx / ups                      # IQ-rate samples

    # fast decay (60 dB over ~600 samples) so the release is visible
    # inside the chunk; the default 4 s decay moves ~2 dB per hang
    # window and the hold would be unobservable
    ak = dict(hang=True, decay_ms=50.0)
    on_x = release_onset(_run_chain(cfg_x, iq, n_chunks=1, agc_kwargs=ak))
    on_p = release_onset(_run_chain(cfg_p, iq, n_chunks=1, agc_kwargs=ak))
    assert on_x > W * 0.5                     # hang actually held (xla)
    # the kernel holds at least as long, and at most ~2 blocks longer
    assert on_p >= on_x - 64, (on_x, on_p)
    assert on_p <= on_x + 2 * T + 256, (on_x, on_p, T)


def test_hang_runtime_flag_off_is_transparent(kernel_tail):
    """hang_enabled compiles the ring in, but params.agc.hang == 0 must
    reproduce the no-hang ballistics exactly (runtime select)."""
    rng = np.random.default_rng(3)
    C = 128
    iq = ((rng.normal(size=(C, 512)) + 1j * rng.normal(size=(C, 512)))
          * 0.1).astype(np.complex64)
    cfg_h = chain.ChainConfig(**CHAIN_BASE, mode="AM", hang_enabled=True,
                              hang_ms=40.0)
    cfg_0 = chain.ChainConfig(**CHAIN_BASE, mode="AM")
    a_h = _run_chain(cfg_h, iq, agc_kwargs=dict(hang=False))
    a_0 = _run_chain(cfg_0, iq)
    np.testing.assert_allclose(a_h, a_0, atol=1e-6)


def test_nbfm_with_squelch_fused_interaction(kernel_tail):
    """NBFM + squelch together through the kernel: the discriminator's
    audio gates on the chunk RSSI like AM does (the controls compose;
    each was verified separately above)."""
    rng = np.random.default_rng(9)
    base = dict(fs_in=64 * 12_000, n_chan=64, chunk_in=64 * 512,
                mode="NBFM", taps_per=4, n_taps=129,
                squelch_enabled=True)
    prof = dict(wideband.PROFILES["fast"])
    cfg = wideband.WidebandConfig(**base, **prof)
    assert chain.kernel_tail_ok(cfg.chain_cfg, (64,))
    iq = ((rng.normal(size=(1, base["chunk_in"]))
           + 1j * rng.normal(size=(1, base["chunk_in"]))) * 0.05
          ).astype(np.complex64)
    # closed gate: everything mutes after the ramp
    p = wideband.make_params(cfg, squelch_kwargs=dict(
        enabled=True, thresh_db=100.0))
    _, out = wideband.process_many(cfg, p, wideband.init_state(cfg), iq)
    a = np.asarray(out, np.float32)
    assert np.abs(a[-1, -1000:, :]).max() == 0.0
    # open gate: audio flows
    p2 = wideband.make_params(cfg, squelch_kwargs=dict(
        enabled=True, thresh_db=-200.0))
    _, out2 = wideband.process_many(cfg, p2, wideband.init_state(cfg), iq)
    assert float(np.abs(np.asarray(out2, np.float32)).mean()) > 0
