"""The GPU chain-tail kernel (ops/pallas/chain_tail.py): the Pallas
interpreter on the CPU against the XLA tail, its lowering for CUDA, the
wrapper's shapes and padding, and the choice of tail. The compiled kernel
is checked on the card by the `gpu`-marked test at the end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersdr_jax.ops.pallas import chain_tail
from supersdr_jax.runtime import chain, wideband


def _tail_inputs(mode, hang, squelch, C=40, n=256, seed=0, thresh=-60.0):
    """A chain config and params for the tail alone, plus a passband
    output y with per-channel levels spread over ±40 dB (so squelch opens
    on some channels and closes on others) and per-channel RSSI."""
    cfg = chain.ChainConfig(mode=mode, iq_rate=12000, audio_rate=48000,
                            chunk=n, os_block=n, n_taps=33,
                            nco_enabled=False, hang_enabled=hang,
                            squelch_enabled=squelch)
    params = chain.make_params(
        cfg, freq_offset_hz=np.zeros(C), agc_kwargs=dict(hang=hang),
        squelch_kwargs=dict(enabled=squelch, thresh_db=thresh))
    rng = np.random.default_rng(seed)
    level = np.exp(rng.normal(size=(C, 1)) * 2.0) * 0.1
    y = jnp.asarray((rng.normal(size=(C, n))
                     + 1j * rng.normal(size=(C, n))) * level, jnp.complex64)
    rssi = jnp.asarray(rng.normal(size=(C, 1)) * 20.0 - 60.0, jnp.float32)
    return cfg, params, y, rssi


def _run_tail(tail, cfg, params, y, rssi, n_chunks=2):
    f = jax.jit(tail, static_argnums=0)
    st = chain.init_state(cfg, y.shape[:1])
    audio = []
    for _ in range(n_chunks):
        dstate, astate, sq, icarry, a = f(cfg, params, st, y, rssi)
        st = st._replace(demod=dstate, agc=astate, squelch=sq,
                         interp_carry=icarry)
        audio.append(np.asarray(a))
    return np.concatenate(audio, axis=-1), st


def _interp(cfg, params, st, y, rssi):
    return chain.tail_kernel(cfg, params, st, y, rssi, interpret=True)


@pytest.mark.parametrize("squelch", [False, True], ids=["sq0", "sq1"])
@pytest.mark.parametrize("hang", [False, True], ids=["hang0", "hang1"])
@pytest.mark.parametrize("mode", ["AM", "USB", "CW", "NBFM"])
def test_kernel_tail_matches_xla_tail(mode, hang, squelch):
    """Demod, AGC (hang), squelch and resampler of the kernel equal the
    XLA ops over two state-chained chunks, audio and every state leaf.
    40 channels exercise the padding to whole 32-channel programs; the
    chunk is shorter than the hang window, where the block-granular hang
    is exact."""
    cfg, params, y, rssi = _tail_inputs(mode, hang, squelch)
    ref, st_ref = _run_tail(chain.tail_xla, cfg, params, y, rssi)
    got, st_got = _run_tail(_interp, cfg, params, y, rssi)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    # state leaves include dB quantities (AGC peak and gain), summed in
    # another order by the XLA scans: 1e-3 dB
    for a, b in zip(jax.tree.leaves(st_ref), jax.tree.leaves(st_got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-3)


def test_fused_chain_tail_matches_xla(rng, kernel_tail):
    """tail_impl='auto' on a GPU (the kernel, interpreted here) equals the
    XLA chain tail through the full wideband pipeline at the fast
    profile, including chunk-chained streaming state."""
    base = dict(fs_in=64 * 12000, n_chan=64, chunk_in=64 * 512,
                mode="AM", taps_per=8, n_taps=129, audio_rate=48_000,
                **wideband.PROFILES["quality"])
    iq = ((rng.normal(size=(2, base["chunk_in"]))
           + 1j * rng.normal(size=(2, base["chunk_in"]))) * 0.05
          ).astype(np.complex64)
    outs = {}
    for tail in ("xla", "auto"):
        cfg = wideband.WidebandConfig(**base, tail_impl=tail)
        p = wideband.make_params(cfg)
        _, audio = wideband.process_many(cfg, p, wideband.init_state(cfg),
                                         iq)
        outs[tail] = np.asarray(audio)
    err = np.abs(outs["auto"] - outs["xla"]).max()
    assert err < 1e-4 * np.abs(outs["xla"]).max()


def test_fused_chain_tail_fallback_conditions(rng, kernel_tail):
    """Configurations the kernel does not cover (IQ and MULTI modes,
    rational resampling, decimated AGC, a chunk that is not whole kernel
    tiles, a 2-D batch) take the XLA tail, with output identical to
    tail_impl='xla'."""
    base = dict(iq_rate=12000, audio_rate=48000, chunk=512, os_block=512,
                n_taps=33, nco_enabled=False)
    covered = chain.ChainConfig(**base)
    assert chain.kernel_tail_ok(covered, (8,))
    for cfg, batch in [
            (chain.ChainConfig(**base, mode="IQ"), (8,)),
            (chain.ChainConfig(**base, mode="MULTI"), (8,)),
            (chain.ChainConfig(**{**base, "iq_rate": 20250,
                                  "chunk": 27 * 16, "os_block": 27 * 16}),
             (8,)),
            (chain.ChainConfig(**base, agc_decimation=4), (8,)),
            (chain.ChainConfig(**{**base, "chunk": 520, "os_block": 520}),
             (8,)),
            (covered, (2, 4))]:
        assert not chain.kernel_tail_ok(cfg, batch), cfg
    cfg = chain.ChainConfig(**{**base, "chunk": 520, "os_block": 520})
    iq = ((rng.normal(size=(8, 520)) + 1j * rng.normal(size=(8, 520)))
          * 0.1).astype(np.complex64)
    p = chain.make_params(cfg, freq_offset_hz=np.zeros(8))
    _, auto = chain.process(cfg, p, chain.init_state(cfg, (8,)), iq)
    cfg_x = chain.ChainConfig(**{**base, "chunk": 520, "os_block": 520,
                                 "tail_impl": "xla"})
    _, xla = chain.process(cfg_x, p, chain.init_state(cfg_x, (8,)), iq)
    assert np.array_equal(np.asarray(auto.audio), np.asarray(xla.audio))


def test_fused_chain_tail_upsample_sweep(rng):
    """The kernel honors the config's upsample factor L (1, 2 and 4)."""
    for audio_rate in (12_000, 24_000, 48_000):
        cfg, params, y, rssi = _tail_inputs("AM", False, False, C=32,
                                            n=128)
        cfg = chain.ChainConfig(**{**cfg.__dict__, "audio_rate": audio_rate})
        params = chain.make_params(cfg, freq_offset_hz=np.zeros(32))
        ref, _ = _run_tail(chain.tail_xla, cfg, params, y, rssi)
        got, _ = _run_tail(_interp, cfg, params, y, rssi)
        assert got.shape == (32, 2 * 128 * audio_rate // 12000)
        assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


def test_auto_tail_is_xla_on_cpu(rng):
    """On the CPU, tail_impl='auto' is the XLA tail itself: no kernel,
    no interpreter."""
    base = dict(iq_rate=12000, audio_rate=48000, chunk=256, os_block=256,
                n_taps=33, nco_enabled=False)
    iq = ((rng.normal(size=(32, 256)) + 1j * rng.normal(size=(32, 256)))
          * 0.1).astype(np.complex64)
    outs = []
    for tail in ("auto", "xla"):
        cfg = chain.ChainConfig(**base, tail_impl=tail)
        p = chain.make_params(cfg, freq_offset_hz=np.zeros(32))
        _, out = chain.process(cfg, p, chain.init_state(cfg, (32,)), iq)
        outs.append(np.asarray(out.audio))
        jaxpr = jax.make_jaxpr(chain.process_traced, static_argnums=0)(
            cfg, p, chain.init_state(cfg, (32,)),
            chain.cx.as_cx(iq))
        assert "pallas_call" not in str(jaxpr)
    assert np.array_equal(outs[0], outs[1])


def test_tail_wrapper_rejects_bad_shapes():
    P = np.ones((9, 4))
    st = jnp.zeros((chain_tail.state_rows(9), 32))
    par = jnp.zeros(chain_tail.N_PAR)
    with pytest.raises(ValueError, match="multiple of 16"):
        chain_tail.chain_tail(jnp.zeros((100, 32)), st, par, P,
                              dc_block=True, interpret=True)
    with pytest.raises(ValueError, match="state must be"):
        chain_tail.chain_tail(jnp.zeros((64, 32)), st[:3], par, P,
                              dc_block=True, interpret=True)
    assert chain_tail.hang_block(16128) == 256
    assert chain_tail.hang_block(512) == 256
    assert chain_tail.hang_block(48) == 48


@pytest.mark.parametrize("mode,hang,squelch",
                         [("AM", False, False), ("NBFM", True, True)])
def test_kernel_tail_lowers_for_cuda(mode, hang, squelch):
    """The kernel lowers through Pallas' Triton route for CUDA at the
    headline's 2560 channels (every primitive has a Triton lowering)."""
    cfg, params, _, _ = _tail_inputs(mode, hang, squelch, C=2560, n=512)
    st = chain.init_state(cfg, (2560,))
    y = jax.ShapeDtypeStruct((2560, 512), jnp.complex64)
    rssi = jax.ShapeDtypeStruct((2560, 1), jnp.float32)
    lowered = jax.jit(chain.tail_kernel, static_argnums=0).trace(
        cfg, params, st, y, rssi).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "grid_x = 80" in text


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["AM", "NBFM"])
def test_compiled_kernel_tail_matches_xla_tail(gpu, mode):
    """The kernel compiled for the card against the XLA tail on the card,
    hang and squelch on."""
    cfg, params, y, rssi = _tail_inputs(mode, True, True, C=256, n=512)
    with jax.default_matmul_precision("highest"):
        ref, _ = _run_tail(chain.tail_xla, cfg, params, y, rssi)
        got, _ = _run_tail(chain.tail_kernel, cfg, params, y, rssi)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
