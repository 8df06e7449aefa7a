"""Extended benchmark suite (secondary metrics beyond bench.py's headline).

Measures, on the attached GPU:

  1. wideband IQ→audio throughput (the bench.py headline, same config)
  2. receiver-chain-only throughput (2560 pre-channelized receivers)
  3. waterfall pipeline rate: 1024-bin windowed-FFT rows/s including dB
     calibration + percentile auto-leveling + 10x LINRAD averaging
     (the reference's server caps this at 23 rows/s — BASELINE.md)
  4. single-receiver per-block latency p50/p95 at the reference's frame
     unit (512 IQ samples), dispatch→audio-fetched round trip

Methodology (bench.py applies the same rules): split-complex boundaries
only, and every timing ends in a fetched device-side checksum, so a
failed execution cannot be timed silently.

Prints one JSON line per metric. `python benchmarks/bench_suite.py`.
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _fetch_stat(x) -> float:
    """Force completion by fetching a device-side reduction."""
    import jax.numpy as jnp
    v = float(jnp.mean(jnp.abs(x)))
    assert np.isfinite(v) and v > 0, f"aborted or degenerate output: {v}"
    return v


def bench_wideband():
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    import jax
    import jax.numpy as jnp

    cfg = wideband.WidebandConfig(fs_in=30_720_000, n_chan=2560,
                                  chunk_in=2560 * (16384 - 256), mode="AM",
                                  taps_per=8, n_taps=257, audio_rate=48_000,
                                  **wideband.PROFILES["fast"])
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)

    # device-generated input;
    # single-chunk process() stepping = the bench.py headline basis
    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        shp = (cfg.chunk_in,)
        return cx.CX(0.05 * jax.random.normal(kr, shp, jnp.float32),
                     0.05 * jax.random.normal(ki, shp, jnp.float32))

    iq = gen(jax.random.PRNGKey(0))
    st, out = wideband.process(cfg, params, state, iq)
    _fetch_stat(out.audio)

    iters = 40
    t0 = time.perf_counter()
    for _ in range(iters):
        st, out = wideband.process(cfg, params, st, iq)
    stat = _fetch_stat(out.audio)
    dt = (time.perf_counter() - t0) / iters
    msps = cfg.chunk_in / dt / 1e6
    return {"metric": "wideband_iq_to_audio_throughput",
            "value": round(msps, 1), "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 500.0, 2),
            "checksum": round(stat, 6)}


def bench_chain_only():
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import chain

    n_rx, chunk = 2560, 16128
    import jax
    import jax.numpy as jnp

    cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                            chunk=chunk, os_block=chunk, n_taps=257,
                            nco_enabled=False,
                            passband_impl="matmul",
                            passband_precision="default",
                            resample_impl="matmul",
                            resample_precision="high")
    params = chain.make_params(cfg, freq_offset_hz=np.zeros(n_rx))
    state = chain.init_state(cfg, (n_rx,))

    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        return cx.CX(0.05 * jax.random.normal(kr, (n_rx, chunk), jnp.float32),
                     0.05 * jax.random.normal(ki, (n_rx, chunk), jnp.float32))

    iq = gen(jax.random.PRNGKey(1))
    st, out = chain.process(cfg, params, state, iq)
    _fetch_stat(out.audio)

    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        st, out = chain.process(cfg, params, st, iq)
    stat = _fetch_stat(out.audio)
    dt = (time.perf_counter() - t0) / iters
    msps = n_rx * chunk / dt / 1e6
    return {"metric": "chain_only_throughput_2560rx",
            "value": round(msps, 1), "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 500.0, 2),
            "checksum": round(stat, 6)}


def bench_waterfall():
    """1024-bin waterfall rows/s: FFT + dB + autolevel + 10x averaging."""
    import jax

    from supersdr_jax.ops import cx, spectrum

    nfft, rows_per_call, n_avg = 1024, 4096, 10
    win = spectrum.spectrum_window(nfft)
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        n = rows_per_call * nfft
        return cx.CX(0.1 * jax.random.normal(kr, (n,), jnp.float32),
                     0.1 * jax.random.normal(ki, (n,), jnp.float32))

    iq = gen(jax.random.PRNGKey(2))

    @jax.jit
    def wf(iq):
        rows = spectrum.segment_rows(cx.to_complex(iq), nfft)
        db = spectrum.power_spectrum_db(rows, win)
        db = spectrum.time_binned_average(db, n_avg)
        return spectrum.autolevel(db)

    lv = wf(iq)
    _fetch_stat(lv.color)
    iters = 50
    t0 = time.perf_counter()
    for _ in range(iters):
        lv = wf(iq)
    stat = _fetch_stat(lv.color)
    dt = (time.perf_counter() - t0) / iters
    rows_s = rows_per_call / dt
    # reference server cap: 23 rows/s (BASELINE.md)
    return {"metric": "waterfall_1024bin_rows_per_s",
            "value": round(rows_s, 1), "unit": "rows/s/chip",
            "vs_baseline": round(rows_s / 23.0, 1),
            "checksum": round(stat, 3)}


def bench_block_latency():
    """Reference frame unit: one receiver, 512-sample block; the latency
    includes fetching the audio to the host (an honest dispatch→
    audio-in-hand round trip)."""
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import chain

    cfg = chain.ChainConfig(mode="USB", iq_rate=12000, audio_rate=48000,
                            chunk=512, os_block=512, n_taps=257)
    params = chain.make_params(cfg)
    state = chain.init_state(cfg, ())
    rng = np.random.default_rng(3)
    iq = cx.as_cx(((rng.normal(size=512) + 1j * rng.normal(size=512)) * 0.1
                   ).astype(np.complex64))
    st, out = chain.process(cfg, params, state, iq)
    audio = np.asarray(out.audio)
    assert np.isfinite(audio).all()
    lats = []
    for _ in range(50):
        t0 = time.perf_counter()
        st, out = chain.process(cfg, params, st, iq)
        np.asarray(out.audio)          # fetch = the completion barrier
        lats.append(time.perf_counter() - t0)
    lats = np.sort(np.asarray(lats)) * 1e6
    return {"metric": "single_rx_512blk_latency_p50",
            "value": round(float(lats[len(lats) // 2]), 1), "unit": "us",
            "vs_baseline": None,
            "p95_us": round(float(lats[int(len(lats) * 0.95)]), 1)}


def main():
    from supersdr_jax import backend

    backend.enable_compile_cache()
    for fn in (bench_wideband, bench_chain_only, bench_waterfall,
               bench_block_latency):
        print(json.dumps(fn()), flush=True)


if __name__ == "__main__":
    main()
