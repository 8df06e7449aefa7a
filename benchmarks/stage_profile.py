"""On-chip stage profile of the wideband step (fetch-forced differencing).

Builds a family of truncated pipelines — channelize only, +passband,
+demod, +AGC+squelch, +resample (= full) — times each at the bench
HEADLINE config with fetch-forced methodology, and reports per-stage
time as consecutive differences. One JSON line per prefix.

CAVEAT (learned the hard way, round 2): prefix deltas are a *ranking*
signal, not ground truth. Each truncated program fuses/DCEs differently
from the full pipeline, so a stage's delta can be badly inflated (the
resample delta read 47 ms here while replacing it changed the full
pipeline by ~0). Any optimization decided from this profile must be
confirmed by a FULL-pipeline A/B (benchmarks/ab_gpu.py) before it
becomes a default.

Usage: python benchmarks/stage_profile.py [fft|matmul]
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

HEADLINE = dict(fs_in=30_720_000, n_chan=2560,
                chunk_in=2560 * (16384 - 256), mode="AM",
                taps_per=8, n_taps=257, audio_rate=48_000)
N_SCAN = 2
MIN_S = 1.5


def main():
    import jax
    import jax.numpy as jnp
    from supersdr_jax import backend
    backend.enable_compile_cache()

    from functools import partial

    from supersdr_jax.ops import agc as agc_ops
    from supersdr_jax.ops import channelizer, cx, fir_matmul, overlap_save
    from supersdr_jax.ops import demod as demod_ops
    from supersdr_jax.ops import resample
    from supersdr_jax.ops import squelch as squelch_ops
    from supersdr_jax.runtime import chain as chain_mod
    from supersdr_jax.runtime import wideband

    impl = sys.argv[1] if len(sys.argv) > 1 else "fft"
    cfg = wideband.WidebandConfig(**HEADLINE, passband_impl=impl)
    ccfg = cfg.chain_cfg
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)
    plan = wideband.pfb_plan(cfg)

    def stage_channelize(st, iq):
        carry, chans = channelizer.channelize_c(
            plan, params.W_pfb, cx.to_complex(st.pfb_carry),
            cx.to_complex(iq))
        return cx.split(carry), chans

    def stage_passband(st, x):
        if impl == "matmul":
            _, y = fir_matmul.fir_matmul_stream_c(
                ccfg.fir_plan, params.chain.W_pass, st.chain.os_carry,
                cx.split(x))
            return cx.to_complex(y)
        _, y = overlap_save.overlap_save_c(
            ccfg.os_plan, cx.to_complex(params.chain.H_pass),
            cx.to_complex(st.chain.os_carry), x)
        return y

    def make_prefix(depth):
        def step(st, iq):
            carry, chans = stage_channelize(st, iq)
            if depth == 0:
                return jnp.mean(jnp.abs(chans.real) + jnp.abs(chans.imag))
            y = stage_passband(st, chans)
            if depth == 1:
                return jnp.mean(jnp.abs(y.real) + jnp.abs(y.imag))
            _, audio = demod_ops.demodulate(ccfg.mode, st.chain.demod, y,
                                            ccfg.iq_rate)
            if depth == 2:
                return jnp.mean(jnp.abs(audio))
            _, audio = agc_ops.apply(params.chain.agc, st.chain.agc, audio,
                                     hang_window=ccfg.hang_window,
                                     decimation=ccfg.agc_decimation)
            if depth == 3:
                return jnp.mean(jnp.abs(audio))
            _, audio = resample.interpolate(ccfg.interp_plan,
                                            params.chain.P_interp,
                                            st.chain.interp_carry,
                                            audio.astype(jnp.float32))
            return jnp.mean(jnp.abs(audio))

        @jax.jit
        def scanned(st, iq_chunks):
            def body(acc, chunk):
                return acc + step(st, chunk), 0.0
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), iq_chunks)
            return acc
        return scanned

    rng = np.random.default_rng(1)
    iq = ((rng.normal(size=(N_SCAN, cfg.chunk_in))
           + 1j * rng.normal(size=(N_SCAN, cfg.chunk_in))) * 0.05
          ).astype(np.complex64)
    iq_dev = cx.as_cx(iq)

    names = ["channelize", "+passband", "+demod", "+agc", "+resample(full)"]
    prev = 0.0
    for depth, name in enumerate(names):
        fn = make_prefix(depth)
        s = float(fn(state, iq_dev))       # compile + warmup, fetch-forced
        assert np.isfinite(s), f"{name}: not finite"
        iters = 4
        while True:
            t0 = time.perf_counter()
            acc = 0.0
            for _ in range(iters):
                acc = float(fn(state, iq_dev))
            dt = time.perf_counter() - t0
            if dt >= MIN_S or iters >= 64:
                break
            iters *= 2
        step_ms = dt / iters * 1e3
        print(json.dumps({"prefix": name, "impl": impl,
                          "step_ms": round(step_ms, 2),
                          "delta_ms": round(step_ms - prev, 2),
                          "stat": round(acc, 6)}), flush=True)
        prev = step_ms


if __name__ == "__main__":
    main()
