"""On-chip A/B of the audio layout at the headline config (fetch-forced,
state-chained): channel-major, time-major (the profiles' layout), and
time-major with a bf16 audio plane.

Run: python benchmarks/ab_tmajor.py
"""

import sys
import time

import numpy as np

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp

from supersdr_jax.ops import cx
from supersdr_jax.runtime import wideband

HEAD = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * (16384 - 256),
            mode="AM", taps_per=8, n_taps=257, audio_rate=48_000)


def run(tag, **extra):
    prof = dict(wideband.PROFILES["fast"])
    prof.pop("time_major", None)
    prof.pop("audio_dtype", None)
    cfg = wideband.WidebandConfig(**HEAD, **prof, **extra)
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)

    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        return cx.CX(0.05 * jax.random.normal(kr, (1, cfg.chunk_in),
                                              jnp.float32),
                     0.05 * jax.random.normal(ki, (1, cfg.chunk_in),
                                              jnp.float32))

    iq = gen(jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    st, audio = wideband.process_many(cfg, params, state, iq)
    stat = float(jnp.mean(jnp.abs(audio.astype(jnp.float32))))
    compile_s = time.perf_counter() - t0
    assert np.isfinite(stat) and stat > 0, f"{tag}: bad audio {stat}"

    iters = 8
    while True:
        t0 = time.perf_counter()
        s = st
        for _ in range(iters):
            s, audio = wideband.process_many(cfg, params, s, iq)
        x = float(jnp.mean(jnp.abs(audio.astype(jnp.float32))))
        dt = time.perf_counter() - t0
        if dt > 2.0 or iters >= 128:
            break
        iters *= 2
    assert np.isfinite(x) and x > 0
    ms = dt / iters * 1e3
    msps = cfg.chunk_in * iters / dt / 1e6
    print(f"{tag:28s} step {ms:6.2f} ms  {msps:7.0f} Msps  "
          f"|a|={x:.6f}  (compile {compile_s:.0f}s)")
    return msps


def main():
    from supersdr_jax import backend

    backend.enable_compile_cache()
    run("cmajor")
    run("tmajor", time_major=True)
    run("tmajor+bf16audio", time_major=True, audio_dtype="bf16")


if __name__ == "__main__":
    main()
