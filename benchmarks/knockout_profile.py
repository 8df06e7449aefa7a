"""Knock-out profile: full HEADLINE pipeline with ONE stage trivialized.

Unlike prefix truncation (stage_profile.py — whose deltas distort under
fusion/DCE), each knock-out keeps the rest of the program intact, so
`full - knockout(stage)` bounds what that stage really costs in context.
Knock-outs change semantics, so there is no oracle gate here — outputs
are only checked finite/nonzero; numbers guide optimization, never a
claim.

Usage: python benchmarks/knockout_profile.py [indices...]
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

BASE = dict(fs_in=30_720_000, n_chan=2560,
            chunk_in=2560 * (16384 - 256), mode="AM",
            taps_per=8, n_taps=257, audio_rate=48_000,
            passband_impl="matmul", passband_precision="default",
            chan_impl="legacy", resample_impl="matmul",
            resample_precision="default", time_major=True)
N_SCAN = 1
MIN_S = 2.0

# (name, config overrides) — each trivializes one stage
VARIANTS = [
    ("full", {}),
    ("no_passband(n_taps=1)", {"n_taps": 1}),
    ("no_resample(audio=iq_rate)", {"audio_rate": 12_000}),
    ("iq_mode(no demod/agc)", {"mode": "IQ", "time_major": False}),
    ("agc_decim8", {"agc_decimation": 8}),
    ("taps_per4(PFB half fold)", {"taps_per": 4}),
    ("xla_mxu2_chan", {"chan_impl": "mxu2", "chan_fold_dtype": "f16"}),
    ("xla_tail", {"tail_impl": "xla"}),
    ("quality_profile", {"passband_precision": "highest",
                         "resample_precision": "highest"}),
    ("no_channelizer(stub)", {"chan_impl": "stub"}),
    ("stub+iq", {"chan_impl": "stub", "mode": "IQ",
                 "time_major": False}),
    ("empty(stub+iq+taps1)", {"chan_impl": "stub", "mode": "IQ",
                              "n_taps": 1, "time_major": False}),
    ("cmajor(r3 layout)", {"time_major": False}),
    ("no_rssi_squelch", {}),
    ("chan_no_fft(fold+T)", {"chan_impl": "nofft"}),
]


def main():
    import jax
    import jax.numpy as jnp
    from supersdr_jax import backend
    backend.enable_compile_cache()
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    idxs = [int(a) for a in sys.argv[1:]] or range(len(VARIANTS))
    for i in idxs:
        name, over = VARIANTS[i]
        cfg = wideband.WidebandConfig(**{**BASE, **over})
        params = wideband.make_params(cfg)
        state = wideband.init_state(cfg)

        # device-generated input
        @jax.jit
        def gen(key, n=cfg.chunk_in):
            kr, ki = jax.random.split(key)
            return cx.CX(0.05 * jax.random.normal(kr, (N_SCAN, n),
                                                  jnp.float32),
                         0.05 * jax.random.normal(ki, (N_SCAN, n),
                                                  jnp.float32))

        iq = gen(jax.random.PRNGKey(1))
        iq1 = cx.CX(iq.re[0], iq.im[0])

        def stat(audio):
            if hasattr(audio, "re"):
                return float(jnp.mean(jnp.abs(audio.re) + jnp.abs(audio.im)))
            return float(jnp.mean(jnp.abs(audio.astype(jnp.float32))))

        def step(st_):
            # single-chunk process(), the bench.py N_SCAN=1 basis
            st2, out = wideband.process(cfg, params, st_, iq1)
            return st2, out.audio

        try:
            st, audio = step(state)
            s = stat(audio)
            assert np.isfinite(s) and s > 0
            iters = 4
            while True:
                t0 = time.perf_counter()
                st_t = st
                for _ in range(iters):
                    st_t, audio = step(st_t)
                s = stat(audio)
                dt = time.perf_counter() - t0
                if dt >= MIN_S or iters >= 64:
                    break
                iters *= 2
            print(json.dumps({"knockout": name,
                              "step_ms": round(dt / iters * 1e3, 2),
                              "stat": round(s, 6)}), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"knockout": name, "error": repr(e)[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
