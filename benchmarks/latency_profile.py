"""Dispatch→audio latency distribution for the interactive path.

One 512-sample receiver block through the full chain, fetch-forced, N
trials → p50/p90/p95/p99. The production budget is the reference's own
427 ms audio buffer (supersdr.py:30-31).

Usage: python benchmarks/latency_profile.py [trials]
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    import jax
    from supersdr_jax import backend
    backend.enable_compile_cache()
    from supersdr_jax.runtime import chain

    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                            chunk=512, os_block=512, n_taps=257)
    params = chain.make_params(cfg)
    state = chain.init_state(cfg)
    rng = np.random.default_rng(0)
    blocks = [((rng.normal(size=512) + 1j * rng.normal(size=512)) * 0.1
               ).astype(np.complex64) for _ in range(8)]

    # warmup/compile
    for b in blocks[:4]:
        state, out = chain.process(cfg, params, state, b)
        _ = np.asarray(out.audio)

    lat = []
    for i in range(trials):
        b = blocks[i % len(blocks)]
        t0 = time.perf_counter()
        state, out = chain.process(cfg, params, state, b)
        a = np.asarray(out.audio)        # fetch-forced
        lat.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(a).all()
    lat = np.sort(np.asarray(lat))

    def pct(p):
        return round(float(np.percentile(lat, p)), 2)

    # device-time vs transport split (VERDICT r3 #8), by repeated-step
    # subtraction: K state-chained steps with ONE final fetch pipeline
    # on the device, so T(K) ≈ transport + K·t_device; the slope over
    # two K values isolates t_device and the intercept the RPC/transport
    # share of the single-block latency above.
    def timed_chain(K, reps=12):
        best = np.inf
        for _ in range(reps):
            st = chain.init_state(cfg)
            t0 = time.perf_counter()
            s2 = st
            for i in range(K):
                s2, out = chain.process(cfg, params, s2, blocks[i % 8])
            _ = float(np.asarray(out.audio[:4]).sum())
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    k1, k2 = 8, 64
    t1, t2 = timed_chain(k1), timed_chain(k2)
    dev_ms = max((t2 - t1) / (k2 - k1), 0.0)
    transport_ms = max(t1 - k1 * dev_ms, 0.0)

    print(json.dumps({"metric": "block512_dispatch_to_audio_ms",
                      "trials": trials,
                      "p50": pct(50), "p90": pct(90),
                      "p95": pct(95), "p99": pct(99),
                      "max": round(float(lat[-1]), 2),
                      "device_step_ms_est": round(dev_ms, 3),
                      "transport_ms_est": round(transport_ms, 2)}))


if __name__ == "__main__":
    main()
