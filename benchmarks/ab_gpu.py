"""A/B of the GPU choices at the headline deployment (30.72 MHz capture,
2560 channels of 12 kHz, 41.3 Msample chunks, bench.HEADLINE):

  * the Triton chain tail (tail_impl="auto" on a GPU) against the XLA
    tail, for AM and for NBFM with AGC hang and squelch on;
  * the "legacy" channelizer (fold, then cuFFT) against "mxu2" (matmul
    DFT on the tensor cores), for both profiles.

Each variant's two-chunk step (wideband.process_n) is compiled once and
then timed in turns A B B A, so drift on the card hits both sides alike;
each pair's audio is also compared (SNR of B against A). Prints one line
per reading and a JSON summary as the last line. Needs the GPU.

    python benchmarks/ab_gpu.py [--rounds N] [--pairs tail,chan]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--pairs", default="tail,chan")
    ap.add_argument("--min-s", type=float, default=1.0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from bench import HEADLINE
    from supersdr_jax import backend
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    backend.enable_compile_cache()
    card = bench.card()
    print("card:", card, "device:", bench.device_info(), flush=True)
    dev = jax.devices()[0]
    fast, quality = wideband.PROFILES["fast"], wideband.PROFILES["quality"]
    nbfm = dict(mode="NBFM", hang_enabled=True, squelch_enabled=True)
    nbfm_kw = dict(agc_kwargs=dict(hang=True),
                   squelch_kwargs=dict(enabled=True))
    pairs = []
    if "tail" in args.pairs:
        pairs += [
            ("am fast: xla tail vs kernel tail",
             ({**fast, "tail_impl": "xla"}, {}), ({**fast}, {})),
            ("nbfm+hang+squelch fast: xla tail vs kernel tail",
             ({**fast, **nbfm, "tail_impl": "xla"}, nbfm_kw),
             ({**fast, **nbfm}, nbfm_kw)),
        ]
    if "chan" in args.pairs:
        pairs += [
            ("am fast: legacy vs mxu2 channelizer",
             ({**fast}, {}), ({**fast, "chan_impl": "mxu2"}, {})),
            ("am quality: legacy vs mxu2 channelizer",
             ({**quality}, {}), ({**quality, "chan_impl": "mxu2"}, {})),
        ]

    base = {k: v for k, v in HEADLINE.items() if k != "mode"}
    key = jax.random.PRNGKey(1)
    kr, ki = jax.random.split(key)
    shp = (HEADLINE["chunk_in"],)
    iq = cx.CX(0.05 * jax.random.normal(kr, shp, jnp.float32),
               0.05 * jax.random.normal(ki, shp, jnp.float32))
    iqs = (iq, iq)

    def build(tuning, kw):
        cfg = wideband.WidebandConfig(**{"mode": "AM", **base, **tuning})
        params = wideband.make_params(cfg, **kw)
        state = wideband.init_state(cfg)
        t0 = time.perf_counter()
        st, outs = wideband.process_n(cfg, params, state, iqs)
        jax.block_until_ready(outs)
        compile_s = time.perf_counter() - t0
        audio = np.asarray(outs[-1], np.float32)
        return cfg, params, st, compile_s, audio

    def timed(cfg, params, st):
        iters = 4
        while True:
            t0 = time.perf_counter()
            for _ in range(iters):
                st, outs = wideband.process_n(cfg, params, st, iqs)
            jax.block_until_ready(outs)
            float(jnp.mean(jnp.abs(outs[-1].astype(jnp.float32))))
            dt = time.perf_counter() - t0
            if dt >= args.min_s or iters >= 256:
                return st, dt / iters / len(iqs) * 1e3
            iters *= 2

    summary = []
    for name, (ta, ka), (tb, kb) in pairs:
        a = build(ta, ka)
        b = build(tb, kb)
        rel = (np.linalg.norm(b[4] - a[4])
               / max(np.linalg.norm(a[4]), 1e-30))
        snr = float(-20.0 * np.log10(max(rel, 1e-30)))
        ok = bool(np.isfinite(b[4]).all() and np.abs(b[4]).mean() > 0)
        sides = {"A": list(a[:3]), "B": list(b[:3])}
        ms = {"A": [], "B": []}
        for _ in range(args.rounds):
            for side in ("A", "B", "B", "A"):
                cfg, params, st = sides[side]
                st, step_ms = timed(cfg, params, st)
                sides[side][2] = st
                ms[side].append(step_ms)
                print(f"{name} [{side}] step_ms_per_chunk={step_ms:.3f}",
                      flush=True)
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        row = {"pair": name, "A": ta, "B": tb,
               "compile_s": {"A": round(a[3], 1), "B": round(b[3], 1)},
               "ms_per_chunk": ms, "B_vs_A_snr_db": round(snr, 1),
               "B_finite_nonzero": ok, "peak_bytes_in_use": int(peak)}
        print(json.dumps(row), flush=True)
        summary.append(row)
    print(json.dumps({"card": card, "device": dev.device_kind,
                      "pairs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
