"""Mode / controls cost matrix at the HEADLINE shape.

The per-chunk step time and oracle SNR for every demod mode and every
reference control (squelch, AGC hang), at the exact headline shape and
profiles bench.py times (2560 channels, 41.3 Msample chunks, process_n
N_SCAN=2). Rows "+fir3" run the passband at HIGH precision with the
rest of the fast profile, to price a precision margin.

Usage: python benchmarks/mode_matrix.py [row-names...]
Rows gate against the CPU plain-path oracle at the MID shape before
timing (hang rows are gated informationally: the kernel tail's hang
window is block-granular by design — [W, W+G] — so exact-oracle SNR on
noise is NOT a correctness bound there; tests/test_fused_controls.py
bounds its ballistics instead).
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import bench  # the shipped bench harness: gates + config constants

MIN_S = 2.0
N_SCAN = 2

FAST = dict(bench.PROFILES["fast"])
QUALITY = dict(bench.PROFILES["quality"])
FAST_FIR3 = {**FAST, "passband_precision": "high"}

# name -> (headline overrides, tuning, gate spec)
#   gate spec: ("std", mid_overrides, seed, tag) | ("nbfm",) | None
ROWS = {
    "AM fast":        ({}, FAST, ("std", {}, 2, "mid")),
    "USB fast":       (dict(mode="USB"), FAST,
                       ("std", dict(mode="USB"), 4, "midssb")),
    "USB fast+fir3":  (dict(mode="USB"), FAST_FIR3,
                       ("std", dict(mode="USB"), 4, "midssb")),
    "NBFM fast":      (dict(mode="NBFM"), FAST, ("nbfm",)),
    "AM fast squelch": (dict(squelch_enabled=True), FAST,
                        ("std", dict(squelch_enabled=True), 2, "midsq")),
    "AM fast hang":   (dict(hang_enabled=True, hang_ms=500.0), FAST,
                       ("info", dict(hang_enabled=True, hang_ms=500.0),
                        2, "midhang")),
    "USB quality":    (dict(mode="USB"), QUALITY,
                       ("std", dict(mode="USB"), 4, "midssb")),
    "NBFM quality":   (dict(mode="NBFM"), QUALITY, ("nbfm",)),
    "AM fast+fir3":   ({}, FAST_FIR3, ("std", {}, 2, "mid")),
}


def time_headline(overrides: dict, tuning: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(**{**bench.HEADLINE, **overrides},
                                  **tuning)
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)

    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        shp = (cfg.chunk_in,)
        return cx.CX(0.05 * jax.random.normal(kr, shp, jnp.float32),
                     0.05 * jax.random.normal(ki, shp, jnp.float32))

    iq1 = gen(jax.random.PRNGKey(1))
    assert np.isfinite(float(jnp.mean(jnp.abs(iq1.re[:64]))))
    iq_tup = (iq1,) * N_SCAN

    def step(st_):
        st2, outs = wideband.process_n(cfg, params, st_, iq_tup)
        return st2, outs[-1]

    def fetch(audio):
        return float(jnp.mean(jnp.abs(audio.astype(jnp.float32))))

    st, audio = step(state)
    stat0 = fetch(audio)
    assert np.isfinite(stat0), f"warmup audio bad: {stat0}"

    iters = 8
    while True:
        t0 = time.perf_counter()
        st_t = st
        for _ in range(iters):
            st_t, audio = step(st_t)
        stat = fetch(audio)
        dt = time.perf_counter() - t0
        if dt >= MIN_S or iters >= 256:
            break
        iters *= 2
    assert np.isfinite(stat), f"timed audio bad: {stat}"
    msps = N_SCAN * cfg.chunk_in * iters / dt / 1e6
    return {"msps": round(msps, 1),
            "step_ms": round(dt / iters / N_SCAN * 1e3, 2),
            "iters": iters}


def main():
    import jax
    from supersdr_jax import backend
    backend.enable_compile_cache()

    names = sys.argv[1:] or list(ROWS)
    for name in names:
        overrides, tuning, gate = ROWS[name]
        res = {"row": name}
        try:
            if gate and gate[0] in ("std", "info"):
                _, mid_over, seed, tag = gate
                g = bench._gate(tuning, {**bench.MID, **mid_over},
                                n_chunks=1, seed=seed, tag=tag)
                res["gate_snr_db"] = g[f"oracle_snr_db_{tag}"]
                res["gate_ok"] = (bool(g[f"ok_{tag}"]) if gate[0] == "std"
                                  else "informational")
            elif gate and gate[0] == "nbfm":
                g = bench._gate_nbfm(tuning)
                res["gate_snr_db"] = g["oracle_snr_db_midnbfm"]
                res["gate_ok"] = bool(g["ok_midnbfm"])
            if res.get("gate_ok") is False:
                print(json.dumps(res), flush=True)
                continue
            res.update(time_headline(overrides, tuning))
        except Exception as e:  # noqa: BLE001
            res["error"] = repr(e)[:300]
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
