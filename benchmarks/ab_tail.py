"""The chain tail alone on the GPU: the Triton kernel (ops/pallas/
chain_tail.py) against the XLA tail it replaces, at the headline's 2560
channels × 16128 samples per chunk.

Times one jitted tail call each (passband output y in, channel-major
audio and state out: the kernel's side includes the demodulating
transpose that feeds it and the transpose of its audio), in turns
A B B A, and checks the kernel's audio against the XLA tail's. Needs
the GPU.

    python benchmarks/ab_tail.py [--configs am,nbfm-hs] [--rounds N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

CONFIGS = {
    "am": ("AM", False, False),
    "usb": ("USB", False, False),
    "nbfm": ("NBFM", False, False),
    "am-hs": ("AM", True, True),
    "nbfm-hs": ("NBFM", True, True),
}
SHAPE = (2560, 16128)        # channels, samples per chunk (the headline)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="am,nbfm-hs")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--min-s", type=float, default=0.5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from supersdr_jax import backend
    from supersdr_jax.runtime import chain

    backend.enable_compile_cache()
    card = bench.card()
    print("card:", card, "device:", bench.device_info(), flush=True)
    C, n = SHAPE
    key = jax.random.PRNGKey(0)
    kr, ki, kl = jax.random.split(key, 3)
    level = jnp.exp(jax.random.normal(kl, (C, 1)) * 2.0) * 0.1
    y = jax.lax.complex(jax.random.normal(kr, (C, n)),
                        jax.random.normal(ki, (C, n))) * level
    rssi = jnp.full((C, 1), -60.0, jnp.float32)

    def timed(f, *a):
        out = f(*a)
        jax.block_until_ready(out)
        iters = 8
        while True:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = f(*a)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            if dt >= args.min_s or iters >= 1024:
                return dt / iters * 1e3
            iters *= 2

    rows = []
    for name in args.configs.split(","):
        mode, hang, sq = CONFIGS[name]
        cfg = chain.ChainConfig(mode=mode, iq_rate=12000, audio_rate=48000,
                                chunk=n, os_block=n, n_taps=257,
                                nco_enabled=False, hang_enabled=hang,
                                squelch_enabled=sq)
        params = chain.make_params(cfg, freq_offset_hz=np.zeros(C),
                                   agc_kwargs=dict(hang=hang),
                                   squelch_kwargs=dict(enabled=sq))
        st = chain.init_state(cfg, (C,))
        fx = jax.jit(chain.tail_xla, static_argnums=0)
        t0 = time.perf_counter()
        ref = np.asarray(fx(cfg, params, st, y, rssi)[4])
        print(f"{name}: xla compile+run {time.perf_counter() - t0:.1f} s",
              flush=True)
        fk = jax.jit(chain.tail_kernel, static_argnums=0)
        t0 = time.perf_counter()
        got = np.asarray(fk(cfg, params, st, y, rssi)[4])
        comp = time.perf_counter() - t0
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        ms = {"xla": [], "kernel": []}
        for _ in range(args.rounds):
            for side in ("xla", "kernel", "kernel", "xla"):
                f = fx if side == "xla" else fk
                ms[side].append(round(timed(f, cfg, params, st, y, rssi),
                                      4))
        row = {"config": name, "kernel_compile_s": round(comp, 1),
               "max_rel_err": err, "ms": ms}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
