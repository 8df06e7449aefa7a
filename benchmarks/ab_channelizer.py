"""On-chip A/B of channelizer implementations at the HEADLINE shape.

Times ONLY the channelizer stage (input [chunk_in] split-complex on
device → chans [M, n_frames] split-complex, fetch-forced) for each
variant, after checking numerics against the legacy path at the same
shape. Stage-level numbers guide which variants graduate to the
full-pipeline A/B (`ab_gpu.py` / `bench.py`) — defaults are only
flipped on full-pipeline, oracle-gated wins (isolated micro-benchmarks
mislead).

Usage: python benchmarks/ab_channelizer.py [variant-names...]
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

M = 2560
K = 8
CHUNK = 2560 * (16384 - 256)
MIN_S = 2.0


def main():
    import jax
    import jax.numpy as jnp
    from supersdr_jax import backend
    backend.enable_compile_cache()
    from supersdr_jax.ops import channelizer as ch
    from supersdr_jax.ops import cx

    plan, proto = ch.design(M, K)
    W = ch.taps_matrix(plan, proto)
    rng = np.random.default_rng(0)
    x = ((rng.normal(size=CHUNK) + 1j * rng.normal(size=CHUNK)) * 0.05
         ).astype(np.complex64)
    x_dev = cx.as_cx(x)
    carry0 = ch.init_carry(plan)

    HIGH = jax.lax.Precision.HIGH
    HIGHEST = jax.lax.Precision.HIGHEST

    def legacy(mxu):
        @jax.jit
        def f(c, xx):
            c2, y = ch.channelize_c(plan, W, cx.to_complex(c),
                                    cx.to_complex(xx), mxu_fft=mxu)
            return cx.split(c2), cx.split(y)
        return f

    def mxu2(fold, prec):
        @jax.jit
        def f(c, xx):
            c2, y = ch.channelize_mxu2_c(plan, W, cx.to_complex(c),
                                         cx.to_complex(xx), fold_impl=fold,
                                         precision=prec)
            return cx.split(c2), cx.split(y)
        return f

    variants = {
        "legacy_mxufft": legacy(True),
        "legacy_hlofft": legacy(False),
        "mxu2_slices": mxu2("slices", HIGHEST),
        "mxu2_conv": mxu2("conv", HIGHEST),
        "mxu2_slices_high": mxu2("slices", HIGH),
    }
    names = sys.argv[1:] or list(variants)

    # reference output statistic for cross-variant agreement (device-side
    # norm of the full output — fetch-forced, catches layout mistakes)
    @jax.jit
    def stat_of(y):
        return jnp.sqrt(jnp.sum(y.re * y.re) + jnp.sum(y.im * y.im)), \
            jnp.sum(y.re[:, : 4] * y.im[:, : 4])

    ref_stat = None
    for name in names:
        f = variants[name]
        try:
            c2, y = f(carry0, x_dev)
            s, probe = stat_of(y)
            s, probe = float(s), float(probe)
            assert np.isfinite(s) and s > 0
            if ref_stat is None:
                ref_stat = (s, probe)
            rel = abs(s - ref_stat[0]) / ref_stat[0]
            prel = abs(probe - ref_stat[1]) / max(abs(ref_stat[1]), 1e-9)
            iters = 4
            while True:
                t0 = time.perf_counter()
                for _ in range(iters):
                    c2, y = f(c2, x_dev)
                sf = float(stat_of(y)[0])
                dt = time.perf_counter() - t0
                if dt >= MIN_S or iters >= 128:
                    break
                iters *= 2
            assert np.isfinite(sf) and sf > 0
            print(json.dumps({"variant": name,
                              "stage_ms": round(dt / iters * 1e3, 2),
                              "norm_rel_vs_first": f"{rel:.2e}",
                              "probe_rel_vs_first": f"{prel:.2e}",
                              "iters": iters}), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"variant": name, "error": repr(e)[:300]}),
                  flush=True)


if __name__ == "__main__":
    main()
