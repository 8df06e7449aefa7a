"""On-chip stage-level A/B for the receiver-chain hot ops at the
HEADLINE batch shape ([2560 chans, 16128 samples]).

Each variant is timed fetch-forced after a device-side norm agreement
check against the first variant of its group. Stage numbers guide which
variants graduate to the full-pipeline A/B (`bench.py` defaults only
move on oracle-gated full-pipeline wins).

Groups:
  pass   — Toeplitz-matmul passband (fir_matmul) structure/precision
  res    — 4× interpolator implementations
  agc    — AGC ballistics (cummax formulation)

Usage: python benchmarks/ab_stages.py [group|variant ...]
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

NCH = 2560
N = 16128
N_TAPS = 257
MIN_S = 2.0


def main():
    import jax
    import jax.numpy as jnp
    from supersdr_jax import backend
    backend.enable_compile_cache()
    from supersdr_jax.ops import agc as agc_ops
    from supersdr_jax.ops import cx, fir_matmul, firdesign, resample

    # device-generated inputs
    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        return cx.CX(jax.random.normal(kr, (NCH, N), jnp.float32),
                     jax.random.normal(ki, (NCH, N), jnp.float32))

    x_cx = gen(jax.random.PRNGKey(0))
    assert np.isfinite(float(jnp.sum(x_cx.re[:, :4])))
    xr = x_cx.re

    taps = firdesign.complex_bandpass_taps(-5000.0, 5000.0, 12000, n=N_TAPS)
    fplan = fir_matmul.plan_for(N, N_TAPS)
    Wp = fir_matmul.build_w(fplan, taps)
    fcarry = fir_matmul.init_carry(fplan, (NCH,))

    HIGH = jax.lax.Precision.HIGH
    HIGHEST = jax.lax.Precision.HIGHEST
    DEFAULT = jax.lax.Precision.DEFAULT

    def fir_v(prec):
        @jax.jit
        def f(c, xx):
            return fir_matmul.fir_matmul_stream_c(fplan, Wp, c, xx,
                                                  precision=prec)
        return f

    def fir_flat(prec):
        # flatten the [NCH, nb] batch into the matmul M dim explicitly
        B = fplan.block
        W2 = Wp

        @jax.jit
        def f(c, xx):
            zr = fir_matmul._windows(fplan, c.re, xx.re)
            zi = fir_matmul._windows(fplan, c.im, xx.im)
            z = jnp.concatenate([zr, zi], axis=-1)
            nb = z.shape[-2]
            z2 = z.reshape(NCH * nb, z.shape[-1])
            y2 = jax.lax.dot_general(z2, W2, (((1,), (0,)), ((), ())),
                                     precision=prec,
                                     preferred_element_type=jnp.float32)
            yr = y2[:, :B].reshape(NCH, nb * B)
            yi = y2[:, B:].reshape(NCH, nb * B)
            nc = cx.CX(xx.re[..., -fplan.overlap:], xx.im[..., -fplan.overlap:])
            return nc, cx.CX(yr, yi)
        return f

    def fir_bf16():
        Wb = Wp.astype(jnp.bfloat16)

        @jax.jit
        def f(c, xx):
            zr = fir_matmul._windows(fplan, c.re, xx.re)
            zi = fir_matmul._windows(fplan, c.im, xx.im)
            z = jnp.concatenate([zr, zi], axis=-1).astype(jnp.bfloat16)
            y2 = jnp.einsum("...bs,so->...bo", z, Wb,
                            preferred_element_type=jnp.float32)
            B = fplan.block
            yr = y2[..., :B].reshape(NCH, -1)
            yi = y2[..., B:].reshape(NCH, -1)
            nc = cx.CX(xx.re[..., -fplan.overlap:], xx.im[..., -fplan.overlap:])
            return nc, cx.CX(yr, yi)
        return f

    iplan, P = resample.design_interp(12000, 48000)
    itaps = firdesign.lowpass_taps(6000.0, 48000)
    implan = resample.plan_interp_matmul(iplan, N)
    Wi = resample.build_w_interp(implan, itaps)
    icarry = resample.init_carry(iplan, (NCH,))
    Pj = jnp.asarray(P, jnp.float32)

    def res_v(impl):
        @jax.jit
        def f(c, xx):
            return resample.interpolate(iplan, Pj, c, xx, impl)
        return f

    @jax.jit
    def res_matmul(c, xx):
        return resample.interpolate_matmul(implan, Wi, c, xx)

    ap = agc_ops.make_params(12000)
    ast = agc_ops.init_state((NCH,))

    @jax.jit
    def agc_v(st, xx):
        return agc_ops.apply(ap, st, xx)

    variants = {
        "pass_high": ("fir", fir_v(HIGH)),
        "pass_highest": ("fir", fir_v(HIGHEST)),
        "pass_default": ("fir", fir_v(DEFAULT)),
        "pass_flat_high": ("fir", fir_flat(HIGH)),
        "pass_bf16": ("fir", fir_bf16()),
        "res_einsum": ("res", res_v("einsum")),
        "res_fma": ("res", res_v("fma")),
        "res_matmul": ("res", res_matmul),
        "agc": ("agc", agc_v),
    }
    names = sys.argv[1:] or list(variants)
    names = [n for pat in names for n in
             ([pat] if pat in variants else
              [v for v in variants if v.startswith(pat)])]

    @jax.jit
    def norm_of(y):
        if isinstance(y, cx.CX):
            return jnp.sqrt(jnp.sum(y.re * y.re) + jnp.sum(y.im * y.im))
        return jnp.sqrt(jnp.sum(y * y))

    refs = {}
    for name in names:
        group, f = variants[name]
        state0 = {"fir": fcarry, "res": icarry, "agc": ast}[group]
        xin = x_cx if group == "fir" else xr
        try:
            st, y = f(state0, xin)
            s = float(norm_of(y))
            assert np.isfinite(s) and s > 0
            rel = 0.0
            if group in refs:
                rel = abs(s - refs[group]) / refs[group]
            else:
                refs[group] = s
            iters = 8
            while True:
                t0 = time.perf_counter()
                for _ in range(iters):
                    st, y = f(st, xin)
                sf = float(norm_of(y))
                dt = time.perf_counter() - t0
                if dt >= MIN_S or iters >= 256:
                    break
                iters *= 2
            assert np.isfinite(sf)
            print(json.dumps({"variant": name,
                              "stage_ms": round(dt / iters * 1e3, 3),
                              "norm_rel": f"{rel:.2e}",
                              "iters": iters}), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"variant": name, "error": repr(e)[:300]}),
                  flush=True)


if __name__ == "__main__":
    main()
