"""Device-time breakdown of the headline step from a jax.profiler trace.

For each variant, warms the two-chunk step (wideband.process_n at
bench.HEADLINE) up, traces a few steps, and reduces the trace of the
first GPU: device time per kernel name (summed over all events and
streams), and the busy share of the traced window (union of kernel
intervals over the window from the first kernel start to the last
kernel end). Prints one JSON line per variant. Needs the GPU.

    python benchmarks/trace_step.py [--variants fast,fast-xla-tail]
        [--steps 3] [--top 15] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
from collections import defaultdict

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def reduce_trace(path: str, plane_prefix: str = "/device:GPU:0") -> dict:
    """Per-kernel device time (ns) and busy share of one device plane."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_kernel = defaultdict(int)
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_kernel[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise RuntimeError(f"no events on a plane named {plane_prefix}*")
    spans.sort()
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return {"kernels_ns": dict(per_kernel), "busy_ns": busy,
            "window_ns": window}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="fast,fast-xla-tail")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    import bench
    from supersdr_jax import backend
    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    backend.enable_compile_cache()
    dev = bench.device_info()
    card = bench.card()
    variants = {
        "fast": dict(wideband.PROFILES["fast"]),
        "fast-xla-tail": {**wideband.PROFILES["fast"], "tail_impl": "xla"},
        "quality": dict(wideband.PROFILES["quality"]),
    }
    iq16 = bench.gen_i16(bench.HEADLINE["chunk_in"])
    iq = cx.CX(iq16[0].astype("float32") / 32768.0,
               iq16[1].astype("float32") / 32768.0)
    for name in args.variants.split(","):
        cfg = wideband.WidebandConfig(**bench.HEADLINE, **variants[name])
        params = wideband.make_params(cfg)
        st = wideband.init_state(cfg)
        for _ in range(2):
            st, outs = wideband.process_n(cfg, params, st, (iq, iq))
        jax.block_until_ready(outs)
        out_dir = args.out or tempfile.mkdtemp()
        tdir = os.path.join(out_dir, name)
        with jax.profiler.trace(tdir):
            for _ in range(args.steps):
                st, outs = wideband.process_n(cfg, params, st, (iq, iq))
            jax.block_until_ready(outs)
        path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        red = reduce_trace(path)
        chunks = 2 * args.steps
        top = sorted(red["kernels_ns"].items(), key=lambda kv: -kv[1])
        print(json.dumps({
            "variant": name, "card": card, "device": dev,
            "chunks": chunks,
            "busy_ms_per_chunk": red["busy_ns"] / chunks / 1e6,
            "window_ms_per_chunk": red["window_ns"] / chunks / 1e6,
            "idle_share": 1.0 - red["busy_ns"] / red["window_ns"],
            "top_kernels_ms_per_chunk": {
                k: v / chunks / 1e6 for k, v in top[:args.top]},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
