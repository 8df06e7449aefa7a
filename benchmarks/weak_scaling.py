"""Weak-scaling of the time-sharded chain on an N-virtual-device CPU mesh.

A structural rehearsal of scaling, next to the HLO-measured collective
volumes (`parallel/comm_model.py`): a weak-scaling run on the JAX CPU
backend with N forced host devices,
fixed per-device work, comparing wall time at D=1 vs D=2,4,8. On CPU the
"devices" share physical cores, so ideal weak scaling shows *flat or
sub-linear* time growth from parallel overheads only — collectives,
halo exchange, scan summaries — which is exactly the overhead the ≥80 %
scaling-efficiency goal needs bounded. Prints one JSON line per D.

KNOWN LIMITATION: CPU host-core contention is indistinguishable from
collective overhead here, so this signal is a loose upper bound only.
Multi-GPU evidence is the mesh path on four cards (chip_smoke.py
--four) and the HLO collective counts/volumes asserted chunk-invariant
in tests/test_comm_model.py. Keep this harness for trend smoke only; do
not read its ratios as efficiency.

Run: python benchmarks/weak_scaling.py  (self-contained; forces CPU)
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8"
                               ).strip()

import numpy as np  # noqa: E402


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from supersdr_jax.parallel import mesh as mesh_mod
    from supersdr_jax.parallel import sharded_chain
    from supersdr_jax.runtime import chain

    n_chan, shard = 8, 16384          # fixed per-device work
    results = []
    for d in (1, 2, 4, 8):
        cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                                chunk=shard, os_block=shard, n_taps=257)
        m = mesh_mod.make_mesh(n_chan=1, n_time=d,
                               devices=jax.devices()[:d])
        params = sharded_chain.make_params(cfg, n_chan,
                                           freq_offsets_hz=500.0)
        state = sharded_chain.init_state(cfg, n_chan)
        process = sharded_chain.build(cfg, m)
        rng = np.random.default_rng(0)
        iq = ((rng.normal(size=(n_chan, shard * d))
               + 1j * rng.normal(size=(n_chan, shard * d))) * 0.1
              ).astype(np.complex64)
        st, out = process(params, state, iq)       # compile + warmup
        s = float(np.mean(np.abs(np.asarray(out.audio))))
        assert np.isfinite(s) and s > 0
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            st, out = process(params, st, iq)
        s = float(np.mean(np.abs(np.asarray(out.audio))))  # fetch-forced
        dt = (time.perf_counter() - t0) / iters
        total_samples = n_chan * shard * d
        results.append({"devices": d, "step_ms": round(dt * 1e3, 1),
                        "samples_per_step": total_samples,
                        "msps_virtual": round(total_samples / dt / 1e6, 1)})
        print(json.dumps(results[-1]), flush=True)

    base = results[0]["step_ms"]
    for r in results:
        # weak-scaling efficiency on shared cores: ideal = flat step time
        r["weak_eff_vs_1dev"] = round(base / r["step_ms"], 3)

    # The clean structural number: SAME total work (8 shards' worth) as one
    # serial program vs the 8-way sharded program, on the same silicon.
    # The gap isolates what sharding adds: halo exchange, scan summaries,
    # shard_map partitioning — the overhead the ICI-efficiency model bounds.
    d = 8
    ser_cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                                chunk=shard * d, os_block=shard, n_taps=257)
    ser_params = chain.make_params(ser_cfg,
                                   freq_offset_hz=np.full(n_chan, 500.0))
    ser_state = chain.init_state(ser_cfg, (n_chan,))
    rng = np.random.default_rng(0)
    iq = ((rng.normal(size=(n_chan, shard * d))
           + 1j * rng.normal(size=(n_chan, shard * d))) * 0.1
          ).astype(np.complex64)
    st, out = chain.process(ser_cfg, ser_params, ser_state, iq)
    float(np.mean(np.abs(np.asarray(out.audio))))
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        st, out = chain.process(ser_cfg, ser_params, st, iq)
    float(np.mean(np.abs(np.asarray(out.audio))))
    ser_ms = (time.perf_counter() - t0) / iters * 1e3
    shard_ms = results[-1]["step_ms"]
    print(json.dumps({"summary": results,
                      "serial_same_work_ms": round(ser_ms, 1),
                      "sharded_8dev_ms": round(shard_ms, 1),
                      "sharding_overhead_pct":
                          round((shard_ms / ser_ms - 1.0) * 100.0, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
