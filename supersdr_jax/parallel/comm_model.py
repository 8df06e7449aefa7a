"""Collective-traffic accounting for the sharded pipelines.

Substantiates the ≥80 % scaling-efficiency north star (BASELINE.md)
structurally: the per-device, per-chunk collective volume of the
time-sharded chain is O(n_taps + D) *samples* — independent of the local
chunk length — so compute grows linearly with chunk while communication
stays constant. Two complementary views:

  * `collective_bytes_from_hlo` — ground truth: parse the compiled HLO of
    an actual sharded program and sum the bytes moved by every
    collective-permute / all-gather / all-to-all. This is what XLA will
    really put on the wire.
  * `chain_comm_model` / `wideband_comm_model` — the analytic model
    (halos + scan summaries + reshard volume) the docs cite; tests assert
    it matches the HLO within a small slack.

`scaling_efficiency` turns bytes into a projected efficiency on a given
interconnect (default: H100 SXM NVLink, 450 GB/s each way per card — the
published figure, not a measurement) vs a single-card step time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_DTYPE_BYTES = {"f32": 4, "c64": 8, "f16": 2, "bf16": 2, "s32": 4,
                "u32": 4, "f64": 8, "c128": 16, "pred": 1, "s8": 1,
                "u8": 1}

_COLLECTIVE_RE = re.compile(
    r"= *([a-z0-9]+)\[([0-9,]*)\][^\n]*?"
    r"\b(all-gather|collective-permute|all-to-all|all-reduce|"
    r"reduce-scatter)\b")


@dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict
    total_bytes: int

    def __str__(self):
        ops = ", ".join(f"{op}: {n}x/{self.bytes_by_op[op]}B"
                        for op, n in sorted(self.counts.items()))
        return f"collectives per step: {ops}; total {self.total_bytes} B"


def collective_bytes_from_hlo(hlo_text: str) -> CollectiveStats:
    """Sum per-device received bytes of every collective in compiled HLO.

    Shapes in HLO are per-participant buffer shapes: an all-gather
    result [D, ...] means each device materializes the full gathered
    buffer; a collective-permute result is the received halo.
    """
    counts: dict = {}
    bytes_by_op: dict = {}
    total = 0
    for dt, shape, op in _COLLECTIVE_RE.findall(hlo_text):
        n = 1
        for d in filter(None, shape.split(",")):
            n *= int(d)
        b = n * _DTYPE_BYTES.get(dt, 4)
        counts[op] = counts.get(op, 0) + 1
        bytes_by_op[op] = bytes_by_op.get(op, 0) + b
        total += b
    return CollectiveStats(counts, bytes_by_op, total)


def lower_hlo(jitted, *args) -> str:
    return jitted.lower(*args).compile().as_text()


# ---------------------------------------------------------------------------
# analytic models (bytes received per device per chunk)
# ---------------------------------------------------------------------------

def chain_comm_model(cfg, n_time: int, n_chan_local: int = 1) -> dict:
    """Per-device received bytes per chunk for the time-sharded chain
    (parallel/sharded_chain.py). Complex samples count as 8 B (two f32
    planes)."""
    halos = 0
    # overlap-save history halo: n_taps-1 complex samples per channel
    halos += n_chan_local * (cfg.n_taps - 1) * 8
    # resampler history halo (audio domain, f32)
    if cfg.mode.upper() != "IQ":
        if cfg.is_rational:
            k = -(-(cfg.rational_plan.history) // cfg.rational_plan.L)
            halos += n_chan_local * k * 4
        else:
            halos += n_chan_local * cfg.interp_plan.history * 4
    # NBFM / DC-block neighbor sample (1 complex or 1 f32 per channel)
    halos += n_chan_local * 8
    # associative-scan summaries: all-gather of (a, b) last elements per
    # shard → D × 2 scalars per scan; scans: DC-block linear (AM), AGC
    # maxplus + AGC linear
    n_scans = 3 if cfg.mode.upper() == "AM" else 2
    summaries = n_scans * n_time * 2 * 4 * n_chan_local
    # hang sliding-max halo (only when compiled in)
    if cfg.hang_enabled:
        halos += n_chan_local * (cfg.hang_window - 1) * 4
    return {"halo_bytes": halos, "summary_bytes": summaries,
            "total_bytes": halos + summaries}


def wideband_comm_model(cfg, d: int) -> dict:
    """Per-device received bytes per chunk for the sharded wideband
    pipeline (parallel/sharded_wideband.py): PFB history halo + the
    all-to-all reshard (the one volume collective) + the carry gather."""
    from supersdr_jax.runtime import wideband as wb
    plan = wb.pfb_plan(cfg)
    halo = plan.history * 8                       # PFB history, complex
    frames_local = cfg.chunk_in // d // plan.hop
    # tiled all-to-all of a [n_chan, frames_local] complex buffer
    a2a = cfg.n_chan * frames_local * 8 * (d - 1) // d
    carry_gather = plan.history * 8   # pfb-carry fan-out ppermute
    return {"halo_bytes": halo, "all_to_all_bytes": a2a,
            "carry_bytes": carry_gather,
            "total_bytes": halo + a2a + carry_gather}


# H100 SXM NVLink: 900 GB/s to the other cards of the host, 450 GB/s
# each way (NVIDIA data sheet; published, not measured here).
NVLINK_GBPS = 450.0
# Per-collective launch/latency term of the α-β model. No published
# figure: 2 µs is an assumption, deliberately on the slow side for a
# small NCCL collective inside one host. Not measured.
LINK_ALPHA_S = 2e-6


def scaling_efficiency(compute_s_per_chunk: float, comm_bytes: int,
                       link_gbps: float = NVLINK_GBPS, overlap: float = 0.0
                       ) -> float:
    """Projected efficiency = compute / (compute + (1-overlap)·comm_time).

    link_gbps: directional per-card link bandwidth. Bandwidth-only —
    prefer `scaling_efficiency_ab` (adds the per-collective latency term
    that dominates for the small halo/summary exchanges)."""
    comm_s = comm_bytes / (link_gbps * 1e9)
    return compute_s_per_chunk / (compute_s_per_chunk
                                  + (1.0 - overlap) * comm_s)


def comm_time_ab(n_collectives: int, comm_bytes: int,
                 alpha_s: float = LINK_ALPHA_S,
                 link_gbps: float = NVLINK_GBPS, hops: int = 1) -> float:
    """α-β estimate: each collective pays `hops`·α launch/propagation
    latency plus bytes/βeff. The α term is what the bandwidth-only model
    misses: the chain's per-step exchanges are a few KB, so the β term
    is tens of ns while each collective costs ~µs to launch —
    latency-dominated, not bandwidth-dominated."""
    return n_collectives * hops * alpha_s + comm_bytes / (link_gbps * 1e9)


def scaling_efficiency_ab(compute_s_per_chunk: float, n_collectives: int,
                          comm_bytes: int, alpha_s: float = LINK_ALPHA_S,
                          link_gbps: float = NVLINK_GBPS, hops: int = 1,
                          overlap: float = 0.0) -> float:
    """Latency-aware projected efficiency (α-β).

    `n_collectives` comes from `collective_bytes_from_hlo(...).counts`
    of the real compiled program — test-asserted O(1) in the chunk
    length (compute scales, launches don't), which is why efficiency
    *improves* with chunk size even in the latency-dominated regime."""
    comm_s = comm_time_ab(n_collectives, comm_bytes, alpha_s, link_gbps,
                          hops)
    return compute_s_per_chunk / (compute_s_per_chunk
                                  + (1.0 - overlap) * comm_s)
