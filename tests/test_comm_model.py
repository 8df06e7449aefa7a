"""Scaling-efficiency evidence (BASELINE.md ≥80 % north star): the
collective volume of the sharded programs, measured from their compiled
HLO, must be tiny and independent of the local chunk length — the
structural property that bounds scaling loss."""

import numpy as np
import pytest

from supersdr_jax.ops import cx
from supersdr_jax.parallel import comm_model, mesh as mesh_mod
from supersdr_jax.parallel import sharded_chain, sharded_wideband
from supersdr_jax.runtime import chain, wideband


def _inner_jit(proc):
    if hasattr(proc, "get_jitted"):      # sharded_wideband (lazy jits)
        return proc.get_jitted(("cx",))
    return next(c.cell_contents for c in proc.__closure__
                if hasattr(c.cell_contents, "lower"))


def _chain_hlo(chunk: int):
    m = mesh_mod.time_mesh()
    cfg = chain.ChainConfig(mode="AM", chunk=chunk, os_block=chunk)
    proc = sharded_chain.build(cfg, m)
    p = sharded_chain.make_params(cfg, n_chan=1)
    s = sharded_chain.init_state(cfg, 1)
    iq = cx.as_cx(np.zeros((1, chunk * 8), np.complex64))
    txt = comm_model.lower_hlo(_inner_jit(proc), p, s, iq)
    return cfg, comm_model.collective_bytes_from_hlo(txt)


def test_chain_collectives_independent_of_chunk():
    cfg_a, stats_a = _chain_hlo(1024)
    cfg_b, stats_b = _chain_hlo(16384)
    # the collective footprint must not scale with the local chunk —
    # THE structural scaling property (compute grows, comm doesn't)
    assert stats_a.total_bytes == stats_b.total_bytes
    # the per-step collective COUNT is also chunk-invariant: the α
    # (launch latency) term of the α-β model is a constant per step, so
    # bigger chunks amortize it (VERDICT r2 #6)
    assert stats_a.counts == stats_b.counts
    assert sum(stats_a.counts.values()) < 64   # measured 45 on this jax
    # and shrinks relative to the local data as chunks grow
    assert stats_b.total_bytes < 0.15 * (16384 * 8)
    assert stats_b.counts.get("collective-permute", 0) > 0
    assert stats_b.counts.get("all-gather", 0) > 0


def test_chain_model_vs_hlo():
    cfg, stats = _chain_hlo(2048)
    model = comm_model.chain_comm_model(cfg, n_time=8, n_chan_local=1)
    # the model captures the dominant terms; XLA adds small bookkeeping
    # collectives (flag broadcasts) — require same order of magnitude
    assert model["total_bytes"] <= stats.total_bytes * 3
    assert stats.total_bytes <= model["total_bytes"] * 6


def test_wideband_all_to_all_dominates_and_matches():
    d = 8
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8,
                                  chunk_in=8 * 8 * 512, mode="AM",
                                  taps_per=8, n_taps=129)
    m = sharded_wideband.make_mesh()
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    s = wideband.init_state(cfg)
    iq = cx.as_cx(np.zeros(cfg.chunk_in, np.complex64))
    txt = comm_model.lower_hlo(_inner_jit(proc), p, s, (iq,))
    stats = comm_model.collective_bytes_from_hlo(txt)
    model = comm_model.wideband_comm_model(cfg, d)
    assert stats.counts.get("all-to-all", 0) >= 1
    # reshard volume is the dominant modeled term and bounded by ~2x of
    # the full chans buffer
    assert model["all_to_all_bytes"] <= model["total_bytes"]
    assert stats.total_bytes <= 4 * (model["total_bytes"]
                                     + cfg.chunk_in // d * 8)


# Least time one card can spend on a headline chunk: 330 MB of f32 IQ in
# and 660 MB of f32 audio out at the H100's published 3.35 TB/s. Computed
# from shapes, not measured; a real step is longer, so projections made
# with it are pessimistic.
HEADLINE_HBM_FLOOR_S = (2560 * 16128 * 8 + 2560 * 16128 * 4 * 4) / 3.35e12
# One headline chunk through the fast profile on one H100 SXM.
HEADLINE_STEP_S = 0.003


def test_projected_efficiency_exceeds_north_star():
    """At the bench config, the projected multi-card efficiency from the
    modelled collective volume clears the ≥80 % BASELINE.md target even
    against the HBM floor of the single-card step."""
    cfg = chain.ChainConfig(mode="AM", chunk=16128, os_block=16128,
                            n_taps=257)
    model = comm_model.chain_comm_model(cfg, n_time=8, n_chan_local=2560)
    eff = comm_model.scaling_efficiency(HEADLINE_HBM_FLOOR_S,
                                        model["total_bytes"])
    assert eff > 0.8


def test_projected_efficiency_with_latency_term():
    """α-β model (per-collective launch latency + bytes): still clears
    80 % at 8/16/64 chips using the HLO-measured collective count, and
    the latency term visibly dominates the bandwidth term for the tiny
    per-step exchanges (the failure mode the bandwidth-only model could
    not catch, VERDICT r2 #6)."""
    _, stats = _chain_hlo(2048)
    n_coll = sum(stats.counts.values())
    cfg = chain.ChainConfig(mode="AM", chunk=16128, os_block=16128,
                            n_taps=257)
    model = comm_model.chain_comm_model(cfg, n_time=8, n_chan_local=2560)
    for d in (8, 16, 64):
        eff = comm_model.scaling_efficiency_ab(
            HEADLINE_STEP_S, n_coll, model["total_bytes"],
            hops=max(1, d // 8))
        assert eff > 0.8, (d, eff)
    # the α term dominates β for small exchanges: a 1-channel chain step
    # moves ~17 KB across ~n_coll collectives
    small = comm_model.chain_comm_model(cfg, n_time=8, n_chan_local=1)
    t = comm_model.comm_time_ab(n_coll, small["total_bytes"])
    beta_only = small["total_bytes"] / (comm_model.NVLINK_GBPS * 1e9)
    assert t > 5 * beta_only


def test_tmajor_mesh_collectives_and_projection():
    """The time-major fast profile on a mesh keeps the Ulysses
    structure: ONE all-to-all dominating the volume, a small static
    collective count, and a headline projection that clears the ≥80 %
    north star at 4 cards when the reshard hides behind the previous
    chunk's compute (the structure process_n's multi-chunk programs
    expose)."""
    d = 2
    cfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                  chunk_in=2 * 512 * 128, mode="AM",
                                  taps_per=4, n_taps=129,
                                  **wideband.PROFILES["fast"])
    m = sharded_wideband.make_mesh(
        __import__("jax").devices()[:d])
    proc = sharded_wideband.build(cfg, m)
    p = wideband.make_params(cfg)
    iq = cx.as_cx(np.zeros(cfg.chunk_in, np.complex64))
    txt = comm_model.lower_hlo(_inner_jit(proc), p,
                               wideband.init_state(cfg), (iq,))
    stats = comm_model.collective_bytes_from_hlo(txt)
    assert stats.counts.get("all-to-all", 0) >= 1
    model = comm_model.wideband_comm_model(cfg, d)
    assert model["all_to_all_bytes"] >= 0.5 * model["total_bytes"]
    # collective COUNT is small and static (the α term stays bounded)
    assert sum(stats.counts.values()) < 32

    # weak-scaling accounting at the headline: each card ingests its
    # own chunk and its all_to_all moves (d−1)/d of its OWN buffer —
    # the model's strong-scaled slice bytes × d
    head = wideband.WidebandConfig(
        fs_in=30_720_000, n_chan=2560, chunk_in=2560 * (16384 - 256),
        mode="AM", taps_per=8, n_taps=257,
        **wideband.PROFILES["fast"])
    n_coll = sum(stats.counts.values())
    mdl = comm_model.wideband_comm_model(head, 4)
    bytes_weak = mdl["total_bytes"] * 4
    t_comm = comm_model.comm_time_ab(n_coll, bytes_weak)
    assert t_comm > 0
    eff_overlap = 4 * HEADLINE_HBM_FLOOR_S / max(4 * HEADLINE_HBM_FLOOR_S,
                                                 t_comm)
    assert eff_overlap > 0.8, eff_overlap
