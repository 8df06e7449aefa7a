"""Mesh-sharded receiver chains: channel × time parallelism over a mesh.

This is where the framework scales past one chip (BASELINE.md: ≥1 Gsample/s
aggregate, ≥80 % efficiency): the same chain as `runtime.chain`, executed
under `shard_map` over a ('chan', 'time') mesh:

  chan — virtual receivers split across devices; no communication.
  time — one long capture split into contiguous shards along the sample
         axis. Cross-shard coupling is tiny and explicit:
           * overlap-save filter history   → ppermute halo (n_taps-1 samples)
           * resampler history             → ppermute halo (per-1 samples)
           * NBFM phase memory             → ppermute halo (1 sample)
           * DC-blocker / AGC recurrences  → two-level associative scans
             (O(D) scalars all-gathered; ops/scans.py axis_name support)
         so per-device traffic is O(n_taps + D) regardless of shard length
         — the halo-exchange structure of ring attention applied to DSP.

Semantics: the sharded program is *sample-exact* equal to the single-device
chain — verified by tests on an 8-device CPU mesh — and streaming state
(entering/leaving a chunk) is fully preserved, so consecutive chunks chain
across calls exactly as the serial version does.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supersdr_jax.ops import agc as agc_ops
from supersdr_jax.ops import cx
from supersdr_jax.ops import demod as demod_ops
from supersdr_jax.ops import fir_matmul, mixer, overlap_save, resample, \
    scans, smeter
from supersdr_jax.ops import squelch as squelch_ops
from supersdr_jax.parallel.mesh import CHAN_AXIS, TIME_AXIS
from supersdr_jax.runtime import chain as chain_mod
from supersdr_jax.runtime.chain import (ChainConfig, ChainOutput, ChainParams,
                                        ChainState)


def _sharded_body(cfg: ChainConfig, params: ChainParams, state: ChainState,
                  iq: cx.CX):
    """shard_map body. iq: [C_local, N_local] split-complex. cfg.chunk must
    equal N_local. Returns (per-shard-stacked state, output)."""
    plan = cfg.os_plan
    t_idx = jax.lax.axis_index(TIME_AXIS)
    batch = iq.shape[:-1]
    n_rows = cfg.chunk // cfg.os_block
    iqc = cx.to_complex(iq)

    # 0. noise blanker (shard-local median when enabled; statically
    #    compiled out when disabled — the default)
    if cfg.blanker_enabled:
        iqc = squelch_ops.apply_blanker(params.blanker, iqc)

    # 1. NCO with per-time-shard phase base: shard t starts at t*N_local
    phase0 = jnp.mod(state.phase + t_idx.astype(jnp.float32)
                     * params.nco.block_inc, 1.0)
    _, x = mixer.mix(params.nco, phase0, iqc)
    phase_out = jnp.mod(state.phase
                        + (t_idx.astype(jnp.float32) + 1.0)
                        * params.nco.block_inc, 1.0)

    # 2. passband; history = left neighbor's tail (halo) or the incoming
    #    stream state on shard 0 — same n_taps-1 input-tail state for both
    #    filter implementations
    halo = scans.left_halo(x, plan.overlap, TIME_AXIS)
    head = jnp.where(t_idx == 0, cx.to_complex(state.os_carry), halo)
    if cfg.passband_impl == "matmul":
        _, y_cx = fir_matmul.fir_matmul_stream_c(
            cfg.fir_plan, params.W_pass, cx.split(head), cx.split(x),
            precision=cx.resolve_precision(cfg.passband_precision))
        y = cx.to_complex(y_cx)
        y_rows = y.reshape(*batch, n_rows, cfg.os_block)
    else:
        rows = x.reshape(*batch, n_rows, cfg.os_block)
        y_rows = overlap_save.overlap_save_batch_c(plan,
                                                   cx.to_complex(params.H_pass),
                                                   head, rows)
        y = y_rows.reshape(*batch, cfg.chunk)
    os_carry = cx.split(x[..., -plan.overlap:] if plan.overlap
                        else x[..., :0])

    rssi = smeter.rssi_db(y_rows)

    # 3-4. demod + AGC with exact cross-shard recurrences
    dstate, audio = demod_ops.demodulate(cfg.mode, state.demod, y,
                                         cfg.iq_rate, axis_name=TIME_AXIS)
    astate, audio = agc_ops.apply(params.agc, state.agc, audio,
                                  hang_window=cfg.hang_window,
                                  axis_name=TIME_AXIS,
                                  decimation=cfg.agc_decimation)

    # squelch gates on the local shard's RSSI (frame-granular, as the
    # KiwiSDR gates per frame — not bit-identical to the serial
    # whole-chunk gate when enabled); statically compiled out when off
    if cfg.squelch_enabled:
        sq_state, audio = squelch_ops.apply_squelch(
            params.squelch, state.squelch, audio, jnp.mean(rssi, axis=-1))
    else:
        sq_state = state.squelch

    # 5. resample; history halo in the audio domain
    if cfg.mode.upper() == "IQ":
        out_audio = cx.split(audio)
        icarry = state.interp_carry
    elif cfg.is_rational:
        # the rational resampler carries zero-stuffed-domain history;
        # reconstruct the neighbor's stuffed tail from its last
        # ceil(history/L) audio samples (stuffing phase is block-aligned
        # because the local block length is a multiple of M and the
        # stuffed block length chunk·L is a multiple of L)
        rplan = cfg.rational_plan
        audio = audio.astype(jnp.float32)
        k = -(-rplan.history // rplan.L)
        halo_in = scans.left_halo(audio, k, TIME_AXIS)
        up_halo = jnp.zeros(halo_in.shape[:-1] + (k * rplan.L,),
                            jnp.float32)
        up_halo = up_halo.at[..., :: rplan.L].set(halo_in)
        ihalo = up_halo[..., -rplan.history:]
        ihead = jnp.where(t_idx == 0, state.interp_carry, ihalo)
        icarry, out_audio = resample.rational_resample_block(
            rplan, params.P_interp, ihead, audio)
    else:
        iplan = cfg.interp_plan
        audio = audio.astype(jnp.float32)
        ihalo = scans.left_halo(audio, iplan.history, TIME_AXIS)
        ihead = jnp.where(t_idx == 0, state.interp_carry, ihalo)
        icarry, out_audio = resample.interpolate(iplan, params.P_interp,
                                                 ihead, audio,
                                                 cfg.resample_impl)
    new_state = ChainState(phase=phase_out, os_carry=os_carry, demod=dstate,
                           agc=astate, interp_carry=icarry,
                           squelch=sq_state)
    # stack a leading per-time-shard axis so the caller can take shard D-1
    stacked = jax.tree.map(lambda s: s[None], new_state)
    return stacked, ChainOutput(audio=out_audio, rssi=rssi,
                                baseband=cx.split(y))


def build(cfg: ChainConfig, mesh: Mesh):
    """Compile the sharded chain for `mesh`. cfg.chunk is the *per-device*
    time-shard length. Returns process(params, state, iq) where
      iq    : [n_chan, chunk * n_time_shards]  sharded P(chan, time)
      state : leaves with leading [n_chan] axis, sharded P(chan)
    and the returned state is the end-of-chunk stream state (from the last
    time shard), directly usable for the next call.
    """
    n_time = mesh.shape[TIME_AXIS]
    if cfg.passband_impl == "matmul_real":
        raise ValueError("passband_impl='matmul_real' is serial-only for "
                         "now (its rotation params are passband-dependent "
                         "structure); use 'matmul' on the mesh")

    def cxspec(*p):
        return cx.CX(P(*p), P(*p))

    params_spec = ChainParams(
        nco=mixer.NCOParams(ramp=P(CHAN_AXIS, None), block_inc=P(CHAN_AXIS)),
        H_pass=cxspec(), P_interp=P(),
        agc=jax.tree.map(lambda _: P(), agc_ops.make_params(cfg.iq_rate)),
        squelch=jax.tree.map(lambda _: P(), squelch_ops.make_squelch()),
        blanker=jax.tree.map(lambda _: P(), squelch_ops.make_blanker()),
        W_pass=P() if cfg.passband_impl == "matmul" else None,
    )
    state_spec = ChainState(
        phase=P(CHAN_AXIS),
        os_carry=cxspec(CHAN_AXIS, None),
        demod=demod_ops.DemodState(last_sample=cxspec(CHAN_AXIS),
                                   dc_x=P(CHAN_AXIS), dc_y=P(CHAN_AXIS)),
        agc=agc_ops.AGCState(peak_db=P(CHAN_AXIS), gain_db=P(CHAN_AXIS)),
        interp_carry=P(CHAN_AXIS, None),
        squelch=squelch_ops.SquelchState(open_=P(CHAN_AXIS),
                                         gain=P(CHAN_AXIS)),
    )
    out_state_spec = jax.tree.map(
        lambda p: P(TIME_AXIS, *p), state_spec,
        is_leaf=lambda x: isinstance(x, P))
    audio_spec = (cxspec(CHAN_AXIS, TIME_AXIS) if cfg.mode.upper() == "IQ"
                  else P(CHAN_AXIS, TIME_AXIS))
    out_spec = (out_state_spec,
                ChainOutput(audio=audio_spec,
                            rssi=P(CHAN_AXIS, TIME_AXIS),
                            baseband=cxspec(CHAN_AXIS, TIME_AXIS)))

    body = partial(_sharded_body, cfg)
    sharded = jax.shard_map(body, mesh=mesh,
                            in_specs=(params_spec, state_spec,
                                      cxspec(CHAN_AXIS, TIME_AXIS)),
                            out_specs=out_spec, check_vma=False)

    state_shardings = jax.tree.map(lambda p: NamedSharding(mesh, p),
                                   state_spec,
                                   is_leaf=lambda x: isinstance(x, P))

    @jax.jit
    def _process_cx(params: ChainParams, state: ChainState, iq: cx.CX):
        stacked, out = sharded(params, state, iq)
        final = jax.tree.map(lambda s: s[-1], stacked)
        # pin the returned state to the SAME sharding the next call expects:
        # without this the output sharding differs from the input spec and
        # every state-chained call re-lowers/recompiles (measured 1.5 s per
        # step vs 50 ms on the CPU mesh)
        final = jax.tree.map(
            lambda a, s: jax.lax.with_sharding_constraint(a, s),
            final, state_shardings)
        return final, out

    def process(params: ChainParams, state: ChainState, iq):
        """iq: [n_chan, chunk·n_time] — CX or complex numpy (split
        host-side; complex64 never touches the program boundary)."""
        # place the state on the mesh up front so the first call and every
        # chained call share one jit signature (one compile, not two)
        state = jax.device_put(state, state_shardings)
        return _process_cx(params, state, cx.as_cx(iq))

    return process


def make_params(cfg: ChainConfig, n_chan: int,
                freq_offsets_hz: np.ndarray | float = 0.0,
                **kwargs) -> ChainParams:
    """Per-channel params for the sharded chain: freq offsets broadcast to
    [n_chan]; everything else as chain.make_params."""
    offs = np.broadcast_to(np.asarray(freq_offsets_hz, np.float64), (n_chan,))
    return chain_mod.make_params(cfg, freq_offset_hz=offs, **kwargs)


def init_state(cfg: ChainConfig, n_chan: int) -> ChainState:
    return chain_mod.init_state(cfg, (n_chan,))
