"""Mesh-sharded wideband channelizer pipeline (the Ulysses-style reshard).

Two phases with different natural shardings (SURVEY.md §5):

  1. channelize — the wideband input is *time*-sharded across all devices;
     each shard runs the PFB locally with its filter history brought in by
     a multi-hop halo exchange (`left_context`), exactly as the serial
     carry would provide.
  2. demodulate — receivers are *channel*-parallel; an `all_to_all`
     re-shards [n_chan, frames] from time-split to channel-split, after
     which each device runs full-length chains for its channel subset with
     zero further communication.

The all_to_all moves each device's [n_chan, frames_local] once — the DSP
analog of the attention-head transpose in DeepSpeed-Ulysses — and XLA
hands it to NCCL over NVLink. Output audio is channel-sharded, ready for channel-parallel sinks.

The mesh also takes int16 IQ (the KiwiSDR wire format, reference
kiwi/client.py:443-454), dequantized per shard, and `process_n` runs N
consecutive chunks in ONE mesh program with tuple outputs (the serial
runtime/wideband.process_n dispatch amortization). Audio rows are in PFB
bin order, as on the serial path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supersdr_jax.ops import cx, scans
from supersdr_jax.runtime import chain as chain_mod
from supersdr_jax.runtime import wideband as wb

AXIS = "dev"

I16_SCALE = 1.0 / 32768.0


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def build(cfg: wb.WidebandConfig, mesh: Mesh):
    """Compile the sharded wideband pipeline.

    Constraints: n_devices divides n_chan and chunk_in; the per-device
    input slice must be a multiple of n_chan.
    Returns process(params, state, iq[chunk_in]) -> (state, audio, rssi)
    with audio [n_chan, chunk_per_chan·L] channel-sharded (time-major
    configs: [chunk_per_chan·L, n_chan]), rows in PFB bin order.
    `process.process_n(params, state, iqs)` is the N-chunk tuple-output
    variant (serial `wideband.process_n` semantics); both accept CX,
    complex numpy, or (re_i16, im_i16) int16 pairs per chunk.
    """
    d = mesh.devices.size
    if cfg.n_chan % d or cfg.chunk_in % (d * cfg.n_chan):
        raise ValueError("n_devices must divide n_chan and chunk_in/n_chan")
    plan = wb.pfb_plan(cfg)
    ccfg = cfg.chain_cfg

    def dequant(v16):
        return v16.astype(jnp.float32) * I16_SCALE

    def bcast_last(v: cx.CX) -> cx.CX:
        """Broadcast the LAST shard's PFB tail to every device via a
        binomial ppermute tree (log₂ d rounds; ppermute forbids fan-out
        pairs) instead of an all_gather — received bytes stay
        O(history) per device instead of O(d·history)."""
        if d == 1:
            return v
        idx = jax.lax.axis_index(AXIS)
        rp = (d - 1) - idx          # relabeled rank: source is rp == 0

        def one(x):
            cur = x
            step = 1
            while step < d:
                perm = [(d - 1 - sp, d - 1 - (sp + step))
                        for sp in range(step) if sp + step < d]
                recv = jax.lax.ppermute(cur, AXIS, perm=perm)
                cur = jnp.where((rp >= step) & (rp < 2 * step), recv, cur)
                step *= 2
            return cur

        return cx.CX(one(v.re), one(v.im))

    def halo_head(state, re_like, im_like):
        """History head for this shard's channelizer: multi-hop halo
        from the left (f32 CX either way — i16 halos dequantize; the
        head is history-sized, a tiny buffer), shard 0 takes the
        carried stream state."""
        idx = jax.lax.axis_index(AXIS)
        halo_r = scans.left_context(re_like, plan.history, AXIS)
        halo_i = scans.left_context(im_like, plan.history, AXIS)
        if halo_r.dtype == jnp.int16:
            halo_r, halo_i = dequant(halo_r), dequant(halo_i)
        head_r = jnp.where(idx == 0, state.pfb_carry.re, halo_r)
        head_i = jnp.where(idx == 0, state.pfb_carry.im, halo_i)
        return cx.CX(head_r, head_i)

    def step(params: wb.WidebandParams, state: wb.WidebandState, iq):
        """One chunk on the mesh (traced, per-shard view)."""
        i16 = isinstance(iq, tuple) and not isinstance(iq, cx.CX)
        if i16:
            re_in, im_in = iq
        else:
            re_in, im_in = iq.re, iq.im
        head = halo_head(state, re_in, im_in)
        tail_r = re_in[..., -plan.history:]
        tail_i = im_in[..., -plan.history:]
        if i16:
            re_in, im_in = dequant(re_in), dequant(im_in)
            tail_r, tail_i = dequant(tail_r), dequant(tail_i)
        pfb_tail = cx.CX(tail_r, tail_i)

        _, chans = wb.channelize_dispatch(cfg, params,
                                          cx.to_complex(head),
                                          jax.lax.complex(re_in, im_in))
        # chans: [n_chan, frames_local]

        # ---- reshard: time-split -> channel-split (all_to_all)
        # [n_chan, f_local] -> [n_chan/d, f_local*d]
        chans = jax.lax.all_to_all(chans, AXIS, split_axis=0, concat_axis=1,
                                   tiled=True)

        # ---- phase 2: channel-parallel chains, full time on-device
        cstate, out = chain_mod.process_traced(ccfg, params.chain,
                                               state.chain, cx.split(chans))
        audio = out.audio
        if cfg.time_major:
            audio = jnp.swapaxes(audio, -1, -2).astype(
                wb._audio_np_dtype(cfg))
        last = bcast_last(pfb_tail)
        return (wb.WidebandState(pfb_carry=last, chain=cstate),
                audio, out.rssi)

    def cxspec(*p):
        return cx.CX(P(*p), P(*p))

    chain_param_spec = jax.tree.map(lambda _: P(), chain_mod.make_params(ccfg))
    chain_param_spec = chain_param_spec._replace(
        nco=chain_param_spec.nco._replace(ramp=P(AXIS, None),
                                          block_inc=P(AXIS)))
    params_spec = wb.WidebandParams(W_pfb=P(), chain=chain_param_spec)
    chain_state_spec = jax.tree.map(lambda _: P(AXIS), chain_mod.init_state(
        ccfg, (d,)))
    chain_state_spec = chain_state_spec._replace(
        os_carry=cxspec(AXIS, None), interp_carry=P(AXIS, None),
        demod=chain_state_spec.demod._replace(last_sample=cxspec(AXIS)))
    state_spec = wb.WidebandState(pfb_carry=cxspec(), chain=chain_state_spec)
    audio_spec = P(None, AXIS) if cfg.time_major else P(AXIS, None)
    state_shardings = jax.tree.map(lambda p: NamedSharding(mesh, p),
                                   state_spec,
                                   is_leaf=lambda x: isinstance(x, P))

    _jitted = {}       # per-chunk input kinds -> jitted mesh program

    def _iq_spec(kind):
        return ((P(AXIS), P(AXIS)) if kind == "i16" else cxspec(AXIS))

    def _get(kinds):
        if kinds in _jitted:
            return _jitted[kinds]
        n = len(kinds)

        def body(params, state, iqs):
            outs = []
            st = state
            rssi = None
            for iq in iqs:
                st, audio, rssi = step(params, st, iq)
                outs.append(audio)
            return st, tuple(outs), rssi

        in_specs = (params_spec, state_spec,
                    tuple(_iq_spec(k) for k in kinds))
        out_specs = (state_spec, tuple(audio_spec for _ in range(n)),
                     P(AXIS, None))
        sharded = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs, check_vma=False)
        fn = jax.jit(sharded)
        _jitted[kinds] = fn
        return fn

    def _coerce(iq):
        if wb._is_i16_pair(iq):
            return ("i16", (jnp.asarray(iq[0], jnp.int16),
                            jnp.asarray(iq[1], jnp.int16)))
        return ("cx", cx.as_cx(iq))

    def process_n(params, state, iqs):
        """N consecutive chunks in ONE mesh program, TUPLE audio outputs
        (serial wideband.process_n semantics); each chunk a CX /
        complex numpy / (re_i16, im_i16) pair. Returns
        (state, audios_tuple, rssi_of_last_chunk)."""
        pairs = [_coerce(q) for q in iqs]
        kinds = tuple(k for k, _ in pairs)
        state = jax.device_put(state, state_shardings)
        return _get(kinds)(params, state, tuple(v for _, v in pairs))

    def process(params, state, iq):
        """iq: [chunk_in] — CX / complex numpy / (re_i16, im_i16)."""
        st, audios, rssi = process_n(params, state, (iq,))
        return st, audios[0], rssi

    process.process_n = process_n
    # the jitted mesh program for HLO inspection (tests/comm model):
    # kinds = per-chunk input kind tuple, e.g. ("cx",) or ("i16", "cx")
    process.get_jitted = _get
    return process


def make_params(cfg: wb.WidebandConfig, **kw) -> wb.WidebandParams:
    return wb.make_params(cfg, **kw)


def init_state(cfg: wb.WidebandConfig) -> wb.WidebandState:
    return wb.init_state(cfg)
