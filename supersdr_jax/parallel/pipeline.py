"""Pipeline parallelism: stage-split wideband over a 2-device mesh axis.

SURVEY.md §2a lists stage pipelining (channelize → demod across mesh
slices) as the optional "PP" axis. This implements the 2-stage GPipe
pattern natively: device 0 runs the PFB on microbatch i while device 1
runs the receiver chains on microbatch i−1, with the inter-stage
activation handed off by ONE `ppermute` hop per microbatch and the whole
schedule expressed as a `lax.scan` (one pipeline bubble at fill, one at
drain).

SPMD note: both devices trace both stage computations, but the stages
are dispatched under `jax.lax.cond` on the device's stage id, so at
runtime each device executes only its own stage — the cond is the
standard mechanism for heterogeneous stages under `shard_map`.

Honest assessment: for this workload the Ulysses
reshard (`parallel/sharded_wideband.py`) is strictly better — one
all_to_all with both phases parallel over ALL devices versus a pipeline
that idles half the mesh per stage imbalance. The pipeline exists for
workloads with strong stage locality (e.g. stage-resident state too big
to reshard) and to complete the parallelism surface.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from supersdr_jax.ops import channelizer, cx
from supersdr_jax.runtime import chain as chain_mod
from supersdr_jax.runtime import wideband as wb

AXIS = "pp"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:2]
    if len(devices) != 2:
        devices = list(devices)[:2]
    return Mesh(np.asarray(devices), (AXIS,))


def build(cfg: wb.WidebandConfig, mesh: Mesh):
    """Compile the 2-stage pipelined wideband.

    Returns process(params, state, iq_microbatches) where
    iq_microbatches: [M, chunk_in] complex/CX — M microbatches; output
    audio [M, n_chan, chunk_per_chan·L] (microbatch i's audio appears at
    scan step i+1; the returned array is already realigned).
    """
    if mesh.devices.size != 2:
        raise ValueError("the 2-stage pipeline uses exactly 2 devices")
    plan = wb.pfb_plan(cfg)
    ccfg = cfg.chain_cfg
    n_chan = cfg.n_chan
    frames = cfg.chunk_per_chan
    L, M_ = ccfg.resample_LM
    out_len = frames * L // M_
    # the inter-stage payload: PFB channels as float planes packed into
    # the audio-shaped buffer (2·frames floats ≤ out_len when L/M ≥ 2)
    if out_len < 2 * frames:
        raise ValueError("audio upsample < 2x: enlarge the payload packing")

    def pfb_stage(carry_pfb, iq_c):
        pfb_carry, chans = channelizer.channelize_c(
            plan, carry_pfb["W"], cx.to_complex(carry_pfb["c"]), iq_c)
        payload = jnp.zeros((n_chan, out_len), jnp.float32)
        payload = payload.at[:, :frames].set(chans.real)
        payload = payload.at[:, frames:2 * frames].set(chans.imag)
        return {"W": carry_pfb["W"], "c": cx.split(pfb_carry)}, payload

    def chain_stage(carry_chain, payload):
        chans = cx.CX(payload[:, :frames], payload[:, frames:2 * frames])
        cstate, out = chain_mod.process_traced(ccfg, carry_chain["p"],
                                               carry_chain["s"], chans)
        return {"p": carry_chain["p"], "s": cstate}, out.audio

    def body(params: wb.WidebandParams, state: wb.WidebandState,
             iq_mb: cx.CX):
        me = jax.lax.axis_index(AXIS)
        n_mb = iq_mb.shape[0]

        pfb_c = {"W": params.W_pfb, "c": state.pfb_carry}
        chain_c = {"p": params.chain, "s": state.chain}

        def step(carry, inp):
            mb, is_drain = inp
            pfb_c, chain_c, inflight = carry
            iq_c = cx.to_complex(mb)

            def run_pfb(args):
                pfb_c, chain_c, _ = args
                pfb_c2, payload = pfb_stage(pfb_c, iq_c)
                # the drain step feeds zeros; keep the real stream carry
                pfb_c2 = {"W": pfb_c2["W"],
                          "c": jax.tree.map(
                              lambda new, old: jnp.where(is_drain, old, new),
                              pfb_c2["c"], pfb_c["c"])}
                return pfb_c2, chain_c, payload

            def run_chain(args):
                pfb_c, chain_c, inflight = args
                chain_c2, audio = chain_stage(chain_c, inflight)
                return pfb_c, chain_c2, audio

            pfb_c, chain_c, out = jax.lax.cond(
                me == 0, run_pfb, run_chain, (pfb_c, chain_c, inflight))
            # hand the stage-0 payload to stage 1 for the next step
            sent = jax.lax.ppermute(out, AXIS, perm=[(0, 1)])
            return (pfb_c, chain_c, sent), out

        zero_payload = jnp.zeros((n_chan, out_len), jnp.float32)
        # one drain step so the last microbatch's audio emerges
        mbs = cx.CX(
            jnp.concatenate([iq_mb.re, jnp.zeros_like(iq_mb.re[:1])]),
            jnp.concatenate([iq_mb.im, jnp.zeros_like(iq_mb.im[:1])]))
        is_drain = jnp.arange(n_mb + 1) >= n_mb
        (pfb_c, chain_c, _), outs = jax.lax.scan(
            step, (pfb_c, chain_c, zero_payload), (mbs, is_drain))
        # each stage's state/output is only valid on ITS device; gather
        # and select so the replicated outputs agree (PFB carry lives on
        # device 0, chain state and audio on device 1)
        from_0 = lambda x: jax.lax.all_gather(x, AXIS)[0]
        from_1 = lambda x: jax.lax.all_gather(x, AXIS)[1]
        audio = from_1(outs)[1:]   # outs[i] on dev1 = microbatch i-1
        new_state = wb.WidebandState(
            pfb_carry=jax.tree.map(from_0, pfb_c["c"]),
            chain=jax.tree.map(from_1, chain_c["s"]))
        return new_state, audio

    state_spec = jax.tree.map(lambda _: P(), wb.init_state(cfg),
                              is_leaf=lambda x: hasattr(x, "dtype"))
    params_spec = jax.tree.map(lambda _: P(), wb.make_params(cfg),
                               is_leaf=lambda x: hasattr(x, "dtype"))
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(params_spec, state_spec, cx.CX(P(), P())),
        out_specs=(state_spec, P()), check_vma=False)
    jitted = jax.jit(sharded)
    from jax.sharding import NamedSharding
    state_shardings = jax.tree.map(lambda p: NamedSharding(mesh, p),
                                   state_spec,
                                   is_leaf=lambda x: isinstance(x, P))

    def process(params, state, iq_microbatches):
        # pre-place the state: one jit signature for host-initialized and
        # chained device states (avoids a second compile on call 2)
        state = jax.device_put(state, state_shardings)
        return jitted(params, state, cx.as_cx(iq_microbatches))

    return process
