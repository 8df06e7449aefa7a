"""GPU chain tail: DC block → AGC (with hang) → squelch → L× resample, as
one Pallas kernel through Triton.

The XLA tail (runtime/chain.py) builds every recurrence of the back half
of the receiver chain from log-depth scans over whole [C, n] planes, and
each level re-reads a plane from device memory. Here each program owns
BC contiguous channels of the time-major demodulated plane ([n, C]: one
thread per channel, so every row load and store coalesces) and walks the
chunk's samples in order, carrying the DC blocker, AGC peak and gain,
hang ring and resampler history in registers. The plane is read once
and the audio is written once.

The demodulator's own arithmetic (AM envelope, SSB real part, NBFM
discriminator) has no recurrence, so it stays in XLA, fused into the
transpose that makes the plane time-major; only the AM DC blocker's
recurrence runs here. Loads run one tile ahead: the K rows of the next
tile are issued before the K samples of the current one are computed,
so their latency hides behind that arithmetic.

Semantics are those of the XLA ops (ops/demod.py, ops/agc.py,
ops/squelch.py, ops/resample.interpolate) sample for sample, with one
exception: the AGC hang's sliding-window max is taken at block
granularity (blocks of G samples from the chunk start; the window covers
between W and W + G samples, never fewer than W). Within a chunk no
longer than W + 1 samples the two agree exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from supersdr_jax.ops.agc import ENV_FLOOR, MANUAL_UNITY_DB

BC = 32            # channels per program: one warp, one thread each
K = 16             # samples per loop step (loads issued together)
MAX_G = 256        # hang block length (samples)
_LOG10_E20 = 20.0 / np.log(10.0)
_LN10_D20 = np.log(10.0) / 20.0
_NEG = -3.0e38

# params vector layout (f32): see `params_vector`
N_PAR = 9


def state_rows(per: int) -> int:
    """Rows of the packed stream state: DC blocker x and y (AM), AGC
    peak, gain, then the resampler history (per − 1 rows, oldest
    first)."""
    return 4 + per - 1


def hang_block(n: int) -> int:
    """Hang block length G: a multiple of K dividing n, at most MAX_G."""
    q = n // K
    g = max(d for d in range(1, MAX_G // K + 1) if q % d == 0)
    return g * K


def _tail_kernel(par_ref, x_ref, st_ref, *rest, n: int, L: int, per: int,
                 taps: tuple, dc_block: bool, hang_blocks: int,
                 squelch: bool):
    if squelch:
        sq_ref, audio_ref, st_out_ref = rest
    else:
        audio_ref, st_out_ref = rest
    cols = pl.ds(pl.program_id(0) * BC, BC)
    (dc_pole, decay, thresh, slope, target, man_gain, agc_on, attack,
     hang_on) = (par_ref[i] for i in range(N_PAR))
    max_gain = target - thresh
    knee = slope / jnp.maximum(-thresh, 1e-6)
    man_db = man_gain - MANUAL_UNITY_DB
    hang = hang_blocks > 0
    G = hang_block(n) if hang else n
    tiles_per_block = G // K
    n_tiles = n // K
    if squelch:
        g0, step, lo, hi = (sq_ref[i, cols] for i in range(4))

    def load_tile(i):
        return tuple(x_ref[i * K + k, cols] for k in range(K))

    def sample(s, a, t):
        dc_x, dc_y, peak, gain, bmax, rmax, pu, hist = s
        if dc_block:
            dc_y = (a - dc_x) + dc_pole * dc_y
            dc_x = a
            a = dc_y
        env_db = _LOG10_E20 * jnp.log(jnp.maximum(jnp.abs(a), ENV_FLOOR))
        peak = jnp.maximum(peak - decay, env_db)
        if hang:
            bmax = jnp.maximum(bmax, peak)
            pu = jnp.where(hang_on > 0, jnp.maximum(bmax, rmax), peak)
        else:
            pu = peak
        auto = jnp.where(pu <= thresh, max_gain,
                         (target - pu) + knee * (pu - thresh))
        g_t = jnp.where(agc_on > 0, auto, man_db)
        gain = attack * gain + (1.0 - attack) * g_t
        a = a * jnp.exp(_LN10_D20 * gain)
        if squelch:
            tt = (t + 1).astype(jnp.float32)
            a = a * jnp.minimum(jnp.maximum(g0 + step * tt, lo), hi)
        seg = hist + (a,)
        outs = []
        for q in range(L):
            acc = None
            for m in range(per):
                w = taps[m * L + q]
                if w == 0.0:
                    continue
                term = w * seg[m]
                acc = term if acc is None else acc + term
            outs.append(acc)
        return (dc_x, dc_y, peak, gain, bmax, rmax, pu, seg[1:]), outs

    def tile_step(i, carry):
        s, cur = carry
        nxt = load_tile(jnp.minimum(i + 1, n_tiles - 1))
        for k in range(K):
            t = i * K + k
            s, outs = sample(s, cur[k], t)
            for q in range(L):
                audio_ref[t * L + q, cols] = outs[q].astype(audio_ref.dtype)
        return s, nxt

    def block_step(b, carry):
        # ring: maxima of the previous hang_blocks blocks' raw peaks
        s, cur, ring = carry
        rmax = ring[0]
        for r in ring[1:]:
            rmax = jnp.maximum(rmax, r)
        s = s[:4] + (jnp.full_like(s[2], _NEG), rmax) + s[6:]
        s, cur = jax.lax.fori_loop(
            b * tiles_per_block, (b + 1) * tiles_per_block, tile_step,
            (s, cur))
        return s, cur, ring[1:] + (s[4],)

    dc_x, dc_y, peak, gain = (st_ref[i, cols] for i in range(4))
    hist = tuple(st_ref[4 + m, cols] for m in range(per - 1))
    neg = jnp.full_like(peak, _NEG)
    s = (dc_x, dc_y, peak, gain, neg, neg, peak, hist)
    cur = load_tile(0)
    if hang:
        ring = (neg,) * hang_blocks
        s, cur, ring = jax.lax.fori_loop(0, n // G, block_step,
                                         (s, cur, ring))
        # the carried peak is the held value (agc.apply stores the
        # post-hang peak), within a chunk the tracker chains the raw one
        s = s[:2] + (jnp.where(hang_on > 0, s[6], s[2]),) + s[3:]
    else:
        s, cur = jax.lax.fori_loop(0, n_tiles, tile_step, (s, cur))
    dc_x, dc_y, peak, gain, _, _, _, hist = s
    for i, v in enumerate((dc_x, dc_y, peak, gain) + hist):
        st_out_ref[i, cols] = v


def params_vector(agc, dc_pole) -> jax.Array:
    """[N_PAR] f32 runtime scalars: DC blocker pole, AGC decay/sample,
    thresh, slope, target, manual gain, on, attack, hang flag."""
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in (
        dc_pole, agc.decay_per_sample_db, agc.thresh_db, agc.slope_db,
        agc.target_db, agc.man_gain_db, agc.on, agc.attack_coeff,
        agc.hang)])


def chain_tail(xT: jax.Array, state: jax.Array, params: jax.Array,
               P: np.ndarray, *, dc_block: bool, hang_window: int = 0,
               squelch: jax.Array | None = None, audio_dtype=jnp.float32,
               interpret: bool = False) -> tuple[jax.Array, jax.Array]:
    """Run the tail on one chunk.

    xT:         [n, C] time-major demodulated plane (n % K == 0): the AM
                envelope, the SSB real part or the NBFM discriminator.
    state:      [state_rows(per), C] packed stream state.
    params:     [N_PAR] from `params_vector`.
    P:          [per, L] polyphase matrix (resample.plan_interp); static.
    dc_block:   run the AM DC blocker first (its state rows pass through
                untouched otherwise).
    hang_window: AGC hang window in samples (≤ 1: hang not compiled in).
    squelch:    None, or [4, C] per-channel gate ramp (g0, step, lo, hi)
                from squelch.gate_ramp — the gate then multiplies the
                audio before the resampler, as the XLA chain does.
    Returns (audioT [n·L, C] in audio_dtype, new state [rows, C]).
    """
    n, C = xT.shape
    if n % K:
        raise ValueError(f"chunk length must be a multiple of {K}")
    per, L = P.shape
    rows = state_rows(per)
    if state.shape != (rows, C):
        raise ValueError(f"state must be [{rows}, {C}]")
    Cp = -(-C // BC) * BC

    def pad(a):
        return a if Cp == C else jnp.pad(a, ((0, 0), (0, Cp - C)))

    inputs = [params.astype(jnp.float32), pad(xT.astype(jnp.float32)),
              pad(state.astype(jnp.float32))]
    if squelch is not None:
        inputs.append(pad(squelch.astype(jnp.float32)))
    hang_blocks = (-(-(hang_window - 1) // hang_block(n))
                   if hang_window > 1 else 0)
    taps = tuple(float(v) for v in np.asarray(P, np.float64).reshape(-1))
    audio, st = pl.pallas_call(
        partial(_tail_kernel, n=n, L=L, per=per, taps=taps,
                dc_block=dc_block, hang_blocks=hang_blocks,
                squelch=squelch is not None),
        out_shape=(jax.ShapeDtypeStruct((n * L, Cp), audio_dtype),
                   jax.ShapeDtypeStruct((rows, Cp), jnp.float32)),
        grid=(Cp // BC,),
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="chain_tail",
    )(*inputs)
    return audio[:, :C], st[:, :C]
