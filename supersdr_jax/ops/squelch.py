"""Squelch and noise blanker — the two remaining server-side DSP controls.

The reference drives them blind over the wire (`SET squelch=<on> max=<th>`,
`SET nb=<gate> th=<thresh>`, /root/reference/kiwi/client.py:251-259); here
they are native block ops:

  Squelch — gate audio when the channel RSSI falls below a threshold, with
  hysteresis (open at thresh, close at thresh - hyst_db) and a short
  open/close ramp to avoid clicks. The gate state is a carried scalar; the
  per-block decision uses the block RSSI, matching the KiwiSDR's
  frame-granular squelch behavior.

  Noise blanker — impulse suppression on the pre-demod IQ: samples whose
  envelope exceeds `thresh_ratio` × the block's median envelope are
  replaced by a short linear interpolation (approximated by zeroing with a
  smooth window), the classic gated blanker. Fully vectorized.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SquelchParams(NamedTuple):
    enabled: jax.Array       # 0/1
    thresh_db: jax.Array     # open threshold (RSSI dB)
    hyst_db: jax.Array       # close at thresh - hyst
    ramp: jax.Array          # per-sample gain slew (e.g. 1/240 = 5 ms @48k)


def make_squelch(enabled: bool = False, thresh_db: float = -100.0,
                 hyst_db: float = 6.0, ramp_samples: int = 240
                 ) -> SquelchParams:
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return SquelchParams(enabled=f32(1.0 if enabled else 0.0),
                         thresh_db=f32(thresh_db), hyst_db=f32(hyst_db),
                         ramp=f32(1.0 / max(ramp_samples, 1)))


class SquelchState(NamedTuple):
    open_: jax.Array   # gate state (0/1)
    gain: jax.Array    # current ramp gain 0..1


def init_squelch(batch_shape: tuple[int, ...] = ()) -> SquelchState:
    return SquelchState(open_=jnp.ones(batch_shape, jnp.float32),
                        gain=jnp.ones(batch_shape, jnp.float32))


def gate_ramp(params: SquelchParams, state: SquelchState,
              rssi_db: jax.Array, n: int
              ) -> tuple[SquelchState, tuple[jax.Array, ...]]:
    """Gate decision for one block of n samples from its RSSI [*batch]:
    hysteresis on the open state, then the linear gain ramp toward the
    gate target. Params broadcast against [*batch, 1]. Returns (new
    state, (g0, step, lo, hi)), each [*batch, 1], with the ramp
    gain(t) = clip(g0 + step·t, lo, hi) for t = 1..n."""
    open_prev = state.open_
    opens = (rssi_db >= params.thresh_db).astype(jnp.float32)
    closes = (rssi_db < params.thresh_db - params.hyst_db).astype(jnp.float32)
    open_now = jnp.clip(open_prev + opens - closes, 0.0, 1.0)
    open_now = jnp.where(params.enabled > 0, open_now,
                         jnp.ones_like(open_now))
    target = open_now[..., None]
    g0 = state.gain[..., None]
    step = jnp.sign(target - g0) * params.ramp
    lo = jnp.minimum(g0, target)
    hi = jnp.maximum(g0, target)
    # carried gain in CLOSED FORM (the t=n ramp value): returning the
    # last element of the full-size gain tensor would make it a program
    # output and stop XLA from fusing it into the audio multiply
    g_last = jnp.clip(g0 + step * n, lo, hi)[..., 0]
    return SquelchState(open_=open_now, gain=g_last), (g0, step, lo, hi)


def apply_squelch(params: SquelchParams, state: SquelchState,
                  audio: jax.Array, rssi_db: jax.Array
                  ) -> tuple[SquelchState, jax.Array]:
    """audio [*batch, n]; rssi_db [*batch] block RSSI. Gate with
    hysteresis; gain ramps linearly toward the gate target within the
    block."""
    n = audio.shape[-1]
    new_state, (g0, step, lo, hi) = gate_ramp(params, state, rssi_db, n)
    t = jnp.arange(1, n + 1, dtype=jnp.float32)
    return new_state, audio * jnp.clip(g0 + step * t, lo, hi)


class BlankerParams(NamedTuple):
    enabled: jax.Array
    thresh_ratio: jax.Array  # envelope / median-envelope trigger


def make_blanker(enabled: bool = False, thresh_ratio: float = 6.0
                 ) -> BlankerParams:
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return BlankerParams(enabled=f32(1.0 if enabled else 0.0),
                         thresh_ratio=f32(thresh_ratio))


def apply_blanker(params: BlankerParams, iq: jax.Array,
                  spread: int = 2) -> jax.Array:
    """Suppress impulse noise in an IQ block [*batch, n]. The blank mask is
    dilated by ±`spread` samples to cover pulse skirts."""
    env = jnp.abs(iq)
    med = jnp.median(env, axis=-1, keepdims=True)
    hit = env > params.thresh_ratio * jnp.maximum(med, 1e-12)
    mask = hit
    for s in range(1, spread + 1):
        mask = mask | jnp.roll(hit, s, axis=-1) | jnp.roll(hit, -s, axis=-1)
    blanked = jnp.where(mask, jnp.zeros_like(iq), iq)
    return jnp.where(params.enabled > 0, blanked, iq)
