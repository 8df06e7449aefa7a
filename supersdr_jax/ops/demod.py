"""Demodulators: AM / SSB (USB, LSB) / CW / NBFM / IQ.

The reference delegates demodulation to the KiwiSDR server's DSP and only
selects it by name over the wire (`SET mod=…`, /root/reference/
utils_supersdr.py:976-980, kiwi/client.py:217-245). Here each mode is a
pure block function on the *already passband-filtered* complex baseband
signal produced by `ops.overlap_save` (the passband is the mode's channel
filter, per `ops.passband` conventions):

  USB/LSB  audio = Re{y}: the one-sided complex bandpass makes y analytic,
           so the real part is the SSB audio (LSB's passband is the mirror
           negative-frequency band).
  CW       identical to USB; the dial-frequency convention already places
           the carrier at +CW_PITCH inside the 400..800 Hz passband
           (supersdr.py:664,709).
  AM       envelope |y| followed by a streaming DC blocker.
  NBFM     phase-difference discriminator angle(y[n]·conj(y[n-1])),
           scaled to ±1 at ±max_deviation.
  IQ       pass-through (complex out), as the library's iq mode
           (kiwi/client.py:443-454).

Every demod is (carry, y) → (carry, audio) with static shapes, so chains
vmap over a channel axis and scan over time.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from supersdr_jax.ops import cx, scans

# NBFM discriminator mute floor on |Re p| + |Im p| of the product
# p = y[n]·conj(y[n−1]): below it the angle is numerical noise (and
# differs across backends that flush denormals and those that keep
# them), so the discriminator outputs 0 there.
# 1e-12 ≈ both samples under −120 dBFS, far below the int16 wire floor.
NBFM_MUTE_FLOOR = 1e-12

# AM DC blocker pole
DC_POLE = 0.999


class DemodState(NamedTuple):
    """Streaming state shared across modes (unused fields stay zero).

    last_sample: final complex input of the previous block (NBFM memory),
                 carried split-complex like every boundary value
    dc_x, dc_y:  DC-blocker state (AM)
    """
    last_sample: cx.CX
    dc_x: jax.Array
    dc_y: jax.Array


def init_state(batch_shape: tuple[int, ...] = ()) -> DemodState:
    f = jnp.zeros(batch_shape, jnp.float32)
    return DemodState(last_sample=cx.zeros(batch_shape), dc_x=f, dc_y=f)


def demod_ssb(state: DemodState, y: jax.Array) -> tuple[DemodState, jax.Array]:
    """USB / LSB / CW: real part of the analytic (one-sided) signal."""
    return state, y.real.astype(jnp.float32)


def demod_am(state: DemodState, y: jax.Array, dc_r: float = DC_POLE,
             axis_name: str | None = None) -> tuple[DemodState, jax.Array]:
    """Envelope detector with streaming DC removal (one-pole blocker)."""
    env = jnp.abs(y).astype(jnp.float32)
    audio, (dc_x, dc_y) = scans.dc_block(env, dc_r, state.dc_x, state.dc_y,
                                         axis_name=axis_name)
    return state._replace(dc_x=dc_x, dc_y=dc_y), audio


def demod_nbfm(state: DemodState, y: jax.Array, fs: float,
               max_dev_hz: float = 5000.0, axis_name: str | None = None
               ) -> tuple[DemodState, jax.Array]:
    """Quadrature discriminator; output ±1 at ±max_dev_hz deviation."""
    last = cx.to_complex(state.last_sample)
    first = jnp.broadcast_to(last, y[..., 0].shape)
    if axis_name is not None:
        neighbor = scans.left_halo(y, 1, axis_name)[..., 0]
        idx = jax.lax.axis_index(axis_name)
        first = jnp.where(idx == 0, first, neighbor)
    prev = jnp.concatenate([first[..., None], y[..., :-1]], axis=-1)
    prod = y * jnp.conj(prev)
    dphi = jnp.angle(prod).astype(jnp.float32)
    mag = (jnp.abs(jnp.real(prod)) + jnp.abs(jnp.imag(prod))
           ).astype(jnp.float32)
    dphi = jnp.where(mag > NBFM_MUTE_FLOOR, dphi, 0.0)
    scale = fs / (2.0 * jnp.pi * max_dev_hz)
    audio = dphi * scale
    return state._replace(last_sample=cx.split(y[..., -1])), audio


def demod_iq(state: DemodState, y: jax.Array) -> tuple[DemodState, jax.Array]:
    return state, y


MODE_IDS = {"USB": 0, "LSB": 0, "CW": 0, "AM": 1, "NBFM": 2}


def demodulate_runtime(state: DemodState, y: jax.Array, fs: float,
                       mode_id: jax.Array, max_dev_hz: float = 5000.0
                       ) -> tuple[DemodState, jax.Array]:
    """Runtime-dispatched demodulator: `mode_id` [*batch] int32 selects
    per batch row (0 = SSB/CW, 1 = AM, 2 = NBFM — `MODE_IDS`).

    All three demods evaluate (cheap elementwise work on small
    interactive chunks) and a where-select keeps the right one, so a
    mode change on any slot of a batched multi-receiver program (the
    dual-RX surface, reference supersdr.py:575-639) is a parameter
    update — never a retrace. Per-branch state only advances for the
    SELECTED branch (DC blocker when AM, last_sample when NBFM) —
    matching the static-dispatch chain, where a deselected mode's state
    is simply not touched.
    """
    _, ssb = demod_ssb(state, y)
    st_am, am = demod_am(state, y)
    st_fm, fm = demod_nbfm(state, y, fs, max_dev_hz)
    sel_b = jnp.asarray(mode_id)
    sel = sel_b[..., None]
    audio = jnp.where(sel == 1, am, jnp.where(sel == 2, fm, ssb))
    st = DemodState(
        last_sample=cx.CX(
            jnp.where(sel_b == 2, st_fm.last_sample.re, state.last_sample.re),
            jnp.where(sel_b == 2, st_fm.last_sample.im, state.last_sample.im)),
        dc_x=jnp.where(sel_b == 1, st_am.dc_x, state.dc_x),
        dc_y=jnp.where(sel_b == 1, st_am.dc_y, state.dc_y))
    return st, audio


def demodulate(mode: str, state: DemodState, y: jax.Array, fs: float,
               axis_name: str | None = None, max_dev_hz: float = 5000.0
               ) -> tuple[DemodState, jax.Array]:
    """Dispatch by mode name (static — one trace per mode)."""
    mode = mode.upper()
    if mode in ("USB", "LSB", "CW"):
        return demod_ssb(state, y)
    if mode == "AM":
        return demod_am(state, y, axis_name=axis_name)
    if mode == "NBFM":
        return demod_nbfm(state, y, fs, max_dev_hz=max_dev_hz,
                          axis_name=axis_name)
    if mode == "IQ":
        return demod_iq(state, y)
    raise ValueError(f"unknown mode {mode!r}")
