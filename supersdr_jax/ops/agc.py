"""AGC — automatic gain control with the KiwiSDR parameter surface.

The reference controls the server's AGC with
`SET agc=<on> hang=<hang> thresh=<dBm> slope=<dB> decay=<ms> manGain=<dB>`
(/root/reference/utils_supersdr.py:936-944,1022-1024; defaults on=1,
hang=0, thresh=-80, slope=0, decay=4000 (CW 1000), manGain=50; decay
clamped to 400..8000 ms at utils_supersdr.py:1009-1017). This module
implements that surface natively with a fully parallel formulation — no
sample-rate `lax.scan` (the GPU tail kernel, ops/pallas/chain_tail.py,
runs the same recurrences in order instead):

  1. envelope → dB
  2. peak tracker: instant attack, exponential decay at `decay` ms/e-fold —
     a max-plus recurrence evaluated with an associative scan (O(log n))
  3. optional hang: a causal sliding-window max holds peaks for `hang_ms`
     before decay resumes
  4. gain law (kneed compressor): below `thresh` the gain is flat at
     max_gain = target - thresh; above it the output rises `slope` dB over
     the thresh→0 dBFS input range:
        gain_db = (target - peak) + slope·(peak - thresh)/(-thresh)
  5. gain smoothing: one-pole at `attack_ms` (associative linear scan)
  6. manual mode (on=0): fixed gain of manGain - MANUAL_UNITY_DB dB
     (unity at the reference default manGain=50).

All parameters are runtime data (no retrace on change). State is a small
NamedTuple so the op chains under scan/vmap/shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from supersdr_jax.ops import scans

MANUAL_UNITY_DB = 50.0
ENV_FLOOR = 1e-9


class AGCParams(NamedTuple):
    """Runtime AGC parameters (all scalars, broadcastable arrays allowed)."""
    on: jax.Array          # bool/int: 1 = auto, 0 = manual gain
    hang: jax.Array        # bool/int: enable hang
    thresh_db: jax.Array   # knee, dBFS (reference dBm convention)
    slope_db: jax.Array    # output rise across thresh→0 input range
    decay_per_sample_db: jax.Array  # precomputed decay rate
    man_gain_db: jax.Array
    target_db: jax.Array
    attack_coeff: jax.Array  # one-pole coefficient for gain smoothing


def make_params(fs: float, on: bool = True, hang: bool = False,
                thresh_db: float = -80.0, slope_db: float = 0.0,
                decay_ms: float = 4000.0, man_gain_db: float = 50.0,
                target_db: float = -10.0, attack_ms: float = 5.0,
                ) -> AGCParams:
    # `decay_ms` is the time for the tracked peak to fall by PEAK_DROP_DB
    # after the signal disappears (reference decay semantics: release time).
    PEAK_DROP_DB = 60.0
    decay_per_sample = PEAK_DROP_DB / (max(decay_ms, 1e-3) * 1e-3 * fs)
    attack_coeff = jnp.exp(-1.0 / (max(attack_ms, 1e-3) * 1e-3 * fs))
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return AGCParams(on=f32(1.0 if on else 0.0), hang=f32(1.0 if hang else 0.0),
                     thresh_db=f32(thresh_db), slope_db=f32(slope_db),
                     decay_per_sample_db=f32(decay_per_sample),
                     man_gain_db=f32(man_gain_db), target_db=f32(target_db),
                     attack_coeff=f32(attack_coeff))


class AGCState(NamedTuple):
    peak_db: jax.Array   # tracked envelope peak at end of last block
    gain_db: jax.Array   # smoothed gain at end of last block


def init_state(batch_shape: tuple[int, ...] = ()) -> AGCState:
    return AGCState(peak_db=jnp.full(batch_shape, -120.0, jnp.float32),
                    gain_db=jnp.zeros(batch_shape, jnp.float32))


def hang_samples(fs: float, hang_ms: float = 500.0) -> int:
    return max(1, int(round(hang_ms * 1e-3 * fs)))


def apply(params: AGCParams, state: AGCState, audio: jax.Array,
          hang_window: int = 1, axis_name: str | None = None,
          decimation: int = 1) -> tuple[AGCState, jax.Array]:
    """Apply AGC to one block. audio: [*batch, n] float32 (or complex for
    IQ-mode level control — envelope uses |.|). `hang_window` is static
    (samples; from `hang_samples(fs)`). With `axis_name` (inside shard_map
    over a time-sharded axis) the ballistics run exactly across shards.

    `decimation` (static) runs the ballistics on per-group envelope peaks:
    a D× reduction in scan traffic at D-sample attack granularity (e.g.
    D=8 at 12 kHz = 0.7 ms). On tonal signals it matches D=1 to <1% rms;
    on noise-dominated input the max-of-D envelope biases the peak
    estimate up by ~2.5 dB (gain correspondingly down) — acceptable for
    AGC but not bit-identical, hence default D=1.
    """
    env = jnp.abs(audio).astype(jnp.float32)
    n = env.shape[-1]
    if decimation > 1:
        if n % decimation:
            raise ValueError("block length must be divisible by decimation")
        env = env.reshape(*env.shape[:-1], n // decimation, decimation
                          ).max(-1)
        if hang_window > 1:
            hang_window = max(1, hang_window // decimation)
    env_db = 20.0 * jnp.log10(jnp.maximum(env, ENV_FLOOR))

    # peak tracking: y[n] = max(y[n-1] - d, env_db[n])  (max-plus scan);
    # the decay is time-constant, so off-mesh the scan collapses to one
    # cumulative max (scans.maxplus_scan_const)
    d_scalar = -params.decay_per_sample_db * decimation
    if axis_name is None and jnp.ndim(d_scalar) == 0:
        peak_db = scans.maxplus_scan_const(d_scalar, env_db, state.peak_db)
    else:
        d = jnp.broadcast_to(d_scalar, env_db.shape)
        peak_db = scans.maxplus_scan(d, env_db, state.peak_db,
                                     axis_name=axis_name)
    if hang_window > 1:
        held = scans.sliding_max(peak_db, hang_window, axis_name=axis_name)
        peak_db = jnp.where(params.hang > 0, held, peak_db)

    # kneed gain law
    max_gain = params.target_db - params.thresh_db
    above = (params.target_db - peak_db) + params.slope_db * (
        (peak_db - params.thresh_db) / jnp.maximum(-params.thresh_db, 1e-6))
    auto_gain = jnp.where(peak_db <= params.thresh_db, max_gain, above)
    manual_gain = params.man_gain_db - MANUAL_UNITY_DB
    gain_db = jnp.where(params.on > 0, auto_gain, manual_gain)

    # attack smoothing (one-pole; time-constant coefficient → blocked
    # Toeplitz-matmul scan off-mesh, general two-level scan on-mesh)
    attack = params.attack_coeff ** decimation
    if axis_name is None and jnp.ndim(attack) == 0:
        gain_db = scans.linear_scan_const(attack, (1.0 - attack) * gain_db,
                                          state.gain_db)
    else:
        a = jnp.broadcast_to(attack, gain_db.shape)
        gain_db = scans.linear_scan(a, (1.0 - attack) * gain_db,
                                    state.gain_db, axis_name=axis_name)

    new_state = AGCState(peak_db=peak_db[..., -1], gain_db=gain_db[..., -1])
    if decimation > 1:
        gain_db = jnp.repeat(gain_db, decimation, axis=-1)
    out = audio * jnp.power(10.0, gain_db / 20.0).astype(audio.dtype)
    return new_state, out
