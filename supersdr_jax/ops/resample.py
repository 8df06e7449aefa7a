"""Polyphase resampling (12 kHz audio → 48 kHz DAC and rational L/M).

The reference upsamples by zero-stuffing ×4, prepending an `n_tap-1` carry,
then running one windowed-sinc lowpass with `np.convolve(mode="valid")` and
a ×4 gain (/root/reference/utils_supersdr.py:1125-1134); 20 kHz kiwis use
`scipy.resample_poly` (:1126). Both are reproduced here with identical
streaming semantics.

Device formulation: the zero-stuffed convolution is algebraically a
polyphase matrix product — each output frame of L samples is `frames @ P`
where `frames` gathers `ceil(n_taps/L)` input samples and `P` is the
[per, L] polyphase tap matrix. That makes the hot path a matmul over a
batch of frames instead of a scalar FIR loop, with history carried
functionally.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import firdesign


@dataclass(frozen=True)
class InterpPlan:
    """Streaming L× interpolator (integer upsample; M=1)."""
    L: int
    n_taps: int
    per: int  # taps per polyphase branch = ceil(n_taps / L)

    @property
    def history(self) -> int:
        # input-domain history needed so every output frame sees `per`
        # past input samples
        return self.per - 1


def design_interp(kiwi_rate: int, audio_rate: int) -> tuple["InterpPlan", np.ndarray]:
    """Reference design: lowpass at kiwi_rate/2 designed at audio_rate
    (utils_supersdr.py:999 `filtering(KIWI_RATE/2, AUDIO_RATE)`)."""
    if audio_rate % kiwi_rate:
        raise ValueError("use rational_resample for non-integer ratios")
    L = audio_rate // kiwi_rate
    taps = firdesign.lowpass_taps(kiwi_rate / 2.0, audio_rate)
    return plan_interp(L, taps)


def plan_interp(L: int, taps: np.ndarray) -> tuple[InterpPlan, np.ndarray]:
    """Build the polyphase matrix for L× zero-stuff interpolation.

    Derivation: with u the zero-stuffed input (u[kL]=x[k]) extended into the
    past by the reference's n_tap-1 carry, the valid-convolve output is
    y[i] = sum_j h[j] u[i-j].  Writing i = nL + p, the only nonzero u terms
    have j = qL + p, giving y[nL+p] = sum_q h[qL+p] x[n-q].  Frame row m of
    the gathered input window holds x[n - (per-1-m)], so
    P[m, p] = h[(per-1-m)·L + p].  Matrix shape: [per, L].
    """
    n_taps = len(taps)
    per = int(np.ceil(n_taps / L))
    P = np.zeros((per, L), dtype=np.float64)
    for p in range(L):
        for m in range(per):
            j = (per - 1 - m) * L + p
            if j < n_taps:
                P[m, p] = taps[j]
    P *= L  # reference multiplies by SAMPLE_RATIO after filtering
    return InterpPlan(L=L, n_taps=n_taps, per=per), P


def init_carry(plan: InterpPlan, batch_shape: tuple[int, ...] = (),
               dtype=jnp.float32) -> jax.Array:
    return jnp.zeros(batch_shape + (plan.history,), dtype=dtype)


@partial(jax.jit, static_argnums=(0, 4))
def interpolate(plan: InterpPlan, P: jax.Array, carry: jax.Array,
                x: jax.Array, impl: str = "einsum"
                ) -> tuple[jax.Array, jax.Array]:
    """One streaming step: x[*batch, n] → y[*batch, n*L].

    Matches the reference zero-stuff + valid-convolve + ×L pipeline sample
    for sample (given the same taps and zero initial history).

    Two formulations (identical outputs):
      "einsum": stack `per` shifted slices → one matmul [.., n, per] @
                [per, L].
      "fma":    broadcast FMA chain y[.., t, p] = Σ_m seg[t+m]·P[m, p] —
                pure elementwise VPU work, no frames materialization.
    """
    seg = jnp.concatenate([carry, x], axis=-1)          # [..., hist + n]
    n = x.shape[-1]
    if impl == "fma":
        Pf = P.astype(seg.dtype)
        y = seg[..., 0:n, None] * Pf[0]
        for m in range(1, plan.per):
            y = y + seg[..., m:m + n, None] * Pf[m]     # [..., n, L]
        y = y.reshape(*x.shape[:-1], n * plan.L)
    else:
        frames = jnp.stack([seg[..., p:p + n] for p in range(plan.per)],
                           axis=-1)                     # [..., n, per]
        y = jnp.einsum("...np,pl->...nl", frames, P.astype(frames.dtype),
                       precision=jax.lax.Precision.HIGHEST)
        y = y.reshape(*x.shape[:-1], n * plan.L)
    new_carry = seg[..., -plan.history:] if plan.history else seg[..., :0]
    return new_carry, y


# ---------------------------------------------------------------------------
# Blocked-Toeplitz matmul interpolator ("matmul" impl).
#
# The "einsum" impl materializes frames [.., n, per] — a minor dim of
# `per` (typically 9), a narrow layout for wide vector units.  Following
# `ops/fir_matmul.py`, the zero-stuffed interpolation FIR is instead a
# banded (block-Toeplitz) matrix from input blocks to OUTPUT blocks:
#
#     y_block[i] = z[i] @ W,  z[i] = x[(i-n_prev)·B : (i+1)·B]
#
# with W [window, L·B] absorbing the zero-stuffing, the polyphase
# structure, AND the phase interleave — the output lands at the audio
# rate in natural interleaved order with full-lane layouts end to end.
# FLOP inflation (window/per ≈ 28× at B=128, per=9) is paid on the
# tensor cores, which are idle here anyway; the win is ~1 pass of memory
# traffic instead of the frames blow-up.  Streaming state (per-1 input tail) is identical
# to InterpPlan's, so impl switches don't convert state.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InterpMatmulPlan:
    L: int
    n_taps: int
    per: int        # ceil(n_taps / L) — input samples seen per output frame
    block_in: int   # input samples per matmul row (multiple of 128)

    def __post_init__(self):
        if self.block_in % 128:
            raise ValueError("block_in must be a multiple of 128")

    @property
    def history(self) -> int:
        return self.per - 1

    @property
    def n_prev(self) -> int:
        return -(-self.history // self.block_in)

    @property
    def window(self) -> int:
        return (self.n_prev + 1) * self.block_in


def plan_interp_matmul(plan: InterpPlan, chunk: int,
                       max_block: int = 256) -> InterpMatmulPlan:
    """Blocked plan for `interpolate_matmul` with B chosen ≤ max_block as
    a 128-multiple divisor of `chunk` when possible (no pad waste)."""
    b = 128
    for cand in range(max_block, 127, -128):
        if chunk % cand == 0:
            b = cand
            break
    return InterpMatmulPlan(L=plan.L, n_taps=plan.n_taps, per=plan.per,
                            block_in=b)


def build_w_interp(plan: InterpMatmulPlan, taps: np.ndarray) -> jnp.ndarray:
    """[window, L·block_in] interpolation matrix.

    Row s is input sample x[k·B - n_prev·B + s]; column o = t·L + p is
    output sample y[(k·B + t)·L + p] = L·Σ_q h[qL+p]·x[kB+t-q]  (the
    reference's zero-stuff → valid-convolve → ×L gain,
    /root/reference/utils_supersdr.py:1125-1134), so
    W[s, tL+p] = L·h[(n_prev·B + t - s)·L + p] on the band, else 0.
    """
    taps = np.asarray(taps, np.float64)
    if len(taps) != plan.n_taps:
        raise ValueError("taps length mismatch")
    B, L, per = plan.block_in, plan.L, plan.per
    S = plan.window
    s = np.arange(S)[:, None]
    t = np.arange(B)[None, :]
    q = plan.n_prev * B + t - s                      # [S, B]
    W = np.zeros((S, B * L), np.float64)
    for p in range(L):
        j = q * L + p
        valid = (q >= 0) & (q < per) & (j < plan.n_taps)
        W[:, p::L] = np.where(valid, L * taps[np.clip(j, 0, plan.n_taps - 1)],
                              0.0)
    # column o = t·L + p ↔ W[:, p::L] columns at stride L starting p ✓
    return jnp.asarray(W, jnp.float32)


def interpolate_matmul(plan: InterpMatmulPlan, Wm: jax.Array,
                       carry: jax.Array, x: jax.Array, *,
                       precision=jax.lax.Precision.HIGHEST
                       ) -> tuple[jax.Array, jax.Array]:
    """Streaming step: x [*batch, n] → y [*batch, n·L]; same carry layout
    and sample-exact outputs as `interpolate` (given the same taps)."""
    B = plan.block_in
    n = x.shape[-1]
    pad_n = (-n) % B
    xp = x
    if pad_n:
        xp = jnp.concatenate(
            [x, jnp.zeros((*x.shape[:-1], pad_n), x.dtype)], axis=-1)
    nb = xp.shape[-1] // B
    pre = jnp.zeros((*x.shape[:-1], plan.n_prev * B - plan.history), x.dtype)
    ext = jnp.concatenate([pre, carry, xp], axis=-1)
    xb = ext.reshape(*x.shape[:-1], nb + plan.n_prev, B)
    z = jnp.concatenate(
        [xb[..., j:j + nb, :] for j in range(plan.n_prev + 1)], axis=-1)
    from supersdr_jax.ops import cx
    dot = cx.make_dot((((z.ndim - 1,), (0,)), ((), ())),
                      cx.resolve_precision(precision))
    y = dot(z, Wm)
    y = y.reshape(*x.shape[:-1], -1)[..., : n * plan.L]
    new_carry = (jnp.concatenate([carry, x], axis=-1)[..., -plan.history:]
                 if plan.history else x[..., :0])
    return new_carry, y


@dataclass(frozen=True)
class RationalPlan:
    """Streaming L/M rational resampler (e.g. 20 kHz kiwi → 48 kHz: 12/5)."""
    L: int
    M: int
    n_taps: int

    @property
    def history(self) -> int:
        return self.n_taps - 1  # in the L-upsampled domain


def plan_rational(in_rate: int, out_rate: int,
                  taps: np.ndarray | None = None) -> tuple["RationalPlan", np.ndarray]:
    g = int(np.gcd(in_rate, out_rate))
    L, M = out_rate // g, in_rate // g
    if taps is None:
        # anti-image + anti-alias lowpass at min(in,out)/2, designed at L*in
        taps = firdesign.lowpass_taps(min(in_rate, out_rate) / 2.0, L * in_rate)
    return RationalPlan(L=L, M=M, n_taps=len(taps)), np.asarray(taps)


def rational_resample_block(plan: RationalPlan, taps: jax.Array,
                            carry: jax.Array, x: jax.Array
                            ) -> tuple[jax.Array, jax.Array]:
    """Resample a block whose length is a multiple of M; output n*L/M.

    Zero-stuff by L, convolve (valid, with carried history in the upsampled
    domain), scale by L, take every M-th sample. Phase continuity across
    blocks holds because block*L ≡ 0 (mod M).
    """
    n = x.shape[-1]
    if (n * plan.L) % plan.M:
        raise ValueError("block length * L must be divisible by M")
    up = jnp.zeros(x.shape[:-1] + (n * plan.L,), dtype=x.dtype)
    up = up.at[..., :: plan.L].set(x)
    seg = jnp.concatenate([carry, up], axis=-1)
    idx = jnp.arange(0, n * plan.L, plan.M)[:, None] + jnp.arange(plan.n_taps)[None, :]
    frames = seg[..., idx]
    h_rev = taps[::-1].astype(frames.dtype)
    y = plan.L * jnp.einsum("...nt,t->...n", frames, h_rev)
    new_carry = seg[..., -plan.history:]
    return new_carry, y
