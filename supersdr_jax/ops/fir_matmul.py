"""Streaming FIR as a blocked-Toeplitz matmul — the FFT-free passband.

The overlap-save path (`ops/overlap_save.py`) filters each chunk with two
large FFTs. This module trades FLOPs for tensor-core work instead: a
K-tap FIR over a length-`chunk` stream is exactly a banded (Toeplitz)
matrix apply, and blocking it at `B` samples turns it into ONE dense
matmul

    Y[i, :] = Z[i, :] @ W,   Z[i] = x[(i-n_prev)·B : (i+1)·B]

with `n_prev = ceil((K-1)/B)` predecessor blocks providing the filter
history. The windows Z are built from shifted *slices* of the carry-padded
input (never a gather), and the complex multiply is folded into one real matmul by stacking the
(re, im) planes along the contraction axis with the block matrix
[[Wr, Wi], [-Wi, Wr]].

FLOP inflation vs the direct form is (n_prev+1)·B / K ≈ 2-4×, paid on the
tensor cores with f32 accumulation.

Streaming semantics are IDENTICAL to overlap-save (reference:
`np.convolve(concat(old, x), h, mode="valid")` with an `n_tap-1` carry,
/root/reference/utils_supersdr.py:1005,1128-1133) and the carried state is
the same `n_taps-1` input-tail, so a chain can switch implementation
without converting its state.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import cx


@dataclass(frozen=True)
class FIRMatmulPlan:
    """Static structure of the blocked FIR matmul.

    block:  output samples per matmul row (multiple of 128)
    n_taps: FIR length K; streaming history is K-1 samples
    """
    block: int
    n_taps: int

    def __post_init__(self):
        if self.block % 128:
            raise ValueError("block must be a multiple of 128")

    @property
    def overlap(self) -> int:
        return self.n_taps - 1

    @property
    def n_prev(self) -> int:
        """Predecessor blocks needed to cover the filter history."""
        return -(-self.overlap // self.block)

    @property
    def window(self) -> int:
        """Z-window length (n_prev+1 blocks)."""
        return (self.n_prev + 1) * self.block


def plan_for(chunk: int, n_taps: int, max_block: int = 512) -> FIRMatmulPlan:
    """Pick a matmul-friendly block: B ≈ overlap rounded to a multiple of
    128 (minimum FLOP inflation), preferring a divisor of `chunk` (no pad
    waste); non-dividing chunks are zero-padded by the stream step."""
    overlap = n_taps - 1
    b = min(max_block, max(128, -(-overlap // 128) * 128))
    d = b
    while d >= 128 and chunk % d:
        d -= 128
    return FIRMatmulPlan(block=d if d >= 128 else b, n_taps=n_taps)


def build_w(plan: FIRMatmulPlan, taps: np.ndarray) -> jax.Array:
    """[2·window, 2·block] real matmul matrix for complex taps.

    Row layout: first `window` rows contract the re plane, the rest the im
    plane; column o < block yields y.re[o], column block+o yields y.im[o].
    Built host-side in float64, stored float32.
    """
    taps = np.asarray(taps)
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan {plan.n_taps}")
    S, B = plan.window, plan.block
    p = plan.n_prev * B                       # prefix length inside a window
    # Wt[s, o] = h[o - s + p] — z[s] is input sample (block_start - p + s)
    o = np.arange(B)[None, :]
    s = np.arange(S)[:, None]
    k = o - s + p
    valid = (k >= 0) & (k < plan.n_taps)
    kc = np.clip(k, 0, plan.n_taps - 1)
    wr = np.where(valid, np.real(taps)[kc], 0.0)
    wi = np.where(valid, np.imag(taps)[kc], 0.0)
    w2 = np.block([[wr, wi], [-wi, wr]])      # [2S, 2B]
    return jnp.asarray(w2, jnp.float32)


def init_carry(plan: FIRMatmulPlan, batch_shape: tuple[int, ...] = ()) -> cx.CX:
    """Zero history [*batch, n_taps-1] — same layout as overlap-save's."""
    return cx.zeros(batch_shape + (plan.overlap,))


def _windows(plan: FIRMatmulPlan, carry: jax.Array, x: jax.Array) -> jax.Array:
    """[*batch, n_blocks, window] sliding windows from shifted slices."""
    B = plan.block
    n_blocks = x.shape[-1] // B
    pad = plan.n_prev * B - plan.overlap
    pre = jnp.zeros((*x.shape[:-1], pad), x.dtype)
    ext = jnp.concatenate([pre, carry, x], axis=-1)
    xb = ext.reshape(*x.shape[:-1], n_blocks + plan.n_prev, B)
    return jnp.concatenate(
        [xb[..., j:j + n_blocks, :] for j in range(plan.n_prev + 1)], axis=-1)


def fir_matmul_stream_c(plan: FIRMatmulPlan, W: jax.Array, carry: cx.CX,
                        x: cx.CX, *,
                        precision=jax.lax.Precision.HIGHEST
                        ) -> tuple[cx.CX, cx.CX]:
    """One streaming filter step (traced contexts).

    W:     [2·window, 2·block] from `build_w`
    carry: [*batch, n_taps-1] split-complex input history
    x:     [*batch, chunk] split-complex (zero-padded to a block multiple
           internally when needed; outputs are cut back to chunk)
    Returns (new_carry, y) with y ≡ convolve(concat(carry, x), taps,
    mode="valid") — bit-compatible with `overlap_save_c` semantics.
    """
    B = plan.block
    chunk = x.shape[-1]
    pad_n = (-chunk) % B
    xp = x
    if pad_n:
        zpad = jnp.zeros((*x.shape[:-1], pad_n), x.re.dtype)
        xp = cx.CX(jnp.concatenate([x.re, zpad], axis=-1),
                   jnp.concatenate([x.im, zpad], axis=-1))
    zr = _windows(plan, carry.re, xp.re)
    zi = _windows(plan, carry.im, xp.im)
    z = jnp.concatenate([zr, zi], axis=-1)            # [..., nb, 2·window]
    dot = cx.make_dot((((z.ndim - 1,), (0,)), ((), ())),
                      cx.resolve_precision(precision))
    y2 = dot(z, W)
    yr = y2[..., :B].reshape(*x.shape[:-1], -1)[..., :chunk]
    yi = y2[..., B:].reshape(*x.shape[:-1], -1)[..., :chunk]
    # carry comes from the true (unpadded) input tail; short chunks
    # (chunk < overlap) keep the older history prefix
    if plan.overlap == 0:
        new_carry = cx.CX(x.re[..., :0], x.im[..., :0])
    elif chunk >= plan.overlap:
        new_carry = cx.CX(x.re[..., -plan.overlap:], x.im[..., -plan.overlap:])
    else:
        new_carry = cx.CX(
            jnp.concatenate([carry.re[..., chunk:], x.re], axis=-1),
            jnp.concatenate([carry.im[..., chunk:], x.im], axis=-1))
    return new_carry, cx.CX(yr, yi)


@partial(jax.jit, static_argnums=0)
def _fir_matmul_cx(plan: FIRMatmulPlan, W: jax.Array, carry: cx.CX,
                   x: cx.CX) -> tuple[cx.CX, cx.CX]:
    return fir_matmul_stream_c(plan, W, carry, x)


def fir_matmul_stream(plan: FIRMatmulPlan, W, carry, x
                      ) -> tuple[cx.CX, cx.CX]:
    """Public streaming step: accepts CX / complex numpy inputs."""
    return _fir_matmul_cx(plan, W, cx.as_cx(carry), cx.as_cx(x))


def build_w_real(plan: FIRMatmulPlan, taps: np.ndarray) -> jax.Array:
    """[window, block] real matmul matrix for REAL taps (the modulated
    passband path: a real lowpass prototype applied to a basebanded
    stream — half the FLOPs of the complex-folded `build_w`)."""
    taps = np.asarray(taps, np.float64)
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan {plan.n_taps}")
    S, B = plan.window, plan.block
    p = plan.n_prev * B
    o = np.arange(B)[None, :]
    s = np.arange(S)[:, None]
    k = o - s + p
    valid = (k >= 0) & (k < plan.n_taps)
    w = np.where(valid, taps[np.clip(k, 0, plan.n_taps - 1)], 0.0)
    return jnp.asarray(w, jnp.float32)


def fir_matmul_stream_real_c(plan: FIRMatmulPlan, W: jax.Array, carry: cx.CX,
                             x: cx.CX, *,
                             precision=jax.lax.Precision.HIGHEST
                             ) -> tuple[cx.CX, cx.CX]:
    """Streaming REAL-taps FIR on a complex stream: each plane filters
    independently through one [window, block] matmul (W from
    `build_w_real`). Same carry/windowing semantics as the complex form."""
    B = plan.block
    chunk = x.shape[-1]
    pad_n = (-chunk) % B
    xp = x
    if pad_n:
        zpad = jnp.zeros((*x.shape[:-1], pad_n), x.re.dtype)
        xp = cx.CX(jnp.concatenate([x.re, zpad], axis=-1),
                   jnp.concatenate([x.im, zpad], axis=-1))
    zr = _windows(plan, carry.re, xp.re)
    zi = _windows(plan, carry.im, xp.im)
    z = jnp.stack([zr, zi], axis=-3)                  # [..., 2, nb, window]
    dot = cx.make_dot((((z.ndim - 1,), (0,)), ((), ())),
                      cx.resolve_precision(precision))
    y2 = dot(z, W)
    yr = y2[..., 0, :, :].reshape(*x.shape[:-1], -1)[..., :chunk]
    yi = y2[..., 1, :, :].reshape(*x.shape[:-1], -1)[..., :chunk]
    if plan.overlap == 0:
        new_carry = cx.CX(x.re[..., :0], x.im[..., :0])
    elif chunk >= plan.overlap:
        new_carry = cx.CX(x.re[..., -plan.overlap:], x.im[..., -plan.overlap:])
    else:
        new_carry = cx.CX(
            jnp.concatenate([carry.re[..., chunk:], x.re], axis=-1),
            jnp.concatenate([carry.im[..., chunk:], x.im], axis=-1))
    return new_carry, cx.CX(yr, yi)
