"""Batched overlap-save FFT convolution — the workhorse filter kernel.

The reference carries `n_tap-1` samples of history between blocks and runs
`np.convolve(concat(old, x), h, mode="valid")` per audio callback
(/root/reference/utils_supersdr.py:1005,1128-1134). Here the same streaming
semantics — bit-compatible output — are realised as a *batched* overlap-save
transform: one FFT per block, the filter (or a raised-cosine passband mask)
applied as a frequency-domain multiply, one IFFT, with the history carried
as an explicit functional state so the op composes under `jit`, `vmap`
(channel batching), `lax.scan` (time), and `shard_map` (mesh sharding).

This turns a memory-bound small convolution into large batched FFT work
with static shapes; XLA fuses the mask multiply into the transform's
neighbours.

Boundary convention: all public entry points take/return split-complex
`cx.CX` float pairs; the `*_c` helpers operate on complex arrays and are
for use inside already-traced code (chain bodies, shard_map bodies).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import cx, firdesign


@dataclass(frozen=True)
class OSPlan:
    """Static plan for a streaming overlap-save filter.

    block:    samples produced per step (static)
    n_taps:   FIR length; history/overlap is n_taps-1 samples
    fft_size: transform size, pow2 ≥ block + n_taps - 1
    """
    block: int
    n_taps: int
    fft_size: int

    @property
    def overlap(self) -> int:
        return self.n_taps - 1

    @property
    def seg_len(self) -> int:
        return self.block + self.n_taps - 1


def plan_for(block: int, n_taps: int) -> OSPlan:
    return OSPlan(block=block, n_taps=n_taps,
                  fft_size=firdesign.next_pow2(block + n_taps - 1))


def taps_to_freq(plan: OSPlan, taps: np.ndarray) -> cx.CX:
    """Frequency response of `taps` at the plan's FFT size, as a CX pair
    (host-side FFT in float64; device arrays are float32 planes)."""
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan n_taps {plan.n_taps}")
    H = np.fft.fft(np.asarray(taps), n=plan.fft_size)
    return cx.CX(jnp.asarray(H.real, jnp.float32),
                 jnp.asarray(H.imag, jnp.float32))


def init_carry(plan: OSPlan, batch_shape: tuple[int, ...] = ()) -> cx.CX:
    """Zero history of shape [*batch, n_taps-1] (split-complex)."""
    return cx.zeros(batch_shape + (plan.overlap,))


# ---------------------------------------------------------------------------
# complex-domain cores — call ONLY inside traced code
# ---------------------------------------------------------------------------

def overlap_save_c(plan: OSPlan, H: jax.Array, carry: jax.Array,
                   x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """One streaming filter step on complex arrays (traced contexts only).

    H:     [fft_size] complex64 frequency response (taps or mask)
    carry: [*batch, n_taps-1] history (previous block's tail)
    x:     [*batch, block] input samples (complex or real; promoted)
    Returns (new_carry, y) with y[*batch, block] equal to
    convolve(concat(carry, x), taps, mode="valid").
    """
    x = x.astype(jnp.complex64)
    carry = carry.astype(jnp.complex64)
    seg = jnp.concatenate([carry, x], axis=-1)            # [..., seg_len]
    X = jnp.fft.fft(seg, n=plan.fft_size, axis=-1)
    y_full = jnp.fft.ifft(X * H, axis=-1)
    y = y_full[..., plan.overlap: plan.overlap + plan.block]
    new_carry = seg[..., -plan.overlap:] if plan.overlap else seg[..., :0]
    return new_carry, y


def overlap_save_batch_c(plan: OSPlan, H: jax.Array, head: jax.Array,
                         x: jax.Array) -> jax.Array:
    """Filter already-stacked blocks, no recurrence (traced contexts only).

    x:    [*batch, n_blocks, block]
    head: [*batch, n_taps-1] history preceding the first block
    Each block's segment is built by gathering its predecessor's tail from
    the *input* (overlap-save carries input history, not filter state), so
    all blocks process in a single batched FFT — no serial scan. This is the
    throughput path for offline / wideband work.
    """
    x = x.astype(jnp.complex64)
    head = head.astype(jnp.complex64)
    n_blocks = x.shape[-2]
    if plan.overlap <= plan.block:
        # each block's history is the tail of its predecessor (or `head`
        # for block 0) — pure slice/concat, no gather
        if plan.overlap:
            heads = jnp.concatenate(
                [head[..., None, :], x[..., :-1, plan.block - plan.overlap:]],
                axis=-2)                               # [..., n_blocks, overlap]
            segs = jnp.concatenate([heads, x], axis=-1)
        else:
            segs = x
    else:
        flat = jnp.concatenate([head, x.reshape(*x.shape[:-2], -1)], axis=-1)
        idx = (jnp.arange(n_blocks)[:, None] * plan.block
               + jnp.arange(plan.seg_len)[None, :])
        segs = flat[..., idx]                          # [..., n_blocks, seg_len]
    X = jnp.fft.fft(segs, n=plan.fft_size, axis=-1)
    y_full = jnp.fft.ifft(X * H, axis=-1)
    return y_full[..., plan.overlap: plan.overlap + plan.block]


# ---------------------------------------------------------------------------
# public split-complex entry points (float-only program boundaries)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=0)
def _overlap_save_cx(plan: OSPlan, H: cx.CX, carry: cx.CX, x: cx.CX
                     ) -> tuple[cx.CX, cx.CX]:
    c, y = overlap_save_c(plan, cx.to_complex(H), cx.to_complex(carry),
                          cx.to_complex(x))
    return cx.split(c), cx.split(y)


def overlap_save(plan: OSPlan, H, carry, x) -> tuple[cx.CX, cx.CX]:
    """One streaming filter step. Accepts CX / complex / real inputs;
    returns (new_carry, y) as CX."""
    return _overlap_save_cx(plan, cx.as_cx(H), cx.as_cx(carry), cx.as_cx(x))


@partial(jax.jit, static_argnums=0)
def _overlap_save_batch_cx(plan: OSPlan, H: cx.CX, head: cx.CX, x: cx.CX
                           ) -> cx.CX:
    y = overlap_save_batch_c(plan, cx.to_complex(H), cx.to_complex(head),
                             cx.to_complex(x))
    return cx.split(y)


def overlap_save_batch(plan: OSPlan, H, head, x) -> cx.CX:
    """Batched (stacked-blocks) filter step. Accepts CX / complex / real;
    returns y [*batch, n_blocks, block] as CX."""
    return _overlap_save_batch_cx(plan, cx.as_cx(H), cx.as_cx(head),
                                  cx.as_cx(x))


def filter_signal(taps: np.ndarray, x, block: int = 4096) -> np.ndarray:
    """Host convenience: stream a whole 1-D/ND signal through overlap-save.

    Zero history at t=0; output length equals input length, matching the
    reference's `valid`-with-carry convention (first n_taps-1 outputs see
    zero-padded history). Returns a numpy array — real when both taps and
    input are real, complex otherwise.
    """
    x_np = np.asarray(x)
    want_real = (not np.iscomplexobj(np.asarray(taps))
                 and not np.iscomplexobj(x_np))
    n = x_np.shape[-1]
    plan = plan_for(block, len(taps))
    H = taps_to_freq(plan, taps)
    pad = (-n) % block
    xp = np.pad(x_np, [(0, 0)] * (x_np.ndim - 1) + [(0, pad)])
    blocks = xp.reshape(*x_np.shape[:-1], -1, block)
    head = init_carry(plan, x_np.shape[:-1])
    y = overlap_save_batch(plan, H, head, cx.as_cx(blocks))
    out = cx.to_numpy(y).reshape(*x_np.shape[:-1], -1)[..., :n]
    return out.real if want_real else out
