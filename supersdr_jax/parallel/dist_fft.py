"""Distributed four-step FFT: the tensor-parallel (TP) axis.

SURVEY.md §2a maps the reference's missing "TP" analog to splitting a
transform across chips. This module implements it idiomatically: an
N = N1·N2 four-step (Cooley-Tukey) FFT where the N1 rows are sharded
over a mesh axis —

  1. each device FFTs its local rows over N2        (no communication)
  2. twiddle multiply W_N^{n1·k2}                   (elementwise, local)
  3. transpose N1 ↔ N2 via ONE `all_to_all`         (the only collective)
  4. each device FFTs its local rows over N1        (no communication)

— i.e. the classic distributed-memory FFT, with XLA's all_to_all on
the device interconnect. Works inside `shard_map` (the `*_sharded` functions are bodies) and
composes with the chain's overlap-save filter to give a mesh-wide
passband transform for FFT sizes that exceed one chip's fast range.

Sample-exact against `jnp.fft.fft` (tests on the 8-device CPU mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from supersdr_jax.ops import cx

AXIS = "fft"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _twiddle(n1: int, n2: int, sign: int) -> np.ndarray:
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
    return np.exp(1j * ang).astype(np.complex64)


def fft_sharded(x_local: jax.Array, n1: int, n2: int, d: int,
                sign: int = -1, axis_name: str = AXIS) -> jax.Array:
    """shard_map body: distributed FFT of x viewed as [n1, n2] row-major
    (x[j] = x_flat[j1·n2 + j2]), rows j1 sharded over `axis_name`.

    x_local: [n1/d, n2] complex. Returns the local shard of the output
    viewed as [n1, n2] with X[k] = X_flat[k2·n1 + k1] — i.e. the result
    transposed into [k2-major] layout, k2 sharded. Use `unshuffle_index`
    to map back to natural frequency order.
    """
    me = jax.lax.axis_index(axis_name)
    rows = x_local.shape[0]
    # step 1: local FFTs along n2
    y = jnp.fft.fft(x_local, axis=-1) if sign < 0 else \
        jnp.fft.ifft(x_local, axis=-1) * n2
    # step 2: twiddle W^{j1·k2} for the GLOBAL row index j1
    j1 = me * rows + jnp.arange(rows)
    k2 = jnp.arange(n2)
    ang = sign * 2.0 * jnp.pi * (j1[:, None] * k2[None, :]) / (n1 * n2)
    y = y * jax.lax.complex(jnp.cos(ang), jnp.sin(ang)).astype(y.dtype)
    # step 3: global transpose [n1, n2] -> [n2, n1]: each device splits
    # its rows into d column-blocks and exchanges (one all_to_all), then
    # reorders locally
    blk = n2 // d
    # y [rows, n2] -> [d, rows, blk]
    y = y.reshape(rows, d, blk).transpose(1, 0, 2)
    y = jax.lax.all_to_all(y, axis_name, split_axis=0, concat_axis=0,
                           tiled=False)        # [d, rows, blk]
    # device q now holds, for every source p, rows p·rows.. of columns
    # q·blk..; assemble local [blk, n1] transpose
    y = y.transpose(2, 0, 1).reshape(blk, d * rows)   # [blk, n1]
    # step 4: local FFTs along n1
    y = jnp.fft.fft(y, axis=-1) if sign < 0 else jnp.fft.ifft(y, axis=-1) * n1
    if sign > 0:
        y = y / (n1 * n2)
    return y


def shuffle_index(n1: int, n2: int) -> np.ndarray:
    """Input load (Bailey column-major): matrix row j1 must hold
    x[j1 + n1·j2], so flat position p = j1·n2 + j2 reads sample
    (p // n2) + n1·(p % n2)."""
    p = np.arange(n1 * n2)
    return (p // n2) + n1 * (p % n2)


def unshuffle_index(n1: int, n2: int) -> np.ndarray:
    """Output store: X_natural[k] = out_flat[(k % n2)·n1 + k // n2]
    (out is [k2, k1] row-major and X[k2 + n2·k1] = out[k2, k1])."""
    k = np.arange(n1 * n2)
    return (k % n2) * n1 + k // n2


def build_fft(n: int, mesh: Mesh, sign: int = -1):
    """Compile a full distributed FFT over `mesh` returning NATURAL-order
    output (includes the final unshuffle gather — skip it in fused
    filtering pipelines where the mask can be pre-shuffled instead).

    Returns f(x: CX[n] sharded) -> CX[n].
    """
    d = mesh.devices.size
    if n % (d * d):
        raise ValueError("n must be divisible by d^2 for the row/column "
                         "block exchange")
    n1 = d * max(1, int(np.sqrt(n // d)) // d * d)
    while n % n1 or (n // n1) % d:
        n1 += d
    n2 = n // n1

    def body(x_local: cx.CX) -> cx.CX:
        y = fft_sharded(cx.to_complex(x_local).reshape(-1, n2), n1, n2, d,
                        sign=sign)
        return cx.split(y.reshape(-1))

    sharded = jax.shard_map(body, mesh=mesh,
                            in_specs=(cx.CX(P(AXIS), P(AXIS)),),
                            out_specs=cx.CX(P(AXIS), P(AXIS)),
                            check_vma=False)
    pre = jnp.asarray(shuffle_index(n1, n2))
    post = jnp.asarray(unshuffle_index(n1, n2))

    @jax.jit
    def f(x: cx.CX) -> cx.CX:
        xs = cx.CX(x.re[pre], x.im[pre])
        y = sharded(xs)
        return cx.CX(y.re[post], y.im[post])

    return f
