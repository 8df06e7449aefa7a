"""Parallel (associative) scan building blocks for streaming DSP.

Sequential recurrences are the data-parallel-hostile part of an SDR chain
(AGC peak tracking, one-pole smoothing, DC blockers). Instead of
`lax.scan` at sample rate, every first-order recurrence used in the XLA
path is expressed as an *associative* operator and evaluated with
`jax.lax.associative_scan`, which runs in O(log n) depth of full-width
vector ops. (On a GPU the chain's tail runs these recurrences in order
inside one kernel instead: ops/pallas/chain_tail.py.)

Two recurrence families cover everything we need:

  linear   : y[n] = a[n] * y[n-1] + b[n]          (one-pole IIR, DC block)
  max-plus : y[n] = max(y[n-1] + a[n], b[n])      (peak detector w/ decay,
                                                   in log/dB domain)

Both are associative under composition of the affine / tropical-affine maps
(a, b), so they parallelize exactly (not approximately).

Every scan optionally extends *across a sharded mesh axis* (`axis_name`):
inside `shard_map`, each device computes its local scan, the per-shard
composition summaries (a handful of scalars) are all-gathered, and
each device folds the shards preceding it — a two-level parallel prefix.
The cross-device traffic is O(D) scalars per scan, independent of block
length, so time-sharded streaming (SURVEY.md §5's sequence-parallel analog)
is exact, not approximate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _fold_preceding_shards(summaries_a, summaries_b, y0, my_idx, apply_op):
    """Fold shard summaries j < my_idx (in order) onto y0.

    summaries_[ab]: [D, ...] gathered per-shard composition elements.
    apply_op(y, a, b) applies one shard's composed map. D is static.
    """
    y_in = y0
    d = summaries_a.shape[0]
    for j in range(d):
        y_next = apply_op(y_in, summaries_a[j], summaries_b[j])
        y_in = jnp.where(j < my_idx, y_next, y_in)
    return y_in


def linear_scan(a: jax.Array, b: jax.Array, y0, axis: int = -1,
                axis_name: str | None = None) -> jax.Array:
    """Evaluate y[n] = a[n] * y[n-1] + b[n] with y[-1] = y0, in parallel.

    `a` and `b` have the same shape; the recurrence runs along `axis`.
    `y0` broadcasts against the non-scan dims. Returns y with the same
    shape as b. With `axis_name` (inside shard_map), the recurrence runs
    across the sharded time axis exactly; `y0` then seeds shard 0 only.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)

    def combine(l, r):
        a_l, b_l = l
        a_r, b_r = r
        return a_r * a_l, a_r * b_l + b_r

    a_s, b_s = jax.lax.associative_scan(combine, (a, b), axis=axis)
    y0 = _align_y0(y0, b, axis)
    if axis_name is not None:
        ax = axis if axis >= 0 else b.ndim + axis
        idx = tuple(slice(None) if d != ax else slice(-1, None)
                    for d in range(b.ndim))
        sum_a = jax.lax.all_gather(a_s[idx], axis_name)   # [D, ..., 1]
        sum_b = jax.lax.all_gather(b_s[idx], axis_name)
        my = jax.lax.axis_index(axis_name)
        y0 = _fold_preceding_shards(sum_a, sum_b, y0, my,
                                    lambda y, sa, sb: sa * y + sb)
    # y[n] = A[0..n] * y_in + B[0..n]
    return a_s * y0 + b_s


def _align_y0(y0, b: jax.Array, axis: int) -> jax.Array:
    """Shape y0 (scalar or [*batch]) to broadcast against b with a
    singleton scan axis."""
    y0 = jnp.asarray(y0, dtype=b.dtype)
    ax = axis if axis >= 0 else b.ndim + axis
    if y0.ndim == b.ndim:
        return y0
    if y0.ndim == 0:
        return jnp.reshape(y0, (1,) * b.ndim)
    # y0 carries the batch dims: insert the scan axis as a singleton
    return jnp.expand_dims(y0, axis=ax)


def maxplus_scan(a: jax.Array, b: jax.Array, y0, axis: int = -1,
                 axis_name: str | None = None) -> jax.Array:
    """Evaluate y[n] = max(y[n-1] + a[n], b[n]) with y[-1] = y0, in parallel.

    This is the tropical-semiring analogue of `linear_scan`: composition of
    f_i(p) = max(p + a_i, b_i) is f_2∘f_1 = (a_1+a_2, max(b_1+a_2, b_2)).
    Used for dB-domain peak detectors: a = -decay_db_per_sample,
    b = envelope_db. `axis_name` extends across a sharded time axis.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)

    def combine(l, r):
        a_l, b_l = l
        a_r, b_r = r
        return a_l + a_r, jnp.maximum(b_l + a_r, b_r)

    a_s, b_s = jax.lax.associative_scan(combine, (a, b), axis=axis)
    y0 = _align_y0(y0, b, axis)
    if axis_name is not None:
        ax = axis if axis >= 0 else b.ndim + axis
        idx = tuple(slice(None) if d != ax else slice(-1, None)
                    for d in range(b.ndim))
        sum_a = jax.lax.all_gather(a_s[idx], axis_name)
        sum_b = jax.lax.all_gather(b_s[idx], axis_name)
        my = jax.lax.axis_index(axis_name)
        y0 = _fold_preceding_shards(
            sum_a, sum_b, y0, my,
            lambda y, sa, sb: jnp.maximum(y + sa, sb))
    return jnp.maximum(a_s + y0, b_s)


def linear_scan_const(a, b: jax.Array, y0, block: int = 128) -> jax.Array:
    """`linear_scan` specialized to a time-CONSTANT coefficient `a`
    (scalar or [*batch, 1]-broadcastable): y[n] = a·y[n-1] + b[n].

    Blocked formulation: within a block of S samples the scan is a lower-
    triangular Toeplitz matmul w = B @ Tᵀ with T[i,j] = a^(i-j) (i ≥ j) —
    matmul work instead of log₂(n) full-array passes; the S× fewer block
    carries chain through a tiny associative scan. ~3 HBM passes total
    versus ~log₂(n) for the general scan. Exponents stay ≤ 0 so no
    overflow for |a| ≤ 1 (the one-pole case).
    """
    b = jnp.asarray(b)
    n = b.shape[-1]
    if n % block:
        return linear_scan(jnp.broadcast_to(jnp.asarray(a, b.dtype),
                                            b.shape), b, y0)
    a = jnp.asarray(a, b.dtype)
    nb = n // block
    i = jnp.arange(block)
    expo = i[:, None] - i[None, :]
    T = jnp.where(expo >= 0,
                  a ** jnp.maximum(expo, 0).astype(b.dtype), 0.0)  # [S, S]
    blocks = b.reshape(*b.shape[:-1], nb, block)
    # HIGHEST precision: a reduced-precision matmul (bf16 or TF32
    # inputs) loses audio SNR through the recurrence
    w = jnp.einsum("...ns,ts->...nt", blocks, T,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=b.dtype)             # [.., nb, S]
    # carries: c[k] = a^S·c[k-1] + w_end[k]
    w_end = w[..., -1]
    aS = jnp.broadcast_to(a ** block, w_end.shape)
    c = linear_scan(aS, w_end, y0, axis=-1)                    # [.., nb]
    y0b = _align_y0(y0, c, -1)
    c_prev = jnp.concatenate(
        [jnp.broadcast_to(y0b, c[..., :1].shape), c[..., :-1]], axis=-1)
    y = w + (a ** (i + 1)) * c_prev[..., None]
    return y.reshape(*b.shape[:-1], n)


def blocked_cummax(s: jax.Array, block: int = 128) -> jax.Array:
    """Cumulative max along the last axis, two-level.

    XLA lowers `lax.cummax` over a length-n axis to ~log2(n) full-array
    shifted-max passes (14 HBM passes at the 16k bench shape). Blocking
    cuts that to log2(block) passes over the same data plus a tiny
    block-tail scan: reshape [nb, B], cummax within blocks, cummax the
    nb block tails (negligible — n/B elements), combine with one
    broadcast max. ~half the HBM traffic at B=128.
    """
    n = s.shape[-1]
    if n % block or n <= block:
        return jax.lax.cummax(s, axis=s.ndim - 1)
    nb = n // block
    sb = s.reshape(*s.shape[:-1], nb, block)
    within = jax.lax.cummax(sb, axis=s.ndim)           # [..., nb, B]
    tails = jax.lax.cummax(within[..., -1], axis=s.ndim - 1)  # [..., nb]
    neg_inf = jnp.asarray(-jnp.inf, s.dtype)
    prev = jnp.concatenate(
        [jnp.full_like(tails[..., :1], neg_inf), tails[..., :-1]], axis=-1)
    return jnp.maximum(within, prev[..., None]).reshape(s.shape)


def maxplus_scan_const(a, b: jax.Array, y0) -> jax.Array:
    """`maxplus_scan` specialized to a time-CONSTANT decrement `a`:
    y[n] = max(y[n-1] + a, b[n]).  With s[j] = b[j] − j·a this collapses
    to y[n] = n·a + max(cummax(s)[n], y0 + a) — one (blocked) cumulative
    max over a single array instead of an associative scan over (a, b)
    pairs."""
    b = jnp.asarray(b)
    n = b.shape[-1]
    j = jnp.arange(n, dtype=b.dtype)
    a = jnp.asarray(a, b.dtype)
    s = b - j * a
    cm = blocked_cummax(s)
    y0b = jnp.asarray(y0, b.dtype)
    if y0b.ndim < b.ndim:
        y0b = y0b[..., None]
    return j * a + jnp.maximum(cm, y0b + a)


def one_pole(x: jax.Array, coeff: jax.Array, y0, axis: int = -1,
             axis_name: str | None = None) -> jax.Array:
    """One-pole smoother y[n] = coeff*y[n-1] + (1-coeff)*x[n] (parallel)."""
    coeff = jnp.asarray(coeff, dtype=x.dtype)
    a = jnp.broadcast_to(coeff, x.shape)
    return linear_scan(a, (1.0 - coeff) * x, y0, axis=axis,
                       axis_name=axis_name)


def left_halo(x: jax.Array, n: int, axis_name: str, fill=0.0) -> jax.Array:
    """Inside shard_map over a time-sharded axis: the last `n` samples of
    the left neighbor's block (shard 0 receives `fill`).

    This is the overlap-save boundary exchange (SURVEY.md §5): the role the
    reference's serial `old_buffer` plays (utils_supersdr.py:1005,1130-1133)
    becomes one `ppermute` hop over the device interconnect.
    """
    if n > x.shape[-1]:
        raise ValueError("halo larger than local block; use left_context")
    tail = x[..., -n:]
    d = jax.lax.axis_size(axis_name)
    recv = jax.lax.ppermute(tail, axis_name,
                            perm=[(i, i + 1) for i in range(d - 1)])
    idx = jax.lax.axis_index(axis_name)
    fill_arr = jnp.full_like(recv, fill)
    return jnp.where(idx == 0, fill_arr, recv)


def left_context(x: jax.Array, n: int, axis_name: str, fill=0.0) -> jax.Array:
    """Like `left_halo` but for contexts longer than one shard: gathers the
    preceding ceil(n/local) shards with multi-hop ppermutes and returns the
    last `n` samples of the concatenated history (fill past stream start)."""
    local = x.shape[-1]
    hops = -(-n // local)
    d = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    parts = []
    for h in range(hops, 0, -1):
        if h >= d:
            parts.append(jnp.full_like(x, fill))
            continue
        recv = jax.lax.ppermute(x, axis_name,
                                perm=[(i, i + h) for i in range(d - h)])
        recv = jnp.where(idx < h, jnp.full_like(x, fill), recv)
        parts.append(recv)
    return jnp.concatenate(parts, axis=-1)[..., -n:]


def dc_block(x: jax.Array, r, y0_x, y0_y, axis: int = -1,
             axis_name: str | None = None):
    """DC blocker y[n] = x[n] - x[n-1] + r*y[n-1].

    Returns (y, (last_x, last_y)) so the state threads across blocks.
    `y0_x` is the final input sample of the previous block, `y0_y` the final
    output sample. With `axis_name`, x[n-1] at a shard boundary comes from
    the left neighbor (ppermute) and the IIR part runs cross-shard.
    """
    if axis not in (-1, jnp.asarray(x).ndim - 1):
        raise NotImplementedError("dc_block supports axis=-1 only")
    x = jnp.asarray(x)
    r = jnp.asarray(r, dtype=x.dtype)
    x_prev0 = jnp.broadcast_to(jnp.asarray(y0_x, x.dtype), x[..., 0].shape)
    if axis_name is not None:
        neighbor = left_halo(x, 1, axis_name)[..., 0]
        idx = jax.lax.axis_index(axis_name)
        x_prev0 = jnp.where(idx == 0, x_prev0, neighbor)
    prev = jnp.concatenate([x_prev0[..., None], x[..., :-1]], axis=-1)
    diff = x - prev
    if axis_name is None and jnp.ndim(r) == 0:
        y = linear_scan_const(r, diff, y0_y)     # r is time-constant
    else:
        a = jnp.broadcast_to(r, x.shape)
        y = linear_scan(a, diff, y0_y, axis=-1, axis_name=axis_name)
    return y, (x[..., -1], y[..., -1])


def sliding_max(x: jax.Array, window: int, axis: int = -1,
                axis_name: str | None = None) -> jax.Array:
    """Causal sliding-window maximum over `window` samples (inclusive).

    y[n] = max(x[n-window+1 .. n]).  Implemented as a log2-depth cascade of
    shifted maxima (van Herk style doubling) — full-width vector ops only.
    Edge samples use a shrunken window (as if x were left-padded with -inf).
    With `axis_name`, the window reaches into the left neighbor's shard via
    a halo exchange (window must not exceed the local block length).
    """
    if axis not in (-1, x.ndim - 1):
        raise NotImplementedError("sliding_max supports axis=-1 only")
    if window <= 1:
        return x
    if axis_name is not None:
        halo = left_context(x, window - 1, axis_name, fill=-jnp.inf)
        ext = jnp.concatenate([halo, x], axis=-1)
        return sliding_max(ext, window)[..., window - 1:]
    neg_inf = jnp.asarray(-jnp.inf, dtype=x.dtype)
    y = x
    covered = 1
    while covered < window:
        shift = min(covered, window - covered)
        shifted = jnp.concatenate(
            [jnp.full_like(y[..., :shift], neg_inf), y[..., :-shift]],
            axis=-1)
        y = jnp.maximum(y, shifted)
        covered += shift
    return y
