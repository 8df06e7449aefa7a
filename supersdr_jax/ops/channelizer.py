"""Polyphase filterbank channelizer: one wideband capture → M virtual
receivers.

The reference caps out at two receivers, each a separate server socket
(supersdr.py:624-639); BASELINE.md's channelizer config wants 100+ AM
channels from a full MW-band capture. The device formulation is the
classic weighted-overlap-add (WOLA) polyphase filterbank:

    x framed at hop M  →  [n_frames, K·M] windows
    multiply by the polyphase-decomposed prototype and fold K taps
    →  [n_frames, M]
    IFFT across the M axis  →  per-channel complex baseband at fs/M

Channel m is centered at m·fs/M (wrapped to ±fs/2). Critically sampled by
default; `osr=2` gives 2× oversampled channels (hop M/2) whose extra
bandwidth tolerates per-channel passband offsets.

The output [..., M, n_frames] feeds the batched receiver chain directly
(channel axis = vmap/shard axis), so wideband → thousands of demodulated
audio streams is two fused device programs end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import cx, firdesign


@dataclass(frozen=True)
class PFBPlan:
    """Static channelizer structure.

    n_chan:   number of channels M (FFT length across the filterbank)
    taps_per: prototype taps per branch K (prototype length = K·M)
    hop:      input samples per output frame (M for critical sampling,
              M//osr when oversampled)
    """
    n_chan: int
    taps_per: int
    hop: int

    @property
    def window_len(self) -> int:
        return self.n_chan * self.taps_per

    @property
    def history(self) -> int:
        return self.window_len - self.hop


@lru_cache(maxsize=64)
def design(n_chan: int, taps_per: int = 8, osr: int = 1,
           cutoff_scale: float = 1.0) -> tuple[PFBPlan, np.ndarray]:
    """Design the prototype lowpass and plan. Cutoff at
    `cutoff_scale · fs/(2M)` (channel half-width), Blackman-windowed sinc
    with the framework's design rule at fixed length K·M."""
    if osr not in (1, 2, 4):
        raise ValueError("osr must be 1, 2 or 4")
    if n_chan % osr:
        raise ValueError("n_chan must be divisible by osr")
    n = n_chan * taps_per
    if n % 2 == 0:
        # design rule wants odd; design at n+1 then drop the last (zero-ish)
        proto = firdesign.lowpass_taps_n(cutoff_scale * 0.5 / n_chan, 1.0,
                                        n + 1)[:-1]
    else:
        proto = firdesign.lowpass_taps_n(cutoff_scale * 0.5 / n_chan, 1.0, n)
    proto = proto / proto.sum()  # unity per-channel passband (DC) gain
    plan = PFBPlan(n_chan=n_chan, taps_per=taps_per, hop=n_chan // osr)
    proto = proto.astype(np.float64)
    proto.setflags(write=False)  # cached instance shared across callers
    return plan, proto


def taps_matrix(plan: PFBPlan, proto: np.ndarray) -> jnp.ndarray:
    """Polyphase weights as [taps_per, n_chan] (row k = taps[k·M .. k·M+M))
    in time-reversed fold order for the WOLA sum."""
    W = proto.reshape(plan.taps_per, plan.n_chan)
    return jnp.asarray(W, jnp.float32)


def init_carry(plan: PFBPlan, batch_shape: tuple[int, ...] = ()) -> cx.CX:
    """Zero filter history [*batch, history] (split-complex)."""
    return cx.zeros(batch_shape + (plan.history,))


def channelize_c(plan: PFBPlan, W: jax.Array, carry: jax.Array, x: jax.Array,
                 mxu_fft: bool = False) -> tuple[jax.Array, jax.Array]:
    """One streaming step on complex arrays — traced contexts only (use
    `channelize` for the public split-complex entry point). x: [*batch, n] complex64 with
    n % hop == 0.

    Returns (new_carry, channels [*batch, n_chan, n // hop]) where
    channels[m, t] is the complex baseband of the band centered at
    m·fs/n_chan (m interpreted mod M, i.e. m > M/2 are negative freqs),
    decimated to fs/hop, with the per-channel mixer phase referenced to the
    *stream* origin so consecutive calls are continuous.

    Matches the direct implementation
        y[m, t] = Σ_j proto[j] · x[t·hop - j] · e^{+2πi m (t·hop - j)/M}
    evaluated blockwise (j over the window, x padded with the carry).
    """
    n = x.shape[-1]
    if n % plan.hop:
        raise ValueError("block length must be a multiple of the hop")
    if n % plan.n_chan:
        raise ValueError("block length must be a multiple of n_chan "
                         "(keeps channel mixer phase continuous across calls)")
    n_frames = n // plan.hop
    M, K, hop = plan.n_chan, plan.taps_per, plan.hop
    seg = jnp.concatenate([carry, x], axis=-1)   # [..., history + n]

    # Derivation: y[m,t] = Σ_j h[j] x[s_t-j] e^{-2πi m (s_t-j)/M}.  With
    # g[p] = h[KM-1-p] (time-reversed prototype) and p = kM + r,
    #   y[m,t] = e^{2πi m ((KM-1) - s_t)/M} · FFT_M{ fold }[m],
    #   fold[r] = Σ_k (g·frames)[kM + r],  frames[t, p] = seg[t·hop + p].
    g = W.reshape(-1)[::-1]
    if hop == M:
        # critical sampling: the overlapping-window gather collapses to K
        # shifted row-slices of seg reshaped [n_frames+K-1, M] — a K-tap
        # depthwise conv down the rows axis, which XLA fuses into one
        # loop; never gather here.
        rows = seg.reshape(*seg.shape[:-1], n_frames + K - 1, M)
        g2 = g.reshape(K, M)
        fold = g2[0] * rows[..., 0:n_frames, :]
        for k in range(1, K):
            fold = fold + g2[k] * rows[..., k:k + n_frames, :]
    else:
        idx = (jnp.arange(n_frames)[:, None] * hop
               + jnp.arange(plan.window_len)[None, :])
        frames = seg[..., idx]                    # [..., n_frames, K·M]
        fold = (frames * g).reshape(*frames.shape[:-1], K, M).sum(-2)
    if mxu_fft and cx.fft_supported(M):
        # matmul four-step FFT (ops/cx.fft) instead of the FFT HLO
        spec_cx = cx.fft(cx.split(fold))
        spec = cx.to_complex(spec_cx)             # stays split inside jit
    else:
        spec = jnp.fft.fft(fold, axis=-1)         # [..., n_frames, M]

    # (KM-1) - s_t = history - t·hop  (mod M); for critical sampling
    # (hop = M) history = (K-1)·M so rot ≡ 0 — statically skip the
    # rotation (two full passes over the spectrum otherwise)
    if hop == M:
        chans = spec
    else:
        m_idx = jnp.arange(M)
        t_idx = jnp.arange(n_frames)
        rot = (plan.history - t_idx[:, None] * hop) % M
        phase = jnp.exp((2j * jnp.pi / M) * (m_idx[None, :] * rot))
        chans = spec * phase.astype(spec.dtype)

    new_carry = seg[..., -plan.history:]
    out = jnp.moveaxis(chans, -2, -1)             # [..., M, n_frames]
    return new_carry, out


@partial(jax.jit, static_argnums=0)
def _channelize_cx(plan: PFBPlan, W: jax.Array, carry: cx.CX, x: cx.CX
                   ) -> tuple[cx.CX, cx.CX]:
    c, out = channelize_c(plan, W, cx.to_complex(carry), cx.to_complex(x))
    return cx.split(c), cx.split(out)


def channelize(plan: PFBPlan, W, carry, x) -> tuple[cx.CX, cx.CX]:
    """Public streaming step with split-complex boundaries.
    Accepts CX / complex / real for carry and x; see `channelize_c`."""
    return _channelize_cx(plan, W, cx.as_cx(carry), cx.as_cx(x))


# ---------------------------------------------------------------------------
# Matmul-DFT channelizer ("mxu2").
#
# The DFT as two matmul stages (tensor-core work) instead of the FFT
# HLO. It never puts a small axis minor: the fold keeps M minor, the two
# FFT stages are
# `dot_general`s whose OUTPUT dim order performs the layout rotation for
# free inside the matmul write, and the result lands directly in the
# [M, n_frames] layout the receiver chain consumes (frames minor).
# Zero explicit transposes end to end. On the H100 the legacy route
# (fold, then cuFFT) is the faster of the two (PERF.md).
# ---------------------------------------------------------------------------


def _pick_factors(M: int) -> tuple[int, int] | None:
    """(n1, n2) with M = n1·n2, both ≤ MAX_DIRECT, preferring lane-friendly
    n2 (a multiple of 128 — it sits in the minor dim through stage A — as
    large as possible so n1, the stage-A contraction, stays small).
    None when M ≤ MAX_DIRECT (direct DFT) or no such factoring exists."""
    if M <= cx.MAX_DIRECT:
        return None
    for n2 in (256, 128):
        if M % n2 == 0 and M // n2 <= cx.MAX_DIRECT:
            return (M // n2, n2)
    for n2 in range(min(cx.MAX_DIRECT, M - 1), 0, -1):
        if M % n2 == 0 and M // n2 <= cx.MAX_DIRECT:
            return (M // n2, n2)
    return None


@lru_cache(maxsize=32)
def _dif_tables(M: int, n1: int, n2: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stage-A matrix with the twiddle PRE-FOLDED, plus the stage-B DFT.

    DIF indexing r = j1·n2 + j2, m = k2·n1 + k1 (validated against
    numpy.fft):  X[m] = Σ_{j2} W_{n2}^{j2 k2} · W_M^{j2 k1} ·
    Σ_{j1} x[j1 n2 + j2] W_{n1}^{j1 k1}.  Folding W_M^{j2 k1} into the
    stage-A matrix A[j2, k1, j1] = W_{n1}^{j1 k1}·W_M^{j2 k1} removes the
    twiddle's full HBM pass; the j2-batched dot keeps frames minor.
    """
    jk1 = np.outer(np.arange(n1), np.arange(n1))
    d1 = np.exp(-2j * np.pi * jk1 / n1)                    # [j1, k1]
    tw = np.exp(-2j * np.pi
                * np.outer(np.arange(n2), np.arange(n1)) / M)  # [j2, k1]
    A = d1.T[None, :, :] * tw[:, :, None]                  # [j2, k1, j1]
    jk2 = np.outer(np.arange(n2), np.arange(n2))
    c2 = np.exp(-2j * np.pi * jk2 / n2)                    # [j2, k2]
    return (A.real.astype(np.float32), A.imag.astype(np.float32),
            c2.real.astype(np.float32), c2.imag.astype(np.float32))


_make_dot = cx.make_dot  # see ops/cx.py (split-bf16 "bf16x3" tier)


def _fft_rotate_dit(fr: jax.Array, fi: jax.Array, M: int, precision
                    ) -> tuple[jax.Array, jax.Array]:
    """Alternative DIT factoring of the rotate-FFT: r = j2·n1 + j1,
    m = k1·n2 + k2, twiddle as a separate elementwise pass, and NO
    batched dot dims (the DIF form batches over j2, which sits on the
    minor axis of the fold — a layout XLA may satisfy by materializing a
    transpose in some fusion contexts)."""
    nf = fr.shape[0]
    fac = _pick_factors(M)
    if fac is None:
        return _fft_rotate(fr, fi, M, precision)
    n1, n2 = fac                     # n1 = A small (contracted), n2 = B lanes
    # r = a·B + b, m = k1·A + k2:
    #   X[k1·A+k2] = Σ_b W_B^{b·k1} · W_M^{b·k2} · Σ_a W_A^{a·k2} x[aB+b]
    c2r, c2i = map(jnp.asarray, cx._dft_tables(n1, -1))      # [a, k2] A×A
    twr, twi = map(jnp.asarray, cx._twiddle_tables(n2, n1, -1))  # [b, k2]
    d1r, d1i = map(jnp.asarray, cx._dft_tables(n2, -1))      # [b, k1] B×B
    f3r = fr.reshape(nf, n1, n2)
    f3i = fi.reshape(nf, n1, n2)
    # stage 1: contract the SECOND-minOR axis (a, size A), no batch dims:
    # Y[k2, nf, b] = Σ_a C[a, k2] · f3[nf, a, b]
    dn1 = (((1,), (1,)), ((), ()))
    dot1 = partial(jax.lax.dot_general, dimension_numbers=dn1,
                   precision=precision, preferred_element_type=jnp.float32)
    yr = dot1(c2r.T, f3r) - dot1(c2i.T, f3i)                 # [k2, nf, b]
    yi = dot1(c2r.T, f3i) + dot1(c2i.T, f3r)
    # twiddle W_M^{-b·k2} broadcast [k2, 1, b] over full-lane b
    tr = twr.T[:, None, :]
    ti = twi.T[:, None, :]
    zr = yr * tr - yi * ti
    zi = yr * ti + yi * tr
    # stage 2: contract the minor axis (b, size B):
    # X[k1, k2, nf] = Σ_b D[b, k1] · Z[k2, nf, b]
    dn2 = (((1,), (2,)), ((), ()))
    dot2 = partial(jax.lax.dot_general, dimension_numbers=dn2,
                   precision=precision, preferred_element_type=jnp.float32)
    xr = dot2(d1r.T, zr) - dot2(d1i.T, zi)                   # [k1, k2, nf]
    xi = dot2(d1r.T, zi) + dot2(d1i.T, zr)
    return xr.reshape(M, nf), xi.reshape(M, nf)


def _fft_rotate(fr: jax.Array, fi: jax.Array, M: int, precision
                ) -> tuple[jax.Array, jax.Array]:
    """FFT over the minor axis of fold [nf, M] → chans [M, nf] planes.

    Two `dot_general`s whose output orders rotate frames from major to
    minor — the transpose rides the matmul writes instead of costing
    separate passes — with the twiddle pre-folded into stage A
    (`_dif_tables`). Zero elementwise HBM passes; the output lands in the
    chain's [M, n_frames] layout directly.
    """
    nf = fr.shape[0]
    fac = _pick_factors(M)
    if fac is None:
        cr, ci = map(jnp.asarray, cx._dft_tables(M, -1))       # [r, m]
        dot = _make_dot((((1,), (1,)), ((), ())), precision)
        # lhs [m, r] free m; rhs [nf, r] free nf → out [m, nf]
        return (dot(cr.T, fr) - dot(ci.T, fi),
                dot(cr.T, fi) + dot(ci.T, fr))
    n1, n2 = fac
    Ar, Ai, c2r, c2i = map(jnp.asarray, _dif_tables(M, n1, n2))
    f3r = fr.reshape(nf, n1, n2)
    f3i = fi.reshape(nf, n1, n2)
    # stage A: Y[j2, k1, nf] = Σ_{j1} A[j2, k1, j1]·f3[nf, j1, j2]
    dotA = _make_dot((((2,), (1,)), ((0,), (2,))), precision)
    yr = dotA(Ar, f3r) - dotA(Ai, f3i)                     # [j2, k1, nf]
    yi = dotA(Ar, f3i) + dotA(Ai, f3r)
    # stage B: X[k2, k1, nf] = Σ_{j2} C2[j2, k2]·Y[j2, k1, nf]
    dotB = _make_dot((((1,), (0,)), ((), ())), precision)
    xr = dotB(c2r.T, yr) - dotB(c2i.T, yi)                 # [k2, k1, nf]
    xi = dotB(c2r.T, yi) + dotB(c2i.T, yr)
    return xr.reshape(M, nf), xi.reshape(M, nf)


def _fold_slices(g2: jax.Array, rows: jax.Array, n_frames: int, K: int
                 ) -> jax.Array:
    """K-tap WOLA fold as shifted row-slices (gather-free)."""
    fold = g2[0] * rows[0:n_frames, :]
    for k in range(1, K):
        fold = fold + g2[k] * rows[k:k + n_frames, :]
    return fold


def _fold_conv(g2: jax.Array, rows: jax.Array, n_frames: int, K: int
               ) -> jax.Array:
    """K-tap fold as a depthwise conv down the frames axis (one XLA
    conv). rows [nT, M] → fold [n_frames, M]."""
    M = rows.shape[-1]
    rows = rows.astype(jnp.float32)        # conv needs matching dtypes
    lhs = rows[None]                       # [N=1, W=nT, C=M]
    rhs = g2[:, None, :]                   # [W=K, I=1, O=M]
    dn = jax.lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                        ("NWC", "WIO", "NWC"))
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=dn, feature_group_count=M,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[0]


def channelize_mxu2_c(plan: PFBPlan, W: jax.Array, carry: jax.Array,
                      x: jax.Array, *, fold_impl: str = "slices",
                      precision=jax.lax.Precision.HIGHEST,
                      fold_dtype=jnp.float32,
                      fft_form: str = "dif") -> tuple[jax.Array, jax.Array]:
    """Lane-layout channelizer step (traced contexts, critical sampling).

    x: [n] complex64, n % n_chan == 0. Returns (new_carry, chans [M, n//M])
    — numerically equivalent to `channelize_c` (same math, same index
    conventions) but ~zero transpose passes and full-lane layouts
    throughout; see the module section comment for why this matters.

    fold_dtype=float16 stores the fold's input window in f16 (11-bit
    mantissa, ≈68 dB quantization floor — well above the 50 dB audio
    gate), halving the K-tap fold's HBM read traffic; accumulation stays
    f32. A/B'd on-chip: ~2.7× faster fold at the headline shape.
    """
    if plan.hop != plan.n_chan:
        raise ValueError("mxu2 channelizer requires critical sampling")
    if x.ndim != 1:
        raise ValueError("mxu2 channelizer is unbatched ([n] input)")
    M, K = plan.n_chan, plan.taps_per
    n = x.shape[-1]
    if n % M:
        raise ValueError("block length must be a multiple of n_chan")
    n_frames = n // M
    seg = jnp.concatenate([carry, x], axis=-1)
    g2 = W.reshape(-1)[::-1].reshape(K, M)
    rows_r = jnp.real(seg).reshape(n_frames + K - 1, M)
    rows_i = jnp.imag(seg).reshape(n_frames + K - 1, M)
    if fold_dtype != jnp.float32:
        if fold_impl == "conv":
            # _fold_conv casts back to f32 (conv needs matching dtypes) —
            # a silent ignore would make f16-vs-conv A/Bs measure the
            # wrong thing
            raise ValueError("fold_impl='conv' runs in float32; combine "
                             "fold_dtype='f16' with the 'slices' fold")
        rows_r = rows_r.astype(fold_dtype)
        rows_i = rows_i.astype(fold_dtype)
    fold_fn = _fold_conv if fold_impl == "conv" else _fold_slices
    fr = fold_fn(g2, rows_r, n_frames, K)
    fi = fold_fn(g2, rows_i, n_frames, K)
    rot = _fft_rotate_dit if fft_form == "dit" else _fft_rotate
    xr, xi = rot(fr, fi, M, precision)
    new_carry = seg[..., -plan.history:]
    return new_carry, jax.lax.complex(xr, xi)


def channel_center_freqs(plan: PFBPlan, fs: float) -> np.ndarray:
    """Center frequency (Hz, wrapped to ±fs/2) of each channel index."""
    m = np.arange(plan.n_chan)
    f = m * fs / plan.n_chan
    f[f >= fs / 2] -= fs
    return f
