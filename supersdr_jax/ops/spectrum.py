"""Streaming FFT spectrum + waterfall pipeline.

The reference receives pre-computed 1024-bin uint8 waterfall rows from the
KiwiSDR server and post-processes them client-side: dB calibration
`-(255-wf) - 13 + 3·zoom`, percentile auto-leveling (P40/P100 with a
≥40 dB minimum displayed range), 0..254 color normalization
(/root/reference/utils_supersdr.py:787-813), and LINRAD-style N× time-binned
averaging (utils_supersdr.py:879-886). Here the rows themselves are computed
natively — windowed FFT power spectra over the tuned span — and the same
auto-leveling / averaging semantics are applied, batched over rows so an
entire waterfall history processes in one fused XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import cx

MIN_DYN_RANGE_DB = 40.0     # kiwi_waterfall.MIN_DYN_RANGE
CLIP_LOW_PERCENTILE = 40.0  # kiwi_waterfall.CLIP_LOWP
CLIP_HIGH_PERCENTILE = 100.0
KIWI_WF_CAL_DB = -13.0      # utils_supersdr.py:789


def spectrum_window(nfft: int, kind: str = "hann") -> jnp.ndarray:
    if kind == "hann":
        w = np.hanning(nfft)
    elif kind == "blackman":
        w = np.blackman(nfft)
    elif kind == "rect":
        w = np.ones(nfft)
    else:
        raise ValueError(kind)
    # normalize for coherent gain so a full-scale tone reads ~0 dBFS
    w = w / np.sum(w) * nfft
    return jnp.asarray(w, jnp.float32)


def power_spectrum_db(iq, window: jax.Array,
                      cal_db: float = KIWI_WF_CAL_DB) -> jax.Array:
    """Windowed FFT power rows. iq: [*batch, nfft] complex (or CX) →
    [*batch, nfft] dB, fftshifted so bin 0 is the low edge of the span
    (matching the waterfall's left-to-right frequency order). Complex input
    is for traced contexts; eager callers use `waterfall_rows_db`."""
    if isinstance(iq, cx.CX):
        iq = cx.to_complex(iq)
    nfft = iq.shape[-1]
    xw = iq * window.astype(iq.dtype)
    X = jnp.fft.fftshift(jnp.fft.fft(xw, axis=-1), axes=-1)
    p = (jnp.abs(X) / nfft) ** 2
    return 10.0 * jnp.log10(jnp.maximum(p, 1e-30)) + cal_db


def segment_rows(iq, nfft: int, hop: int | None = None):
    """Split a long IQ block into FFT rows. iq [..., n] → [..., rows, nfft].
    Works on real, complex, and CX inputs. Non-overlapping segmentation is
    a reshape; overlapping windows fall back to a gather (prefer
    hop == nfft on the device)."""
    hop = hop or nfft
    n = iq.shape[-1]
    rows = (n - nfft) // hop + 1
    if hop == nfft:
        return iq[..., : rows * nfft].reshape(*iq.shape[:-1], rows, nfft)
    idx = jnp.arange(rows)[:, None] * hop + jnp.arange(nfft)[None, :]
    return iq[..., idx]


@partial(jax.jit, static_argnums=(2, 3, 4))
def _waterfall_rows_db_cx(iq: cx.CX, window: jax.Array, nfft: int, hop: int,
                          cal_db: float) -> jax.Array:
    rows = segment_rows(cx.to_complex(iq), nfft, hop)
    return power_spectrum_db(rows, window, cal_db)


def waterfall_rows_db(iq, window: jax.Array, nfft: int,
                      hop: int | None = None,
                      cal_db: float = KIWI_WF_CAL_DB) -> jax.Array:
    """Public pipeline: IQ (CX / complex numpy) → [rows, nfft] dB.
    One fused program — segmentation, window, FFT, power, calibration —
    with float-only program boundaries."""
    return _waterfall_rows_db_cx(cx.as_cx(iq), window, nfft,
                                 int(hop or nfft), float(cal_db))


def time_binned_average(rows_db: jax.Array, n_avg: int) -> jax.Array:
    """LINRAD-style averaging: mean of every n_avg consecutive rows in the
    *linear power* domain (the reference averages the raw uint8 spectra,
    utils_supersdr.py:881-886 — linear-in-byte ≈ dB; we average power for
    correct SNR gain and return dB). rows_db [..., R, bins] with R % n == 0."""
    if n_avg <= 1:
        return rows_db
    shape = rows_db.shape
    r = shape[-2] // n_avg
    g = rows_db[..., : r * n_avg, :].reshape(*shape[:-2], r, n_avg, shape[-1])
    p = jnp.power(10.0, g / 10.0)
    return 10.0 * jnp.log10(jnp.maximum(jnp.mean(p, axis=-2), 1e-30))


class AutoLevel(NamedTuple):
    color: jax.Array    # [..., bins] float 0..255 (clipped at 254 scale)
    low_db: jax.Array   # chosen low clip (per row)
    high_db: jax.Array
    dyn_range: jax.Array


def autolevel(row_db: jax.Array,
              auto: bool = True,
              low_clip_db: float = -120.0,
              high_clip_db: float = -60.0,
              delta_low_db: float = 0.0,
              delta_high_db: float = 0.0,
              clip_lowp: float = CLIP_LOW_PERCENTILE,
              clip_highp: float = CLIP_HIGH_PERCENTILE,
              min_dyn_range: float = MIN_DYN_RANGE_DB) -> AutoLevel:
    """Percentile auto-leveling → colormap indices, reference semantics
    (utils_supersdr.py:787-813 `spectrum_db2col`).

    row_db: [..., bins]. When `auto`, low/high clips come from the P40/P100
    percentiles of each row; the displayed dynamic range is at least
    `min_dyn_range` dB. Returns color values scaled 0..254 then clipped to
    0..255, plus the per-row dB window actually used.
    """
    if auto:
        low = jnp.percentile(row_db, clip_lowp, axis=-1, keepdims=True)
        high = jnp.percentile(row_db, clip_highp, axis=-1, keepdims=True)
    else:
        low = jnp.full(row_db.shape[:-1] + (1,), low_clip_db, row_db.dtype)
        high = jnp.full(row_db.shape[:-1] + (1,), high_clip_db, row_db.dtype)
    dyn = jnp.maximum(high - low, min_dyn_range)
    shifted = row_db - (low + delta_low_db)
    norm = (dyn + delta_high_db) - delta_low_db
    color = jnp.clip(shifted / norm, 0.0, 1.0) * 254.0
    color = jnp.clip(color, 0.0, 255.0)
    return AutoLevel(color=color,
                     low_db=(low + delta_low_db)[..., 0],
                     high_db=(low + norm)[..., 0],
                     dyn_range=dyn[..., 0])


def kiwi_byte_to_db(wf_bytes: jax.Array, zoom: int) -> jax.Array:
    """Wire-format compatibility: decode a KiwiSDR uint8 waterfall row to dB
    with the reference's calibration `-(255-b) - 13 + 3·zoom`
    (utils_supersdr.py:787-790). The first bin is broken server-side and is
    replaced by its neighbor, as the reference does."""
    wf = wf_bytes.astype(jnp.float32)
    db = -(255.0 - wf) - 13.0 + 3.0 * zoom
    return db.at[..., 0].set(db[..., 1])


def scroll(history: jax.Array, new_row: jax.Array) -> jax.Array:
    """Waterfall history update: shift rows down one, write the new row at
    the top (utils_supersdr.py:893-897) — functional, jit-safe."""
    return jnp.concatenate([new_row[..., None, :], history[..., :-1, :]],
                           axis=-2)


def spectrum_scope_row(history_color: jax.Array, n_rows: int = 15) -> jax.Array:
    """Scope trace = mean of the newest n_rows waterfall rows
    (utils_supersdr.py:1678)."""
    return jnp.mean(history_color[..., :n_rows, :], axis=-2)
