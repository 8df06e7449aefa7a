"""Waterfall colormaps.

The CuteSDR palette reproduces the piecewise-linear map the reference
builds from the public CuteSDR source (utils_supersdr.py:1391-1409);
additional palettes are vectorized numpy."""

from __future__ import annotations

import numpy as np


def cutesdr_palette() -> np.ndarray:
    """[256, 3] uint8 palette (index 255 repeats 254, as pygame's
    set_palette pads)."""
    i = np.arange(255, dtype=np.float64)
    r = np.zeros(255)
    g = np.zeros(255)
    b = np.zeros(255)

    m = i < 43
    b[m] = 255 * i[m] / 43
    m = (i >= 43) & (i < 87)
    g[m] = 255 * (i[m] - 43) / 43
    b[m] = 255
    m = (i >= 87) & (i < 120)
    g[m] = 255
    b[m] = 255 - 255 * (i[m] - 87) / 32
    m = (i >= 120) & (i < 154)
    r[m] = 255 * (i[m] - 120) / 33
    g[m] = 255
    m = (i >= 154) & (i < 217)
    r[m] = 255
    g[m] = 255 - 255 * (i[m] - 154) / 62
    m = i >= 217
    r[m] = 255
    b[m] = 128 * (i[m] - 217) / 38

    pal = np.stack([r, g, b], axis=1)
    pal = np.concatenate([pal, pal[-1:]], axis=0)
    return np.clip(pal, 0, 255).astype(np.uint8)


def grayscale_palette() -> np.ndarray:
    v = np.arange(256, dtype=np.uint8)
    return np.stack([v, v, v], axis=1)


PALETTES = {"cutesdr": cutesdr_palette, "gray": grayscale_palette}


def get_palette(name: str = "cutesdr") -> np.ndarray:
    try:
        return PALETTES[name]()
    except KeyError:
        raise ValueError(f"unknown colormap {name!r}") from None


def apply(palette: np.ndarray, color_rows: np.ndarray) -> np.ndarray:
    """color_rows [rows, bins] float/int 0..255 → RGB [rows, bins, 3]."""
    idx = np.clip(np.asarray(color_rows), 0, 255).astype(np.uint8)
    return palette[idx]
