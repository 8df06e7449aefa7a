"""Split-complex arithmetic and matmul-formulated FFTs.

This module provides:

  * `CX` — an explicit split-complex value: two float32 planes (re, im).
    It is a NamedTuple, so it is a pytree and passes through jit /
    shard_map / scans unchanged. All framework device code uses CX at
    program boundaries; complex64 appears only host-side (numpy).
  * `fft` / `ifft` — a recursive four-step (Cooley-Tukey) FFT over the
    last axis, built ENTIRELY from real matmuls + twiddle multiplies:
    DFT-by-matrix for factors ≤ MAX_DIRECT, `N = N1·N2` decomposition
    with balanced factors above that. Every FLOP is a matmul, and
    batch dims stay untouched leading dims. Cost is N·(ΣNi) MACs per
    element-batch versus N·log2(N) for a radix-2 FFT — for the sizes an
    SDR needs (≤ 64k) with factors ≤ 256 this is at most a few× more
    FLOPs, paid on the tensor cores.

Replaces the reference's reliance on numpy/scipy FFTs (e.g. waterfall
rows, resample_poly internals — /root/reference/utils_supersdr.py:787,
/root/reference/utils_supersdr.py:1126) with device-side formulations.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_DIRECT = 256  # largest DFT evaluated as a single [n, n] matmul


class CX(NamedTuple):
    """Split-complex array: z = re + i·im, two same-shape float planes."""
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    # numpy-style aliases so code written for complex arrays reads naturally
    @property
    def real(self):
        return self.re

    @property
    def imag(self):
        return self.im

    def __array__(self, dtype=None, copy=None):
        """np.asarray(cx) → complex numpy array (two float fetches)."""
        out = np.asarray(self.re, np.float32).astype(np.complex64) \
            + 1j * np.asarray(self.im, np.float32).astype(np.complex64)
        return out if dtype is None else out.astype(dtype)

    def __add__(self, o):
        o = as_cx(o)
        return CX(self.re + o.re, self.im + o.im)

    def __sub__(self, o):
        o = as_cx(o)
        return CX(self.re - o.re, self.im - o.im)

    def __mul__(self, o):
        if isinstance(o, CX):
            return CX(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return CX(self.re * o, self.im * o)  # real scalar/array

    def __getitem__(self, idx):
        return CX(self.re[idx], self.im[idx])

    def conj(self) -> "CX":
        return CX(self.re, -self.im)

    def abs2(self) -> jax.Array:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jax.Array:
        return jnp.sqrt(self.abs2())

    def reshape(self, *shape) -> "CX":
        return CX(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype) -> "CX":
        return CX(self.re.astype(dtype), self.im.astype(dtype))


def as_cx(x) -> CX:
    """Coerce: CX passthrough; complex numpy/jax split host-side; real
    arrays get a zero imaginary plane."""
    if isinstance(x, CX):
        return x
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        return CX(jnp.asarray(x.real, jnp.float32),
                  jnp.asarray(x.imag, jnp.float32))
    if hasattr(x, "dtype") and jnp.iscomplexobj(x):
        # jax complex array: only safe on backends with complex buffers
        # (CPU); split through real/imag ops
        return CX(jnp.real(x).astype(jnp.float32),
                  jnp.imag(x).astype(jnp.float32))
    arr = jnp.asarray(x, jnp.float32)
    return CX(arr, jnp.zeros_like(arr))


def to_numpy(z: CX) -> np.ndarray:
    return np.asarray(z.re).astype(np.complex64) + 1j * np.asarray(z.im)


def to_complex(z: CX) -> jax.Array:
    """CX → complex64 array, for traced (jit) contexts: the framework's
    program boundaries carry split-complex CX pairs only."""
    return jax.lax.complex(jnp.asarray(z.re, jnp.float32),
                           jnp.asarray(z.im, jnp.float32))


def split(x: jax.Array) -> CX:
    """complex array (a tracer inside jit, or any array on CPU) → CX."""
    if isinstance(x, CX):
        return x
    if jnp.iscomplexobj(x):
        return CX(jnp.real(x).astype(jnp.float32),
                  jnp.imag(x).astype(jnp.float32))
    x = jnp.asarray(x, jnp.float32)
    return CX(x, jnp.zeros_like(x))


def zeros(shape, dtype=jnp.float32) -> CX:
    return CX(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def stack(zs, axis=0) -> CX:
    return CX(jnp.stack([z.re for z in zs], axis),
              jnp.stack([z.im for z in zs], axis))


def concatenate(zs, axis=-1) -> CX:
    return CX(jnp.concatenate([z.re for z in zs], axis),
              jnp.concatenate([z.im for z in zs], axis))


def swapaxes(z: CX, a: int, b: int) -> CX:
    return CX(jnp.swapaxes(z.re, a, b), jnp.swapaxes(z.im, a, b))


def exp_i(phase: jax.Array) -> CX:
    """e^{i·phase} for a real phase array."""
    return CX(jnp.cos(phase), jnp.sin(phase))


# ---------------------------------------------------------------------------
# FFT: recursive four-step decomposition, all matmuls
# ---------------------------------------------------------------------------

def _balanced_factor(n: int) -> int:
    """Largest divisor of n that is ≤ sqrt(n) (1 if n is prime)."""
    best = 1
    f = 2
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


@lru_cache(maxsize=None)
def _plan(n: int) -> tuple:
    """Factor tree: () leaf for direct DFT, else (N1, N2) with both
    recursively planned. Raises for unsupported (large prime) sizes."""
    if n <= MAX_DIRECT:
        return ()
    f = _balanced_factor(n)
    if f == 1:
        raise ValueError(
            f"fft size {n} is a prime > {MAX_DIRECT}; choose a composite "
            f"block size (SDR block sizes are composite by construction)")
    return (n // f, f)  # N1 = n//f ≥ f = N2


@lru_cache(maxsize=None)
def _dft_tables(n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT matrices W[j, k] = exp(sign·2πi·jk/n), float32."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    ang = sign * 2.0 * np.pi * jk / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@lru_cache(maxsize=None)
def _twiddle_tables(n1: int, n2: int, sign: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """W_N^{sign·n1·k2} laid out [n1, n2] for the four-step twiddle."""
    n = n1 * n2
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _cmatmul(xr, xi, cr, ci):
    """(xr + i·xi) @ (cr + i·ci) as four real matmuls, f32 accum."""
    dot = lambda a, b: jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return (dot(xr, cr) - dot(xi, ci), dot(xr, ci) + dot(xi, cr))


def _fft_last(xr, xi, sign: int):
    n = xr.shape[-1]
    plan = _plan(n)
    if plan == ():
        cr, ci = _dft_tables(n, sign)
        return _cmatmul(xr, xi, jnp.asarray(cr), jnp.asarray(ci))
    n1, n2 = plan
    batch = xr.shape[:-1]
    # x[n1 + N1·n2] → [..., N2, N1] → put n2 last → inner DFTs over N2
    xr = jnp.swapaxes(xr.reshape(*batch, n2, n1), -1, -2)
    xi = jnp.swapaxes(xi.reshape(*batch, n2, n1), -1, -2)
    yr, yi = _fft_last(xr, xi, sign)                 # [..., n1, k2]
    twr, twi = _twiddle_tables(n1, n2, sign)
    twr, twi = jnp.asarray(twr), jnp.asarray(twi)
    yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
    # outer DFTs over n1 → [..., k2, k1]
    yr = jnp.swapaxes(yr, -1, -2)
    yi = jnp.swapaxes(yi, -1, -2)
    zr, zi = _fft_last(yr, yi, sign)                 # [..., k2, k1]
    # X[k2 + N2·k1] → [..., k1, k2] flattened
    zr = jnp.swapaxes(zr, -1, -2).reshape(*batch, n)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*batch, n)
    return zr, zi


def fft(z: CX, axis: int = -1) -> CX:
    z = as_cx(z)
    if axis not in (-1, z.ndim - 1):
        z = swapaxes(z, axis, -1)
    r, i = _fft_last(z.re, z.im, -1)
    out = CX(r, i)
    if axis not in (-1, out.ndim - 1):
        out = swapaxes(out, axis, -1)
    return out


def ifft(z: CX, axis: int = -1) -> CX:
    z = as_cx(z)
    if axis not in (-1, z.ndim - 1):
        z = swapaxes(z, axis, -1)
    n = z.shape[-1]
    r, i = _fft_last(z.re, z.im, +1)
    out = CX(r / n, i / n)
    if axis not in (-1, out.ndim - 1):
        out = swapaxes(out, axis, -1)
    return out


def fft_supported(n: int) -> bool:
    try:
        _plan(n)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# layout-rotating two-stage FFT pair (round 3)
#
# `fft` above is layout-agnostic but swaps small factors into the lane
# dimension (measured ~3× off the HBM roofline at SDR shapes). This pair
# instead expresses one FFT level as two dot_generals whose OUTPUT dim
# order carries the layout rotation for free:
#
#   fft_rotate : x [b, n]  (n minor)  →  X [n, b]  (b minor)
#   ifft_major : X [n, b]  (n MAJOR)  →  z [n, b]
#
# Composing them implements overlap-save convolution with the batch axis
# lane-resident through every pass: forward-rotate, multiply the [n]
# mask down the major axis, inverse in place, one final transpose back
# to [b, n]. DIF indexing r = j1·n2 + j2, m = k2·n1 + k1 with the
# twiddle folded into the stage matrices (no elementwise twiddle pass).
# ---------------------------------------------------------------------------


def _balanced_pair(n: int) -> tuple[int, int] | None:
    """(n1, n2), n = n1·n2, both ≤ MAX_DIRECT, as square as possible
    (minimizes the inverse's [n1, n2, n2] table)."""
    if n <= MAX_DIRECT:
        return None
    best = None
    f = 1
    i = 2
    while i * i <= n:
        if n % i == 0:
            f = i
        i += 1
    for n1 in range(f, 0, -1):
        if n % n1 == 0 and n // n1 <= MAX_DIRECT and n1 <= MAX_DIRECT:
            best = (n1, n // n1)
            break
    return best


@lru_cache(maxsize=16)
def _rot_fwd_tables(n: int, n1: int, n2: int):
    """Forward: A[j2, k1, j1] = W_{n1}^{-j1k1}·W_n^{-j2k1};
    C2[j2, k2] = W_{n2}^{-j2k2}."""
    d1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    A = d1.T[None, :, :] * tw[:, :, None]                   # [j2, k1, j1]
    c2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    return (A.real.astype(np.float32), A.imag.astype(np.float32),
            c2.real.astype(np.float32), c2.imag.astype(np.float32))


@lru_cache(maxsize=16)
def _rot_inv_tables(n: int, n1: int, n2: int):
    """Inverse: B[k1, j2, k2] = W_n^{+j2k1}·W_{n2}^{+j2k2} (scaled 1/n);
    D[j1, k1] = W_{n1}^{+j1k1}."""
    tw = np.exp(2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    c2 = np.exp(2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    B = (tw.T[:, :, None] * c2[None, :, :]) / n             # [k1, j2, k2]
    d1 = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    return (B.real.astype(np.float32), B.imag.astype(np.float32),
            d1.real.astype(np.float32), d1.imag.astype(np.float32))


def fft_rotate(xr: jax.Array, xi: jax.Array,
               precision=jax.lax.Precision.HIGHEST
               ) -> tuple[jax.Array, jax.Array]:
    """FFT along the minor axis: [b, n] → [n, b] (m = k2·n1 + k1)."""
    b, n = xr.shape
    fac = _balanced_pair(n)
    if fac is None:
        cr, ci = map(jnp.asarray, _dft_tables(n, -1))       # [r, m]
        dot = _mk_dot((((1,), (1,)), ((), ())), precision)
        # lhs [m, r]; rhs [b, r] → out [m, b]
        return (dot(cr.T, xr) - dot(ci.T, xi),
                dot(cr.T, xi) + dot(ci.T, xr))
    n1, n2 = fac
    Ar, Ai, c2r, c2i = map(jnp.asarray, _rot_fwd_tables(n, n1, n2))
    x3r = xr.reshape(b, n1, n2)
    x3i = xi.reshape(b, n1, n2)
    # stage A: Y[j2, k1, b] = Σ_{j1} A[j2, k1, j1]·x3[b, j1, j2]
    dotA = _mk_dot((((2,), (1,)), ((0,), (2,))), precision)
    yr = dotA(Ar, x3r) - dotA(Ai, x3i)
    yi = dotA(Ar, x3i) + dotA(Ai, x3r)
    # stage B: X[k2, k1, b] = Σ_{j2} C2[j2, k2]·Y[j2, k1, b]
    dotB = _mk_dot((((1,), (0,)), ((), ())), precision)
    Xr = dotB(c2r.T, yr) - dotB(c2i.T, yi)
    Xi = dotB(c2r.T, yi) + dotB(c2i.T, yr)
    return Xr.reshape(n, b), Xi.reshape(n, b)


def ifft_major(Xr: jax.Array, Xi: jax.Array,
               precision=jax.lax.Precision.HIGHEST
               ) -> tuple[jax.Array, jax.Array]:
    """Inverse FFT along the MAJOR axis: [n, b] → [n, b], matching
    `fft_rotate`'s output indexing (includes the 1/n scale)."""
    n, b = Xr.shape
    fac = _balanced_pair(n)
    if fac is None:
        cr, ci = map(jnp.asarray, _dft_tables(n, +1))       # [m, s]
        dot = _mk_dot((((1,), (0,)), ((), ())), precision)
        # lhs [s, m]; rhs [m, b] → out [s, b]
        zr = (dot(cr.T, Xr) - dot(ci.T, Xi)) / n
        zi = (dot(cr.T, Xi) + dot(ci.T, Xr)) / n
        return zr, zi
    n1, n2 = fac
    Br, Bi, d1r, d1i = map(jnp.asarray, _rot_inv_tables(n, n1, n2))
    X3r = Xr.reshape(n2, n1, b)
    X3i = Xi.reshape(n2, n1, b)
    # stage A': T[k1, j2, b] = Σ_{k2} B[k1, j2, k2]·X3[k2, k1, b]
    dotA = _mk_dot((((2,), (0,)), ((0,), (1,))), precision)
    tr = dotA(Br, X3r) - dotA(Bi, X3i)
    ti = dotA(Br, X3i) + dotA(Bi, X3r)
    # stage B': z[j1, j2, b] = Σ_{k1} D[j1, k1]·T[k1, j2, b]
    dotB = _mk_dot((((1,), (0,)), ((), ())), precision)
    zr = dotB(d1r, tr) - dotB(d1i, ti)
    zi = dotB(d1r, ti) + dotB(d1i, tr)
    return zr.reshape(n, b), zi.reshape(n, b)


def _mk_dot(dimension_numbers, precision):
    from functools import partial
    return partial(jax.lax.dot_general, dimension_numbers=dimension_numbers,
                   precision=precision, preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# precision helpers: manual split-bf16 matmuls
# ---------------------------------------------------------------------------

def resolve_precision(p):
    """Config string ("default" | "high" | "highest") → lax.Precision.

    On an NVIDIA GPU an f32 matmul at DEFAULT (and HIGH) may run on the
    TF32 tensor cores (10-bit mantissa); HIGHEST keeps full f32. Which
    tier each profile uses, and the oracle SNR it reaches, is recorded
    in PERF.md."""
    if isinstance(p, str):
        return jax.lax.Precision(p.lower())
    return p


def make_dot(dimension_numbers, precision):
    """dot_general factory with f32 accumulation."""
    from functools import partial
    return partial(jax.lax.dot_general, dimension_numbers=dimension_numbers,
                   precision=resolve_precision(precision),
                   preferred_element_type=jnp.float32)
