"""IMA-ADPCM codec (the KiwiSDR stream compression).

The wire format is standard IMA/DVI ADPCM: 4-bit codes, the canonical
89-entry step-size table and index-adjust table (see e.g. the IMA ADPCM
specification; the reference decodes it per-sample in Python at
/root/reference/kiwi/client.py:58-87). Three implementations:

  decode_np / encode_np : host-side numpy loop (used by the IO layer; the
                          native C extension in `native/` replaces the loop
                          at line rate when built)
  decode_jax            : `lax.scan` formulation — the decoder is a true
                          sequential dependency, so on-device it is a scan;
                          useful when decode must live inside a jitted
                          ingest program.
"""

from __future__ import annotations

import numpy as np

STEP_SIZES = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026,
    4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442,
    11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623,
    27086, 29794, 32767], dtype=np.int32)

INDEX_ADJUST = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                         -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)


class AdpcmState:
    __slots__ = ("index", "prev")

    def __init__(self, index: int = 0, prev: int = 0):
        self.index = index
        self.prev = prev


def _decode_nibble(state: AdpcmState, code: int) -> int:
    step = int(STEP_SIZES[state.index])
    state.index = int(np.clip(state.index + INDEX_ADJUST[code], 0,
                              len(STEP_SIZES) - 1))
    diff = step >> 3
    if code & 1:
        diff += step >> 2
    if code & 2:
        diff += step >> 1
    if code & 4:
        diff += step
    if code & 8:
        diff = -diff
    state.prev = int(np.clip(state.prev + diff, -32768, 32767))
    return state.prev


def decode_np(data: bytes | np.ndarray, state: AdpcmState | None = None
              ) -> np.ndarray:
    """Decode packed 4-bit codes → int16 samples (2 per byte, low nibble
    first). Stateful across calls when `state` is supplied. Uses the
    native sdrkit codec when built (same algorithm in C++)."""
    state = state or AdpcmState()
    from supersdr_jax import native
    fast = native.adpcm_decode(data, state)
    if fast is not None:
        return fast
    b = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(2 * len(b), dtype=np.int16)
    for i, byte in enumerate(b):
        out[2 * i] = _decode_nibble(state, byte & 0x0F)
        out[2 * i + 1] = _decode_nibble(state, byte >> 4)
    return out


def encode_np(samples: np.ndarray, state: AdpcmState | None = None) -> bytes:
    """Encode int16 samples → packed 4-bit codes (for the fake-Kiwi test
    server and recorders)."""
    state = state or AdpcmState()
    from supersdr_jax import native
    fast = native.adpcm_encode(np.asarray(samples, np.int16), state)
    if fast is not None:
        return fast
    samples = np.asarray(samples, dtype=np.int64)
    if len(samples) % 2:
        samples = np.append(samples, samples[-1])
    out = bytearray()
    nib = []
    for s in samples:
        step = int(STEP_SIZES[state.index])
        diff = int(s) - state.prev
        code = 0
        if diff < 0:
            code = 8
            diff = -diff
        if diff >= step:
            code |= 4
            diff -= step
        if diff >= step >> 1:
            code |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            code |= 1
        _decode_nibble(state, code)  # track decoder state exactly
        nib.append(code)
        if len(nib) == 2:
            out.append(nib[0] | (nib[1] << 4))
            nib = []
    return bytes(out)


def decode_jax(data, index0=0, prev0=0):
    """On-device decode via lax.scan. data: uint8 array of packed codes.
    Returns (samples int16 [2n], final_index, final_prev)."""
    import jax
    import jax.numpy as jnp

    steps = jnp.asarray(STEP_SIZES)
    adj = jnp.asarray(INDEX_ADJUST)
    b = jnp.asarray(data, jnp.int32)
    codes = jnp.stack([b & 0x0F, b >> 4], axis=-1).reshape(-1)

    def step_fn(carry, code):
        index, prev = carry
        step = steps[index]
        index = jnp.clip(index + adj[code], 0, len(STEP_SIZES) - 1)
        diff = (step >> 3) + jnp.where(code & 1, step >> 2, 0) \
            + jnp.where(code & 2, step >> 1, 0) + jnp.where(code & 4, step, 0)
        diff = jnp.where(code & 8, -diff, diff)
        prev = jnp.clip(prev + diff, -32768, 32767)
        return (index, prev), prev

    (index, prev), samples = jax.lax.scan(
        step_fn, (jnp.int32(index0), jnp.int32(prev0)), codes)
    return samples.astype(jnp.int16), index, prev
