"""Native sdrkit library: build, bind, and match the python reference
implementations bit-for-bit."""

import numpy as np
import pytest

from supersdr_jax import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def test_adpcm_decode_matches_python(rng):
    from supersdr_jax.ops import adpcm

    data = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    # python reference path (bypass the native fast path explicitly)
    st_py = adpcm.AdpcmState()
    b = np.frombuffer(data, np.uint8)
    ref = np.empty(2 * len(b), np.int16)
    for i, byte in enumerate(b):
        ref[2 * i] = adpcm._decode_nibble(st_py, byte & 0x0F)
        ref[2 * i + 1] = adpcm._decode_nibble(st_py, byte >> 4)
    st_c = adpcm.AdpcmState()
    got = native.adpcm_decode(data, st_c)
    np.testing.assert_array_equal(got, ref)
    assert (st_c.index, st_c.prev) == (st_py.index, st_py.prev)


def test_adpcm_encode_roundtrip(rng):
    from supersdr_jax.ops import adpcm

    t = np.arange(4096) / 12000
    x = (6000 * np.sin(2 * np.pi * 500 * t)).astype(np.int16)
    st = adpcm.AdpcmState()
    enc = native.adpcm_encode(x, st)
    dec = adpcm.decode_np(enc)
    err = dec[: len(x)].astype(np.float64) - x
    snr = 10 * np.log10(np.mean(x.astype(np.float64) ** 2)
                        / np.mean(err ** 2))
    assert snr > 20


def test_be16_conversions(rng):
    vals = rng.integers(-32768, 32767, 512, dtype=np.int16)
    payload = vals.astype(">i2").tobytes()
    out = native.be16_to_f32(payload)
    np.testing.assert_array_equal(out, vals.astype(np.float32))

    iq = native.be16_iq_to_c64(payload, scale=2.0)
    assert iq.dtype == np.complex64
    np.testing.assert_allclose(iq.view(np.float32),
                               vals.astype(np.float32) / 2.0)


def test_xor_mask_roundtrip(rng):
    data = bytes(rng.integers(0, 256, 10001, dtype=np.uint8))
    mask = bytes(rng.integers(0, 256, 4, dtype=np.uint8))
    buf = bytearray(data)
    native.xor_mask(buf, mask)
    ref = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    assert bytes(buf) == ref
    native.xor_mask(buf, mask)
    assert bytes(buf) == data


def test_ring_buffer_spsc(rng):
    rb = native.RingBuffer(1024)
    x = rng.normal(size=600).astype(np.float32)
    assert rb.write(x) == 600
    assert len(rb) == 600
    got = rb.read(300)
    np.testing.assert_array_equal(got, x[:300])
    y = rng.normal(size=800).astype(np.float32)
    wrote = rb.write(y)
    assert wrote <= 1024 - 300
    got2 = rb.read(2000)
    np.testing.assert_array_equal(got2[:300], x[300:])
    np.testing.assert_array_equal(got2[300:], y[:wrote])
    assert len(rb) == 0


def test_ring_buffer_threads():
    import threading

    rb = native.RingBuffer(1 << 14)
    n_total = 200_000
    src = np.arange(n_total, dtype=np.float32)
    out = []

    def producer():
        i = 0
        while i < n_total:
            i += rb.write(src[i:i + 1024])

    def consumer():
        got = 0
        while got < n_total:
            chunk = rb.read(1024)
            if len(chunk):
                out.append(chunk)
                got += len(chunk)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(); tc.start()
    tp.join(timeout=20); tc.join(timeout=20)
    cat = np.concatenate(out)
    assert len(cat) == n_total
    np.testing.assert_array_equal(cat, src)


def test_websocket_uses_native_mask(rng):
    from supersdr_jax.io.websocket import _apply_mask

    payload = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    mask = b"\x12\x34\x56\x78"
    ref = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    assert _apply_mask(payload, mask) == ref


def test_be16_iq_split_i16_matches_numpy():
    """Native wire deinterleave (interleaved BE IQ int16 → split i16
    planes, the process_i16 ingest format) matches the numpy slicing
    path bit-exactly, and the protocol/client layers expose it."""
    import numpy as np
    from supersdr_jax import native
    from supersdr_jax.io import kiwi_protocol as kp

    rng = np.random.default_rng(0)
    n = 512
    inter = rng.integers(-32768, 32767, size=2 * n).astype(">i2")
    payload = inter.tobytes()
    ref_re = inter.astype(np.int16)[0::2]
    ref_im = inter.astype(np.int16)[1::2]
    out = native.be16_iq_split_i16(payload)
    if out is not None:          # native lib built
        np.testing.assert_array_equal(out[0], ref_re)
        np.testing.assert_array_equal(out[1], ref_im)
    # frame-level API (works with or without the native lib)
    import struct
    frame = kp.SndFrame(flags=0, seq=0, rssi=0.0,
                        payload=struct.pack("<BBII", 255, 0, 1, 0)
                        + payload)
    gps, re, im = frame.iq_samples_i16()
    np.testing.assert_array_equal(re, ref_re)
    np.testing.assert_array_equal(im, ref_im)
    # and the i16 planes dequantize to the complex path's samples
    _, z = frame.iq_samples()
    np.testing.assert_allclose(re.astype(np.float32), z.real)
    np.testing.assert_allclose(im.astype(np.float32), z.imag)
