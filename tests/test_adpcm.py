import numpy as np

from supersdr_jax.ops import adpcm


def reference_decoder(data):
    """The reference ImaAdpcmDecoder verbatim semantics
    (kiwi/client.py:58-87)."""
    step_table = adpcm.STEP_SIZES
    adj_table = adpcm.INDEX_ADJUST
    index, prev = 0, 0
    out = []

    def dec(code):
        nonlocal index, prev
        step = int(step_table[index])
        index = min(max(index + int(adj_table[code]), 0), len(step_table) - 1)
        difference = step >> 3
        if code & 1:
            difference += step >> 2
        if code & 2:
            difference += step >> 1
        if code & 4:
            difference += step
        if code & 8:
            difference = -difference
        prev = min(max(prev + difference, -32768), 32767)
        return prev

    for b in data:
        out.append(dec(b & 0x0F))
        out.append(dec(b >> 4))
    return np.array(out, np.int16)


def test_decode_matches_reference(rng):
    data = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    np.testing.assert_array_equal(adpcm.decode_np(data),
                                  reference_decoder(data))


def test_decode_jax_matches_np(rng):
    data = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    ref = adpcm.decode_np(data)
    got, idx, prev = adpcm.decode_jax(np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert int(prev) == int(ref[-1])


def test_encode_decode_roundtrip_quality(rng):
    # ADPCM is lossy; a bandlimited signal should survive with decent SNR
    fs = 12000
    t = np.arange(6000) / fs
    x = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    enc = adpcm.encode_np(x)
    dec = adpcm.decode_np(enc)[: len(x)]
    err = dec.astype(np.float64) - x.astype(np.float64)
    snr = 10 * np.log10(np.mean(x.astype(np.float64) ** 2) / np.mean(err ** 2))
    assert snr > 20


def test_stateful_streaming_decode(rng):
    data = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    full = adpcm.decode_np(data)
    st = adpcm.AdpcmState()
    part = np.concatenate([adpcm.decode_np(data[:100], st),
                           adpcm.decode_np(data[100:], st)])
    np.testing.assert_array_equal(part, full)
