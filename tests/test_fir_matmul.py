"""The blocked-Toeplitz matmul FIR must be stream-equivalent to
overlap-save (and hence to the reference's carry+convolve,
/root/reference/utils_supersdr.py:1005,1128-1133)."""

import numpy as np
import pytest

from supersdr_jax.ops import cx, fir_matmul, firdesign, overlap_save


def _oracle(taps, x, overlap_carry=None):
    old = (np.zeros(len(taps) - 1, dtype=np.complex128)
           if overlap_carry is None else overlap_carry)
    seg = np.concatenate([old, x])
    return np.convolve(seg, taps, mode="valid")


@pytest.mark.parametrize("n_taps,chunk", [(257, 4096), (513, 4096),
                                          (33, 1024), (1025, 2048)])
def test_matches_convolve_oracle(rng, n_taps, chunk):
    taps = firdesign.complex_bandpass_taps(300, 2700, 12000, n=n_taps)
    x = (rng.normal(size=chunk) + 1j * rng.normal(size=chunk)
         ).astype(np.complex64)
    plan = fir_matmul.plan_for(chunk, n_taps)
    W = fir_matmul.build_w(plan, taps)
    carry = fir_matmul.init_carry(plan)
    _, y = fir_matmul.fir_matmul_stream(plan, W, carry, x)
    ref = _oracle(taps, x)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=2e-4)


def test_streaming_continuity(rng):
    """Chunked processing must equal one-shot processing sample-exactly
    (same carry convention as overlap-save: the input tail)."""
    n_taps, chunk, n_chunks = 257, 2048, 4
    taps = firdesign.complex_bandpass_taps(-3000, 3000, 12000, n=n_taps)
    x = (rng.normal(size=chunk * n_chunks)
         + 1j * rng.normal(size=chunk * n_chunks)).astype(np.complex64)
    plan = fir_matmul.plan_for(chunk, n_taps)
    W = fir_matmul.build_w(plan, taps)
    carry = fir_matmul.init_carry(plan)
    outs = []
    for i in range(n_chunks):
        carry, y = fir_matmul.fir_matmul_stream(
            plan, W, carry, x[i * chunk:(i + 1) * chunk])
        outs.append(np.asarray(y))
    chunked = np.concatenate(outs)

    big_plan = fir_matmul.plan_for(chunk * n_chunks, n_taps)
    Wb = fir_matmul.build_w(big_plan, taps)
    _, y1 = fir_matmul.fir_matmul_stream(
        big_plan, Wb, fir_matmul.init_carry(big_plan), x)
    np.testing.assert_allclose(chunked, np.asarray(y1), rtol=0, atol=1e-4)


def test_state_compatible_with_overlap_save(rng):
    """The carried state is the same input-tail as overlap-save's, so a
    chain can switch filter implementation mid-stream."""
    n_taps, chunk = 257, 2048
    taps = firdesign.complex_bandpass_taps(100, 5000, 12000, n=n_taps)
    x = (rng.normal(size=2 * chunk) + 1j * rng.normal(size=2 * chunk)
         ).astype(np.complex64)

    os_plan = overlap_save.plan_for(chunk, n_taps)
    H = overlap_save.taps_to_freq(os_plan, taps)
    os_carry, y_os = overlap_save.overlap_save(
        os_plan, H, overlap_save.init_carry(os_plan), x[:chunk])

    mm_plan = fir_matmul.plan_for(chunk, n_taps)
    W = fir_matmul.build_w(mm_plan, taps)
    # feed overlap-save's carry straight into the matmul filter
    _, y_mm = fir_matmul.fir_matmul_stream(mm_plan, W, os_carry, x[chunk:])
    ref = _oracle(np.asarray(taps),
                  x[chunk:].astype(np.complex128),
                  overlap_carry=x[:chunk][-(n_taps - 1):].astype(np.complex128))
    np.testing.assert_allclose(np.asarray(y_mm), ref, rtol=0, atol=2e-4)
    # and the two filters agree on the first chunk too
    np.testing.assert_allclose(np.asarray(y_os),
                               _oracle(np.asarray(taps), x[:chunk]),
                               rtol=0, atol=2e-4)


def test_batched_channels(rng):
    n_taps, chunk, n_chan = 257, 1024, 5
    taps = firdesign.complex_bandpass_taps(-2000, 2000, 12000, n=n_taps)
    x = (rng.normal(size=(n_chan, chunk)) + 1j * rng.normal(size=(n_chan, chunk))
         ).astype(np.complex64)
    plan = fir_matmul.plan_for(chunk, n_taps)
    W = fir_matmul.build_w(plan, taps)
    carry = fir_matmul.init_carry(plan, (n_chan,))
    _, y = fir_matmul.fir_matmul_stream(plan, W, carry, x)
    got = np.asarray(y)
    for c in range(n_chan):
        np.testing.assert_allclose(got[c], _oracle(np.asarray(taps), x[c]),
                                   rtol=0, atol=2e-4)


def test_nondividing_chunk_padding(rng):
    """Chunks that are not a block multiple are padded internally and cut
    back — output must still match the oracle, and the carry must come
    from the true input tail."""
    n_taps, chunk = 257, 3000          # 3000 % 256 != 0
    taps = firdesign.complex_bandpass_taps(200, 4000, 12000, n=n_taps)
    x = (rng.normal(size=2 * chunk) + 1j * rng.normal(size=2 * chunk)
         ).astype(np.complex64)
    plan = fir_matmul.plan_for(chunk, n_taps)
    W = fir_matmul.build_w(plan, taps)
    carry = fir_matmul.init_carry(plan)
    outs = []
    for i in range(2):
        carry, y = fir_matmul.fir_matmul_stream(
            plan, W, carry, x[i * chunk:(i + 1) * chunk])
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), _oracle(taps, x),
                               rtol=0, atol=2e-4)
