"""Distributed four-step FFT (TP axis): sample-exact vs jnp.fft on the
8-device CPU mesh, one all_to_all per transform."""

import numpy as np
import pytest

from supersdr_jax.ops import cx
from supersdr_jax.parallel import comm_model, dist_fft


@pytest.mark.parametrize("n", [4096, 8192, 65536])
def test_dist_fft_matches_reference(n, rng):
    m = dist_fft.make_mesh()
    f = dist_fft.build_fft(n, m)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    got = cx.to_numpy(f(cx.as_cx(x)))
    want = np.fft.fft(x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_dist_ifft_roundtrip(rng):
    n = 8192
    m = dist_fft.make_mesh()
    f = dist_fft.build_fft(n, m, sign=-1)
    finv = dist_fft.build_fft(n, m, sign=+1)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    back = cx.to_numpy(finv(f(cx.as_cx(x))))
    np.testing.assert_allclose(back, x, atol=2e-4)


def test_dist_fft_has_single_all_to_all(rng):
    n = 8192
    m = dist_fft.make_mesh()
    f = dist_fft.build_fft(n, m)
    x = cx.as_cx(np.zeros(n, np.complex64))
    txt = comm_model.lower_hlo(f, x)
    stats = comm_model.collective_bytes_from_hlo(txt)
    # one logical transpose phase (XLA may emit it as per-shard pieces);
    # no other collective kinds, volume ~ the local shard re+im
    assert stats.counts.get("all-to-all", 0) >= 1
    assert set(stats.counts) == {"all-to-all"}
    assert stats.total_bytes <= 2 * n * 8 // 8
