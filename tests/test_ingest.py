import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from supersdr_jax.parallel import ingest, mesh as mesh_mod, sharded_chain
from supersdr_jax.runtime import chain


def test_local_time_range_single_process():
    m = mesh_mod.time_mesh()
    lo, hi = ingest.local_time_range(8 * 1024, m)
    # single process owns everything
    assert (lo, hi) == (0, 8 * 1024)


def test_make_global_feeds_sharded_chain():
    m = mesh_mod.time_mesh()
    n = 8 * 1024
    t = np.arange(n) / 12000
    iq = np.exp(2j * np.pi * 800 * t).astype(np.complex64)[None, :]
    garr = ingest.make_global_iq(iq, iq.shape, m,
                                 P(mesh_mod.CHAN_AXIS, mesh_mod.TIME_AXIS))
    # the array is actually sharded over the time axis
    assert len(garr.sharding.device_set) == 8

    cfg = chain.ChainConfig(mode="USB", chunk=1024, os_block=1024,
                            n_taps=129)
    proc = sharded_chain.build(cfg, m)
    params = sharded_chain.make_params(cfg, n_chan=1)
    state = sharded_chain.init_state(cfg, 1)
    state, out = proc(params, state, garr)
    audio = np.asarray(out.audio)
    assert audio.shape == (1, n * 4)
    assert np.abs(audio[0, 8000:]).max() > 0.1
