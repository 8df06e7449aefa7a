"""2-stage pipeline parallelism (PP axis): the pipelined wideband must
match the serial wideband sample-exactly, microbatch by microbatch."""

import numpy as np
import jax

from supersdr_jax.parallel import pipeline
from supersdr_jax.runtime import wideband

AGC_OFF = dict(on=False, man_gain_db=50.0)


def test_pipelined_wideband_matches_serial():
    cfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=16384,
                                  mode="AM", taps_per=8, n_taps=129)
    rng = np.random.default_rng(0)
    n_mb = 3
    t = np.arange(n_mb * cfg.chunk_in) / cfg.fs_in
    iq = (0.4 * (1 + 0.6 * np.cos(2 * np.pi * 500 * t))
          * np.exp(2j * np.pi * 12000 * t)
          + 0.01 * (rng.normal(size=len(t))
                    + 1j * rng.normal(size=len(t)))).astype(np.complex64)
    mbs = iq.reshape(n_mb, cfg.chunk_in)
    params = wideband.make_params(cfg, agc_kwargs=AGC_OFF)

    # serial reference
    state = wideband.init_state(cfg)
    ref = []
    for i in range(n_mb):
        state, out = wideband.process(cfg, params, state, mbs[i])
        ref.append(np.asarray(out.audio))
    ref = np.stack(ref)

    # pipelined over 2 devices
    mesh = pipeline.make_mesh(jax.devices()[:2])
    proc = pipeline.build(cfg, mesh)
    pstate = wideband.init_state(cfg)
    pstate, audio = proc(params, pstate, mbs)
    np.testing.assert_allclose(np.asarray(audio), ref, rtol=2e-4,
                               atol=2e-4)
    # stream state carried correctly: next serial step from the pipeline
    # state matches the serial continuation
    state2, out2 = wideband.process(cfg, params, pstate, mbs[0])
    state2r, out2r = wideband.process(cfg, params, state, mbs[0])
    np.testing.assert_allclose(np.asarray(out2.audio),
                               np.asarray(out2r.audio), atol=2e-4)
