"""Batched dual-RX: MAIN + SUB receivers as ONE device program.

The reference runs each receiver as its own server socket + thread
(supersdr.py:624-639); SURVEY §2a's rule for the device build is "N
channels as a sharded array axis, not N threads". This module fixes the
last violation of that rule: the live TUI used to dispatch MAIN and SUB
as two separate device programs per chunk.

Design: a fixed [2, chunk] channel axis through `chain.process_traced`
with `cfg.mode = "MULTI"` — every per-slot control (NCO offset, passband
response, AGC set, demod mode id, active mask) is RUNTIME data stacked
from per-slot `chain.make_params` pytrees, so enabling/disabling the SUB
or changing any slot's mode/tuning never retraces: one jit signature for
the life of the session. An inactive slot simply runs with a muted
output mask (compute for 2 slots is marginal at interactive chunk
sizes, and a static [1]/[2] switch would recompile on the `y` key —
exactly what this design exists to avoid).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import cx, demod as demod_ops
from supersdr_jax.runtime import chain


def _stack_params(plist: list[chain.ChainParams],
                  modes: list[str]) -> chain.ChainParams:
    """Per-slot ChainParams → one batched pytree with a leading [slots]
    axis; scalar control leaves get a trailing singleton so they
    broadcast against [slots, n] sample axes."""
    def stack(*xs):
        if xs[0] is None:
            return None
        return jnp.stack([jnp.asarray(x) for x in xs], axis=0)

    stacked = jax.tree.map(stack, *plist,
                           is_leaf=lambda x: x is None)
    # broadcast shapes per consumer: AGC compares against [slots, n]
    # sample arrays (→ [slots, 1]); squelch gates on [slots] block RSSI
    # except `ramp`, which multiplies a [n] time index; the blanker works
    # on [slots, n] IQ with [slots, 1] keepdims medians
    agc = type(stacked.agc)(*[v[:, None] for v in stacked.agc])
    sq = stacked.squelch._replace(ramp=stacked.squelch.ramp[:, None])
    bl = type(stacked.blanker)(*[v[:, None] for v in stacked.blanker])
    mode_id = jnp.asarray([demod_ops.MODE_IDS[m.upper()] for m in modes],
                          jnp.int32)
    # structural (slot-independent) matrices stay unstacked: the
    # resampler design depends only on the rates
    return stacked._replace(agc=agc, squelch=sq, blanker=bl,
                            mode_id=mode_id,
                            P_interp=plist[0].P_interp,
                            W_interp=plist[0].W_interp)


class DualChain:
    """Two receiver slots in one jitted chain program.

    `slot_cfgs(rx)`-style per-slot settings come from `Receiver`
    controllers; call `refresh(receivers, active)` whenever any slot's
    tuning changed (host-side param rebuild — data only, no retrace) and
    `process(iq)` per chunk. Slot 1 is the SUB; when inactive its audio
    is masked to silence but its state keeps threading (no pops or
    retraces on enable/disable — reference `y`/`Y` keys).
    """

    def __init__(self, cfg: chain.ChainConfig):
        if cfg.mode.upper() == "IQ":
            raise ValueError("dual-RX slots are audio receivers")
        if cfg.passband_impl != "fft":
            raise ValueError("batched dual-RX needs the fft passband "
                             "(per-slot responses broadcast through the "
                             "frequency-domain multiply)")
        # squelch stays compiled in: per-slot enables are runtime data
        # on the batched program (cheap at interactive chunk sizes)
        self.cfg = dataclasses.replace(cfg, mode="MULTI",
                                       squelch_enabled=True)
        self.state = chain.init_state(self.cfg, (2,))
        self.params = None
        self.active = np.array([1.0, 0.0], np.float32)

    def refresh(self, receivers, active: list[bool]) -> None:
        """receivers: [main, sub] Receiver-like objects (sub may equal
        main when disabled); rebuilds the batched parameter pytree."""
        plist, modes = [], []
        for r in receivers:
            cfg_slot = dataclasses.replace(self.cfg, mode=r.radio_mode)
            plist.append(chain.make_params(
                cfg_slot, freq_offset_hz=r.freq_offset_hz,
                low_cut=r.lc, high_cut=r.hc,
                agc_kwargs=r.agc.kwargs(),
                squelch_kwargs=dict(enabled=r.squelch_on,
                                    thresh_db=r.squelch_thresh_db),
                blanker_kwargs=dict(enabled=r.nb_on,
                                    thresh_ratio=r.nb_thresh)))
            modes.append(r.radio_mode)
        self.params = _stack_params(plist, modes)
        self.active = np.asarray([1.0 if a else 0.0 for a in active],
                                 np.float32)

    def process(self, iq_chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One chunk through both slots: iq [chunk] complex →
        (audio [2, chunk·L] float32, rssi [2, n_rows]). ONE device
        dispatch; the jit signature is identical across SUB add/drop and
        any mode/tune change (asserted in tests)."""
        iq2 = np.broadcast_to(np.asarray(iq_chunk, np.complex64),
                              (2, len(iq_chunk)))
        self.state, out = chain.process(self.cfg, self.params, self.state,
                                        iq2)
        audio = np.asarray(out.audio) * self.active[:, None]
        return audio, np.asarray(out.rssi)
