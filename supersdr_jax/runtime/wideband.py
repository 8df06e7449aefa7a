"""Wideband receiver: one capture → polyphase channelizer → N demod chains.

BASELINE.md's channelizer config: a full MW-band capture (e.g. 1.2 MHz of
IQ) split into 100 AM channels of 12 kHz each, all demodulated at once.
With n_chan chosen so fs_in / n_chan equals the chain's IQ rate, the PFB
output feeds the standard receiver chain batched over its channel axis —
two fused device programs end-to-end, versus the reference's
two-sockets-per-receiver ceiling (supersdr.py:624-639).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax.ops import channelizer, cx
from supersdr_jax.runtime import chain


# Tuning profiles: whole-pipeline settings chosen on the GPU against the
# bench's oracle gates (PERF.md records each profile's gate dB and step
# time). Both use the "legacy" channelizer (fold, then cuFFT), faster on
# the H100 than the matmul DFT. "fast" runs the passband and resampler
# matmuls at the default f32 precision (TF32 tensor cores); "quality"
# runs them in full f32. On a GPU the chain tail (and with it the
# resampler) runs in the Triton kernel in f32 under either profile.
PROFILES = {
    "fast": dict(passband_impl="matmul", passband_precision="default",
                 chan_impl="legacy", resample_impl="matmul",
                 resample_precision="default", time_major=True),
    "quality": dict(passband_impl="matmul", passband_precision="highest",
                    chan_impl="legacy", resample_impl="matmul",
                    resample_precision="highest", time_major=True),
}


@dataclass(frozen=True)
class WidebandConfig:
    """fs_in must equal n_chan * chain.iq_rate (critical sampling)."""
    fs_in: int = 1_200_000
    n_chan: int = 100
    taps_per: int = 8
    mode: str = "AM"
    chunk_in: int = 1_200_000 // 4      # input samples per call
    audio_rate: int = 48000
    n_taps: int = 257
    agc_decimation: int = 1             # AGC ballistics decimation (perf)
    hang_enabled: bool = False          # AGC hang
    hang_ms: float = 500.0
    squelch_enabled: bool = False       # squelch gate
    max_dev_hz: float = 5000.0          # NBFM full-scale deviation
    passband_impl: str = "fft"          # chain passband: "fft" overlap-save,
                                        # "matmul" blocked-Toeplitz FIR, or
                                        # "matmul_real" (modulated real
                                        # prototype, half the matmul FLOPs)
    passband_precision: str = "highest"  # matmul precision (see ChainConfig)
    resample_impl: str = "einsum"       # see ChainConfig.resample_impl
    resample_precision: str = "highest"  # see ChainConfig
    mxu_chan_fft: bool = False          # legacy channelizer: matmul
                                        # four-step FFT (ops/cx.fft)
                                        # instead of the FFT HLO
    chan_impl: str = "legacy"           # "legacy" (fold, then the FFT
                                        # HLO — cuFFT on the GPU),
                                        # "mxu2" / "mxu2conv" (matmul DFT,
                                        # ops/channelizer.channelize_mxu2_c)
                                        # or "stub"/"nofft" (knockout
                                        # profiling only)
    chan_fold_dtype: str = "f32"        # mxu2: "f16" stores the PFB fold
                                        # input window in float16 (f32
                                        # accumulation)
    chan_precision: str = "highest"     # mxu2 DFT matmul precision
                                        # ("default" | "high" | "highest",
                                        # see ops/cx.resolve_precision)
    chan_fft_form: str = "dif"          # mxu2: "dif" (twiddle folded into
                                        # a j2-batched stage-A dot) or
                                        # "dit" (separate twiddle pass)
    time_major: bool = False            # audio comes back [frames·L,
                                        # n_chan] instead of [n_chan,
                                        # frames·L]
    audio_dtype: str = "f32"            # audio output plane: "f32",
                                        # "f16" or "bf16"
    tail_impl: str = "auto"             # see ChainConfig.tail_impl

    def __post_init__(self):
        if self.fs_in % self.n_chan:
            raise ValueError("n_chan must divide fs_in")
        if self.chunk_in % self.n_chan:
            raise ValueError("chunk_in must be a multiple of n_chan")
        if self.time_major and self.mode.upper() == "IQ":
            raise ValueError("time_major is an audio-path layout (IQ "
                             "mode keeps complex baseband)")
        if self.audio_dtype not in ("f32", "f16", "bf16"):
            raise ValueError("audio_dtype must be 'f32', 'f16' or 'bf16'")
        if self.chan_impl not in ("legacy", "mxu2", "mxu2conv", "stub",
                                  "nofft"):
            raise ValueError("chan_impl must be 'legacy', 'mxu2', "
                             "'mxu2conv', 'stub' or 'nofft' (stub/nofft: "
                             "knockout profiling)")

    @property
    def iq_rate(self) -> int:
        return self.fs_in // self.n_chan

    @property
    def chunk_per_chan(self) -> int:
        return self.chunk_in // self.n_chan

    @property
    def chain_cfg(self) -> chain.ChainConfig:
        # PFB output is channel-centered (offsets structurally zero —
        # make_params forbids overriding them), so the NCO pass is
        # statically compiled out
        return chain.ChainConfig(mode=self.mode, iq_rate=self.iq_rate,
                                 audio_rate=self.audio_rate,
                                 chunk=self.chunk_per_chan,
                                 os_block=self.chunk_per_chan,
                                 n_taps=self.n_taps,
                                 agc_decimation=self.agc_decimation,
                                 hang_enabled=self.hang_enabled,
                                 hang_ms=self.hang_ms,
                                 squelch_enabled=self.squelch_enabled,
                                 max_dev_hz=self.max_dev_hz,
                                 nco_enabled=False,
                                 passband_impl=self.passband_impl,
                                 passband_precision=self.passband_precision,
                                 resample_impl=self.resample_impl,
                                 resample_precision=self.resample_precision,
                                 tail_impl=self.tail_impl)


class WidebandParams(NamedTuple):
    W_pfb: jax.Array
    chain: chain.ChainParams


class WidebandState(NamedTuple):
    pfb_carry: cx.CX           # split-complex PFB history
    chain: chain.ChainState


def make_params(cfg: WidebandConfig, **chain_kwargs) -> WidebandParams:
    plan, proto = channelizer.design(cfg.n_chan, cfg.taps_per)
    W = channelizer.taps_matrix(plan, proto)
    cp = chain.make_params(cfg.chain_cfg,
                           freq_offset_hz=np.zeros(cfg.n_chan),
                           **chain_kwargs)
    return WidebandParams(W_pfb=W, chain=cp)


def init_state(cfg: WidebandConfig) -> WidebandState:
    plan, _ = channelizer.design(cfg.n_chan, cfg.taps_per)
    return WidebandState(pfb_carry=channelizer.init_carry(plan),
                         chain=chain.init_state(cfg.chain_cfg, (cfg.n_chan,)))


def pfb_plan(cfg: WidebandConfig) -> channelizer.PFBPlan:
    # plan is pure structure — building it directly avoids re-running the
    # prototype FIR design (≈1 ms host time) on every process() step
    return channelizer.PFBPlan(n_chan=cfg.n_chan, taps_per=cfg.taps_per,
                               hop=cfg.n_chan)


def channelize_dispatch(cfg: WidebandConfig, params: WidebandParams,
                        carry_c: jax.Array, iq_c: jax.Array
                        ) -> tuple[jax.Array, jax.Array]:
    """Channelizer implementation dispatch (shared by the serial pipeline
    and the mesh body in parallel/sharded_wideband.py — the mesh passes
    its halo-exchange history as `carry_c`).

    carry_c: [history] complex filter history; iq_c: [n] complex wideband
    (n a multiple of n_chan). Returns (new_carry, chans [n_chan, n/M]).
    """
    plan = pfb_plan(cfg)
    n_frames = iq_c.shape[-1] // cfg.n_chan
    if cfg.chan_impl == "stub":
        # knockout-profiling stub (semantics-free): reshape-decimate +
        # transpose — the minimal [chunk]→[M, frames] layout work with
        # no fold and no FFT, so `full - stub` bounds the channelizer's
        # in-context compute cost
        x2 = iq_c.reshape(n_frames, cfg.n_chan)
        chans = jnp.swapaxes(x2, 0, 1)
        pfb_carry = carry_c
    elif cfg.chan_impl == "nofft":
        # knockout-profiling: real fold (f16) + transpose, FFT skipped —
        # `full - nofft` isolates the DFT in context
        seg = jnp.concatenate([carry_c, iq_c], axis=-1)
        nf = n_frames
        rows_r = jnp.real(seg).reshape(nf + cfg.taps_per - 1, cfg.n_chan
                                       ).astype(jnp.float16)
        rows_i = jnp.imag(seg).reshape(nf + cfg.taps_per - 1, cfg.n_chan
                                       ).astype(jnp.float16)
        g2 = params.W_pfb.reshape(-1)[::-1].reshape(cfg.taps_per,
                                                    cfg.n_chan)
        fr = channelizer._fold_slices(g2, rows_r, nf, cfg.taps_per)
        fi = channelizer._fold_slices(g2, rows_i, nf, cfg.taps_per)
        chans = jax.lax.complex(fr.T, fi.T)
        pfb_carry = seg[..., -plan.history:]
    elif cfg.chan_impl in ("mxu2", "mxu2conv"):
        pfb_carry, chans = channelizer.channelize_mxu2_c(
            plan, params.W_pfb, carry_c, iq_c,
            fold_impl="slices" if cfg.chan_impl == "mxu2" else "conv",
            precision=cx.resolve_precision(cfg.chan_precision),
            fold_dtype=(jnp.float16 if cfg.chan_fold_dtype == "f16"
                        else jnp.float32),
            fft_form=cfg.chan_fft_form)
    else:
        pfb_carry, chans = channelizer.channelize_c(
            plan, params.W_pfb, carry_c, iq_c, mxu_fft=cfg.mxu_chan_fft)
    return pfb_carry, chans


def _audio_np_dtype(cfg: WidebandConfig):
    return {"f32": jnp.float32, "f16": jnp.float16,
            "bf16": jnp.bfloat16}[cfg.audio_dtype]


def _is_i16_pair(iq) -> bool:
    """True for a plain (re_i16, im_i16) tuple. Any other plain 2-tuple
    of arrays raises: silently quantizing float planes to int16 collapses
    a ±1.0-scale signal to ~0 after dequantize — float pairs must come
    wrapped as cx.CX."""
    if not (isinstance(iq, tuple) and not isinstance(iq, cx.CX)
            and len(iq) == 2):
        return False
    dt = getattr(iq[0], "dtype", None)       # works on tracers too
    if dt is None:
        dt = np.asarray(iq[0]).dtype
    if np.dtype(dt) != np.int16:
        raise TypeError(
            f"plain 2-tuple IQ must be (re_i16, im_i16) int16 planes, got "
            f"dtype {dt}; wrap float planes as cx.CX(re, im)")
    return True


def _as_f32_cx(iq) -> cx.CX:
    """CX passthrough; plain (re_i16, im_i16) tuples dequantize to
    f32 (CX is itself a NamedTuple — check it first)."""
    if _is_i16_pair(iq):
        return cx.CX(iq[0].astype(jnp.float32) * (1.0 / 32768.0),
                     iq[1].astype(jnp.float32) * (1.0 / 32768.0))
    return iq


def process_traced(cfg: WidebandConfig, params: WidebandParams,
                   state: WidebandState, iq
                   ) -> tuple[WidebandState, chain.ChainOutput]:
    """Traced-context body: iq [chunk_in] split-complex (or an int16
    pair) wideband → audio [n_chan, chunk_per_chan·upsample]
    (cfg.time_major: [chunk_per_chan·upsample, n_chan], in
    cfg.audio_dtype)."""
    iq = _as_f32_cx(iq)
    pfb_carry, chans = channelize_dispatch(
        cfg, params, cx.to_complex(state.pfb_carry), cx.to_complex(iq))
    cstate, out = chain.process_traced(cfg.chain_cfg, params.chain,
                                       state.chain, cx.split(chans))
    if cfg.time_major:
        out = out._replace(
            audio=jnp.swapaxes(out.audio, -1, -2).astype(
                _audio_np_dtype(cfg)),
            baseband=cx.swapaxes(out.baseband, -1, -2))
    return (WidebandState(pfb_carry=cx.split(pfb_carry), chain=cstate), out)


_process_cx = partial(jax.jit, static_argnums=0)(process_traced)


def process(cfg: WidebandConfig, params: WidebandParams,
            state: WidebandState, iq
            ) -> tuple[WidebandState, chain.ChainOutput]:
    """iq: [chunk_in] wideband — CX or complex numpy (split host-side)
    → audio [n_chan, chunk_per_chan·upsample], one fused PFB+chains
    device program."""
    return _process_cx(cfg, params, state, cx.as_cx(iq))


def process_many_traced(cfg: WidebandConfig, params: WidebandParams,
                        state: WidebandState, iq_chunks: cx.CX
                        ) -> tuple[WidebandState, jax.Array]:
    """Several consecutive chunks in ONE device program.

    iq_chunks: [n_chunks, chunk_in] split-complex → audio
    [n_chunks, n_chan, chunk_per_chan · upsample].

    A `lax.scan` over the chunk axis threads the streaming state through
    sample-exactly (identical results to n_chunks `process` calls), while
    paying host→device dispatch once per batch instead of once per chunk.
    """
    def body(st, chunk):
        st2, out = process_traced(cfg, params, st, chunk)
        return st2, out.audio

    return jax.lax.scan(body, state, iq_chunks)


_process_many_cx = partial(jax.jit, static_argnums=0)(process_many_traced)


def process_many(cfg: WidebandConfig, params: WidebandParams,
                 state: WidebandState, iq_chunks
                 ) -> tuple[WidebandState, jax.Array]:
    """Public multi-chunk step: iq_chunks [n_chunks, chunk_in] as CX or
    complex numpy; returns (state, audio[n_chunks, n_chan, out_len])."""
    return _process_many_cx(cfg, params, state, cx.as_cx(iq_chunks))


def process_n_traced(cfg: WidebandConfig, params: WidebandParams,
                     state: WidebandState, iqs: tuple
                     ) -> tuple[WidebandState, tuple]:
    """N consecutive chunks in ONE device program, audio returned as a
    TUPLE (no [N, ...] stack, so no extra audio copy). Each chunk is a
    CX or an (re_i16, im_i16) pair."""
    outs = []
    for iq in iqs:
        state, out = process_traced(cfg, params, state, iq)
        outs.append(out.audio)
    return state, tuple(outs)


_process_n_jit = partial(jax.jit, static_argnums=0)(process_n_traced)


def process_n(cfg: WidebandConfig, params: WidebandParams,
              state: WidebandState, iqs) -> tuple[WidebandState, tuple]:
    """Public multi-chunk step with tuple outputs (see
    process_n_traced); iqs: sequence of CX / complex numpy / i16 pairs."""
    def coerce(iq):
        if _is_i16_pair(iq):
            return (jnp.asarray(iq[0], jnp.int16),
                    jnp.asarray(iq[1], jnp.int16))
        return cx.as_cx(iq)
    return _process_n_jit(cfg, params, state, tuple(coerce(q) for q in iqs))


def process_i16(cfg: WidebandConfig, params: WidebandParams,
                state: WidebandState, iq16
                ) -> tuple[WidebandState, chain.ChainOutput]:
    """One chunk of INT16 IQ (the 16-bit ADC / KiwiSDR IQ wire format):
    iq16 = (re_i16, im_i16) [chunk_in] planes, full-scale ±32768 ≡ ±1.0.
    The dequantize fuses into the channelizer's first pass; semantics
    equal the f32 pipeline fed the dequantized planes."""
    re16 = jnp.asarray(iq16[0], jnp.int16)
    im16 = jnp.asarray(iq16[1], jnp.int16)
    return _process_cx(cfg, params, state, (re16, im16))


def channel_freqs(cfg: WidebandConfig, center_hz: float = 0.0,
                  order: np.ndarray | None = None) -> np.ndarray:
    """Absolute center frequency of each OUTPUT ROW given the capture
    center. Rows are in PFB bin order; `order` (row → bin) selects or
    permutes rows for consumers that hold a subset."""
    plan = pfb_plan(cfg)
    freqs = center_hz + channelizer.channel_center_freqs(plan, cfg.fs_in)
    if order is None:
        return freqs
    return freqs[np.asarray(order)]
