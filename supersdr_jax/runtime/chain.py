"""Receiver chain: the complete IQ→audio demodulation program.

This is the device-native replacement for the KiwiSDR server-side DSP the
reference only *controls* (channel selection, passband filtering,
demodulation, AGC — SURVEY.md §0): one pure jittable function

    process(params, state, iq_chunk) -> (state, ChainOutput)

composing  NCO mix → overlap-save passband filter → demodulator → AGC →
polyphase resample to the audio rate.  Design points:

* Chunk size is static but arbitrary: 512 samples for low-latency
  streaming, 2^18+ for offline/wideband throughput — the same program, one
  trace per shape. Internally the passband filter runs as *batched*
  overlap-save over `os_block`-sized rows (one big FFT batch, no serial
  per-block loop), and every recurrence (DC block, AGC tracking) is an
  associative scan, so a whole chunk evaluates with no sequential
  sample-rate dependency anywhere.
* All tuning (frequency, passband taps, AGC settings) is runtime data —
  retuning never retraces.
* State (NCO phase, filter history, demod memory, AGC level, resampler
  tail) is an explicit pytree; consecutive chunks are sample-exact
  continuous, and the whole chain vmaps over a leading channel axis for
  multi-receiver operation (the generalization of the reference's dual-RX,
  supersdr.py:624-639).

Reference control surface being reproduced: `SET mod=… low_cut=… high_cut=…
freq=…` and `SET agc=…` (utils_supersdr.py:976-980,1022-1029).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from supersdr_jax import backend
from supersdr_jax.ops import agc as agc_ops
from supersdr_jax.ops import cx
from supersdr_jax.ops import demod as demod_ops
from supersdr_jax.ops import fir_matmul, firdesign, mixer, overlap_save, \
    passband, resample
from supersdr_jax.ops import smeter
from supersdr_jax.ops import squelch as squelch_ops
from supersdr_jax.ops.pallas import chain_tail


@dataclass(frozen=True)
class ChainConfig:
    """Static chain structure (hashable; changing any field retraces)."""
    mode: str = "AM"
    iq_rate: int = 12000
    audio_rate: int = 48000
    chunk: int = 2048          # IQ samples per process() call
    os_block: int = 2048       # internal overlap-save row length
    n_taps: int = 513          # fixed passband FIR budget (odd)
    hang_ms: float = 500.0
    hang_enabled: bool = False  # static: compile the hang sliding-max in
    agc_decimation: int = 1     # static: AGC ballistics decimation (perf)
    max_dev_hz: float = 5000.0  # NBFM deviation full-scale
    blanker_enabled: bool = False  # static: compile the noise blanker in
                                   # (its median = a device sort; never pay
                                   # for it when NB is off)
    squelch_enabled: bool = False  # static: compile the squelch gate in
                                   # (its ramp/multiply passes cost real
                                   # HBM on wideband audio; like the
                                   # blanker, toggling retraces — the
                                   # thresh/hyst stay runtime data)
    nco_enabled: bool = True    # static: False skips the mixer pass when
                                # the input is already channel-centered
                                # (PFB output — offsets structurally 0)
    passband_impl: str = "fft"  # static: "fft" = overlap-save FFT,
                                # "matmul" = blocked-Toeplitz FIR
                                # (ops/fir_matmul.py)
    passband_precision: str = "highest"  # matmul impl only: "highest"
                                # (full f32), "high" or "default" (TF32
                                # on a GPU); gate on oracle SNR
    resample_impl: str = "einsum"  # "einsum" (stacked frames → matmul),
                                # "fma" (broadcast FMA chain), or "matmul"
                                # (blocked-Toeplitz interleaving matmul,
                                # ops/resample.py); identical outputs
    resample_precision: str = "highest"  # matmul resampler precision
                                # (same ladder as passband_precision)
    tail_impl: str = "auto"     # "auto": demod → AGC → squelch →
                                # resample as one GPU kernel when this
                                # process runs on a GPU and the config
                                # qualifies (kernel_tail_ok), else XLA;
                                # "xla": always the XLA ops

    def __post_init__(self):
        if self.chunk % self.os_block:
            raise ValueError("chunk must be a multiple of os_block")
        if self.n_taps % 2 == 0:
            raise ValueError("n_taps must be odd")
        if self.passband_impl not in ("fft", "fftmxu", "matmul",
                                      "matmul_real"):
            raise ValueError("passband_impl must be 'fft', 'fftmxu', "
                             "'matmul' or 'matmul_real'")
        if self.tail_impl not in ("auto", "xla"):
            raise ValueError("tail_impl must be 'auto' or 'xla'")
        if self.passband_impl == "fftmxu" and self.chunk != self.os_block:
            raise ValueError("passband_impl='fftmxu' runs one overlap-save"
                             " row per chunk (os_block must equal chunk)")
        if self.audio_rate % self.iq_rate:
            _, M = self.resample_LM
            if self.chunk % M:
                raise ValueError(
                    f"rational resampling {self.iq_rate}->{self.audio_rate} "
                    f"needs chunk % {M} == 0 (got chunk={self.chunk}); e.g. "
                    f"20250->48000 is L/M=32/13.5 -> 64/27 after gcd")

    @property
    def os_plan(self) -> overlap_save.OSPlan:
        return overlap_save.plan_for(self.os_block, self.n_taps)

    @property
    def fir_plan(self) -> fir_matmul.FIRMatmulPlan:
        return fir_matmul.plan_for(self.chunk, self.n_taps)

    @property
    def is_rational(self) -> bool:
        """True when audio_rate / iq_rate is not an integer (e.g. the
        reference's 20.25 kHz 3-channel kiwis → 48 kHz,
        /root/reference/utils_supersdr.py:1126)."""
        return self.audio_rate % self.iq_rate != 0

    @property
    def resample_LM(self) -> tuple[int, int]:
        g = int(np.gcd(self.iq_rate, self.audio_rate))
        return self.audio_rate // g, self.iq_rate // g

    @property
    def upsample(self) -> int:
        if self.is_rational:
            raise ValueError("non-integer rate ratio; use resample_LM")
        return self.audio_rate // self.iq_rate

    @property
    def audio_chunk(self) -> int:
        """Audio samples produced per process() call."""
        L, M = self.resample_LM
        return self.chunk * L // M

    @property
    def hang_window(self) -> int:
        if not self.hang_enabled:
            return 1
        return agc_ops.hang_samples(self.iq_rate, self.hang_ms)

    @property
    def interp_plan(self) -> resample.InterpPlan:
        plan, _ = resample.design_interp(self.iq_rate, self.audio_rate)
        return plan

    @property
    def interp_matmul_plan(self) -> resample.InterpMatmulPlan:
        return resample.plan_interp_matmul(self.interp_plan, self.chunk)

    @property
    def rational_plan(self) -> resample.RationalPlan:
        plan, _ = resample.plan_rational(self.iq_rate, self.audio_rate)
        return plan


class ChainParams(NamedTuple):
    """Runtime tuning (a pytree of arrays; swap freely without retracing).

    All complex quantities are split-complex `cx.CX` float pairs, like
    every value that crosses a program boundary.
    """
    nco: mixer.NCOParams
    H_pass: cx.CX              # [fft_size] split-complex passband response
    P_interp: jax.Array        # [per, L] polyphase interpolation matrix
    agc: agc_ops.AGCParams
    squelch: squelch_ops.SquelchParams
    blanker: squelch_ops.BlankerParams
    W_pass: jax.Array | None = None  # [2·window, 2·block] Toeplitz matmul
                                     # matrix (passband_impl="matmul"), or
                                     # [window, block] real prototype matrix
                                     # (passband_impl="matmul_real")
    rot_in: cx.CX | None = None      # matmul_real: e^{-jωn} input rotation
                                     # [chunk] (None when the passband is
                                     # symmetric — ω snapped to fs/chunk)
    rot_out: cx.CX | None = None     # matmul_real: e^{+jω(n-c)} output
                                     # rotation [chunk]
    W_interp: jax.Array | None = None  # [window, L·block_in] blocked-
                                     # Toeplitz interpolation matrix
                                     # (resample_impl="matmul")
    mode_id: jax.Array | None = None  # [*batch] int32 per-slot demod
                                     # select (cfg.mode == "MULTI" only;
                                     # ops/demod.MODE_IDS)


class ChainState(NamedTuple):
    phase: jax.Array
    os_carry: cx.CX            # split-complex filter history
    demod: demod_ops.DemodState
    agc: agc_ops.AGCState
    interp_carry: jax.Array
    squelch: squelch_ops.SquelchState


class ChainOutput(NamedTuple):
    audio: jax.Array     # [*batch, chunk * upsample] float32 at audio_rate
                         # (IQ mode: split-complex cx.CX baseband instead)
    rssi: jax.Array      # [*batch, chunk/os_block] per-row RSSI dB
    baseband: cx.CX      # [*batch, chunk] passband-filtered split-complex


def make_params(cfg: ChainConfig,
                freq_offset_hz: float | np.ndarray = 0.0,
                delta_low: float = 0.0, delta_high: float = 0.0,
                low_cut: float | None = None,
                high_cut: float | None = None,
                agc_kwargs: dict | None = None,
                squelch_kwargs: dict | None = None,
                blanker_kwargs: dict | None = None) -> ChainParams:
    """Host-side parameter build (float64 design, device float32 results).

    `freq_offset_hz` is the receiver offset within the incoming IQ span
    (0 for an already-centered capture). Passband defaults follow the
    app-level mode conventions unless explicit cuts are given.
    """
    if low_cut is None or high_cut is None:
        lc, hc = passband.supersdr_passband(cfg.mode, delta_low, delta_high)
    else:
        lc, hc = low_cut, high_cut
    plan = cfg.os_plan
    taps = firdesign.complex_bandpass_taps(lc, hc, cfg.iq_rate, n=cfg.n_taps)
    H = overlap_save.taps_to_freq(plan, taps)
    W_interp = None
    if cfg.is_rational:
        # P_interp carries the rational-resampler prototype taps instead
        # of a polyphase matrix (resample_poly semantics, utils:1126)
        _, P = resample.plan_rational(cfg.iq_rate, cfg.audio_rate)
    else:
        itaps = firdesign.lowpass_taps(cfg.iq_rate / 2, cfg.audio_rate)
        _, P = resample.plan_interp(cfg.upsample, itaps)
        if cfg.resample_impl == "matmul":
            W_interp = resample.build_w_interp(cfg.interp_matmul_plan, itaps)
    nco = mixer.NCOParams.make(-np.asarray(freq_offset_hz, np.float64),
                               cfg.iq_rate, cfg.chunk)
    agc_p = agc_ops.make_params(cfg.iq_rate, **(agc_kwargs or {}))
    W_pass, rot_in, rot_out = None, None, None
    if cfg.passband_impl == "matmul":
        W_pass = fir_matmul.build_w(cfg.fir_plan, taps)
    elif cfg.passband_impl == "matmul_real":
        # modulated-prototype form: filter the basebanded stream with the
        # REAL lowpass prototype (half the matmul FLOPs), rotating in/out
        # by e^{∓jωn}. ω is snapped to the fs/chunk grid (≤ fs/2chunk Hz
        # error) so the rotation vectors are chunk-periodic and streaming
        # needs no phase state; ω = 0 (symmetric passband, e.g. AM)
        # statically drops the rotations entirely.
        center = 0.5 * (lc + hc)
        half_width = 0.5 * (hc - lc)
        grid = cfg.iq_rate / cfg.chunk
        center_s = round(center / grid) * grid
        proto = firdesign.lowpass_taps_n(half_width, cfg.iq_rate, cfg.n_taps)
        W_pass = fir_matmul.build_w_real(cfg.fir_plan, proto)
        if center_s != 0.0:
            w = 2.0 * np.pi * center_s / cfg.iq_rate
            ns = np.arange(cfg.chunk)
            c = (cfg.n_taps - 1) / 2.0
            rot_in = cx.CX(jnp.asarray(np.cos(-w * ns), jnp.float32),
                           jnp.asarray(np.sin(-w * ns), jnp.float32))
            rot_out = cx.CX(jnp.asarray(np.cos(w * (ns - c)), jnp.float32),
                            jnp.asarray(np.sin(w * (ns - c)), jnp.float32))
    return ChainParams(nco=nco, H_pass=H, P_interp=jnp.asarray(P, jnp.float32),
                       agc=agc_p,
                       squelch=squelch_ops.make_squelch(**(squelch_kwargs or {})),
                       blanker=squelch_ops.make_blanker(**(blanker_kwargs or {})),
                       W_pass=W_pass, rot_in=rot_in, rot_out=rot_out,
                       W_interp=W_interp)


def init_state(cfg: ChainConfig, batch_shape: tuple[int, ...] = ()
               ) -> ChainState:
    plan = cfg.os_plan
    if cfg.is_rational:
        icarry = jnp.zeros(batch_shape + (cfg.rational_plan.history,),
                           jnp.float32)
    else:
        icarry = resample.init_carry(cfg.interp_plan, batch_shape)
    return ChainState(
        phase=mixer.init_phase(batch_shape),
        os_carry=overlap_save.init_carry(plan, batch_shape),
        demod=demod_ops.init_state(batch_shape),
        agc=agc_ops.init_state(batch_shape),
        interp_carry=icarry,
        squelch=squelch_ops.init_squelch(batch_shape),
    )


def process_traced(cfg: ChainConfig, params: ChainParams, state: ChainState,
                   iq: cx.CX) -> tuple[ChainState, ChainOutput]:
    """Chain body for traced contexts (inside jit/scan/shard_map).

    iq: [*batch, chunk] split-complex. Complex math happens freely inside;
    every leaf of the returned pytrees is float (CX for complex values) so
    the enclosing program's boundary carries no complex buffers.
    """
    plan = cfg.os_plan
    batch = iq.shape[:-1]
    n_rows = cfg.chunk // cfg.os_block
    iqc = cx.to_complex(iq)

    # 0. impulse noise blanker on the raw IQ (SET nb equivalent);
    # statically gated — toggling NB retraces, like a mode change
    if cfg.blanker_enabled:
        iqc = squelch_ops.apply_blanker(params.blanker, iqc)

    # 1. tune: complex mix by -freq_offset (statically skipped for
    #    channel-centered inputs, e.g. PFB output)
    if cfg.nco_enabled:
        phase, x = mixer.mix(params.nco, state.phase, iqc)
    else:
        phase, x = state.phase, iqc

    # 2. passband selection: batched overlap-save rows, or the FFT-free
    #    blocked-Toeplitz matmul (same streaming state either way)
    if cfg.passband_impl == "matmul":
        prec = cx.resolve_precision(cfg.passband_precision)
        _, y_cx = fir_matmul.fir_matmul_stream_c(cfg.fir_plan, params.W_pass,
                                                 state.os_carry, cx.split(x),
                                                 precision=prec)
        y = cx.to_complex(y_cx)
        y_rows = y.reshape(*batch, n_rows, cfg.os_block)
    elif cfg.passband_impl == "matmul_real":
        prec = cx.resolve_precision(cfg.passband_precision)
        xs = cx.split(x)
        carry = state.os_carry
        if params.rot_in is not None:
            rin = params.rot_in
            xs = xs * rin
            if plan.overlap:
                carry = carry * rin[..., -plan.overlap:]
        _, u = fir_matmul.fir_matmul_stream_real_c(cfg.fir_plan,
                                                   params.W_pass, carry, xs,
                                                   precision=prec)
        if params.rot_out is not None:
            u = u * params.rot_out
        y = cx.to_complex(u)
        y_rows = y.reshape(*batch, n_rows, cfg.os_block)
    elif cfg.passband_impl == "fftmxu":
        # layout-rotating matmul overlap-save: forward FFT rotates
        # the batch axis into the lanes ([B, F] → [F, B]), the passband
        # mask multiplies down the major axis, the inverse runs major-
        # axis in place, and ONE transpose returns [B, chunk]. All FFT
        # FLOPs are dot_generals with full-lane minor dims — the formula
        # that made round 2 reject FFT passbands (~3× off roofline) was
        # an artifact of the old small-dim-swapping four-step layout.
        prec = cx.resolve_precision(cfg.passband_precision)
        xs = cx.split(x)
        F = plan.fft_size
        seg_r = jnp.concatenate([state.os_carry.re, xs.re], axis=-1)
        seg_i = jnp.concatenate([state.os_carry.im, xs.im], axis=-1)
        pad = F - seg_r.shape[-1]
        if pad:
            zpad = jnp.zeros((*seg_r.shape[:-1], pad), jnp.float32)
            seg_r = jnp.concatenate([seg_r, zpad], axis=-1)
            seg_i = jnp.concatenate([seg_i, zpad], axis=-1)
        b2r = seg_r.reshape(-1, F)
        b2i = seg_i.reshape(-1, F)
        Xr, Xi = cx.fft_rotate(b2r, b2i, precision=prec)      # [F, B]
        Hr = params.H_pass.re[:, None]
        Hi = params.H_pass.im[:, None]
        Yr = Xr * Hr - Xi * Hi
        Yi = Xr * Hi + Xi * Hr
        zr, zi = cx.ifft_major(Yr, Yi, precision=prec)        # [F, B]
        sl = slice(plan.overlap, plan.overlap + cfg.chunk)
        yr = zr[sl, :].T.reshape(*batch, cfg.chunk)
        yi = zi[sl, :].T.reshape(*batch, cfg.chunk)
        y = jax.lax.complex(yr, yi)
        y_rows = y.reshape(*batch, n_rows, cfg.os_block)
    else:
        rows = x.reshape(*batch, n_rows, cfg.os_block)
        H = cx.to_complex(params.H_pass)
        if params.H_pass.re.ndim > 1:
            # per-slot passbands (batched multi-receiver): broadcast the
            # [*batch, fft] responses over the rows axis
            H = H[..., None, :]
        y_rows = overlap_save.overlap_save_batch_c(plan, H,
                                                   cx.to_complex(state.os_carry),
                                                   rows)
        y = y_rows.reshape(*batch, cfg.chunk)
    # NB x[..., -0:] would be the whole array — guard the overlap-0 case
    os_carry = cx.split(x[..., -plan.overlap:] if plan.overlap
                        else x[..., :0])

    # 3. per-row RSSI from the passband signal (the reference receives one
    #    RSSI per 512-sample SND frame; here one per overlap-save row)
    rssi = smeter.rssi_db(y_rows)

    # 4-6. demod → AGC → squelch → resample: one GPU kernel where the
    #      configuration has one, else the XLA ops
    tail = (tail_kernel if cfg.tail_impl == "auto" and backend.gpu_kernels()
            and kernel_tail_ok(cfg, batch) else tail_xla)
    dstate, astate, sq_state, icarry, out_audio = tail(cfg, params, state, y,
                                                       rssi)
    new_state = ChainState(phase=phase, os_carry=os_carry, demod=dstate,
                           agc=astate, interp_carry=icarry,
                           squelch=sq_state)
    return new_state, ChainOutput(audio=out_audio, rssi=rssi,
                                  baseband=cx.split(y))


def tail_xla(cfg: ChainConfig, params: ChainParams, state: ChainState,
             y: jax.Array, rssi: jax.Array):
    """Back half of the chain in XLA ops: passband output y [*batch,
    chunk] complex → (demod, AGC, squelch state, resampler history,
    audio [*batch, chunk·L])."""
    # 4. demodulate (MULTI: per-slot runtime select — mode changes on a
    #    batched multi-receiver program never retrace)
    if cfg.mode.upper() == "MULTI":
        dstate, audio = demod_ops.demodulate_runtime(
            state.demod, y, cfg.iq_rate, params.mode_id, cfg.max_dev_hz)
    else:
        dstate, audio = demod_ops.demodulate(cfg.mode, state.demod, y,
                                             cfg.iq_rate,
                                             max_dev_hz=cfg.max_dev_hz)

    # 5. AGC
    astate, audio = agc_ops.apply(params.agc, state.agc, audio,
                                  hang_window=cfg.hang_window,
                                  decimation=cfg.agc_decimation)

    # 5b. squelch gate on the chunk RSSI (SET squelch equivalent);
    # statically compiled out when off — the default, like the blanker
    if cfg.squelch_enabled:
        sq_state, audio = squelch_ops.apply_squelch(
            params.squelch, state.squelch, audio, jnp.mean(rssi, axis=-1))
    else:
        sq_state = state.squelch

    # 6. resample to the audio rate (IQ mode keeps complex baseband as-is)
    if cfg.mode.upper() == "IQ":
        out_audio = cx.split(audio)
        icarry = state.interp_carry
    elif cfg.is_rational:
        icarry, out_audio = resample.rational_resample_block(
            cfg.rational_plan, params.P_interp, state.interp_carry,
            audio.astype(jnp.float32))
    elif cfg.resample_impl == "matmul":
        icarry, out_audio = resample.interpolate_matmul(
            cfg.interp_matmul_plan, params.W_interp, state.interp_carry,
            audio.astype(jnp.float32),
            precision=cx.resolve_precision(cfg.resample_precision))
    else:
        icarry, out_audio = resample.interpolate(cfg.interp_plan,
                                                 params.P_interp,
                                                 state.interp_carry,
                                                 audio.astype(jnp.float32),
                                                 cfg.resample_impl)
    return dstate, astate, sq_state, icarry, out_audio


_KERNEL_MODES = ("AM", "USB", "LSB", "CW", "NBFM")


def kernel_tail_ok(cfg: ChainConfig, batch: tuple) -> bool:
    """Whether the GPU tail kernel covers this configuration: a mode
    whose demodulator is elementwise (AM, SSB, CW, NBFM), an integer
    upsample, full-rate AGC, one channel axis and a chunk of whole
    kernel tiles."""
    return (cfg.mode.upper() in _KERNEL_MODES
            and not cfg.is_rational
            and cfg.agc_decimation == 1
            and len(batch) == 1
            and cfg.chunk % chain_tail.K == 0)


def tail_kernel(cfg: ChainConfig, params: ChainParams, state: ChainState,
                y: jax.Array, rssi: jax.Array, *, interpret: bool = False):
    """`tail_xla` with its recurrences in one GPU kernel (ops/pallas/
    chain_tail.py) for a [C, chunk] channel batch. The demodulator's
    elementwise part stays in XLA, fused into the transpose that feeds
    the kernel (AM: the envelope, whose DC blocker runs in the kernel).
    Same state pytree in and out, so chunks chain across the two
    tails."""
    am = cfg.mode.upper() == "AM"
    if am:
        dstate, x = state.demod, jnp.abs(y).astype(jnp.float32)
    else:
        dstate, x = demod_ops.demodulate(cfg.mode, state.demod, y,
                                         cfg.iq_rate,
                                         max_dev_hz=cfg.max_dev_hz)
    packed = jnp.concatenate(
        [jnp.stack([state.demod.dc_x, state.demod.dc_y, state.agc.peak_db,
                    state.agc.gain_db]),
         state.interp_carry.T], axis=0)
    sq_ramp = None
    sq_state = state.squelch
    if cfg.squelch_enabled:
        sq_state, ramp = squelch_ops.gate_ramp(
            params.squelch, state.squelch, jnp.mean(rssi, axis=-1),
            cfg.chunk)
        sq_ramp = jnp.stack([r[..., 0] for r in ramp])
    par = chain_tail.params_vector(params.agc, demod_ops.DC_POLE)
    _, P = resample.design_interp(cfg.iq_rate, cfg.audio_rate)
    audioT, st = chain_tail.chain_tail(
        x.T, packed, par, P, dc_block=am,
        hang_window=cfg.hang_window if cfg.hang_enabled else 0,
        squelch=sq_ramp, interpret=interpret)
    if am:
        dstate = dstate._replace(dc_x=st[0], dc_y=st[1])
    astate = agc_ops.AGCState(peak_db=st[2], gain_db=st[3])
    return dstate, astate, sq_state, st[4:].T, audioT.T


_process_cx = partial(jax.jit, static_argnums=0)(process_traced)


def process(cfg: ChainConfig, params: ChainParams, state: ChainState,
            iq) -> tuple[ChainState, ChainOutput]:
    """Run one chunk through the full chain. iq: [*batch, chunk] — CX,
    complex numpy (split host-side), or a complex array."""
    return _process_cx(cfg, params, state, cx.as_cx(iq))


def run_offline(cfg: ChainConfig, params: ChainParams, iq: np.ndarray,
                state: ChainState | None = None
                ) -> tuple[ChainState, np.ndarray, np.ndarray]:
    """Host convenience: stream an arbitrary-length IQ signal through the
    chain in `cfg.chunk` slices (zero-padding the tail), returning
    (final_state, audio, rssi_rows)."""
    if state is None:
        state = init_state(cfg, iq.shape[:-1])
    n = iq.shape[-1]
    pad = (-n) % cfg.chunk
    iqp = np.pad(np.asarray(iq, np.complex64),
                 [(0, 0)] * (iq.ndim - 1) + [(0, pad)])
    audio_parts, rssi_parts = [], []
    for i in range(0, iqp.shape[-1], cfg.chunk):
        state, out = process(cfg, params, state, iqp[..., i:i + cfg.chunk])
        audio_parts.append(np.asarray(out.audio))
        rssi_parts.append(np.asarray(out.rssi))
    audio = np.concatenate(audio_parts, axis=-1)
    rssi = np.concatenate(rssi_parts, axis=-1)
    if cfg.mode.upper() != "IQ":
        L, M = cfg.resample_LM
        audio = audio[..., : n * L // M]
    return state, audio, rssi
