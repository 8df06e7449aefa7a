"""Sustained-session soak (VERDICT r2 #7): ≥2 simulated minutes of
real-time-paced streaming through the engine + latency governor, with an
injected mid-stream disconnect.

Asserts the reference's self-healing behavior
(/root/reference/utils_supersdr.py:1110-1115,1158-1186 + kiwi/worker.py
reconnect loop) at session scale, deterministically: a simulated clock
paces frame arrivals, so the test runs in CI time while exercising two
minutes of governor/stream dynamics."""

import numpy as np

from supersdr_jax.runtime.engine import (EngineConfig, SourceClosed,
                                         StreamEngine)
from supersdr_jax.runtime.governor import DriftCompensator, LatencyGovernor

FRAME = 512
RATE = 12000.0
MS_PER_FRAME = FRAME / RATE * 1000.0


class SimSession:
    """Deterministic session: a simulated wall clock advanced by the
    source at real-time pace (±jitter), an outage at a chosen frame, and
    in-line buffer draining standing in for the audio callback."""

    def __init__(self, total_frames: int, outage_at: int | None = None,
                 outage_ms: float = 0.0, jitter_ms: float = 0.4,
                 stall_at: int | None = None, stall_ms: float = 0.0):
        self.total = total_frames
        self.outage_at = outage_at            # disconnect (SourceClosed)
        self.outage_ms = outage_ms
        self.stall_at = stall_at              # in-stream stall + burst
        self.stall_ms = stall_ms
        self.jitter = jitter_ms
        self.now_ms = 0.0
        self.sent = 0
        self.rng = np.random.default_rng(7)
        self.engine: StreamEngine | None = None
        self.connects = 0
        self.played = 0

    def clock(self) -> float:
        return self.now_ms

    def factory(self):
        self.connects += 1
        outage_pending = (self.outage_at is not None
                          and self.sent < self.outage_at)

        def gen():
            burst = 0
            while self.sent < self.total:
                if (outage_pending and self.sent >= self.outage_at):
                    self.now_ms += self.outage_ms   # dead air
                    raise SourceClosed()
                if self.stall_at is not None and self.sent == self.stall_at:
                    # server hiccup: dead air, then the buffered frames
                    # arrive in a burst (near-zero inter-arrival)
                    self.now_ms += self.stall_ms
                    burst = int(self.stall_ms / MS_PER_FRAME)
                if burst > 0:
                    burst -= 1
                    self.now_ms += 0.1
                else:
                    self.now_ms += MS_PER_FRAME + float(
                        self.rng.uniform(-self.jitter, self.jitter))
                self.sent += 1
                # the "audio callback": consume one frame per frame-time
                # once the buffer has filled
                if self.engine is not None and \
                        self.engine.buffer.qsize() > 2:
                    if self.engine.pop_audio(timeout=0.01) is not None:
                        self.played += 1
                yield np.zeros(FRAME, np.complex64)
        return gen()


def run_session(total_frames: int, outage_at=None, outage_ms=0.0,
                stall_at=None, stall_ms=0.0):
    sim = SimSession(total_frames, outage_at, outage_ms,
                     stall_at=stall_at, stall_ms=stall_ms)
    gov = LatencyGovernor(buffer_frames=10, ms_per_frame=MS_PER_FRAME)
    eng = StreamEngine(sim.factory,
                       process=lambda b: np.zeros(FRAME * 4, np.float32),
                       config=EngineConfig(buffer_frames=10,
                                           backoff_closed_s=0.0),
                       governor=gov,
                       drift=DriftCompensator(12000, 12000.6, FRAME),
                       clock=sim.clock)
    sim.engine = eng
    eng.run()          # synchronous: returns when the stream is exhausted
    return sim, eng, gov


def test_soak_steady_state_no_drops():
    """2 simulated minutes of in-time frames: the governor must never
    enter late mode and no frames may be dropped."""
    frames = int(120_000 / MS_PER_FRAME) + 10       # ≥ 2 simulated minutes
    sim, eng, gov = run_session(frames)
    assert sim.now_ms >= 120_000
    assert eng.dropped_frames == 0
    assert not gov.late
    assert eng.status == "stopped"
    assert sim.played > frames - 30                 # audio actually flowed


def test_soak_recovers_from_midstream_disconnect():
    """A mid-stream disconnect (2 s of dead air, then the server drops
    the socket) must trigger the reconnect path and resume a CLEAN
    stream: the governor's timeline resets with the new connection (the
    reference rebuilds kiwi_sound outright, supersdr.py:743-796), so no
    post-reconnect frames are dropped."""
    frames = int(150_000 / MS_PER_FRAME)
    cut = frames // 3
    sim, eng, gov = run_session(frames, outage_at=cut, outage_ms=2_000.0)
    assert sim.sent == frames                       # stream completed
    assert eng.reconnects == 1
    assert eng.dropped_frames == 0                  # fresh timeline
    assert not gov.late
    assert eng.status == "stopped"


def test_soak_stall_burst_drop_refill():
    """An in-stream stall (1.5 s dead air, then the buffered frames burst
    in) exercises the drop→silence→refill machine: the late burst is
    shed, the governor refills, and the tail runs clean (reference
    utils:1110-1115,1158-1186)."""
    frames = int(150_000 / MS_PER_FRAME)
    sim, eng, gov = run_session(frames, stall_at=frames // 3,
                                stall_ms=1_500.0)
    assert sim.sent == frames
    assert eng.reconnects == 0
    assert eng.dropped_frames > 0                   # late burst shed
    assert not gov.late                             # recovered
    # the shed burst is bounded by the stall length plus the drain margin
    assert eng.dropped_frames < int(1_500 / MS_PER_FRAME) + 15


def test_soak_drift_double_reads():
    """The drift compensator absorbs a +0.6 Hz true-rate offset by
    consuming extra frames — all within the no-drop steady state."""
    frames = int(130_000 / MS_PER_FRAME)
    sim, eng, gov = run_session(frames)
    # 0.6/12000 drift → one double-read every nominal/delta ≈ 20000/…
    # frames; over ~5600 frames that's ≥ a couple of events, observable
    # as sent > processed (extra frames consumed by the drift tick)
    assert eng.dropped_frames == 0
    assert sim.sent == frames


def run_session_real_chain(total_frames: int, outage_at=None,
                           outage_ms=0.0):
    """Soak with the ACTUAL receiver chain as the process callback
    (VERDICT r3 #5): every frame runs NCO → passband → demod → AGC →
    resample on the CPU backend, so compile stalls and per-dispatch
    jitter are part of the simulated session, not stubbed out."""
    from supersdr_jax.control.receiver import Receiver
    from supersdr_jax.runtime import chain as chain_mod

    cfg = chain_mod.ChainConfig(mode="AM", iq_rate=12000,
                                audio_rate=48000, chunk=FRAME,
                                os_block=FRAME, n_taps=129)
    rx = Receiver(cfg=cfg, center_freq_khz=1000.0, freq=1001.0,
                  radio_mode="AM")
    sim = SimSession(total_frames, outage_at, outage_ms)
    # a real AM station at +1 kHz so the chain produces audible audio
    t_idx = {"n": 0}

    base_factory = sim.factory

    def factory():
        gen = base_factory()

        def toned():
            for _ in gen:
                n0 = t_idx["n"]
                t = (n0 + np.arange(FRAME)) / RATE
                t_idx["n"] = n0 + FRAME
                z = (0.4 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
                     * np.exp(2j * np.pi * 1000.0 * t)).astype(np.complex64)
                yield z
        return toned()

    audio_seen = {"max": 0.0, "frames": 0}

    def process(block):
        out = rx.process(block)
        a = np.asarray(out, np.float32)
        assert np.isfinite(a).all()
        audio_seen["max"] = max(audio_seen["max"], float(np.abs(a).max()))
        audio_seen["frames"] += 1
        return a

    gov = LatencyGovernor(buffer_frames=10, ms_per_frame=MS_PER_FRAME)
    eng = StreamEngine(factory, process=process,
                       config=EngineConfig(buffer_frames=10,
                                           backoff_closed_s=0.0),
                       governor=gov,
                       drift=DriftCompensator(12000, 12000.6, FRAME),
                       clock=sim.clock)
    sim.engine = eng
    eng.run()
    return sim, eng, gov, audio_seen


def test_soak_real_chain_steady_state():
    """≥60 simulated seconds with the real DSP in the loop: no drops,
    no late mode, real demodulated audio flowing end to end."""
    frames = int(65_000 / MS_PER_FRAME)
    sim, eng, gov, seen = run_session_real_chain(frames)
    assert sim.now_ms >= 60_000
    assert eng.dropped_frames == 0
    assert not gov.late
    assert seen["frames"] >= frames - 5
    assert seen["max"] > 0.01            # demodulated audio is nonzero


def test_soak_real_chain_disconnect_recovery():
    """Mid-stream disconnect with the real chain processing: reconnect
    resumes a clean timeline (zero dropped frames post-recovery)."""
    frames = int(70_000 / MS_PER_FRAME)
    sim, eng, gov, seen = run_session_real_chain(
        frames, outage_at=frames // 3, outage_ms=2_000.0)
    assert sim.sent == frames
    assert eng.reconnects == 1
    assert eng.dropped_frames == 0
    assert not gov.late
    assert seen["max"] > 0.01
