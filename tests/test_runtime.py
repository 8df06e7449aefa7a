"""Deterministic simulations of the streaming governors and engine
(SURVEY.md §4: drift/latency behaviors with a mocked clock)."""

import numpy as np
import pytest

from supersdr_jax.runtime.engine import (EngineConfig, SourceBusy,
                                         SourceClosed, StreamEngine)
from supersdr_jax.runtime.governor import DriftCompensator, LatencyGovernor
from supersdr_jax.runtime.ring import FrameBuffer


def test_drift_double_read_cadence():
    # KIWI_RATE_TRUE 12001.15 vs 12000: extra read every
    # 512/((1.15/12000)*512) ≈ 10434 frames
    d = DriftCompensator(nominal_rate=12000, true_rate=12001.15, frame=512)
    doubles = [i for i in range(25000) if d.tick()]
    assert len(doubles) == 2
    expected = 12000 / 1.15
    assert abs(doubles[0] - expected) < 2
    assert abs((doubles[1] - doubles[0]) - expected) < 2


def test_drift_no_compensation_when_exact():
    d = DriftCompensator(nominal_rate=12000, true_rate=12000.0)
    assert not any(d.tick() for _ in range(100000))


def test_governor_steady_state_buffers():
    g = LatencyGovernor(buffer_frames=10, ms_per_frame=42.67)
    t = 0.0
    actions = []
    for _ in range(100):
        actions.append(g.on_frame(t))
        t += 42.67  # perfectly on time
    assert all(a == "buffer" for a in actions)
    assert not g.late


def test_governor_stall_then_burst_recovers():
    mpf = 42.67
    g = LatencyGovernor(buffer_frames=10, ms_per_frame=mpf)
    t = 0.0
    for _ in range(20):
        assert g.on_frame(t) == "buffer"
        t += mpf
    # network stall: 1.5 s gap, then frames burst in instantly
    t += 1500.0
    first = g.on_frame(t)
    assert first == "drop" and g.late
    actions = []
    for _ in range(60):
        t += 1.0  # burst: frames arrive nearly instantly
        actions.append(g.on_frame(t))
    assert "refill" in actions
    i = actions.index("refill")
    assert all(a == "drop" for a in actions[:i])
    assert not g.late
    # back to steady state
    for _ in range(10):
        t += mpf
        assert g.on_frame(t) == "buffer"


def test_frame_buffer_counts():
    fb = FrameBuffer(2)
    assert fb.put(np.zeros(4), block=False)
    assert fb.put(np.zeros(4), block=False)
    assert not fb.put(np.zeros(4), block=False)
    assert fb.overruns == 1
    assert fb.fill == 1.0
    fb.get()
    fb.get()
    assert fb.get(block=False) is None
    assert fb.underruns == 1


def blocks_source(n, fail_at=None, exc=SourceClosed):
    def factory():
        def gen():
            for i in range(n):
                if fail_at is not None and i == fail_at:
                    raise exc()
                yield np.full(512, i, np.complex64)
        return gen()
    return factory


def test_engine_pumps_to_buffer():
    eng = StreamEngine(blocks_source(5),
                       process=lambda b: np.real(b).astype(np.float32),
                       config=EngineConfig(buffer_frames=8))
    eng.run()
    assert eng.status == "stopped"
    got = [eng.pop_audio(timeout=0.1) for _ in range(5)]
    assert all(g is not None for g in got)
    assert got[3][0] == 3.0


def test_engine_reconnects_on_close():
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        if calls["n"] == 1:
            def gen():
                yield np.zeros(512, np.complex64)
                raise SourceClosed()
            return gen()
        return iter([np.ones(512, np.complex64)] * 2)

    eng = StreamEngine(factory, process=lambda b: np.abs(b),
                       config=EngineConfig(buffer_frames=8,
                                           backoff_closed_s=0.01))
    eng.run()
    assert calls["n"] == 2
    assert eng.reconnects == 1


def test_engine_busy_backoff_then_gives_up_with_budget():
    def factory():
        raise SourceBusy()

    eng = StreamEngine(factory, process=lambda b: b,
                       config=EngineConfig(buffer_frames=2,
                                           connect_retries=3,
                                           backoff_busy_s=0.01))
    # busy retries are unlimited in the reference; bound the test via stop()
    import threading
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    import time
    time.sleep(0.15)
    eng.stop(join=False)
    t.join(timeout=2)
    assert eng.reconnects >= 2
    assert eng.status in ("stopped", "busy")


def test_engine_drift_double_read():
    # true rate much faster: expect extra reads consuming blocks
    drift = DriftCompensator(nominal_rate=12000, true_rate=13200, frame=512)
    eng = StreamEngine(blocks_source(40), process=lambda b: np.abs(b),
                       config=EngineConfig(buffer_frames=64), drift=drift)
    eng.run()
    n_buffered = eng.buffer.qsize()
    # 10% drift → roughly every 10th block skipped
    assert n_buffered < 40
    assert 30 <= n_buffered <= 38


def _block_source(tag, n_blocks=1000):
    def factory():
        def gen():
            for i in range(n_blocks):
                yield np.full(4, tag, np.float32)
        return gen()
    return factory


def test_engine_switch_source_success():
    """Interactive server switching: blocks from the new source appear
    after switch_source (supersdr.py:743-778)."""
    eng = StreamEngine(_block_source(1.0), process=lambda b: b,
                       config=EngineConfig(buffer_frames=4,
                                           connect_retries=1))
    eng.start()
    first = eng.pop_audio(timeout=2.0)
    assert first is not None and first[0] == 1.0
    eng.switch_source(_block_source(2.0))
    seen = set()
    for _ in range(40):
        f = eng.pop_audio(timeout=2.0)
        if f is None:
            break
        seen.add(float(f[0]))
        if 2.0 in seen:
            break
    eng.stop()
    assert 2.0 in seen
    assert eng.switch_failures == 0


def test_engine_switch_source_failure_reverts():
    """A switch to an unreachable server reverts to the previous one
    (supersdr.py:779-796)."""
    def bad_factory():
        raise SourceClosed()

    eng = StreamEngine(_block_source(1.0), process=lambda b: b,
                       config=EngineConfig(buffer_frames=4,
                                           connect_retries=1))
    eng.start()
    assert eng.pop_audio(timeout=2.0) is not None
    eng.switch_source(bad_factory)
    got = []
    for _ in range(40):
        f = eng.pop_audio(timeout=2.0)
        if f is None:
            break
        got.append(float(f[0]))
        if eng.switch_failures:
            break
    # drain a few more frames — they must come from the old source
    tail = [eng.pop_audio(timeout=2.0) for _ in range(5)]
    eng.stop()
    assert eng.switch_failures == 1
    assert all(f is None or f[0] == 1.0 for f in tail)


def test_engine_pipelined_dispatch_preserves_order_and_drains():
    """pipeline_depth=1: the engine keeps one dispatch in flight (fetch
    of block k-1 overlaps block k), order is preserved, the tail drains."""
    dispatched, fetched = [], []

    def dispatch(block):
        dispatched.append(float(block[0]))
        return ("handle", float(block[0]))

    def fetch(handle):
        fetched.append(handle[1])
        return np.full(4, handle[1], np.float32)

    def factory():
        def gen():
            for i in range(6):
                yield np.full(4, float(i), np.float32)
        return gen()

    eng = StreamEngine(factory, process=None,
                       process_dispatch=dispatch, process_fetch=fetch,
                       config=EngineConfig(buffer_frames=16,
                                           connect_retries=1,
                                           pipeline_depth=1))
    eng.start()
    got = []
    for _ in range(6):
        f = eng.pop_audio(timeout=2.0)
        if f is None:
            break
        got.append(float(f[0]))
    eng.stop()
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    # dispatch ran one block ahead of fetch while streaming
    assert dispatched == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert fetched == dispatched
