"""Tracing and per-block timing.

The reference's only diagnostics are prints and stdlib logging
(SURVEY.md §5); here the pipeline gets first-class observability:

  * `trace(...)` — context manager around `jax.profiler` for device traces
    viewable in TensorBoard/Perfetto
  * `BlockTimer` — streaming per-stage wall-time stats (EWMA + percentiles)
    for the host loop: source wait, device step, sink push
  * `log` — structured logging setup (one line per event, key=value)
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np


def get_logger(name: str = "supersdr_jax", level: int = logging.INFO
               ) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


@contextlib.contextmanager
def trace(logdir: str = "/tmp/supersdr_jax_trace"):
    """Capture a device trace around the enclosed block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class BlockTimer:
    """Per-stage streaming timing stats for the host pipeline loop."""

    def __init__(self, window: int = 512):
        self.window = window
        self._samples: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._open: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def stats(self, name: str) -> dict:
        s = np.asarray(self._samples[name])
        if len(s) == 0:
            return {"n": 0}
        return {"n": len(s), "mean_ms": float(s.mean() * 1e3),
                "p50_ms": float(np.percentile(s, 50) * 1e3),
                "p95_ms": float(np.percentile(s, 95) * 1e3),
                "max_ms": float(s.max() * 1e3)}

    def report(self) -> str:
        lines = []
        for name in sorted(self._samples):
            st = self.stats(name)
            if st["n"]:
                lines.append(f"{name}: n={st['n']} mean={st['mean_ms']:.2f}ms "
                             f"p50={st['p50_ms']:.2f}ms p95={st['p95_ms']:.2f}ms "
                             f"max={st['max_ms']:.2f}ms")
        return "\n".join(lines)


@dataclass
class ThroughputMeter:
    """Samples/sec EWMA for the HUD."""
    alpha: float = 0.1
    rate: float = 0.0
    _last: float | None = None

    def update(self, n_samples: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_samples / max(now - self._last, 1e-9)
            self.rate = (1 - self.alpha) * self.rate + self.alpha * inst \
                if self.rate else inst
        self._last = now
        return self.rate
