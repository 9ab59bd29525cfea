"""Structured logging, counters, and per-stage timing.

The reference's observability is tagged prints + ad-hoc chrono timers
(SURVEY.md §5: logMessage Stabilizer.cpp:40-46, FPS prints
DeepStreamTracker.cpp:119-129, main-ffmpeg.cpp:686-695). Here it is a
first-class metrics struct: named counters, per-stage millisecond
histograms, and an FPS meter, all cheap enough for per-frame use, plus a
`trace` contextmanager that forwards to jax.profiler for device timelines.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from collections import defaultdict
from typing import Dict


def get_logger(tag: str, enabled: bool = True,
               level: int = logging.INFO) -> logging.Logger:
    """Tagged logger matching the reference's `[Component] msg` convention."""
    logger = logging.getLogger(f"video_stab_tpu.{tag}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(f"[{tag}] %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level if enabled else logging.CRITICAL)
    return logger


class StageTimer:
    """Per-stage wall-time accumulator with simple percentile estimates."""

    def __init__(self, keep_last: int = 300):
        self.keep_last = keep_last
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            buf = self._samples[name]
            buf.append(dt)
            if len(buf) > self.keep_last:
                del buf[:len(buf) - self.keep_last]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self._samples.items():
            if not buf:
                continue
            s = sorted(buf)
            out[name] = {
                "n": len(s),
                "mean_ms": sum(s) / len(s),
                "p50_ms": s[len(s) // 2],
                "p95_ms": s[min(int(len(s) * 0.95), len(s) - 1)],
                "max_ms": s[-1],
            }
        return out


class FpsMeter:
    """Sliding-window FPS (the reference prints every 30/300 frames)."""

    def __init__(self, window: int = 120):
        self.window = window
        self._stamps: list = []

    def tick(self) -> float:
        now = time.perf_counter()
        self._stamps.append(now)
        if len(self._stamps) > self.window:
            del self._stamps[:len(self._stamps) - self.window]
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0


class Metrics:
    """Named counters + gauges: fps, dropped frames, feature count, RANSAC
    inlier ratio, correction magnitude (SURVEY.md §5 target list)."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.timer = StageTimer()
        self.fps = FpsMeter()

    def inc(self, name: str, n: int = 1):
        self.counters[name] += n

    def set(self, name: str, value: float):
        self.gauges[name] = float(value)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "stages": self.timer.summary(),
        }


@contextlib.contextmanager
def trace(name: str):
    """jax.profiler annotation (no-op overhead when not profiling)."""
    try:
        import jax
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def start_profiler_trace(logdir: str) -> None:
    import jax
    jax.profiler.start_trace(logdir)


def stop_profiler_trace() -> None:
    import jax
    jax.profiler.stop_trace()
