"""Timing utilities: StopWatch / FpsLimiter / FpsMeter.

Rebuild of NvCommon.h:209 (StopWatch), FpsLimiter.h:6-26, and the
AppMeTrans live per-second FPS counters (AppMeTrans.cpp:214-219,347-355).
"""
from __future__ import annotations

import threading
import time


class StopWatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        return time.perf_counter() - self.t0


class FpsLimiter:
    """Sleep so frames are released no faster than `fps` (0 = unlimited)."""

    def __init__(self, fps: float = 0.0):
        self.interval = 1.0 / fps if fps > 0 else 0.0
        self._next = time.perf_counter()

    def tick(self, frames: int = 1):
        """Account for `frames` released frames (batched pipelines must
        pass their batch size or the limit is exceeded by that factor)."""
        if not self.interval or frames <= 0:
            return      # nothing released: sleeping would be pure stall
        now = time.perf_counter()
        if now < self._next:
            time.sleep(self._next - now)
        self._next = max(self._next + self.interval * frames,
                         now + self.interval * (frames - 1))


class FpsMeter:
    """Thread-safe frame counter with periodic rate reporting."""

    def __init__(self, label: str = "", report_every: float = 1.0,
                 quiet: bool = False):
        self.label = label
        self.report_every = report_every
        self.quiet = quiet
        self.count = 0
        self.t0 = time.perf_counter()
        self._last_report = self.t0
        self._last_count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1):
        msg = None
        with self._lock:
            self.count += n
            now = time.perf_counter()
            if not self.quiet and now - self._last_report >= self.report_every:
                rate = (self.count - self._last_count) / (now - self._last_report)
                msg = (f"[{self.label}] {rate:.1f} fps "
                       f"({self.count} frames)")
                self._last_report, self._last_count = now, self.count
        if msg is not None:   # console IO OUTSIDE the lock: a slow pipe
            print(msg, flush=True)   # must not stall other counters

    @property
    def fps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0
