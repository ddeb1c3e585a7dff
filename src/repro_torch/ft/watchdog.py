"""Straggler / hang detection (port of ``repro/ft/watchdog.py``; pure
Python, no device state).

  StepWatchdog    per-step wall times on this host; flags a step as a
                  straggler when it exceeds ``threshold x`` the rolling
                  median, and as a hang when a deadline passes with no
                  completion (checked from any thread via ``check``).
  HeartbeatTable  host-id -> last-heartbeat bookkeeping for a launcher;
                  ``stragglers(now)`` returns hosts silent for more than
                  ``timeout_s`` seconds.
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple


class StepWatchdog:
    def __init__(self, *, window: int = 32, threshold: float = 3.0,
                 hang_timeout_s: float = 600.0, clock=time.monotonic):
        self.window = window
        self.threshold = threshold
        self.hang_timeout_s = hang_timeout_s
        self._clock = clock
        self._durations: List[float] = []
        self._started_at: Optional[float] = None
        self._lock = threading.Lock()
        self.straggler_steps: List[Tuple[int, float, float]] = []
        self._step = 0

    def start_step(self):
        with self._lock:
            self._started_at = self._clock()

    def end_step(self) -> Tuple[float, bool]:
        """-> (duration, was_straggler)."""
        with self._lock:
            if self._started_at is None:
                raise RuntimeError("end_step without start_step")
            dur = self._clock() - self._started_at
            self._started_at = None
            med = statistics.median(self._durations) if self._durations else None
            slow = med is not None and dur > self.threshold * med
            if slow:
                self.straggler_steps.append((self._step, dur, med))
            self._durations.append(dur)
            if len(self._durations) > self.window:
                self._durations.pop(0)
            self._step += 1
            return dur, slow

    def check(self) -> Optional[float]:
        """If a step has been running past the hang deadline, return its
        age in seconds (else None). Safe from a monitor thread."""
        with self._lock:
            if self._started_at is None:
                return None
            age = self._clock() - self._started_at
            return age if age > self.hang_timeout_s else None

    @property
    def median(self) -> Optional[float]:
        with self._lock:
            return statistics.median(self._durations) if self._durations else None


class HeartbeatTable:
    def __init__(self, *, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, host: str, at: Optional[float] = None):
        with self._lock:
            self._last[host] = self._clock() if at is None else at

    def stragglers(self, now: Optional[float] = None) -> List[str]:
        now = self._clock() if now is None else now
        with self._lock:
            return sorted(h for h, t in self._last.items() if now - t > self.timeout_s)

    def evict(self, host: str):
        with self._lock:
            self._last.pop(host, None)

    @property
    def hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._last)
