"""Perf-regression sentinel: the loss watchdog's median+MAD machinery
pointed at latency instead of loss (port of telemetry/sentinel.py,
host only: a copy; training/watchdog.py imports its `RobustWindow`).

The loss watchdog (training/watchdog.py) catches a run whose MATH went
bad; nothing catches a run whose SPEED went bad — a step_ms or decode
round_ms that quietly doubles (thermal throttling, a neighbor VM, a
retrace storm that slipped past the contracts, a degrading host) burns
the same budget as a crash but never trips an alarm. `RobustWindow` is
the shared robust statistic (median + MAD over a sliding window — a
stall must not poison the estimate that should catch it, same argument
as the watchdog's); `PerfSentinel` applies it to a latency series:
`patience` consecutive observations above median + k_sigma * 1.4826*MAD
is a SUSTAINED regression — it emits a flight-recorder event trail,
trips a counter, and the owner (trainer / engine) auto-dumps the flight
ring through the same postmortem path as poison/rollback.

Emission is pure host arithmetic on floats the caller already fetched
(the hot-path list lists observe()); the sentinel never
touches a device value, so sentinel-on steps are bitwise sentinel-off.
"""

from __future__ import annotations

import collections
import math
from typing import Deque, Optional

__all__ = ["RobustWindow", "PerfSentinel"]


class RobustWindow:
    """Sliding window with a median+MAD threshold — the ONE robust
    statistic the loss watchdog and the perf sentinel share
    (training/watchdog.py delegates here)."""

    def __init__(self, window: int = 64, min_history: int = 8):
        assert window >= 4 and min_history >= 2
        # a window smaller than min_history could never arm the
        # threshold (the deque caps below it) — clamp so every accepted
        # window size actually detects
        self.min_history = min(min_history, window)
        self._window: Deque[float] = collections.deque(maxlen=window)

    def push(self, x: float) -> None:
        self._window.append(x)

    def clear(self) -> None:
        self._window.clear()

    def __len__(self) -> int:
        return len(self._window)

    def median_mad(self):
        xs = sorted(self._window)
        n = len(xs)
        med = (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
        dev = sorted(abs(x - med) for x in xs)
        mad = (dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
        return med, mad

    def threshold(self, k_sigma: float) -> float:
        """Value above which an observation is an outlier; +inf while
        disabled (k_sigma <= 0) or the window is too short to be
        trusted. 1.4826 * MAD estimates sigma for a normal population;
        the floor keeps a perfectly flat window (MAD 0) from flagging
        every observation."""
        if k_sigma <= 0 or len(self._window) < self.min_history:
            return math.inf
        med, mad = self.median_mad()
        sigma = max(1.4826 * mad, 1e-3 * abs(med), 1e-8)
        return med + k_sigma * sigma


class PerfSentinel:
    """Sustained-latency-regression detector with flight-record trail.

    `observe(value_ms, step=...)` feeds one latency sample; returns
    True exactly when this sample completes a TRIP (`patience`
    consecutive samples above threshold) — the caller dumps the flight
    ring on True. Good samples enter the window; bad samples never do
    (they would drag the baseline toward the regression). After a trip
    the window CLEARS: if the regression is the new normal (a slower
    chip, a permanent noisy neighbor) the sentinel re-arms at the new
    level instead of tripping forever, and the trip count records that
    the baseline moved.

    `k_sigma <= 0` disables the sentinel entirely (`enabled` False —
    owners skip construction-side costs and counters keys, keeping the
    /metrics JSON schema byte-compatible when off)."""

    def __init__(self, k_sigma: float = 0.0, window: int = 64,
                 patience: int = 8, min_history: int = 8,
                 recorder=None, name: str = "step_ms"):
        assert patience >= 1
        self.k_sigma = k_sigma
        self.patience = patience
        self.name = name
        # optional telemetry.FlightRecorder: every bad verdict and trip
        # lands in the flight ring keyed by step/round, so the dumped
        # artifact shows the latency trail that led to the trip
        self.recorder = recorder
        self._stat = RobustWindow(window=window, min_history=min_history)
        self.consecutive_bad = 0
        self.bad_total = 0
        self.trips = 0
        self.last_threshold = math.inf

    @property
    def enabled(self) -> bool:
        return self.k_sigma > 0

    def threshold(self) -> float:
        return self._stat.threshold(self.k_sigma)

    def observe(self, value_ms: float, step: int = -1) -> bool:
        """hot path: host floats only — the caller already
        fetched/measured the latency."""
        if not self.enabled:
            return False
        thr = self._stat.threshold(self.k_sigma)
        self.last_threshold = thr
        if not (value_ms > thr):
            self.consecutive_bad = 0
            self._stat.push(value_ms)
            return False
        self.consecutive_bad += 1
        self.bad_total += 1
        if self.recorder is not None:
            self.recorder.record(
                f"perf_bad.{self.name}", step=step,
                value_ms=round(value_ms, 3), threshold_ms=round(thr, 3),
                streak=self.consecutive_bad)
        if self.consecutive_bad < self.patience:
            return False
        self.trips += 1
        self.consecutive_bad = 0
        med, mad = self._stat.median_mad()
        # re-arm at the new level: the post-trip window starts empty
        self._stat.clear()
        if self.recorder is not None:
            self.recorder.record(
                f"perf_regression.{self.name}", step=step,
                value_ms=round(value_ms, 3), threshold_ms=round(thr, 3),
                baseline_median_ms=round(med, 3),
                baseline_mad_ms=round(mad, 3),
                patience=self.patience, trip=self.trips)
        return True

    def counters(self) -> dict:
        return {f"perf_regressions_{self.name}": self.trips,
                f"perf_bad_{self.name}": self.bad_total}
