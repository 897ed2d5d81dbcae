"""Goodput ledger: every second of trainer wall time classified into
exclusive buckets that provably sum to wall (port of
telemetry/goodput.py, host only: a copy).

"23.5k tok/s at MFU 55%" describes the steady state; a production run's
bill is dominated by everything else — trace/compile stalls, checkpoint
waits, data-loader hiccups, watchdog skips, plain idleness. The Goodput
literature (and the pjit-TPUv4 paper's utilization framing, PAPERS.md)
prices a run as productive_time / wall_time; that requires an exclusive
partition of wall, not a pile of overlapping timers. This ledger is
that partition:

- `productive` — optimizer steps that landed (dispatch + loss fetch);
- `compile`    — the first execution of each train-step specialization
  (trace + XLA compile ride the first call on this JAX line; the
  bucket's semantics are "the step that paid the compile", first
  productive execution included — docs/GUIDE.md states the caveat);
- `checkpoint` — save dispatch + async-tail/commit waits + rollback
  reload stalls;
- `data_wait`  — blocking next() on the data iterator;
- `watchdog`   — steps the loss watchdog skipped (the device discarded
  the update: the wall was spent, the step bought nothing);
- `idle`       — everything else (logging, eval, scheduler host work,
  genuine idleness), DERIVED as wall - sum(explicit buckets), which is
  what makes the sum-to-wall invariant hold by construction.

`note()` is one float add on the host (the hot-path list);
the ledger never touches a device value, so ledger-on training is
bitwise ledger-off. If explicit buckets ever overlap-count past wall
(a bug in the caller's classification), `overcount_s` goes positive
instead of silently clamping — the invariant test pins it at 0.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

__all__ = ["GOODPUT_BUCKETS", "GoodputLedger"]

# the exclusive wall-time partition; "idle" is derived, never noted
GOODPUT_BUCKETS = ("productive", "compile", "checkpoint", "data_wait",
                   "watchdog", "idle")


class GoodputLedger:
    """Exclusive wall-time accounting for a host-driven loop."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0: Optional[float] = None
        self._acc: Dict[str, float] = {
            b: 0.0 for b in GOODPUT_BUCKETS if b != "idle"}
        self.productive_steps = 0

    def start(self) -> None:
        """Start (or restart) the wall clock. Idempotent-by-intent:
        the first call pins t0; a second call is a no-op so nested
        callers cannot reset a running ledger's wall."""
        if self._t0 is None:
            self._t0 = self._clock()

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def note(self, bucket: str, seconds: float) -> None:
        """Attribute `seconds` of wall to one explicit bucket. Hot
        path: one dict add on host floats, called once or twice
        per trainer iteration."""
        if bucket == "idle":
            raise ValueError(
                "'idle' is derived (wall - sum of explicit buckets) — "
                "noting it would double-count the remainder")
        self._acc[bucket] += seconds  # KeyError on unknown = loud
        if bucket == "productive":
            self.productive_steps += 1

    def wall_s(self) -> float:
        return 0.0 if self._t0 is None else self._clock() - self._t0

    def snapshot(self) -> dict:
        """The partition at this instant. Invariant (pinned by
        tests/test_goodput.py): sum(buckets.values()) == wall_s exactly
        — idle is the derived remainder; if the explicit buckets
        overcounted past wall, idle floors at 0 and `overcount_s`
        carries the excess so the books never silently balance."""
        wall = self.wall_s()
        explicit = dict(self._acc)
        total = sum(explicit.values())
        idle = wall - total
        overcount = max(-idle, 0.0)
        buckets = {**explicit, "idle": max(idle, 0.0)}
        return {
            "wall_s": round(wall, 6),
            "buckets": {b: round(buckets[b], 6) for b in GOODPUT_BUCKETS},
            "goodput_fraction": round(
                buckets["productive"] / wall, 6) if wall > 0 else 0.0,
            "productive_steps": self.productive_steps,
            "overcount_s": round(overcount, 6),
        }

    def counters(self, prefix: str = "goodput_") -> dict:
        """Flat gauge form for the timers-gauge ride-along / Prometheus
        rendering: cumulative seconds per bucket plus the headline
        fraction."""
        snap = self.snapshot()
        out = {f"{prefix}{b}_s": round(v, 3)
               for b, v in snap["buckets"].items()}
        out[f"{prefix}wall_s"] = round(snap["wall_s"], 3)
        out[f"{prefix}fraction"] = round(snap["goodput_fraction"], 4)
        return out
