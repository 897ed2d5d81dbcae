"""Flight recorder: a bounded ring of structured events + counter
snapshots, dumped to a JSON artifact when a run dies (port of
telemetry/recorder.py, host only: a copy).

The failure modes this repo already survives — engine serve-loop poison
(engine.py `_fail_all`), loss-watchdog rollback (trainer.py
`_rollback`), SIGTERM preemption (the emergency save) — previously left
only a log tail. The recorder keeps the last N structured events (one
per scheduler round / train step / lifecycle transition, each carrying
the correlating `rid` or `step`) and periodic counter snapshots in
memory, and `dump()` writes them as one readable JSON artifact at the
moment of death, so the postmortem starts from "what was the engine
doing for the last 4096 rounds" instead of grepping stdout.

Recording is pure host bookkeeping (dict literal + deque append; the
emit path is listed in the hot-path list) and the ring is
bounded, so a recorder can stay on permanently — it is constructed by
default in both the engine and the trainer.

Artifact shape (tests/test_telemetry.py loads and correlates it):

    {"reason": "...", "dumped_at_unix": ..., "created_at_unix": ...,
     "pid": ..., "extra": {...},
     "events": [{"t": <unix>, "kind": "...", ...fields}, ...],
     "counters": {<last snapshot>}, "dropped_events": N}
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

_logger = logging.getLogger(__name__)

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded structured-event ring with crash-dump export."""

    def __init__(self, capacity: int = 4096,
                 base: Optional[dict] = None):
        assert capacity >= 16, "a flight record needs some history"
        self.capacity = capacity
        # `base`: fields stamped into EVERY event (the
        # engine's replica id — N replicas' aggregated dumps must stay
        # attributable at the router). None keeps the event schema
        # byte-identical to the standalone recorder's.
        self._base = dict(base) if base else {}
        self._events: deque = deque(maxlen=capacity)
        # serializes ring mutation vs snapshot(): GET /flight_record
        # iterates the ring from an HTTP thread while the serve loop
        # appends — an unlocked list(deque) mid-append raises
        # RuntimeError exactly when the postmortem endpoint matters
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._counters_t: float = 0.0
        self._created = time.time()
        self._pid = os.getpid()
        self.dropped = 0
        self.dumps = 0
        # the most recent artifact dump() actually wrote:
        # the router attaches it to the eviction event when a replica
        # leaves rotation, so poison rotation and the auto-dump stop
        # being uncorrelated; stays None until a dump lands on disk
        self.last_dump_path: Optional[str] = None

    # -- emit (hot path: host bookkeeping only) ---------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event. Values must already be host
        scalars/strings — the recorder never touches a device value.
        The lock is uncontended on the hot path (snapshot() holds it
        only for a ring copy)."""
        ev = {"t": time.time(), "kind": kind, **self._base, **fields}
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def note_counters(self, counters: dict) -> None:
        """Attach the latest counter snapshot (the engine's counters()
        dict / the trainer's gauges) — the dump carries the last one."""
        snap = dict(counters)
        with self._lock:
            self._counters = snap
            self._counters_t = time.time()

    # -- export ------------------------------------------------------------

    def snapshot(self, reason: str = "on-demand",
                 extra: Optional[dict] = None) -> dict:
        with self._lock:
            events = list(self._events)
            counters = self._counters
            counters_t = self._counters_t
            dropped = self.dropped
        return {
            "reason": reason,
            "created_at_unix": self._created,
            "dumped_at_unix": time.time(),
            "pid": self._pid,
            "capacity": self.capacity,
            "dropped_events": dropped,
            "extra": extra or {},
            "counters": counters,
            "counters_at_unix": counters_t,
            "events": events,
        }

    def dump(self, directory: Optional[str], reason: str,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the snapshot artifact into `directory` and log the
        path LOUDLY (a dying run's last useful line). Returns the path;
        None when no directory is configured (the snapshot is still
        logged in summary form so the information is not lost) or the
        write itself failed (a full disk must not mask the original
        failure with a second traceback)."""
        snap = self.snapshot(reason=reason, extra=extra)
        self.dumps += 1
        if not directory:
            _logger.error(
                "FLIGHT RECORDER (%s): no record dir configured — "
                "in-memory snapshot only (%d events, last: %s)",
                reason, len(snap["events"]),
                snap["events"][-1] if snap["events"] else None)
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"flight_record_{reason}_{self._pid}_{self.dumps}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(snap, fh, indent=1, default=str)
            os.replace(tmp, path)
        except OSError as e:
            _logger.error(
                "FLIGHT RECORDER (%s): dump to %s failed: %r — "
                "%d events lost to disk, kept in memory",
                reason, directory, e, len(snap["events"]))
            return None
        _logger.error(
            "FLIGHT RECORDER (%s): dumped %d events + counters to %s",
            reason, len(snap["events"]), path)
        self.last_dump_path = path
        return path
