"""Self-driving fleet controller: the act half of the
sense->act loop (port of inference/fleet.py, host only: a copy).

The telemetry package holds the sensors — the perf sentinel (per-round
regression verdicts), the flight recorder (bounded postmortem ring),
per-request device-cost records (`modeled_backlog_seconds`) — and the
router holds the fleet (ReplicaRouter poison rotation, disaggregated hand-off,
modeled-backlog admission). But nothing acted on a verdict: a poisoned
or sentinel-regressed replica left rotation and stayed gone, and the
fleet's size was fixed at boot. `FleetController` closes the loop:

- **Replace cycle** (ROADMAP 5a): on a poison verdict (serve loop dead
  / health broken) or a sentinel trip (`serve_perf_regressions` grew
  since the last tick), run condemn -> drain -> stop -> spawn a warmed
  replacement on the freed devices -> rotate back in. The condemned
  replica's flight-record dump rides the router's eviction event, so
  the postmortem artifact and the rotation decision stay correlated.
  In-flight requests on the dead replica are NOT this module's job:
  the router's `recover_requests` proxy resubmits queued and
  un-streamed requests transparently (router.py _RecoverableRequest).

- **Load-adaptive scaling** (ROADMAP 5b, EQuARX's wire-efficiency
  framing applied to fleet capacity): grow/shrink the active set
  against modeled demand — the cost records' fleet-wide
  `modeled_backlog_seconds` per active replica vs the scale
  thresholds. Hysteresis (`scale_patience` consecutive identical
  verdicts before acting) keeps it from flapping on a bursty queue.
  Every decision is recorded WITH its inputs, and the verdict function
  is a pure static method — feeding the recorded inputs back through
  `FleetController.decide` replays the same verdicts, which is the
  reproducibility bar tests/test_fleet.py pins.

Everything is off by default: a router only becomes "managed" (and
grows the gated `serve_fleet_replaced`/`serve_scale_events` counters)
when a controller registers on it.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

_logger = logging.getLogger(__name__)

__all__ = ["FleetController"]


class FleetController:
    """Sentinel/poison-driven replace cycles + load-adaptive scaling
    over one ReplicaRouter (module docstring).

    Parameters:
    - `spawn_replica(old) -> replica`: builds (and ideally warms) a
      replacement carrying `old.replica_id`, typically on the devices
      the dead engine freed. Without it the controller degrades to
      condemn-only: a bad replica still leaves rotation permanently,
      it just is not replaced.
    - `check_interval_s`: background-thread tick period.
    - `drain_timeout_s`: how long a condemned replica may finish its
      live slots before the hard stop. The condemn happened first, so
      no NEW work lands on it while it drains.
    - `scale_up_backlog_s` / `scale_down_backlog_s`: per-replica
      modeled-backlog thresholds (seconds). Both None disables
      scaling. Sane settings keep a wide dead band between them
      (up >> down) — the hysteresis streak protects against flapping
      VERDICTS, the dead band against oscillating LOAD.
    - `scale_patience`: consecutive identical non-hold verdicts
      required before acting.
    - `standby`: built-but-idle replicas the scale-up draws from (and
      scale-down returns to). Scale-up without standby capacity holds.
    - `min_replicas` / `max_replicas`: active-set bounds.
    """

    _EVENTS_CAP = 256

    def __init__(self, router, *,
                 spawn_replica: Optional[Callable] = None,
                 check_interval_s: float = 0.5,
                 drain_timeout_s: float = 10.0,
                 scale_up_backlog_s: Optional[float] = None,
                 scale_down_backlog_s: Optional[float] = None,
                 scale_patience: int = 3,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 standby: Optional[List] = None):
        if (scale_up_backlog_s is not None
                and scale_down_backlog_s is not None
                and scale_down_backlog_s >= scale_up_backlog_s):
            raise ValueError(
                f"scale_down_backlog_s ({scale_down_backlog_s}) must "
                f"be < scale_up_backlog_s ({scale_up_backlog_s}) — "
                f"without a dead band the fleet flaps on steady load")
        if scale_patience < 1:
            raise ValueError("scale_patience must be >= 1")
        self.router = router
        self.spawn_replica = spawn_replica
        self.check_interval_s = float(check_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.scale_up_backlog_s = scale_up_backlog_s
        self.scale_down_backlog_s = scale_down_backlog_s
        self.scale_patience = int(scale_patience)
        self.min_replicas = int(min_replicas)
        self.max_replicas = max_replicas
        self.standby: List = list(standby or [])
        self.events: collections.deque = collections.deque(
            maxlen=self._EVENTS_CAP)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # sentinel-trip detection is a DELTA: the per-replica
        # serve_perf_regressions count at the last tick
        self._sentinel_seen: Dict[int, float] = {}
        self._condemned: set = set()  # condemn-only replicas (no
        # spawn callback): skip them on later ticks instead of
        # re-running the cycle forever
        self._seen_alive: set = set()  # replicas observed healthy at
        # least once: "not alive" only counts as a DEATH after that
        # (a not-yet-started replica is not a poison verdict)
        self._streak_verdict = "hold"
        self._streak = 0
        # registration flips the router into managed mode: its
        # /metrics grows the gated fleet counters, its flight_record
        # the "fleet" decision trail
        router._controller = self
        router._managed = True

    # -- event trail -------------------------------------------------------

    def _note(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"t": time.time(), "kind": kind,
                                **fields})

    def flight_events(self) -> list:
        """The bounded decision/action trail, served under the
        router's flight_record()["fleet"]."""
        with self._lock:
            return [dict(e) for e in self.events]

    # -- replace cycle -----------------------------------------------------

    def _drain_condemned(self, rep) -> bool:
        """Wait (bounded) for the condemned replica's live slots to
        finish — it was condemned FIRST, so the router admits nothing
        new onto it. Returns True when it drained clean, False on
        timeout or death (either way the caller stops it)."""
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            try:
                h = rep.health()
            except Exception:  # noqa: BLE001 — dead is drained
                return False
            if not h.get("alive") or h.get("broken") is not None:
                return False
            if (h.get("queue_depth", 0) == 0
                    and h.get("slots_busy", 0) == 0):
                return True
            time.sleep(0.05)
        return False

    def _replace(self, rep, why: str) -> None:
        """The full replace cycle: condemn -> drain -> stop -> spawn
        warmed replacement -> rotate back in. Degrades to condemn-only
        without a spawn callback."""
        rid = rep.replica_id
        t0 = time.monotonic()
        self.router.condemn(rid, why)
        drained = self._drain_condemned(rep)
        try:
            rep.stop(drain=False)
        except Exception as e:  # noqa: BLE001 — it may already be dead
            _logger.warning("fleet: stopping condemned replica %d "
                            "failed: %r", rid, e)
        dump = None
        fn = getattr(rep, "last_dump_path", None)
        if fn is not None:
            try:
                dump = fn()
            except Exception:  # noqa: BLE001 — advisory attach
                dump = None
        if self.spawn_replica is None:
            self._condemned.add(rid)
            self._note("condemn", replica=rid, why=str(why)[:200],
                       drained=drained, flight_dump=dump)
            _logger.error(
                "fleet: replica %d condemned (%s) with no spawn "
                "callback — fleet is now %d wide", rid, why,
                len(self.router.replicas) - len(self._condemned))
            return
        new = self.spawn_replica(rep)
        wfn = getattr(new, "warmup", None)
        if wfn is not None:
            try:
                wfn()  # compile/first-step cost lands HERE, not on
                # the first request after rotation back in
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                _logger.warning("fleet: replacement %d warmup failed: "
                                "%r", rid, e)
        new.start()
        self.router.replace_replica(rid, new)
        self.router.note_replaced()
        dt = time.monotonic() - t0
        self._note("replace", replica=rid, why=str(why)[:200],
                   drained=drained, flight_dump=dump,
                   recovery_s=round(dt, 3))
        _logger.warning("fleet: replica %d replaced in %.2fs (%s)",
                        rid, dt, why)

    # -- scaling -----------------------------------------------------------

    @staticmethod
    def decide(backlogs: List[Optional[float]], n_active: int,
               up_threshold_s: Optional[float],
               down_threshold_s: Optional[float]) -> str:
        """Pure scale verdict from one tick's inputs: "up", "down" or
        "hold". Per-replica modeled backlog (fleet sum / active count)
        against the thresholds; holds when ANY replica cannot model
        its backlog (mirrors _order_by_backlog's all-report rule —
        acting on a partial model would be guessing). Static + pure on
        purpose: tests replay recorded decision events through this
        exact function and require the same verdicts."""
        if up_threshold_s is None and down_threshold_s is None:
            return "hold"
        if not backlogs or any(b is None for b in backlogs):
            return "hold"
        per = sum(backlogs) / max(n_active, 1)
        if up_threshold_s is not None and per > up_threshold_s:
            return "up"
        if down_threshold_s is not None and per < down_threshold_s:
            return "down"
        return "hold"

    def _scale_tick(self) -> None:
        if (self.scale_up_backlog_s is None
                and self.scale_down_backlog_s is None):
            return
        active = [r for r in list(self.router.replicas)
                  if r.replica_id not in self._condemned]
        backlogs: List[Optional[float]] = []
        for rep in active:
            fn = getattr(rep, "modeled_backlog_s", None)
            b = None
            if fn is not None:
                try:
                    b = fn()
                except Exception:  # noqa: BLE001 — advisory signal
                    b = None
            backlogs.append(None if b is None else float(b))
        verdict = self.decide(backlogs, len(active),
                              self.scale_up_backlog_s,
                              self.scale_down_backlog_s)
        # hysteresis: only scale_patience consecutive IDENTICAL
        # non-hold verdicts act; anything else resets the streak
        if verdict == self._streak_verdict and verdict != "hold":
            self._streak += 1
        else:
            self._streak_verdict = verdict
            self._streak = 1 if verdict != "hold" else 0
        acted = None
        if self._streak >= self.scale_patience:
            if verdict == "up":
                acted = self._scale_up()
            elif verdict == "down":
                acted = self._scale_down(active, backlogs)
            self._streak_verdict, self._streak = "hold", 0
        # every decision — acted or not — is an event carrying the
        # exact decide() inputs: the reproducibility contract
        self._note("scale_decision", verdict=verdict,
                   backlogs=[None if b is None else round(b, 4)
                             for b in backlogs],
                   n_active=len(active),
                   up_threshold_s=self.scale_up_backlog_s,
                   down_threshold_s=self.scale_down_backlog_s,
                   streak=self._streak, acted=acted)

    def _scale_up(self) -> Optional[str]:
        n = len(self.router.replicas)
        cap = self.max_replicas
        if cap is not None and n >= cap:
            return "held:max_replicas"
        if not self.standby:
            return "held:no_standby"
        rep = self.standby.pop(0)
        wfn = getattr(rep, "warmup", None)
        if wfn is not None:
            try:
                wfn()
            except Exception as e:  # noqa: BLE001
                _logger.warning("fleet: standby %d warmup failed: %r",
                                rep.replica_id, e)
        rep.start()
        self.router.add_replica(rep)
        self.router.note_scale_event()
        _logger.warning("fleet: scaled UP to %d replicas (+%d)",
                        len(self.router.replicas), rep.replica_id)
        return f"added:{rep.replica_id}"

    def _scale_down(self, active, backlogs) -> Optional[str]:
        if len(active) <= self.min_replicas:
            return "held:min_replicas"
        # shed the least-backlogged replica: fewest in-flight tokens
        # to drain, and the modeled numbers are already in hand
        pairs = sorted(zip(active, backlogs),
                       key=lambda p: (p[1] if p[1] is not None else 0.0,
                                      p[0].replica_id))
        victim = pairs[0][0]
        rid = victim.replica_id
        try:
            rep = self.router.remove_replica(rid)
        except (KeyError, ValueError) as e:
            return f"held:{e}"
        try:
            rep.drain()
            rep.stop(drain=False)
        except Exception as e:  # noqa: BLE001 — shed anyway
            _logger.warning("fleet: draining removed replica %d "
                            "failed: %r", rid, e)
        self.standby.append(rep)
        self.router.note_scale_event()
        _logger.warning("fleet: scaled DOWN to %d replicas (-%d)",
                        len(self.router.replicas), rid)
        return f"removed:{rid}"

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        """One sense->act pass: poison scan, sentinel scan, scale
        decision. Public (and deterministic given replica state) so
        tier-1 tests drive the controller without its thread."""
        for rep in list(self.router.replicas):
            rid = rep.replica_id
            if rid in self._condemned:
                continue
            # poison verdict: the serve loop died or health is broken
            try:
                h = rep.health()
            except Exception as e:  # noqa: BLE001 — dead host
                self._replace(rep, f"health probe failed: {e!r}")
                continue
            broken = h.get("broken")
            alive = bool(h.get("alive"))
            if alive and broken is None:
                self._seen_alive.add(rid)
            if broken is not None or (not alive
                                      and rid in self._seen_alive):
                self._replace(rep, broken or "serve loop dead")
                continue
            # sentinel trip: the regression counter grew since our
            # last look (the sentinel already logged + dumped; ours is
            # the remediation verdict)
            try:
                trips = float(rep.counters().get(
                    "serve_perf_regressions", 0))
            except Exception:  # noqa: BLE001 — advisory signal
                continue
            seen = self._sentinel_seen.get(rid, 0.0)
            self._sentinel_seen[rid] = trips
            if trips > seen:
                self._replace(
                    rep, f"perf sentinel tripped "
                         f"({trips:.0f} regressions, was {seen:.0f})")
        self._scale_tick()

    # -- lifecycle ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the controller must
                # outlive one bad tick; the next tick retries
                _logger.exception("fleet: tick failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None
