"""Deterministic fault injection for the serving fleet (port of
inference/chaos.py, host only: a copy with the same grammar and draws).

The self-driving fleet (inference/fleet.py) is only as trustworthy as
the failures it has been proven against, and real failures — a replica
poisoned mid-round, a flapping health endpoint, a corrupted KV hand-off
— are miserable to reproduce on demand. `ChaosPolicy` is the test
substrate: a seeded, fully deterministic fault injector that plugs into
the EXISTING failure paths instead of simulating parallel ones. A kill
raises inside the engine's scheduler round, so the serve loop dies
through its real poison path (flight-ring dump, `_fail_all`, `_broken`)
— exactly what a device fault produces. A stall sleeps inside the
round's timed window, so the perf sentinel trips on the same
per-token-advance series it watches in production. A dropped probe
makes the router's health probe fail the way a dead host does. A
corrupted hand-off payload trips the receiver's `_check_payload`
geometry gate.

Everything is off by default and bitwise-invisible when off: replicas
carry `chaos=None`, the engine's `_fault_hook` stays None (one
attribute check per round), and no counter or schema changes shape.

Spec strings (the serving tool's `--chaos` knob, ChaosPolicy.parse):

    kill=RID            kill replica RID on its next scheduler round
    kill=RID@N          ... once RID has accepted N submits
    stall=RID:MSxK      sleep MS milliseconds in each of RID's next K
                        scheduler rounds (sentinel-trip fuel)
    submit_latency_ms=F sleep F ms on every replica submit
    probe_latency_ms=F  sleep F ms on every HTTPReplica health probe
    probe_drop=P        drop each health probe with probability P
    probe_drop=P@RID    ... only replica RID's probes
    corrupt_handoff     corrupt every exported KV hand-off payload
                        (wrong page_size -> receiver degrades to a
                        local prefill, never a poisoned splice)
    seed=N              the injector's RNG seed (default 0)

Example: `--chaos "kill=1@8,probe_drop=0.3,seed=7"`.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

__all__ = ["ChaosFault", "ChaosPolicy"]


class ChaosFault(RuntimeError):
    """The injected kill. Raised from inside a scheduler round so it
    propagates through the serve loop's real poison path; the string
    rides `engine._broken` and every failed waiter's error, which is
    how tests (and the resubmit path's death-marker match) identify an
    injected death."""


class ChaosPolicy:
    """Seeded deterministic fault injector (module docstring). One
    policy instance serves a whole fleet: faults target replicas by id,
    and every injection appends a structured entry to `events` (bounded)
    so a chaos run's fault schedule is auditable after the fact."""

    _EVENTS_CAP = 1024

    def __init__(self, *, seed: int = 0,
                 kill_replica: Optional[int] = None,
                 kill_after_submits: int = 0,
                 stall_replica: Optional[int] = None,
                 stall_ms: float = 0.0,
                 stall_rounds: int = 0,
                 submit_latency_ms: float = 0.0,
                 probe_latency_ms: float = 0.0,
                 probe_drop_rate: float = 0.0,
                 probe_drop_replica: Optional[int] = None):
        if not 0.0 <= probe_drop_rate <= 1.0:
            raise ValueError(
                f"probe_drop_rate must be in [0, 1], got {probe_drop_rate}")
        if kill_after_submits < 0 or stall_rounds < 0:
            raise ValueError("kill_after_submits / stall_rounds must be "
                             ">= 0")
        self.seed = int(seed)
        self.kill_replica = kill_replica
        self.kill_after_submits = int(kill_after_submits)
        self.stall_replica = stall_replica
        self.stall_ms = float(stall_ms)
        self.stall_rounds = int(stall_rounds)
        self.submit_latency_ms = float(submit_latency_ms)
        self.probe_latency_ms = float(probe_latency_ms)
        self.probe_drop_rate = float(probe_drop_rate)
        self.probe_drop_replica = probe_drop_replica
        # one seeded stream per fault kind: each stream's draw sequence
        # depends only on how often ITS fault was consulted, so e.g.
        # probe-drop decisions replay identically whether or not a kill
        # also fired that run
        self._probe_rng = random.Random(self.seed ^ 0x9E3779B9)
        self._lock = threading.Lock()
        self._submits: Dict[int, int] = {}
        self._stalls_left = self.stall_rounds
        self.killed: List[int] = []
        self.events: List[dict] = []

    # -- parse (the --chaos knob) ------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "ChaosPolicy":
        """Build a policy from the serving tool's comma-separated spec
        string (module docstring grammar). Unknown keys fail loudly —
        a typo'd chaos knob silently injecting nothing would make a
        green convergence run meaningless."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            val = val.strip()
            if key == "kill":
                rid, _, after = val.partition("@")
                kw["kill_replica"] = int(rid)
                if after:
                    kw["kill_after_submits"] = int(after)
            elif key == "stall":
                rid, _, rest = val.partition(":")
                ms, _, rounds = rest.partition("x")
                kw["stall_replica"] = int(rid)
                kw["stall_ms"] = float(ms)
                kw["stall_rounds"] = int(rounds) if rounds else 1
            elif key == "submit_latency_ms":
                kw["submit_latency_ms"] = float(val)
            elif key == "probe_latency_ms":
                kw["probe_latency_ms"] = float(val)
            elif key == "probe_drop":
                rate, _, rid = val.partition("@")
                kw["probe_drop_rate"] = float(rate)
                if rid:
                    kw["probe_drop_replica"] = int(rid)
            elif key == "corrupt_handoff":
                if val not in ("", "1", "true", "True"):
                    raise ValueError(
                        f"chaos: corrupt_handoff takes no value, got "
                        f"{val!r}")
                kw["corrupt_handoff"] = True
            elif key == "seed":
                kw["seed"] = int(val)
            else:
                raise ValueError(f"chaos: unknown fault {key!r} in "
                                 f"{spec!r}")
        corrupt = kw.pop("corrupt_handoff", False)
        policy = cls(**kw)
        policy.corrupt_handoff = corrupt
        return policy

    corrupt_handoff = False

    # -- bookkeeping -------------------------------------------------------

    def _note(self, kind: str, **fields) -> None:
        with self._lock:
            if len(self.events) < self._EVENTS_CAP:
                self.events.append({"t": time.time(), "kind": kind,
                                    **fields})

    # -- replica-side hooks ------------------------------------------------

    def on_submit(self, replica_id: Optional[int]) -> None:
        """Called by a replica as it accepts a submit: injects submit
        latency and advances the kill-arming submit count."""
        with self._lock:
            self._submits[replica_id] = self._submits.get(replica_id,
                                                          0) + 1
        if self.submit_latency_ms > 0:
            self._note("submit_latency", replica=replica_id,
                       ms=self.submit_latency_ms)
            time.sleep(self.submit_latency_ms / 1e3)

    def kill_armed(self, replica_id: Optional[int]) -> bool:
        """Whether the configured kill should fire for this replica
        now: the target matches, it has not fired yet, and the replica
        has accepted at least `kill_after_submits` submits."""
        if self.kill_replica is None or replica_id != self.kill_replica:
            return False
        with self._lock:
            if replica_id in self.killed:
                return False
            return (self._submits.get(replica_id, 0)
                    >= self.kill_after_submits)

    def engine_hook(self, replica_id: Optional[int]):
        """The per-round fault hook installed on a replica's engine
        (`engine._fault_hook`): stalls sleep INSIDE the round's timed
        window (the sentinel measures them honestly), kills raise
        ChaosFault into the serve loop's poison path."""

        def hook(_engine) -> None:
            if (self.stall_replica == replica_id
                    and self.stall_ms > 0):
                fire = False
                with self._lock:
                    if self._stalls_left > 0:
                        self._stalls_left -= 1
                        fire = True
                if fire:
                    self._note("stall", replica=replica_id,
                               ms=self.stall_ms)
                    time.sleep(self.stall_ms / 1e3)
            if self.kill_armed(replica_id):
                with self._lock:
                    self.killed.append(replica_id)
                self._note("kill", replica=replica_id)
                raise ChaosFault(
                    f"chaos: injected kill of replica {replica_id}")

        return hook

    def on_probe(self, replica_id: Optional[int]) -> bool:
        """Called by HTTPReplica before each health probe: injects
        probe latency; returns True when this probe should be DROPPED
        (the replica then reports the same synthetic-unhealthy snapshot
        a dead host produces). Drop decisions come from the policy's
        own seeded stream — same seed, same probe sequence, same
        drops."""
        if self.probe_latency_ms > 0:
            self._note("probe_latency", replica=replica_id,
                       ms=self.probe_latency_ms)
            time.sleep(self.probe_latency_ms / 1e3)
        if self.probe_drop_rate <= 0.0:
            return False
        if (self.probe_drop_replica is not None
                and replica_id != self.probe_drop_replica):
            return False
        with self._lock:
            drop = self._probe_rng.random() < self.probe_drop_rate
        if drop:
            self._note("probe_drop", replica=replica_id)
        return drop

    def on_export(self, replica_id: Optional[int], payload):
        """Called by a replica on each KV hand-off export: with
        `corrupt_handoff` armed, returns a SHALLOW-corrupted copy —
        page_size off by one — that the receiver's `_check_payload`
        geometry gate rejects with ValueError. The corruption is
        metadata-only on a copy: the donor's real payload (and pools)
        are untouched, and the receiver refuses the splice instead of
        decoding garbage — which is the degrade-not-fail property the
        chaos matrix proves."""
        if not self.corrupt_handoff or payload is None:
            return payload
        bad = dict(payload)
        bad["page_size"] = int(bad.get("page_size", 0)) + 1
        self._note("corrupt_handoff", replica=replica_id)
        return bad
