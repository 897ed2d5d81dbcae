"""Host-side span tracer: Chrome trace-event JSON for Perfetto (port of
telemetry/trace.py, host only: a copy with the same events and names).

The serving engine and the trainer are host-driven schedulers around
device rounds; diagnosing a stall ("why did request 41's TTFT blow
up at 02:13?") needs the host timeline — queue wait, admission, chunk
prefill, decode-scan dispatch, COW copies, checkpoint stalls — not the
device profile (that is what `torch.profiler` and the POST /profile
hook capture). This tracer records nestable wall-clock spans into a bounded
ring and exports them as Chrome trace-event JSON (the `{"traceEvents":
[...]}` form), loadable in Perfetto / chrome://tracing.

Correlation model (docs/GUIDE.md "Observability"): every span carries
its emitter's args — engine spans the request id (`rid`) and round
number, trainer spans the train step — so a client-visible stall greps
from the SSE `id:` field to the exact engine rounds it spanned, and a
loss spike to the data-fetch/step/save spans around it.

The hard contract: emission is pure host bookkeeping — perf_counter
reads, dict literals, deque appends. No tracer method may touch a
device value, so telemetry-on rounds are bitwise-identical to
telemetry-off by construction and a device sync can never creep in.

A disabled tracer (`enabled=False`, the default everywhere no
--trace_dir is given) short-circuits every emitter to a shared no-op
span: the off cost is one attribute check per site.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["SpanTracer", "NULL_TRACER"]


class _NullSpan:
    """Shared no-op context manager: the telemetry-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a complete ("ph": "X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # pure host bookkeeping (hot path): one clock read and
        # one ring append — never a device value
        self._tracer.complete(self._name, self._t0, time.perf_counter(),
                              **self._args)
        return False


class SpanTracer:
    """Bounded ring of Chrome trace events with nestable span emitters.

    Nesting is positional, the Chrome trace-event way: a span emitted
    while another is open on the same thread lies inside it on the
    timeline (child `ts`/`ts+dur` contained in the parent's), so no
    explicit parent pointers are kept — the emit path stays O(1).

    `set_context(**kv)` attaches ambient correlation keys (e.g. the
    trainer's current `step`) merged into every subsequent event's args;
    per-call args win on collision.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        # serializes ring mutation vs events()/export(): iterating the
        # deque while another thread appends raises RuntimeError (the
        # HTTP threads read while the serve loop emits)
        self._events_lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self._context: dict = {}
        self._pid = os.getpid()
        # stable small tids: Perfetto tracks read better as "tid 1..n"
        # than 140737352472320
        self._tids: dict = {}
        self._tid_lock = threading.Lock()
        self.dropped = 0  # events pushed past capacity (ring overwrote)

    # -- emitters (hot path: host bookkeeping only) -----------------

    def span(self, name: str, **args):
        """Context manager measuring one complete span."""
        if not self.enabled:
            return _NULL_SPAN
        if self._context:
            args = {**self._context, **args}
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (ph "i")."""
        if not self.enabled:
            return
        if self._context:
            args = {**self._context, **args}
        self._push({"name": name, "ph": "i", "s": "t",
                    "ts": self._ts(time.perf_counter()),
                    "pid": self._pid, "tid": self._tid(), "args": args})

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a complete span from two perf_counter readings — the
        retroactive form: the engine books `queue_wait` at admission
        from the request's own submit/admit stamps, after the fact."""
        if not self.enabled:
            return
        if self._context:
            args = {**self._context, **args}
        self._push({"name": name, "ph": "X", "ts": self._ts(t0),
                    "dur": max(round((t1 - t0) * 1e6), 0),
                    "pid": self._pid, "tid": self._tid(), "args": args})

    def set_context(self, **kv) -> None:
        """Merge ambient correlation keys into subsequent events' args
        (e.g. `set_context(step=it)` each trainer iteration). No-op
        when disabled: NULL_TRACER is a shared module singleton, and
        every telemetry-off component calls this per step — mutating
        one global dict from all of them would be cross-component
        state for nothing."""
        if not self.enabled:
            return
        self._context.update(kv)

    # -- internals ---------------------------------------------------------

    def _ts(self, t: float) -> int:
        return round((t - self._epoch) * 1e6)  # us since tracer epoch

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids) + 1)
        return tid

    def _push(self, ev: dict) -> None:
        with self._events_lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    # -- export ------------------------------------------------------------

    def events(self) -> list:
        """Snapshot of the ring, sorted by ts (deque appends from
        concurrent threads may interleave slightly out of order; the
        trace-event format wants monotone ts)."""
        with self._events_lock:
            evs = list(self._events)
        return sorted(evs, key=lambda e: (e["pid"], e["tid"], e["ts"]))

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads."""
        evs = self.events()
        # thread-name metadata events so Perfetto labels the tracks
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "megatron_llm_tpu"}}]
        for ident, tid in sorted(self._tids.items(), key=lambda x: x[1]):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": f"host-thread-{tid}"}})
        return {
            "traceEvents": meta + evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix": self._epoch_unix,
                "dropped_events": self.dropped,
            },
        }

    def export(self, path: str) -> Optional[str]:
        """Write the Chrome trace JSON artifact; returns the path (None
        when the tracer is disabled — nothing to write)."""
        if not self.enabled:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome_trace(), fh)
        os.replace(tmp, path)
        return path


# the shared disabled tracer: every component's default when no
# --trace_dir is configured (one attribute check per emit site)
NULL_TRACER = SpanTracer(capacity=1, enabled=False)
