"""Named wall-clock timers (port of training/timers.py, a host-only copy;
ref: megatron/timers.py:54-307).

Same interface shape: `timers('name', log_level).start()/.stop()`,
`timers.log(names)`, `timers.write(names, writer, iteration)`. Device
work is asynchronous: a timer that should include device time must be
stopped after a host sync (the trainer reads the loss, which serves as
that barrier). With a tracer (telemetry/trace.SpanTracer) every
start/stop interval of a named timer is also a span on its timeline, as
in the JAX package.
"""

from __future__ import annotations

import time
from typing import List, Optional


class _Timer:
    def __init__(self, name: str, tracer=None):
        self.name = name
        # the span tracer: each start/stop interval lands on its timeline
        self._tracer = tracer
        self._elapsed = 0.0
        self._started = False
        self._start_time = 0.0

    def start(self):
        assert not self._started, f"timer {self.name} already started"
        self._start_time = time.perf_counter()
        self._started = True

    def stop(self):
        assert self._started, f"timer {self.name} not started"
        now = time.perf_counter()
        self._elapsed += now - self._start_time
        self._started = False
        if self._tracer is not None:
            self._tracer.complete(self.name, self._start_time, now)

    def reset(self):
        self._elapsed = 0.0
        self._started = False

    def elapsed(self, reset: bool = True) -> float:
        started = self._started
        if started:
            # the internal stop/start pair is bookkeeping, not an
            # interval: it emits no span
            tracer, self._tracer = self._tracer, None
            self.stop()
        total = self._elapsed
        if reset:
            self.reset()
        if started:
            self.start()
            self._tracer = tracer
        return total


class Timers:
    """ref: Timers (timers.py:120-307); log_option max/minmax/all collapse
    to the single-process value in the single-controller runtime."""

    def __init__(self, log_level: int = 0, log_option: str = "minmax",
                 tracer=None):
        self._log_level = log_level
        self._log_option = log_option
        # timer intervals double as the tracer's spans (None: no spans)
        self._tracer = tracer
        self._timers: dict = {}
        self._log_levels: dict = {}
        # one-shot run facts (remat policy, compiled temp/args bytes, ...)
        # recorded once and carried alongside the timers so a perf
        # trajectory is attributable to the configuration that produced it
        self._gauges: dict = {}
        self._gauges_unprinted: set = set()
        self._gauges_unwritten: set = set()

    def gauge(self, name: str, value):
        """Record a one-shot named value (number or string). Surfaced ONCE
        per channel: printed by the next `log()` and written by the next
        `write()` after being set (re-setting re-arms both)."""
        self._gauges[name] = value
        self._gauges_unprinted.add(name)
        self._gauges_unwritten.add(name)

    def gauges(self) -> dict:
        return dict(self._gauges)

    def __call__(self, name: str, log_level: Optional[int] = None) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name, tracer=self._tracer)
            self._log_levels[name] = log_level if log_level is not None else 0
        return self._timers[name]

    def log(
        self,
        names: Optional[List[str]] = None,
        normalizer: float = 1.0,
        reset: bool = True,
    ) -> Optional[str]:
        names = names if names is not None else list(self._timers)
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name not in self._timers:
                continue
            if self._log_levels[name] > self._log_level:
                continue
            t = self._timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            parts.append(f"{name}: {t:.2f}")
        if self._gauges_unprinted:
            gparts = [f"{n}: {self._gauges[n]}"
                      for n in self._gauges if n in self._gauges_unprinted]
            self._gauges_unprinted.clear()
            print("run facts | " + " | ".join(gparts), flush=True)
        if not parts:
            return None
        line = "time (ms) | " + " | ".join(parts)
        print(line, flush=True)
        return line

    def write(self, names: List[str], writer, iteration: int,
              normalizer: float = 1.0, reset: bool = False):
        """ref: Timers.write (timers.py:280-300) — tensorboard dump.
        Gauges not yet written ride along once (numeric via add_scalar,
        strings — e.g. the remat policy — via add_text when supported)."""
        for name in names:
            if name in self._timers:
                value = self._timers[name].elapsed(reset=reset) / normalizer
                writer.add_scalar(f"{name}-time", value, iteration)
        for name in [n for n in self._gauges if n in self._gauges_unwritten]:
            value = self._gauges[name]
            if isinstance(value, (int, float)):
                writer.add_scalar(name, value, iteration)
            elif hasattr(writer, "add_text"):
                writer.add_text(name, str(value), iteration)
            # consumed either way: a writer with no text sink will never
            # grow one, so retrying a string gauge forever is pointless
            self._gauges_unwritten.discard(name)
