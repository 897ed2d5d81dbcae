"""Loss watchdog: spike/NaN detection, skip accounting, rollback policy.

Production LLM runs hit loss spikes — bad data shards, optimizer-state
blowups after restarts, silent hardware corruption (PAPERS.md: the
Llama 2 and Megatron-LM training reports both describe operator-driven
restart-and-skip around spikes). This module makes that loop automatic:

- the watchdog keeps a ROBUST running statistic of recent good losses
  (median + MAD over a sliding window — a spike must not poison the very
  estimate that is supposed to catch it, which rules out plain
  mean/variance);
- a step is BAD when its loss is non-finite or exceeds
  median + k_sigma * (1.4826 * MAD). The trainer feeds the same
  threshold into the jitted train step as a traced scalar, where it
  rides the fp16 scaler's skip machinery (`optimizer_step(found_inf=)`)
  — so a bad step leaves params/optimizer untouched on device for bf16
  runs exactly like an fp16 overflow does, with no extra host round
  trip;
- `spike_rollback_patience` consecutive bad steps escalate to a
  ROLLBACK: the trainer reloads the last complete checkpoint and keeps
  the data iterator where it is, fast-forwarding past the poison window
  (training/trainer.py `_rollback`).

Counters (`skipped`, `rollbacks`) are exported through the timers-gauge
path (`loss_watchdog_skipped` / `loss_watchdog_rollbacks`).

Port of training/watchdog.py, a host-only copy with its own copy of
`RobustWindow`. The rollback itself needs checkpoints (a later slice);
the ported trainer runs the skip gate and counts. The JAX copy's
flight-recorder events belong to the telemetry slice and are left out.
"""

from __future__ import annotations

import collections
import math
from typing import Deque


class RobustWindow:
    """Sliding window with a median+MAD threshold (a copy of the JAX
    package's telemetry/sentinel.py:31, which the perf sentinel of the
    telemetry slice will share)."""

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



class LossWatchdog:
    """Host-side spike detector with skip/rollback bookkeeping.

    `k_sigma <= 0` disables SPIKE detection (non-finite losses are still
    bad — a NaN loss must never enter the window or the weights).
    `patience <= 0` disables rollback escalation (skip-only mode)."""

    def __init__(self, k_sigma: float = 0.0, window: int = 64,
                 patience: int = 0, min_history: int = 8):
        assert window >= 4 and min_history >= 2
        self.k_sigma = k_sigma
        self.patience = patience
        # median + MAD over a sliding window with the min_history arming
        # clamp
        self._stat = RobustWindow(window=window, min_history=min_history)
        self.min_history = self._stat.min_history
        self.consecutive_bad = 0
        self.skipped = 0
        self.rollbacks = 0

    # -- robust running stat ----------------------------------------------

    def _median_mad(self):
        return self._stat.median_mad()

    def threshold(self) -> float:
        """Loss value above which the current step is a spike; +inf while
        spike detection is off or the window is too short to be trusted
        (RobustWindow.threshold — 1.4826*MAD sigma with the flat-window
        floor)."""
        return self._stat.threshold(self.k_sigma)

    # -- per-step protocol -------------------------------------------------

    def observe(self, loss: float) -> bool:
        """Feed one step's loss; returns True when the step was BAD
        (non-finite or spiking) — the trainer's in-step threshold already
        skipped the update for exactly these steps, so the watchdog and
        the device agree by construction (same threshold value)."""
        bad = (not math.isfinite(loss)) or loss > self.threshold()
        if bad:
            self.consecutive_bad += 1
            self.skipped += 1
        else:
            self.consecutive_bad = 0
            self._stat.push(loss)
        return bad

    def should_rollback(self) -> bool:
        return self.patience > 0 and self.consecutive_bad >= self.patience

    def note_rollback(self) -> None:
        """Reset after the trainer reloaded a checkpoint: the window is
        cleared (it described the diverged trajectory, not the restored
        one) and the bad-streak ends."""
        self.rollbacks += 1
        self.consecutive_bad = 0
        self._stat.clear()

    def counters(self) -> dict:
        return {"loss_watchdog_skipped": self.skipped,
                "loss_watchdog_rollbacks": self.rollbacks}
