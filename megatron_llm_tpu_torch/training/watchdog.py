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
path and tensorboard (`loss_watchdog_skipped` / `loss_watchdog_rollbacks`);
with a flight recorder every bad verdict and rollback is an event of its
ring, keyed by step.

Port of training/watchdog.py, host only; its `RobustWindow` is the
perf sentinel's (telemetry/sentinel.py), one definition for both.
"""

from __future__ import annotations

import math

from megatron_llm_tpu_torch.telemetry.sentinel import RobustWindow


class LossWatchdog:
    """Host-side spike detector with skip/rollback bookkeeping.

    `k_sigma <= 0` disables SPIKE detection (non-finite losses are still
    bad — a NaN loss must never enter the window or the weights).
    `patience <= 0` disables rollback escalation (skip-only mode)."""

    def __init__(self, k_sigma: float = 0.0, window: int = 64,
                 patience: int = 0, min_history: int = 8,
                 recorder=None):
        assert window >= 4 and min_history >= 2
        self.k_sigma = k_sigma
        self.patience = patience
        # telemetry.FlightRecorder or None: the verdict trail of a dump
        self.recorder = recorder
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

    def observe(self, loss: float, step: int = -1) -> bool:
        """Feed one step's loss; returns True when the step was BAD
        (non-finite or spiking) — the trainer's in-step threshold already
        skipped the update for exactly these steps, so the watchdog and
        the device agree by construction (same threshold value).
        `step` keys the recorder's verdict event."""
        thr = self.threshold()
        bad = (not math.isfinite(loss)) or loss > thr
        if bad:
            self.consecutive_bad += 1
            self.skipped += 1
            if self.recorder is not None:
                self.recorder.record(
                    "watchdog_bad", step=step, loss=loss,
                    threshold=thr, streak=self.consecutive_bad)
        else:
            self.consecutive_bad = 0
            self._stat.push(loss)
        return bad

    def should_rollback(self) -> bool:
        return self.patience > 0 and self.consecutive_bad >= self.patience

    def note_rollback(self, step: int = -1,
                      restored_step: int = -1) -> None:
        """Reset after the trainer reloaded a checkpoint: the window is
        cleared (it described the diverged trajectory, not the restored
        one) and the bad-streak ends."""
        self.rollbacks += 1
        self.consecutive_bad = 0
        self._stat.clear()
        if self.recorder is not None:
            self.recorder.record("watchdog_rollback", step=step,
                                 restored_step=restored_step,
                                 rollback=self.rollbacks)

    def counters(self) -> dict:
        return {"loss_watchdog_skipped": self.skipped,
                "loss_watchdog_rollbacks": self.rollbacks}
