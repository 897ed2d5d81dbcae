"""WandB logging shim (port of training/wandb_logger.py, a host-only
copy; ref: megatron/wandb_logger.py:13-172).

Duck-types the tensorboard SummaryWriter interface (`add_scalar`,
`add_text`, `flush`) so the trainer logs to either or both; batches values
and flushes on demand like the reference's `flush_all` (training.py:706-708).
Gated: if wandb isn't importable or configured, becomes a no-op (the
tensorboard writer underneath, if any, still gets every value).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class WandBConfig:
    """ref: WandBConfig (wandb_logger.py:13-40) + the --wandb_id/
    --wandb_resume/--wandb_api_key CLI knobs (ref arguments.py:512-529)."""

    project: str = "megatron_llm_tpu"
    name: Optional[str] = None
    entity: Optional[str] = None
    mode: str = "offline"
    id: Optional[str] = None
    resume: bool = False
    api_key: Optional[str] = None


class WandbTBShim:
    def __init__(self, tb_writer=None, config: Optional[WandBConfig] = None):
        self._tb = tb_writer
        self._pending: dict = {}
        self._run = None
        cfg = config or WandBConfig()
        try:
            import wandb

            if cfg.api_key:
                import os

                os.environ.setdefault("WANDB_API_KEY", cfg.api_key)
            self._run = wandb.init(
                project=cfg.project, name=cfg.name, entity=cfg.entity,
                mode=cfg.mode, id=cfg.id,
                resume="must" if cfg.resume else None,
            )
        except Exception:
            self._run = None

    def add_scalar(self, name: str, value, iteration: int):
        if self._tb is not None:
            self._tb.add_scalar(name, value, iteration)
        self._pending.setdefault(iteration, {})[name] = value

    def add_text(self, name: str, text: str, iteration: int = 0):
        if self._tb is not None:
            self._tb.add_text(name, text, iteration)

    def log_run_metadata(self, metadata: dict):
        """One-shot run facts (active remat policy, compiled per-device
        temp/args bytes, ...) — lands in the wandb run CONFIG, so runs are
        filterable/groupable by it in the UI, not buried in a scalar
        stream. (The tensorboard copy arrives separately via the timers'
        gauge ride-along — no mirroring here, or it would land twice.)"""
        if self._run is not None:
            try:
                self._run.config.update(metadata, allow_val_change=True)
            except Exception:
                pass

    def flush(self):
        if self._run is not None:
            for it in sorted(self._pending):
                self._run.log(self._pending[it], step=it)
        self._pending.clear()
        if self._tb is not None:
            self._tb.flush()
