"""LR + weight-decay scheduler (port of optimizer/scheduler.py, a host-only
copy: ref megatron/optimizer_param_scheduler.py).

Same decay styles and semantics: warmup ramp (:78-88), then
constant/linear/cosine/inverse-square-root decay (:89-118); weight decay
ramps constant/linear/cosine by completed samples-or-steps (:53-76); state
dict round-trips for checkpoint resume (:130-228).
"""

from __future__ import annotations

import math
from typing import Optional


class OptimizerParamScheduler:
    def __init__(
        self,
        max_lr: float,
        min_lr: float = 0.0,
        lr_warmup_steps: int = 0,
        lr_decay_steps: Optional[int] = None,
        lr_decay_style: str = "linear",
        start_wd: float = 0.01,
        end_wd: float = 0.01,
        wd_incr_steps: Optional[int] = None,
        wd_incr_style: str = "constant",
        use_checkpoint_opt_param_scheduler: bool = False,
        override_opt_param_scheduler: bool = False,
    ):
        assert max_lr >= min_lr >= 0.0
        assert not (use_checkpoint_opt_param_scheduler and override_opt_param_scheduler)
        self.max_lr = max_lr
        self.min_lr = min_lr
        self.lr_warmup_steps = lr_warmup_steps
        self.lr_decay_steps = lr_decay_steps
        self.lr_decay_style = lr_decay_style
        self.start_wd = start_wd
        self.end_wd = end_wd
        self.wd_incr_steps = wd_incr_steps
        self.wd_incr_style = wd_incr_style
        self.use_checkpoint_opt_param_scheduler = use_checkpoint_opt_param_scheduler
        self.override_opt_param_scheduler = override_opt_param_scheduler
        self.num_steps = 0
        if self.lr_decay_steps is not None:
            assert self.lr_decay_steps > 0
            assert self.lr_warmup_steps < self.lr_decay_steps

    # -- lr (ref: optimizer_param_scheduler.py:78-118) --------------------
    def get_lr(self, step: Optional[int] = None) -> float:
        step = self.num_steps if step is None else step
        if self.lr_warmup_steps > 0 and step <= self.lr_warmup_steps:
            return self.max_lr * step / self.lr_warmup_steps
        if self.lr_decay_style == "constant" or self.lr_decay_steps is None:
            return self.max_lr
        if step > self.lr_decay_steps:
            return self.min_lr
        if self.lr_decay_style == "inverse-square-root":
            warmup = max(self.lr_warmup_steps, 1)
            lr = self.max_lr * math.sqrt(warmup) / math.sqrt(max(step, warmup))
            return max(self.min_lr, lr)
        num = step - self.lr_warmup_steps
        den = self.lr_decay_steps - self.lr_warmup_steps
        frac = num / den
        delta = self.max_lr - self.min_lr
        if self.lr_decay_style == "linear":
            coeff = 1.0 - frac
        elif self.lr_decay_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * frac) + 1.0)
        else:
            raise ValueError(self.lr_decay_style)
        return self.min_lr + coeff * delta

    # -- wd (ref: optimizer_param_scheduler.py:53-76) ---------------------
    def get_wd(self, step: Optional[int] = None) -> float:
        step = self.num_steps if step is None else step
        if self.wd_incr_style == "constant":
            assert self.start_wd == self.end_wd
            return self.end_wd
        if self.wd_incr_steps is None:
            raise ValueError(
                f"wd_incr_style={self.wd_incr_style!r} requires wd_incr_steps"
            )
        frac = min(step / max(self.wd_incr_steps, 1), 1.0)
        delta = self.end_wd - self.start_wd
        if self.wd_incr_style == "linear":
            coeff = frac
        elif self.wd_incr_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * (1 - frac)) + 1.0)
        else:
            raise ValueError(self.wd_incr_style)
        return self.start_wd + coeff * delta

    def step(self, increment: int = 1):
        self.num_steps += increment
        return self.get_lr(), self.get_wd()

    # -- checkpoint state (ref: :130-228) ---------------------------------
    def state_dict(self) -> dict:
        return {
            "max_lr": self.max_lr,
            "min_lr": self.min_lr,
            "lr_warmup_steps": self.lr_warmup_steps,
            "lr_decay_steps": self.lr_decay_steps,
            "lr_decay_style": self.lr_decay_style,
            "start_wd": self.start_wd,
            "end_wd": self.end_wd,
            "num_steps": self.num_steps,
        }

    def load_state_dict(self, sd: dict):
        """ref semantics: checkpoint values win unless override is set
        (optimizer_param_scheduler.py:176-228)."""
        if self.override_opt_param_scheduler:
            self.num_steps = 0
            self.step(sd["num_steps"])
            return
        if self.use_checkpoint_opt_param_scheduler:
            for k in ("max_lr", "min_lr", "lr_warmup_steps", "lr_decay_steps",
                      "lr_decay_style", "start_wd", "end_wd"):
                setattr(self, k, sd[k])
        self.num_steps = 0
        self.step(sd["num_steps"])
