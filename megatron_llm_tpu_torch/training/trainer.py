"""The training runtime: setup + train loop (port of training/trainer.py).

`Trainer.setup()` / `Trainer.train()` are the loop `pretrain()` drives
(JAX :1244-1275), fed an iterator of (num_micro, mbs, seq+1) int token
arrays. The trainer runs on its model's device (`cuda` unless the model
was built for the CPU): params are fp32 leaves that require grad, the
optimizer state is fp32, compute runs in the config's compute dtype.

Ported: `TrainState`, `get_batch`, `Trainer` with `setup`, `train_step`,
the `train` loop, `evaluate` on the plain path, and `_training_log` with
tokens/s and model TFLOP/s. The loop reads one value back from the card
per step, the loss, as the JAX loop does (:1044); the log reads the
gradient norm and skip flag at its interval. Each step appends its host
facts to `step_log` (step, loss, ms), the part of the JAX flight
recorder's step trail this slice keeps.

Later slices, each raising ValueError while set: checkpointing (`save`,
`load`, `save_interval`), the signal handler and autoresume, tensorboard
and WandB, profiling and span traces, the device-cost registry and the
perf sentinel. `setup(params=...)` takes an initial parameter tree (for
example one bridged from the JAX package) until checkpoint loading is
ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.config import ModelConfig, ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.optimizer import (
    OptimizerParamScheduler,
    init_optimizer_state,
)
from megatron_llm_tpu_torch.optimizer.optimizer import (
    OptimizerState,
    tree_leaves,
)
from megatron_llm_tpu_torch.training.microbatches import (
    build_num_microbatches_calculator,
)
from megatron_llm_tpu_torch.training.timers import Timers
from megatron_llm_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from megatron_llm_tpu_torch.training.watchdog import LossWatchdog
from megatron_llm_tpu_torch.utils.masks import get_ltor_masks_and_position_ids

# TrainConfig fields of later slices: (field, the slice that ports it)
_LATER = (
    ("save", "checkpointing"), ("load", "checkpointing"),
    ("save_interval", "checkpointing"),
    ("exit_signal_handler", "checkpointing (the SIGTERM emergency save)"),
    ("autoresume_file", "checkpointing (autoresume)"),
    ("tensorboard_dir", "the trainer's telemetry hooks"),
    ("wandb_logger", "the trainer's telemetry hooks"),
    ("profile", "the trainer's telemetry hooks"),
    ("trace_dir", "the trainer's telemetry hooks"),
    ("device_cost_registry", "the trainer's telemetry hooks"),
    ("perf_sentinel_ksigma", "the trainer's telemetry hooks"),
    ("spike_rollback_patience", "checkpointing (the watchdog's rollback)"),
)


def get_batch(text, eod_token=None, reset_position_ids=False,
              reset_attention_mask=False, eod_mask_loss=False,
              device="cuda"):
    """(num_micro, b, seq+1) 'text' -> model inputs on `device` (JAX
    :66-103): tokens, labels, loss_mask, position_ids, and the dense
    (num_micro, b, 1, s, s) attention_mask when documents reset it."""
    text = torch.as_tensor(np.asarray(text), device=device).long()
    tokens, labels = text[:, :, :-1], text[:, :, 1:]
    n, b, s = tokens.shape
    attn_mask, loss_mask, position_ids = get_ltor_masks_and_position_ids(
        tokens.reshape(n * b, s), eod_token, reset_position_ids,
        reset_attention_mask, eod_mask_loss)
    batch = {"tokens": tokens, "labels": labels,
             "loss_mask": loss_mask.reshape(n, b, s),
             "position_ids": position_ids.reshape(n, b, s)}
    if attn_mask is not None:
        batch["attention_mask"] = attn_mask.reshape(n, b, 1, s, s)
    return batch


@dataclass
class TrainState:
    params: Any
    opt_state: OptimizerState
    iteration: int = 0
    consumed_train_samples: int = 0


class Trainer:
    """Owns setup + the loop."""

    def __init__(self, model, tcfg: TrainConfig, pcfg: ParallelConfig,
                 train_data_iterator: Optional[Iterable] = None,
                 valid_data_iterator: Optional[Iterable] = None,
                 eod_token: Optional[int] = None,
                 reset_position_ids: bool = False,
                 reset_attention_mask: bool = False,
                 eod_mask_loss: bool = False, batch_builder=None):
        for name, slice_name in _LATER:
            if getattr(tcfg, name):
                raise ValueError(f"TrainConfig.{name} is not ported yet "
                                 f"({slice_name}, ROADMAP.md A3)")
        cfg: ModelConfig = model.cfg
        if cfg.hidden_dropout > 0 or cfg.attention_dropout > 0:
            raise ValueError(
                f"hidden_dropout={cfg.hidden_dropout}, attention_dropout="
                f"{cfg.attention_dropout}: dropout is not ported yet (the "
                f"dropout slice, ROADMAP.md A3)")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.tcfg = tcfg
        self.pcfg = pcfg
        self.train_data_iterator = train_data_iterator
        self.valid_data_iterator = valid_data_iterator
        self.batch_builder = batch_builder
        self.eod_token = eod_token
        self.reset_position_ids = reset_position_ids
        self.reset_attention_mask = reset_attention_mask
        self.eod_mask_loss = eod_mask_loss
        self.timers = Timers()
        self._n_params = 0  # set in setup(); enables the TFLOP/s log field
        self._eval_step_fn = None
        self.step_log: list = []  # per step: step, loss, ms
        self.num_microbatches_calc = build_num_microbatches_calculator(
            tcfg.global_batch_size, tcfg.micro_batch_size,
            pcfg.data_parallel_size, tcfg.rampup_batch_size)
        # sample-based runs step the scheduler in samples (JAX :205-236)
        self._samples_mode = tcfg.train_samples is not None
        if self._samples_mode:
            decay_steps = tcfg.lr_decay_samples or tcfg.train_samples
            warmup = tcfg.lr_warmup_samples
            wd_incr_steps = tcfg.train_samples
        else:
            decay_steps = tcfg.lr_decay_iters or tcfg.train_iters
            warmup = tcfg.lr_warmup_iters
            wd_incr_steps = tcfg.train_iters
        if tcfg.lr_warmup_fraction is not None and decay_steps:
            warmup = int(tcfg.lr_warmup_fraction * decay_steps)
        self.scheduler = OptimizerParamScheduler(
            max_lr=tcfg.lr, min_lr=tcfg.min_lr, lr_warmup_steps=warmup,
            lr_decay_steps=decay_steps, lr_decay_style=tcfg.lr_decay_style,
            start_wd=tcfg.start_weight_decay
            if tcfg.start_weight_decay is not None else tcfg.weight_decay,
            end_wd=tcfg.end_weight_decay
            if tcfg.end_weight_decay is not None else tcfg.weight_decay,
            wd_incr_steps=wd_incr_steps,
            wd_incr_style=tcfg.weight_decay_incr_style,
            use_checkpoint_opt_param_scheduler=(
                tcfg.use_checkpoint_opt_param_scheduler),
            override_opt_param_scheduler=tcfg.override_opt_param_scheduler)
        self.watchdog = LossWatchdog(
            k_sigma=tcfg.loss_watchdog_ksigma,
            window=max(tcfg.loss_watchdog_window, 4),
            patience=tcfg.spike_rollback_patience)
        self._train_steps: dict = {}  # num_microbatches -> step function

    # ------------------------------------------------------------------
    def setup(self, params: Optional[dict] = None) -> TrainState:
        """fp32 params (drawn on the model's device from tcfg.seed unless
        `params` is given) and fresh optimizer state."""
        self.timers("model-and-optimizer-setup").start()
        if params is None:
            params = self.model.init(seed=self.tcfg.seed)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt_state = init_optimizer_state(params, self.tcfg)
        self.timers("model-and-optimizer-setup").stop()
        self._n_params = sum(p.numel() for p in tree_leaves(params))
        return TrainState(params=params, opt_state=opt_state)

    def _get_step_fn(self, num_microbatches: int):
        if num_microbatches not in self._train_steps:
            import dataclasses

            pcfg = dataclasses.replace(self.pcfg,
                                       num_microbatches=num_microbatches)
            self._train_steps[num_microbatches] = make_train_step(
                self.model, self.tcfg, pcfg, batch_builder=self.batch_builder)
        return self._train_steps[num_microbatches]

    def train_step(self, state: TrainState, text, dropout_rng=None) -> dict:
        """One optimizer step over a global batch 'text' (num_micro,
        mbs*dp, seq+1) (JAX :517-598). The stats stay on the card."""
        num_micro = text.shape[0]
        batch = get_batch(text, self.eod_token, self.reset_position_ids,
                          self.reset_attention_mask, self.eod_mask_loss,
                          device=self.device)
        lr, wd = self.scheduler.get_lr(), self.scheduler.get_wd()
        step_fn = self._get_step_fn(num_micro)
        # the watchdog's in-step skip gate: +inf until its window has
        # history (NaN/inf losses still skip)
        params, opt_state, stats = step_fn(
            state.params, state.opt_state, batch, lr, wd, dropout_rng,
            self.watchdog.threshold())
        state.params, state.opt_state = params, opt_state
        state.iteration += 1
        mbs_dp = batch["tokens"].shape[1]
        self.scheduler.step(num_micro * mbs_dp if self._samples_mode else 1)
        state.consumed_train_samples += num_micro * mbs_dp
        self.num_microbatches_calc.update(state.consumed_train_samples)
        stats["lr"] = lr
        stats["batch_size"] = num_micro * mbs_dp
        return stats

    def evaluate(self, state: TrainState,
                 max_iters: Optional[int] = None) -> float:
        """Mean eval loss over `eval_iters` batches (JAX :600-695, the
        plain path)."""
        if self.valid_data_iterator is None:
            return float("nan")
        if self._eval_step_fn is None:
            self._eval_step_fn = make_eval_step(self.model)
        total, count = 0.0, 0
        iters = max_iters if max_iters is not None else self.tcfg.eval_iters
        it = iter(self.valid_data_iterator)
        for _ in range(iters):
            try:
                text = next(it)
            except StopIteration:
                break
            raw = get_batch(text, self.eod_token, device=self.device)
            batch = {k: v.reshape((-1,) + v.shape[2:]) for k, v in raw.items()}
            total += float(self._eval_step_fn(state.params, batch))
            count += 1
        return total / max(count, 1)

    # ------------------------------------------------------------------
    def _training_log(self, state: TrainState, stats: dict, elapsed: float):
        """JAX :698-744, with tokens/s and model TFLOP/s (6 N per token)."""
        loss = float(stats["loss"])
        gnorm = float(stats["grad_norm"])
        line = (
            f"iteration {state.iteration:8d}/{self.tcfg.train_iters or 0:8d} | "
            f"consumed samples: {state.consumed_train_samples:12d} | "
            f"elapsed time per iteration (ms): {elapsed * 1000:.1f} | "
            f"learning rate: {stats['lr']:.3E} | "
            f"global batch size: {stats['batch_size']:5d} | "
            f"lm loss: {loss:.6E} | grad norm: {gnorm:.3f} | ")
        if "num_zeros" in stats:
            line += f"num zeros: {int(stats['num_zeros'])} | "
        if "params_norm" in stats:
            line += f"params norm: {float(stats['params_norm']):.3f} | "
        line += f"skipped iterations: {int(stats['skipped'])}"
        for name, val in self.watchdog.counters().items():
            if self.timers.gauges().get(name) != val:
                self.timers.gauge(name, val)
        if self._n_params:
            tok_s, tflops = self.throughput(stats["batch_size"], elapsed)
            line += (f" | tokens/sec: {tok_s:.1f} | "
                     f"model TFLOP/s: {tflops:.2f}")
        print(line, flush=True)
        self.timers.log(["batch-generator", "train-step"],
                        normalizer=self.tcfg.log_interval)

    def throughput(self, batch_size: int, elapsed: float):
        """(tokens/s, model TFLOP/s) of one step: 6 N FLOPs per token, the
        trainer's own formula (JAX :725-730)."""
        tok_s = batch_size * self.cfg.seq_length / max(elapsed, 1e-9)
        return tok_s, tok_s * 6 * self._n_params / 1e12

    def train(self, state: TrainState) -> TrainState:
        """The loop (JAX :985-1199, the paths this slice ports)."""
        tcfg = self.tcfg
        assert self.train_data_iterator is not None
        data_iter = iter(self.train_data_iterator)
        start_time = time.time()

        def keep_going():
            if self._samples_mode:
                return state.consumed_train_samples < tcfg.train_samples
            return tcfg.train_iters is None or \
                state.iteration < tcfg.train_iters

        while keep_going():
            self.timers("batch-generator").start()
            try:
                text = next(data_iter)
            except StopIteration:
                print("data iterator exhausted", flush=True)
                break
            finally:
                self.timers("batch-generator").stop()
            t0 = time.time()
            self.timers("train-step").start()
            stats = self.train_step(state, text)
            loss_val = float(stats["loss"])  # the loop's one host read
            self.timers("train-step").stop()
            stats["loss"] = loss_val
            elapsed = time.time() - t0
            # a bad step (NaN/inf or a spike) was already skipped on the
            # card by the threshold gate; the host counts the streak
            bad = self.watchdog.observe(loss_val)
            self.step_log.append({"step": state.iteration, "loss": loss_val,
                                  "ms": elapsed * 1e3, "bad": bad})
            if bad:
                print(f"loss watchdog: bad step at iteration "
                      f"{state.iteration} (loss {loss_val:.6E}, streak "
                      f"{self.watchdog.consecutive_bad})", flush=True)
            if state.iteration % tcfg.log_interval == 0:
                self._training_log(state, stats, elapsed)
            if (tcfg.eval_interval and self.valid_data_iterator is not None
                    and state.iteration % tcfg.eval_interval == 0):
                val = self.evaluate(state)
                print(f"validation loss at iteration {state.iteration}: "
                      f"{val:.6E} | ppl: {float(np.exp(min(20.0, val))):.4f}",
                      flush=True)
            if tcfg.exit_duration_in_mins is not None and (
                    time.time() - start_time) / 60.0 \
                    > tcfg.exit_duration_in_mins:
                print("exiting on duration limit", flush=True)
                break
            if tcfg.exit_interval and state.iteration % tcfg.exit_interval == 0:
                print(f"exiting at iteration {state.iteration}", flush=True)
                break
        return state
