"""The training runtime: setup, the train loop and `pretrain` (port of
training/trainer.py).

`pretrain()` is the one-call entry (`finetune.main` calls it): it builds
the datasets, the `Trainer`, resumes from `load`, builds the loaders
from the resumed sample and runs `Trainer.train()`, fed
(num_micro, mbs, seq+1) int token arrays. The trainer runs on its model's
device (`cuda` unless the model was built for the CPU): params are fp32
leaves that require grad, the optimizer state is fp32, compute runs in
the config's compute dtype.

Ported: `TrainState`, `get_batch`, `SignalHandler`, `Trainer` with
`setup` (fresh or from a checkpoint), `train_step`, the `train` loop,
`evaluate` on the plain path, `_training_log` with tokens/s and model
TFLOP/s, the checkpoint paths (async interval saves, the blocking saves
of the SIGTERM, duration and autoresume exits and of the end of
`pretrain`, the loss watchdog's rollback to the last complete
checkpoint), and `pretrain`. The loop reads one value back from the card
per step, the loss, as the JAX loop does (:1044); the log reads the
gradient norm and skip flag at its interval. Each step appends its host
facts to `step_log` (step, loss, ms, the loader's ms), the part of the
JAX flight recorder's step trail this slice keeps.

A save of an iteration this trainer has already saved (the emergency
save after an interval save of the same step, the final save after an
emergency one) waits for that save instead of writing the same state
again; the JAX package writes it twice.

With a dropout rate above 0 each step draws its masks from the base
stream `seed + 1` folded with the iteration (JAX :991-997), so a resumed
run draws the masks an uninterrupted one would; the base seed is saved
in the checkpoint's meta and restored unless `--no_load_rng` or
`--finetune`. Under fp16 the log line carries the loss scale.

Across ranks (a parallel context, parallel/mesh.py) the trainer holds
this rank's state: its stage's layers at pp > 1, its tensor-parallel
slices of the parameters and, under ZeRO-1, its blocks of the Adam
moments; the loaders read the rank's rows of every global microbatch
(every stage and cp rank of a dp index reads the same rows), and under
context parallelism each step and eval batch is cut to the rank's
contiguous sequence shard after `get_batch` ran on the whole sequence
(`context_shard`: global position ids, labels shifted before the cut,
--reset_attention_mask in its O(s) doc-start form); the log line,
printed by rank 0 only, carries the global loss (the last stage's,
broadcast), gradient norm and tokens/s. A save gathers every leaf whole
and rank 0 writes the checkpoint (the same files as one card's), the
other ranks waiting for its commit; cp cuts no leaf, so only cp rank 0
of each coordinate takes part in the gather. A load cuts each rank's
slices from the whole leaves, so a checkpoint resumes at any layout,
pp and cp included. Rank 0
holds a host copy of the whole state meanwhile. At pp > 1 `evaluate`
runs the pipelined loss forward (JAX :607-690), which refuses a batch
with `--reset_attention_mask`'s masks (JAX :533-540).

Later slices, each raising ValueError while set: tensorboard and WandB,
profiling and span traces, the flight-record dumps, the device-cost
registry and the perf sentinel (the trainer's telemetry hooks, A3.8).
"""

from __future__ import annotations

import signal as _signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from megatron_llm_tpu_torch.models.dropout import fold_in
from megatron_llm_tpu_torch.optimizer import (
    OptimizerParamScheduler,
    init_optimizer_state,
)
from megatron_llm_tpu_torch.optimizer.optimizer import (
    OptimizerState,
    tree_leaves,
    tree_map,
)
from megatron_llm_tpu_torch.optimizer.zero1 import (
    build_zero1_plan,
    map_indexed,
)
from megatron_llm_tpu_torch.parallel.mesh import gather_rows, get_context
from megatron_llm_tpu_torch.parallel.multihost import (
    AutoResume,
    all_hosts_any,
    host_barrier,
    process_row_range,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    layout_specs,
    model_axis,
    shard_params,
    slice_axis,
    spec_leaves,
    stage_axis,
)
from megatron_llm_tpu_torch.training.checkpointing import (
    CheckpointManager,
    flatten,
    load_checkpoint,
    unflatten_like,
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
from megatron_llm_tpu_torch.utils.masks import (
    get_document_starts,
    get_ltor_masks_and_position_ids,
)

# TrainConfig fields of later slices: (field, the slice that ports it)
_LATER = tuple(
    (name, "the trainer's telemetry hooks, ROADMAP.md A3.8") for name in (
        "tensorboard_dir", "wandb_logger", "profile", "trace_dir",
        "flight_record_dir", "device_cost_registry", "perf_sentinel_ksigma"))


class SignalHandler:
    """Latches SIGTERM (installed from the main thread only); the loop
    makes an emergency save and leaves when it sees the latch."""

    def __init__(self, sig=_signal.SIGTERM):
        self.triggered = False
        try:
            _signal.signal(sig, self._handle)
        except ValueError:  # not the main thread: nothing is latched
            pass

    def _handle(self, signum, frame):
        self.triggered = True

    def signals_received(self) -> bool:
        return self.triggered


def get_batch(text, eod_token=None, reset_position_ids=False,
              reset_attention_mask=False, eod_mask_loss=False,
              packed_doc_starts=False, device="cuda"):
    """(num_micro, b, seq+1) 'text' -> model inputs on `device` (JAX
    :66-103): tokens, labels, loss_mask, position_ids, and the dense
    (num_micro, b, 1, s, s) attention_mask when documents reset it, or
    with `packed_doc_starts` its O(s) form {"doc_start": (num_micro, b,
    s)} (utils/masks.py `get_document_starts`), which context
    parallelism cuts with the sequence."""
    text = torch.as_tensor(np.asarray(text), device=device).long()
    tokens, labels = text[:, :, :-1], text[:, :, 1:]
    n, b, s = tokens.shape
    flat = tokens.reshape(n * b, s)
    attn_mask, loss_mask, position_ids = get_ltor_masks_and_position_ids(
        flat, eod_token, reset_position_ids,
        reset_attention_mask and not packed_doc_starts, eod_mask_loss)
    batch = {"tokens": tokens, "labels": labels,
             "loss_mask": loss_mask.reshape(n, b, s),
             "position_ids": position_ids.reshape(n, b, s)}
    if reset_attention_mask and packed_doc_starts:
        batch["attention_mask"] = {"doc_start": get_document_starts(
            flat, eod_token).reshape(n, b, s)}
    elif attn_mask is not None:
        batch["attention_mask"] = attn_mask.reshape(n, b, 1, s, s)
    return batch


def context_shard(batch: dict, ctx) -> dict:
    """This cp rank's contiguous sequence shard of a batch whose last
    axis is the sequence: positions [c s / cp, (c + 1) s / cp) of
    tokens, labels, loss_mask, position_ids (global, so RoPE rotates
    each shard by its own angles) and a {"doc_start"} mask (global
    indices). The labels were shifted on the whole sequence, so none
    crosses a shard. The batch itself at cp = 1."""
    if ctx is None or ctx.cp == 1:
        return batch
    s = batch["tokens"].shape[-1]
    if s % ctx.cp:
        raise ValueError(f"context parallelism cp={ctx.cp} does not divide "
                         f"the sequence length {s}")
    n = s // ctx.cp
    sl = slice(ctx.cp_rank * n, (ctx.cp_rank + 1) * n)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[..., sl]

    return {k: cut(v) for k, v in batch.items()}


class StateLayout:
    """How a rank's state relates to the whole model: each leaf's
    pipeline-stage axis (the layer axis at pp > 1), its tensor-parallel
    axis and, under ZeRO-1, its moments' dp axis (optimizer/zero1.py).
    `shard` cuts a whole leaf to this rank's slice, `gather` makes a
    slice whole again on rank 0's host; leaf names are the checkpoint
    files' ("layers.attention.wqkv", "m.<leaf>", "v.<leaf>")."""

    def __init__(self, ctx, cfg, full_template: dict, zero1: bool,
                 bucket_mb: float):
        self.ctx = ctx
        self.pp = getattr(ctx, "pp", 1)
        specs = spec_leaves(layout_specs(cfg, full_template, self.pp))
        self.tp_axes = [model_axis(sp) for sp in specs]
        self.pp_axes = [stage_axis(sp) for sp in specs]
        index, _ = map_indexed(lambda i, _: i, full_template)
        self.index = flatten(index)
        local = shard_params(tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), full_template), ctx, cfg)
        self.plan = build_zero1_plan(cfg, local, ctx.dp, bucket_mb,
                                     pp=self.pp) \
            if zero1 and ctx.dp > 1 else None

    def _leaf(self, name: str):
        moment = name.startswith(("m.", "v."))
        i = self.index.get(name[2:] if moment else name)
        z1 = None if i is None or self.plan is None or not moment \
            else self.plan.leaf_axes[i]
        return i, z1

    def shard(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        i, z1 = self._leaf(name)
        if i is None:  # "step", the scaler's state
            return leaf
        if self.pp > 1:
            leaf = slice_axis(leaf, self.pp_axes[i], self.pp,
                              self.ctx.pp_rank)
        x = slice_axis(leaf, self.tp_axes[i], self.ctx.tp, self.ctx.tp_rank)
        return slice_axis(x, z1, self.ctx.dp, self.ctx.dp_rank)

    def gather(self, name: str, x: torch.Tensor):
        """The whole leaf on rank 0 (a host tensor of its own), None on
        the other ranks; a collective the ranks of cp rank 0 enter (the
        other cp ranks hold the same state). A ZeRO-1 block goes to the
        dp group's first rank, then a tensor-parallel slice
        to the tp group's first rank, then a stage's layers to the first
        stage: only what rank 0 needs moves."""
        i, z1 = self._leaf(name)
        ctx = self.ctx
        if ctx.cp_rank != 0:
            # cp cuts no leaf: cp rank 0 of each coordinate gathers it
            return None
        live = x = x.detach()
        if z1 is not None:
            x = gather_rows(x, ctx.dp_group, ctx, axis=z1)
        k = None if i is None else self.tp_axes[i]
        if k is not None and ctx.dp_rank == 0:
            x = gather_rows(x, ctx.tp_group, ctx, axis=k)
        k = None if i is None or self.pp == 1 else self.pp_axes[i]
        if k is not None and ctx.dp_rank == 0 and ctx.tp_rank == 0:
            x = gather_rows(x, ctx.pp_group, ctx, axis=k)
        if ctx.rank != 0:
            return None
        x = x.contiguous().cpu()
        return x.clone() if x.data_ptr() == live.data_ptr() else x

    def zero_moments(self, params: dict, device) -> dict:
        """A zero moment tree of this rank's shapes."""
        def zeros(i, p):
            shape = p.shape if self.plan is None else self.plan.shard_shape(i)
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return map_indexed(zeros, params)[0]


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
                                 f"({slice_name})")
        cfg: ModelConfig = model.cfg
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
        self.timers = Timers(tcfg.timing_log_level, tcfg.timing_log_option)
        self._n_params = 0  # set in setup(); enables the TFLOP/s log field
        self._eval_step_fn = None
        self.step_log: list = []  # per step: step, loss, ms, data_ms, bad
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
        self.signal_handler = (SignalHandler() if tcfg.exit_signal_handler
                               else None)
        # the checkpoint writer is made at the first save
        self._ckpt_manager: Optional[CheckpointManager] = None
        self._loaded_ckpt_path: Optional[str] = None
        self._saved_iteration: Optional[int] = None
        self._autoresume = (AutoResume(tcfg.autoresume_file,
                                       tcfg.autoresume_interval)
                            if tcfg.autoresume_file else None)
        self._train_steps: dict = {}  # num_microbatches -> step function
        ctx = get_context()
        # the parallel context across ranks; None on one card
        self.ctx = ctx if ctx is not None and ctx.world_size > 1 else None
        self.layout: Optional[StateLayout] = None
        self._rank0 = self.ctx is None or self.ctx.rank == 0
        # the dropout base stream (models/dropout.py), set by train() or
        # restored from a checkpoint; None without dropout
        self._dropout_seed: Optional[int] = None

    # ------------------------------------------------------------------
    def setup(self, params: Optional[dict] = None) -> TrainState:
        """fp32 params (drawn on the model's device from tcfg.seed unless
        `params` is given) and fresh optimizer state; then, with
        `tcfg.load`, the newest complete checkpoint there (JAX :293-366):
        its params, optimizer state (unless --finetune or
        --no_load_optim), iteration, consumed samples and scheduler.
        Across ranks `params` is the whole tree and the state this
        rank's slices of it."""
        self.timers("model-and-optimizer-setup").start()
        if params is None:
            params = self.model.init(seed=self.tcfg.seed)
        self._n_params = sum(p.numel() for p in tree_leaves(params))
        if self.ctx is None:
            opt_state = init_optimizer_state(params, self.tcfg)
        else:
            self.layout = StateLayout(self.ctx, self.cfg, params,
                                      self.pcfg.use_distributed_optimizer,
                                      self.pcfg.grad_rs_bucket_mb)
            params = shard_params(params, self.ctx, self.cfg)
            opt_state = init_optimizer_state({}, self.tcfg,
                                             device=self.device)
            moments = self.layout.zero_moments(params, self.device)
            opt_state = opt_state._replace(
                m=moments, v=self.layout.zero_moments(params, self.device)
                if self.tcfg.optimizer == "adam" else None)
        self.timers("model-and-optimizer-setup").stop()
        state = TrainState(params=params, opt_state=opt_state)
        if self.tcfg.load:
            loaded = self._load(self.tcfg.load, state,
                                finetune=self.tcfg.finetune,
                                no_load_optim=self.tcfg.no_load_optim,
                                no_load_rng=self.tcfg.no_load_rng)
            if loaded is not None:
                params, opt_state_l, meta, iteration = loaded
                state = TrainState(
                    params=params,
                    opt_state=opt_state_l if opt_state_l is not None
                    else opt_state,
                    iteration=iteration,
                    consumed_train_samples=0 if self.tcfg.finetune
                    else meta.get("consumed_train_samples", 0))
                if meta.get("scheduler") and not self.tcfg.finetune:
                    self.scheduler.load_state_dict(meta["scheduler"])
                # null under --no_load_rng and --finetune
                if meta.get("rng_key") is not None:
                    self._dropout_seed = int(meta["rng_key"])
                # retention GC never deletes the checkpoint a resume read
                self._loaded_ckpt_path = meta.get("loaded_path")
                # a batch-size rampup resumes at the resumed sample
                self.num_microbatches_calc.update(
                    state.consumed_train_samples)
                self._print(f"loaded checkpoint from {self.tcfg.load} at "
                            f"iteration {state.iteration}")
        for p in tree_leaves(state.params):
            p.requires_grad_(True)
        return state

    def _print(self, line: str) -> None:
        if self._rank0:
            print(line, flush=True)

    def _load(self, load_dir: str, state: TrainState, **kw):
        """`load_checkpoint` into this rank's layout: on one card with the
        state as template; across ranks against whole-shape templates,
        each leaf cut to the rank's slice."""
        if self.layout is None:
            return load_checkpoint(load_dir, state.params,
                                   kw.pop("opt_template", state.opt_state),
                                   self.cfg, **kw)
        full = self.model.abstract_params()
        moments = tree_map(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="meta"), full)
        tmpl = kw.pop("opt_template", state.opt_state)
        opt_tmpl = None if tmpl is None else tmpl._replace(
            m=moments, v=moments if tmpl.v is not None else None)
        return load_checkpoint(load_dir, full, opt_tmpl, self.cfg,
                               device=self.device, shard=self.layout.shard,
                               **kw)

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
        cp = 1 if self.ctx is None else self.ctx.cp
        # under cp the dense mask would need the whole sequence: the O(s)
        # doc-start form rides the ring (JAX :529-531)
        batch = get_batch(text, self.eod_token, self.reset_position_ids,
                          self.reset_attention_mask, self.eod_mask_loss,
                          packed_doc_starts=cp > 1, device=self.device)
        batch = context_shard(batch, self.ctx)
        lr, wd = self.scheduler.get_lr(), self.scheduler.get_wd()
        step_fn = self._get_step_fn(num_micro)
        # the watchdog's in-step skip gate: +inf until its window has
        # history (NaN/inf losses still skip)
        params, opt_state, stats = step_fn(
            state.params, state.opt_state, batch, lr, wd, dropout_rng,
            self.watchdog.threshold())
        state.params, state.opt_state = params, opt_state
        state.iteration += 1
        mbs_dp = batch["tokens"].shape[1] * self.pcfg.data_parallel_size
        self.scheduler.step(num_micro * mbs_dp if self._samples_mode else 1)
        state.consumed_train_samples += num_micro * mbs_dp
        self.num_microbatches_calc.update(state.consumed_train_samples)
        stats["lr"] = lr
        stats["batch_size"] = num_micro * mbs_dp
        return stats

    def evaluate(self, state: TrainState,
                 max_iters: Optional[int] = None) -> float:
        """Mean eval loss over `eval_iters` batches (JAX :600-695): the
        plain path, or at pp > 1 the pipelined loss of each (num_micro,
        rows, seq) batch; under cp each rank its sequence shard."""
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
            raw = context_shard(get_batch(text, self.eod_token,
                                          device=self.device), self.ctx)
            batch = raw if self.pcfg.pipeline_parallel_size > 1 else {
                k: v.reshape((-1,) + v.shape[2:]) for k, v in raw.items()}
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
            f"lm loss: {loss:.6E} | ")
        if "loss_scale" in stats:
            line += f"loss scale: {float(stats['loss_scale']):.1f} | "
        line += f"grad norm: {gnorm:.3f} | "
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
        self._print(line)
        if self._rank0:
            self.timers.log(["batch-generator", "train-step"],
                            normalizer=self.tcfg.log_interval)

    def throughput(self, batch_size: int, elapsed: float):
        """(tokens/s, model TFLOP/s) of one step: 6 N FLOPs per token, the
        trainer's own formula (JAX :725-730)."""
        tok_s = batch_size * self.cfg.seq_length / max(elapsed, 1e-9)
        return tok_s, tok_s * 6 * self._n_params / 1e12

    # ------------------------------------------------------------------
    def _get_ckpt_manager(self) -> CheckpointManager:
        if self._ckpt_manager is None:
            self._ckpt_manager = CheckpointManager(
                self.tcfg.save, keep_latest_n=self.tcfg.keep_latest_n,
                async_save=self.tcfg.async_save)
            self._ckpt_manager.protect(self._loaded_ckpt_path)
        return self._ckpt_manager

    def _save(self, state: TrainState, blocking: bool = False):
        """Save to `tcfg.save` (JAX :879-912): async unless `blocking`
        (the exit paths), which also waits for the commit. The loop's
        stall is the `ckpt_blocked_ms` gauge."""
        if not self.tcfg.save:
            return
        mgr = self._get_ckpt_manager()
        if self._saved_iteration == state.iteration:
            # this state is saved already, or its save is in flight
            if blocking:
                self._wait_for_commit()
            return
        self.timers("save-checkpoint").start()
        if self.layout is None:
            mgr.save(state.iteration, state.params,
                     None if self.tcfg.no_save_optim else state.opt_state,
                     self.cfg, self.scheduler.state_dict(),
                     state.consumed_train_samples, rng_key=self._dropout_seed)
        else:
            params, opt = self._gather_state(state)
            if self._rank0:
                mgr.save(state.iteration, params, opt, self.cfg,
                         self.scheduler.state_dict(),
                         state.consumed_train_samples,
                         rng_key=self._dropout_seed, fresh=True)
        self.timers("save-checkpoint").stop()
        self._saved_iteration = state.iteration
        self.timers.gauge("ckpt_blocked_ms", round(mgr.last_blocked_ms, 2))
        if blocking:
            self._wait_for_commit()
        self._print(f"saved checkpoint at iteration {state.iteration} to "
                    f"{self.tcfg.save}"
                    f"{' (committed)' if blocking else ' (async)'}")

    def _wait_for_commit(self) -> None:
        """Wait for the save in flight (rank 0 writes it); every other
        rank waits for rank 0."""
        if self._ckpt_manager is not None:
            self._ckpt_manager.wait_until_finished()
        host_barrier("checkpoint-commit")

    def _gather_state(self, state: TrainState):
        """The whole params and optimizer state on rank 0's host (None,
        None elsewhere): a collective, leaf by leaf."""
        lay = self.layout
        flat = {k: lay.gather(k, v) for k, v in flatten(state.params).items()}
        params = unflatten_like(flat, state.params) if self._rank0 else None
        if self.tcfg.no_save_optim:
            return params, None
        o = state.opt_state
        out = {}
        for prefix, tree in (("m.", o.m), ("v.", o.v)):
            if tree is not None:
                out[prefix] = unflatten_like(
                    {k: lay.gather(prefix + k, v)
                     for k, v in flatten(tree).items()}, tree)
        if not self._rank0:
            return None, None
        opt = o._replace(
            step=o.step.detach().cpu().clone(), m=out["m."],
            v=out.get("v."),
            scaler=None if o.scaler is None else {
                k: v.detach().cpu().clone() for k, v in o.scaler.items()})
        return params, opt

    def _rollback(self, state: TrainState) -> bool:
        """The loss watchdog's escalation (JAX :914-985): reload the last
        complete checkpoint into `state` and keep the data iterator where
        it is, so the batches since that checkpoint are consumed but
        never trained on. `consumed_train_samples` is not rewound (it is
        the data position a later resume restarts from). False, and
        skip-only training, when there is nothing to roll back to."""
        if not self.tcfg.save:
            self._print("WARNING: loss watchdog wants a rollback but no "
                        "--save dir is configured; continuing in skip-only "
                        "mode")
            return False
        # the save in flight is the newest: it must land first
        self._get_ckpt_manager()
        self._wait_for_commit()
        loaded = self._load(
            self.tcfg.save, state,
            # --no_save_optim checkpoints have no optim file
            opt_template=None if self.tcfg.no_save_optim
            else state.opt_state,
            no_load_optim=self.tcfg.no_save_optim or self.tcfg.no_load_optim)
        if loaded is None:
            self._print("WARNING: loss watchdog wants a rollback but no "
                        "complete checkpoint exists yet; continuing in "
                        "skip-only mode")
            return False
        params, opt_state, meta, iteration = loaded
        poison = state.iteration - iteration
        for p in tree_leaves(params):
            p.requires_grad_(True)
        state.params = params
        if opt_state is not None:
            state.opt_state = opt_state
        state.iteration = iteration
        if meta.get("scheduler"):
            self.scheduler.load_state_dict(meta["scheduler"])
        self._get_ckpt_manager().protect(meta.get("loaded_path"))
        self.watchdog.note_rollback()
        self._print(f"LOSS WATCHDOG ROLLBACK: reloaded iteration "
                    f"{iteration} from {self.tcfg.save}; data iterator "
                    f"fast-forwarded past the {poison}-iteration poison "
                    f"window (rollback #{self.watchdog.rollbacks})")
        return True

    def train(self, state: TrainState) -> TrainState:
        """The loop (JAX :985-1199, the paths this slice ports)."""
        tcfg = self.tcfg
        assert self.train_data_iterator is not None
        data_iter = iter(self.train_data_iterator)
        start_time = time.time()
        if (self.cfg.hidden_dropout > 0 or self.cfg.attention_dropout > 0) \
                and self._dropout_seed is None:
            self._dropout_seed = tcfg.seed + 1

        def keep_going():
            if self._samples_mode:
                return state.consumed_train_samples < tcfg.train_samples
            return tcfg.train_iters is None or \
                state.iteration < tcfg.train_iters

        while keep_going():
            self.timers("batch-generator").start()
            t_fetch = time.perf_counter()
            try:
                text = next(data_iter)
            except StopIteration:
                self._print("data iterator exhausted")
                break
            finally:
                self.timers("batch-generator").stop()
            data_ms = (time.perf_counter() - t_fetch) * 1e3
            step_rng = None if self._dropout_seed is None \
                else fold_in(self._dropout_seed, state.iteration)
            t0 = time.time()
            self.timers("train-step").start()
            stats = self.train_step(state, text, step_rng)
            loss_val = float(stats["loss"])  # the loop's one host read
            self.timers("train-step").stop()
            stats["loss"] = loss_val
            elapsed = time.time() - t0
            # a bad step (NaN/inf or a spike) was already skipped on the
            # card by the threshold gate; the host counts the streak and
            # rolls back after `spike_rollback_patience` in a row
            bad = self.watchdog.observe(loss_val)
            self.step_log.append({"step": state.iteration, "loss": loss_val,
                                  "ms": elapsed * 1e3, "data_ms": data_ms,
                                  "bad": bad})
            if bad:
                self._print(f"loss watchdog: bad step at iteration "
                            f"{state.iteration} (loss {loss_val:.6E}, "
                            f"streak {self.watchdog.consecutive_bad})")
                if self.watchdog.should_rollback():
                    self._rollback(state)
            if state.iteration % tcfg.log_interval == 0:
                self._training_log(state, stats, elapsed)
            if (tcfg.eval_interval and self.valid_data_iterator is not None
                    and state.iteration % tcfg.eval_interval == 0):
                val = self.evaluate(state)
                self._print(f"validation loss at iteration "
                            f"{state.iteration}: {val:.6E} | ppl: "
                            f"{float(np.exp(min(20.0, val))):.4f}")
            if tcfg.save_interval and state.iteration % tcfg.save_interval \
                    == 0:
                self._save(state)
            # the exits (JAX :1127-1186): signal, duration and autoresume
            # each make a blocking save first
            if self.signal_handler is not None and all_hosts_any(
                    self.signal_handler.signals_received()):
                self._print("exiting on termination signal - emergency "
                            "save")
                self._save(state, blocking=True)
                host_barrier("emergency-save-done")
                break
            if tcfg.exit_duration_in_mins is not None and all_hosts_any(
                    (time.time() - start_time) / 60.0
                    > tcfg.exit_duration_in_mins):
                self._print("exiting on duration limit")
                self._save(state, blocking=True)
                host_barrier("duration-save-done")
                break
            if self._autoresume is not None and \
                    self._autoresume.termination_requested(state.iteration):
                self._print("exiting on autoresume termination request")
                self._save(state, blocking=True)
                host_barrier("autoresume-save-done")
                break
            if tcfg.exit_interval and state.iteration % tcfg.exit_interval \
                    == 0:
                self._print(f"exiting at iteration {state.iteration}")
                break
        # an interval save in flight lands before the loop returns
        if self._ckpt_manager is not None or self.layout is not None:
            self._wait_for_commit()
        return state


def pretrain(model, tcfg: TrainConfig, pcfg: ParallelConfig,
             train_valid_test_dataset_provider: Callable,
             eod_token: Optional[int] = None,
             reset_position_ids: bool = False,
             reset_attention_mask: bool = False,
             eod_mask_loss: bool = False,
             dataloader_type: str = "single") -> TrainState:
    """One-call training entry (JAX :1202-1275).

    `train_valid_test_dataset_provider(train_val_test_num_samples)`
    returns (train_ds, valid_ds, test_ds), each with __len__ and
    __getitem__ -> {"text": ...} or None. The loaders start at the
    resumed `consumed_train_samples`; the train loader asks the
    trainer's microbatch calculator for its count at every step;
    `dataloader_type` "cyclic" reshuffles every epoch (the JAX `pretrain`
    always reads in order). With `tcfg.save` the end state is saved,
    blocking."""
    from megatron_llm_tpu_torch.data.data_samplers import (
        build_pretraining_data_loader,
    )

    if tcfg.train_samples is not None:
        from megatron_llm_tpu_torch.training.microbatches import (
            iterations_for_samples,
        )

        train_iters = iterations_for_samples(
            tcfg.train_samples, tcfg.global_batch_size,
            tcfg.micro_batch_size, pcfg.data_parallel_size,
            tcfg.rampup_batch_size)
        train_budget = tcfg.train_samples
    else:
        train_iters = tcfg.train_iters or 0
        train_budget = train_iters * tcfg.global_batch_size
    eval_iters = (train_iters // max(tcfg.eval_interval, 1) + 1) \
        * tcfg.eval_iters
    num_samples = [train_budget, eval_iters * tcfg.global_batch_size,
                   tcfg.eval_iters * tcfg.global_batch_size]
    train_ds, valid_ds, _ = train_valid_test_dataset_provider(num_samples)

    trainer = Trainer(model, tcfg, pcfg, eod_token=eod_token,
                      reset_position_ids=reset_position_ids,
                      reset_attention_mask=reset_attention_mask,
                      eod_mask_loss=eod_mask_loss)
    state = trainer.setup()
    # a dp rank loads its rows of each global microbatch (JAX :1245-1275)
    rows = process_row_range(trainer.ctx, tcfg.micro_batch_size
                             * pcfg.data_parallel_size)
    trainer.train_data_iterator = build_pretraining_data_loader(
        train_ds, state.consumed_train_samples, tcfg.micro_batch_size,
        pcfg.data_parallel_size, trainer.num_microbatches_calc.get,
        dataloader_type=dataloader_type, row_range=rows)
    trainer.valid_data_iterator = build_pretraining_data_loader(
        valid_ds, 0, tcfg.micro_batch_size, pcfg.data_parallel_size, 1,
        dataloader_type=dataloader_type, row_range=rows)
    state = trainer.train(state)
    if tcfg.save:
        trainer._save(state, blocking=True)
    return state
