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
`evaluate` on the plain path, a `batch_builder` (the encoder family's
dict batches: the builder's loss keywords go to `model.loss`, the eval
averages the model's loss over the microbatches, JAX :517-530,
:628-648), `_training_log` with tokens/s and model
TFLOP/s, the checkpoint paths (async interval saves, the blocking saves
of the SIGTERM, duration and autoresume exits and of the end of
`pretrain`, the loss watchdog's rollback to the last complete
checkpoint), and `pretrain`. The loop reads one value back from the card
per step, the loss, as the JAX loop does (:1044); the log reads the
gradient norm and skip flag at its interval.

The telemetry (JAX :144-191, :255-291, :395-560, :725-870, :873-980,
:1000-1200), all host bookkeeping outside the step, so a run with every
flag on computes the same bits as one with every flag off:
- the always-on flight recorder (`recorder`, `--flight_recorder_size`):
  a `step` event per step (step, loss, ms, goodput bucket), the
  watchdog's verdicts, the checkpoint lifecycle and the perf sentinel's;
  dumped into `--flight_record_dir` (default `--save`) on a watchdog
  rollback, the SIGTERM emergency save and a perf-sentinel trip, each
  dump carrying the goodput snapshot;
- the span tracer under `--trace_dir` (the named timers are its spans),
  exported at the end of `train()` as `trace_train_<pid>.json`
  (`trace_train_rank<r>_<pid>.json` across ranks);
- the always-on goodput ledger (`ledger`): each step's wall in one
  bucket (productive; "compile" for the first step of a microbatch
  count; "watchdog" for a skipped step), save stalls, rollbacks and the
  loader's wait; eval and logging land in the derived idle bucket, as
  in JAX;
- the `train_step_ms` histogram, and the perf sentinel on it
  (`--perf_sentinel_ksigma > 0`, productive steps only);
- the device-cost registry (`--device_cost_registry`): `train.step`
  (`train.pipeline_step` at pp > 1) keyed by the microbatch count,
  counted during the first real step of each count
  (telemetry/costs.py); with a chip spec (`--chip_spec` or a detected
  H100) the log's gauges `train_mfu`, `train_mfu_effective`,
  `train_mfu_source`, `chip_spec`, `train_step_achieved_gbps` and
  `train_step_hbm_frac`;
- tensorboard (training/tensorboard.py: the port writes its own event
  files, with or without the `tensorboard` package) and WandB
  (training/wandb_logger.py) on `--tensorboard_log_interval`, with the
  JAX tags, written by rank 0 only; the run facts once at step 0 (on a
  card under `--log_memory_to_tensorboard`, the first step's
  `torch.cuda.max_memory_allocated()` and peak reserved bytes, where
  JAX logs the compiled step's temp and argument bytes);
- the profile window (`--profile`, steps [profile_step_start,
  profile_step_end)): `torch.profiler` with CUDA activity on a card and
  CPU activity on the CPU, started and stopped where JAX starts and
  stops `jax.profiler`, written as Chrome trace JSON
  (`profile_train_<pid>.json`, the rank in the name across ranks) into
  `--profile_dir`, `--tensorboard_dir` or ./profile.

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
broadcast), gradient norm and tokens/s. A save writes per-rank files:
each rank its pieces of the state (StateLayout.pieces: its stage's and
tp slices of the params, its ZeRO-1 blocks of the moments, one writer
per distinct piece; cp cuts no leaf, so cp ranks above 0 write
nothing), and rank 0 commits the checkpoint once every rank's marker is
there (training/checkpointing.py); no rank gathers or holds the whole
state. A load reads only the pieces that overlap the rank's slice
(`StateLayout.region`), so a checkpoint resumes at any layout, pp and
cp included, and one of an earlier version's whole-tensor files too.
Under `--overlap_param_gather` the parameter all-gathers in flight are
waited for before an eval, a save, a rollback and the loop's end. At
pp > 1 `evaluate`
runs the pipelined loss forward (JAX :607-690), which refuses a batch
with `--reset_attention_mask`'s masks (JAX :533-540).
"""

from __future__ import annotations

import os
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
    build_overlap_plan,
    build_state_plan,
    build_zero1_plan,
    map_indexed,
)
from megatron_llm_tpu_torch.parallel.mesh import (
    gather_rows,
    get_context,
    sum_over_tokens,
)
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
    spec_leaves,
    stage_axis,
)
from megatron_llm_tpu_torch.telemetry import (
    NULL_TRACER,
    CostRegistry,
    FlightRecorder,
    GoodputLedger,
    Histogram,
    PerfSentinel,
    SpanTracer,
    detect_chip,
)
from megatron_llm_tpu_torch.telemetry.chipspec import train_flops_per_token
from megatron_llm_tpu_torch.training.checkpointing import (
    CheckpointManager,
    flatten,
    load_checkpoint,
    optim_flat,
    unflatten_like,
)
from megatron_llm_tpu_torch.training.microbatches import (
    build_num_microbatches_calculator,
)
from megatron_llm_tpu_torch.training.tensorboard import SummaryWriter
from megatron_llm_tpu_torch.training.timers import Timers
from megatron_llm_tpu_torch.analysis.contracts import record_variant
from megatron_llm_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from megatron_llm_tpu_torch.training.wandb_logger import (
    WandBConfig,
    WandbTBShim,
)
from megatron_llm_tpu_torch.training.watchdog import LossWatchdog
from megatron_llm_tpu_torch.utils.masks import (
    get_document_starts,
    get_ltor_masks_and_position_ids,
)


def _tensor_bytes(*trees) -> int:
    """The bytes of every tensor in `trees` (dicts, lists, tuples, named
    tuples; other leaves count nothing)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(trees)
               if isinstance(x, torch.Tensor))


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
    `region` names this rank's slice of a whole leaf (what it loads and
    the offsets of what it saves); `gather` makes a slice whole again on
    rank 0's host, for the tests' reference only. Leaf names are the
    checkpoint files' ("layers.attention.wqkv", "m.<leaf>",
    "v.<leaf>")."""

    def __init__(self, ctx, cfg, full_template: dict, zero1: bool,
                 bucket_mb: float, overlap_grads: bool = False):
        self.ctx = ctx
        self.pp = getattr(ctx, "pp", 1)
        specs = spec_leaves(layout_specs(cfg, full_template, self.pp))
        self.tp_axes = [model_axis(sp) for sp in specs]
        self.pp_axes = [stage_axis(sp) for sp in specs]
        index, _ = map_indexed(lambda i, _: i, full_template)
        self.index = flatten(index)
        local = shard_params(tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), full_template), ctx, cfg)
        # under --overlap_grad_reduce the moments follow the grads to the
        # within-layer axis
        self.plan = build_state_plan(cfg, local, ctx.dp, bucket_mb,
                                     pp=self.pp,
                                     overlap_grads=overlap_grads) \
            if zero1 and ctx.dp > 1 else None

    def _leaf(self, name: str):
        moment = name.startswith(("m.", "v."))
        i = self.index.get(name[2:] if moment else name)
        z1 = None if i is None or self.plan is None or not moment \
            else self.plan.leaf_axes[i]
        return i, z1

    def region(self, name: str, shape) -> tuple:
        """The slices of the whole leaf `name` (of `shape`) that this
        rank holds: its stage's layers, its tp slice and, for a moment
        under ZeRO-1, its dp block; "step" and the scaler's state
        whole."""
        i, z1 = self._leaf(name)
        out = [slice(None)] * len(shape)
        if i is None:
            return tuple(out)
        ctx, sizes = self.ctx, list(shape)
        for k, n, r in ((self.pp_axes[i] if self.pp > 1 else None,
                         self.pp, getattr(ctx, "pp_rank", 0)),
                        (self.tp_axes[i], ctx.tp, ctx.tp_rank),
                        (z1, ctx.dp, ctx.dp_rank)):
            if k is None or n == 1:
                continue
            start = (out[k].start or 0) + r * (sizes[k] // n)
            sizes[k] //= n
            out[k] = slice(start, start + sizes[k])
        return tuple(out)

    def writes(self, name: str) -> bool:
        """Whether this rank writes its piece of `name` in a save: the
        one rank at coordinate 0 of every axis the leaf is not split
        over (cp splits none); "step" and the scaler's state are rank
        0's."""
        i, z1 = self._leaf(name)
        ctx = self.ctx
        if i is None:
            return ctx.rank == 0
        split_pp = self.pp > 1 and self.pp_axes[i] is not None
        return (getattr(ctx, "cp_rank", 0) == 0
                and (ctx.dp_rank == 0 or z1 is not None)
                and (ctx.tp_rank == 0 or self.tp_axes[i] is not None)
                and (getattr(ctx, "pp_rank", 0) == 0 or split_pp))

    def pieces(self, flat: dict, shapes: dict) -> dict:
        """{name: (this rank's piece, its offsets, the whole shape)} of
        the leaves of `flat` this rank writes; `shapes` gives each
        name's whole shape."""
        out = {}
        for name, x in flat.items():
            if not self.writes(name):
                continue
            shape = tuple(shapes.get(name, tuple(x.shape)))
            offs = tuple(r.start or 0 for r in self.region(name, shape))
            out[name] = (x.detach(), offs, shape)
        return out

    def gather(self, name: str, x: torch.Tensor):
        """The whole leaf on rank 0 (a host tensor of its own), None on
        the other ranks; a collective the ranks of cp rank 0 enter (the
        other cp ranks hold the same state). A ZeRO-1 block goes to the
        dp group's first rank, then a tensor-parallel slice
        to the tp group's first rank, then a stage's layers to the first
        stage: only what rank 0 needs moves. Saves write per-rank pieces
        instead; this is the tests' whole-state reference."""
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


def init_rank_state(ctx, cfg, params: dict, tcfg: TrainConfig,
                    pcfg: ParallelConfig, device):
    """(StateLayout or None, this rank's params, fresh optimizer state)
    from the whole tree `params`: at world size 1 (`ctx` None) the tree
    itself; across ranks its slices (`shard_params`) and zero moments of
    the rank's shapes (ZeRO-1 blocks under --use_distributed_optimizer)."""
    if ctx is None:
        return None, params, init_optimizer_state(params, tcfg)
    layout = StateLayout(ctx, cfg, params, pcfg.use_distributed_optimizer,
                         pcfg.grad_rs_bucket_mb, pcfg.overlap_grad_reduce)
    params = shard_params(params, ctx, cfg)
    opt_state = init_optimizer_state({}, tcfg, device=device)
    opt_state = opt_state._replace(
        m=layout.zero_moments(params, device),
        v=layout.zero_moments(params, device)
        if tcfg.optimizer == "adam" else None)
    return layout, params, opt_state


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
        ctx = get_context()
        # the parallel context across ranks; None on one card
        self.ctx = ctx if ctx is not None and ctx.world_size > 1 else None
        self._rank0 = self.ctx is None or self.ctx.rank == 0
        # telemetry (module doc): every rank keeps its own tracer,
        # recorder, ledger, histogram and sentinel
        self.tracer = (SpanTracer(enabled=True) if tcfg.trace_dir
                       else NULL_TRACER)
        self.recorder = FlightRecorder(tcfg.flight_recorder_size)
        self._step_ms_hist = Histogram(
            "train_step_ms", help_text="wall ms per optimizer step "
            "(dispatch + loss fetch)")
        self.ledger = GoodputLedger()
        self.chip = detect_chip(devices=[self.device],
                                override=tcfg.chip_spec)
        self.costs = (CostRegistry(chip=self.chip, owner=self).attach()
                      if tcfg.device_cost_registry else None)
        self.sentinel = PerfSentinel(
            k_sigma=tcfg.perf_sentinel_ksigma,
            window=max(tcfg.perf_sentinel_window, 4),
            patience=max(tcfg.perf_sentinel_patience, 1),
            recorder=self.recorder, name="train_step_ms")
        self._last_step_minted = False
        self._last_num_micro: Optional[int] = None
        self.timers = Timers(tcfg.timing_log_level, tcfg.timing_log_option,
                             tracer=self.tracer)
        self._n_params = 0  # set in setup(); enables the TFLOP/s log field
        self._eval_step_fn = None
        self._run_facts_logged = False
        self._profiler = None  # the open torch.profiler window
        self.profile_path: Optional[str] = None  # its last trace file
        self.trace_path: Optional[str] = None  # the exported span trace
        self._tb_writer = self._make_writer() if self._rank0 else None
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
            patience=tcfg.spike_rollback_patience,
            recorder=self.recorder)
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
        self.layout: Optional[StateLayout] = None
        # the dropout base stream (models/dropout.py), set by train() or
        # restored from a checkpoint; None without dropout
        self._dropout_seed: Optional[int] = None

    def _make_writer(self):
        """Rank 0's scalar sink (JAX :261-290): the event writer under
        --tensorboard_dir, wrapped by the WandB shim under
        --wandb_logger; None without either. `world-size` at step 0
        under --log_world_size_to_tensorboard."""
        tcfg = self.tcfg
        writer = None
        if tcfg.tensorboard_dir:
            writer = SummaryWriter(tcfg.tensorboard_dir,
                                   max_queue=tcfg.tensorboard_queue_size)
        if tcfg.wandb_logger:
            writer = WandbTBShim(writer, WandBConfig(
                project=tcfg.wandb_project or "megatron_llm_tpu",
                entity=tcfg.wandb_entity, id=tcfg.wandb_id,
                resume=tcfg.wandb_resume, api_key=tcfg.wandb_api_key))
        if writer is not None and tcfg.log_world_size_to_tensorboard:
            writer.add_scalar("world-size", 1 if self.ctx is None
                              else self.ctx.world_size, 0)
        return writer

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
        self.layout, params, opt_state = init_rank_state(
            self.ctx, self.cfg, params, self.tcfg, self.pcfg, self.device)
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
                               device=self.device,
                               region=self.layout.region, **kw)

    def _get_step_fn(self, num_microbatches: int):
        if num_microbatches not in self._train_steps:
            import dataclasses

            pcfg = dataclasses.replace(self.pcfg,
                                       num_microbatches=num_microbatches)
            # one step function a microbatch count, under this trainer
            # (JAX :366-392)
            record_variant("train.pipeline_step"
                           if pcfg.pipeline_parallel_size > 1
                           else "train.step", num_microbatches, owner=self)
            self._train_steps[num_microbatches] = make_train_step(
                self.model, self.tcfg, pcfg, batch_builder=self.batch_builder)
        return self._train_steps[num_microbatches]

    def train_step(self, state: TrainState, text, dropout_rng=None) -> dict:
        """One optimizer step over a global batch 'text' (num_micro,
        mbs*dp, seq+1), or with a `batch_builder` the loader's dict of
        such arrays, which the builder turns into the model's loss
        keywords (JAX :517-598). The stats stay on the card."""
        if self.batch_builder is not None:
            batch = self._built(text)
            num_micro = next(iter(batch.values())).shape[0]
        else:
            num_micro = text.shape[0]
            cp = 1 if self.ctx is None else self.ctx.cp
            # under cp the dense mask would need the whole sequence: the
            # O(s) doc-start form rides the ring (JAX :529-531)
            batch = get_batch(text, self.eod_token, self.reset_position_ids,
                              self.reset_attention_mask, self.eod_mask_loss,
                              packed_doc_starts=cp > 1, device=self.device)
            batch = context_shard(batch, self.ctx)
        lr, wd = self.scheduler.get_lr(), self.scheduler.get_wd()
        # the first step of a microbatch count is the goodput ledger's
        # "compile" step and, with the registry on, the one it counts
        minted = num_micro not in self._train_steps
        self._last_step_minted = minted
        self._last_num_micro = num_micro
        step_fn = self._get_step_fn(num_micro)
        first_step = state.iteration == 0 and not self._run_facts_logged
        # the watchdog's in-step skip gate: +inf until its window has
        # history (NaN/inf losses still skip)
        thr = self.watchdog.threshold()

        def run():
            return step_fn(state.params, state.opt_state, batch, lr, wd,
                           dropout_rng, thr)

        if minted and self.costs is not None:
            # counted while it runs (telemetry/costs.py): no extra step
            params, opt_state, stats = self.costs.capture(
                "train.pipeline_step"
                if self.pcfg.pipeline_parallel_size > 1 else "train.step",
                num_micro, run, all_threads=True,
                arg_bytes=_tensor_bytes(state.params, state.opt_state,
                                        batch))
        else:
            params, opt_state, stats = run()
        state.params, state.opt_state = params, opt_state
        if first_step:
            self._log_run_facts(params, opt_state)
        state.iteration += 1
        mbs_dp = next(iter(batch.values())).shape[1] \
            * self.pcfg.data_parallel_size
        self.scheduler.step(num_micro * mbs_dp if self._samples_mode else 1)
        state.consumed_train_samples += num_micro * mbs_dp
        self.num_microbatches_calc.update(state.consumed_train_samples)
        stats["lr"] = lr
        stats["batch_size"] = num_micro * mbs_dp
        return stats

    def _built(self, raw) -> dict:
        """The batch builder's loss keywords of a loader dict, as tensors
        on the trainer's device, each (num_micro, rows, ...)."""
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in self.batch_builder(raw).items()}

    def evaluate(self, state: TrainState,
                 max_iters: Optional[int] = None) -> float:
        """Mean eval loss over `eval_iters` batches (JAX :600-695): the
        plain path, or at pp > 1 the pipelined loss of each (num_micro,
        rows, seq) batch; under cp each rank its sequence shard. With a
        batch builder, the model's own loss of each microbatch's
        keywords, averaged over the microbatches (JAX :628-648)."""
        if self.valid_data_iterator is None:
            return float("nan")
        self.drain_param_gathers()
        if self._eval_step_fn is None and self.batch_builder is not None:
            record_variant("train.eval_step", "generic", owner=self)
            model = self.model

            ctx = self.ctx
            dp_cp = ctx is not None and ctx.dp * ctx.cp > 1

            @torch.no_grad()
            def generic_eval(params, batch):
                n = next(iter(batch.values())).shape[0]
                losses = []
                for i in range(n):
                    kw = {k: v[i] for k, v in batch.items()}
                    if not dp_cp:
                        losses.append(model.loss(params, deterministic=True,
                                                 **kw))
                        continue
                    # the global batch's means, as the train step's
                    num, den = sum_over_tokens(torch.stack(
                        model.loss_terms(params, deterministic=True, **kw)),
                        ctx)
                    losses.append((num / den.clamp(min=1.0)).sum())
                return sum(losses) / len(losses)

            self._eval_step_fn = generic_eval
        if self._eval_step_fn is None:
            record_variant("train.eval_step", "pp" if self.pcfg
                           .pipeline_parallel_size > 1 else "plain",
                           owner=self)
            self._eval_step_fn = make_eval_step(self.model)
        total, count = 0.0, 0
        iters = max_iters if max_iters is not None else self.tcfg.eval_iters
        it = iter(self.valid_data_iterator)
        for _ in range(iters):
            try:
                text = next(it)
            except StopIteration:
                break
            if self.batch_builder is not None:
                total += float(self._eval_step_fn(state.params,
                                                  self._built(text)))
                count += 1
                continue
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
        # the goodput partition re-set each log (its seconds move every
        # step) and the MFU and roofline gauges with a known chip
        for name, val in self.ledger.counters().items():
            self.timers.gauge(name, val)
        self._device_cost_gauges(elapsed, stats["batch_size"])
        self._print(line)
        if self._rank0:
            self.timers.log(["batch-generator", "train-step"],
                            normalizer=self.tcfg.log_interval)

    def _log_run_facts(self, params, opt_state):
        """Once, after the first step (JAX :397-515): the recompute
        policy, at pp > 1 the pipeline's, under ZeRO-1 this rank's
        moment bytes and the plan's gradient wire bytes and buckets,
        under --log_memory_to_tensorboard with an overlap flag the step's
        measured overlap gauges (analysis/overlap.py), and on a card
        under --log_memory_to_tensorboard the step's peak allocated and
        reserved bytes; printed as the run facts line and written at
        step 0 (strings as text)."""
        self._run_facts_logged = True
        facts = {"remat-policy": self.cfg.resolved_remat_policy}
        if self.pcfg.pipeline_parallel_size > 1:
            facts["pipeline-remat"] = self.pcfg.resolved_pipeline_remat
        if self.pcfg.use_distributed_optimizer and self.layout is not None \
                and self.layout.plan is not None:
            facts["zero1-path"] = "explicit-rs"
            quantized = self.pcfg.quantized_grad_reduce
            if quantized:
                facts["zero1-quantized-reduce"] = True
            overlap_on = [n for n, f in (
                ("grads", self.pcfg.overlap_grad_reduce),
                ("gather", self.pcfg.overlap_param_gather)) if f]
            if overlap_on:
                facts["zero1-overlap"] = "+".join(overlap_on)
            facts["opt-state-bytes-device"] = _tensor_bytes(opt_state.m,
                                                            opt_state.v)
            # the plan the step reduces by: one reduction a step, then
            # the parameters' all-gather (JAX reduces every microbatch)
            if self.pcfg.overlap_grad_reduce:
                step_plan = build_overlap_plan(
                    self.cfg, params, self.ctx.dp,
                    bucket_mb=self.pcfg.grad_rs_bucket_mb)
            else:
                step_plan = build_zero1_plan(
                    self.cfg, params, self.ctx.dp,
                    bucket_mb=self.pcfg.grad_rs_bucket_mb,
                    pp=self.pcfg.pipeline_parallel_size)
            facts["grad-comm-bytes-step"] = (
                step_plan.comm_bytes_per_reduce(quantized)
                + _tensor_bytes(params))
            bucket_bytes = step_plan.bucket_comm_bytes(quantized)
            facts["grad-rs-buckets"] = len(bucket_bytes)
            facts["grad-rs-bucket-bytes"] = list(bucket_bytes)
        if self.tcfg.log_memory_to_tensorboard and (
                self.pcfg.overlap_grad_reduce
                or self.pcfg.overlap_param_gather):
            # the first step's measured overlap (analysis/overlap.py;
            # JAX :478-503 reads it from the compiled step)
            from megatron_llm_tpu_torch.analysis.overlap import (
                grad_overlap_report,
            )

            rep = grad_overlap_report(
                self._train_steps.get(self._last_num_micro))
            facts["grad-comm-overlap-pairs"] = rep.async_pairs
            facts["grad-comm-overlap-max-in-flight"] = rep.max_in_flight
        if self.tcfg.log_memory_to_tensorboard \
                and self._tb_writer is not None \
                and self.device.type == "cuda":
            facts["max-memory-allocated-bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
            facts["max-memory-reserved-bytes"] = int(
                torch.cuda.memory_stats(self.device).get(
                    "reserved_bytes.all.peak", 0))
        for k, v in facts.items():
            self.timers.gauge(k, v)
        if self._rank0:
            self.timers.log([])  # the run facts line, now
        if self._tb_writer is not None:
            self.timers.write([], self._tb_writer, 0)
            if hasattr(self._tb_writer, "log_run_metadata"):
                self._tb_writer.log_run_metadata(facts)

    def _device_cost_gauges(self, elapsed: float, batch_size: int):
        """The live MFU and roofline gauges (JAX :746-805), absent
        without a chip spec. `train_mfu` is the logged step's FLOPs over
        its wall and the peak; `train_mfu_effective` debits every
        non-productive second of the ledger. The FLOPs are the
        registry's record of the microbatch count the step ran
        (`train_mfu_source` "registry": this rank's step against one
        card's peak) or the analytic 6 N + attention model ("analytic":
        the whole step against every rank's card)."""
        if self.chip is None or not self._n_params or elapsed <= 0:
            return
        key = self._last_num_micro
        rec = (self.costs.record("train.step", key)
               or self.costs.record("train.pipeline_step", key)) \
            if self.costs is not None and key is not None else None
        peak = self.chip.peak_flops_for(str(self.cfg.compute_dtype))
        if rec is not None and rec.flops:
            step_flops, source = rec.flops, "registry"
        else:
            step_flops = train_flops_per_token(
                self._n_params, self.cfg.num_layers, self.cfg.hidden_size,
                self.cfg.seq_length) * batch_size * self.cfg.seq_length
            source = "analytic"
            peak *= 1 if self.ctx is None else self.ctx.world_size
        self.timers.gauge("train_mfu", round(step_flops / elapsed / peak, 6))
        snap = self.ledger.snapshot()
        if snap["wall_s"] > 0 and snap["productive_steps"]:
            self.timers.gauge(
                "train_mfu_effective",
                round(step_flops * snap["productive_steps"]
                      / snap["wall_s"] / peak, 6))
        self.timers.gauge("train_mfu_source", source)
        self.timers.gauge("chip_spec", self.chip.label())
        if rec is not None and rec.bytes_accessed:
            gbps = rec.bytes_accessed / elapsed / 1e9
            self.timers.gauge("train_step_achieved_gbps", round(gbps, 1))
            self.timers.gauge("train_step_hbm_frac",
                              round(gbps * 1e9 / self.chip.hbm_bytes_s, 4))

    def _tb_log(self, state: TrainState, stats: dict, elapsed: float):
        """Tensorboard and WandB scalars on --tensorboard_log_interval
        (JAX :807-861), with its tags; rank 0 only (the others hold no
        writer)."""
        w = self._tb_writer
        if w is None or (state.iteration
                         % max(self.tcfg.tensorboard_log_interval, 1)):
            return
        it = state.iteration
        w.add_scalar("lm-loss", float(stats["loss"]), it)
        w.add_scalar("learning-rate", stats["lr"], it)
        w.add_scalar("grad-norm", float(stats["grad_norm"]), it)
        w.add_scalar("batch-size", stats["batch_size"], it)
        if "loss_scale" in stats:
            w.add_scalar("loss-scale", float(stats["loss_scale"]), it)
        if "params_norm" in stats:
            w.add_scalar("params-norm", float(stats["params_norm"]), it)
        if "num_zeros" in stats:
            w.add_scalar("num-zeros", int(stats["num_zeros"]), it)
        if self.tcfg.log_timers_to_tensorboard:
            w.add_scalar("iteration-time", elapsed, it)
        w.add_scalar("loss-watchdog-skipped", self.watchdog.skipped, it)
        w.add_scalar("loss-watchdog-rollbacks", self.watchdog.rollbacks, it)
        snap = self.ledger.snapshot()
        w.add_scalar("goodput-fraction", snap["goodput_fraction"], it)
        for b, v in snap["buckets"].items():
            w.add_scalar(f"goodput-{b}-seconds", v, it)
        if self.sentinel.enabled:
            w.add_scalar("perf-sentinel-trips", self.sentinel.trips, it)
        if self._ckpt_manager is not None and self._ckpt_manager.saves:
            w.add_scalar("ckpt-blocked-ms",
                         self._ckpt_manager.last_blocked_ms, it)
        if self.tcfg.log_memory_to_tensorboard \
                and self.device.type == "cuda":
            # the allocator's live bytes (JAX: the device's bytes_in_use);
            # no gauge on the CPU
            w.add_scalar("mem-bytes-in-use",
                         torch.cuda.memory_allocated(self.device), it)
        w.flush()

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
                async_save=self.tcfg.async_save, recorder=self.recorder)
            self._ckpt_manager.protect(self._loaded_ckpt_path)
        return self._ckpt_manager

    def _save(self, state: TrainState, blocking: bool = False):
        """Save to `tcfg.save` (JAX :879-912): async unless `blocking`
        (the exit paths), which also waits for the commit. The loop's
        stall is the `ckpt_blocked_ms` gauge."""
        if not self.tcfg.save:
            return
        mgr = self._get_ckpt_manager()
        t_save = time.perf_counter()
        if self._saved_iteration == state.iteration:
            # this state is saved already, or its save is in flight
            if blocking:
                self._wait_for_commit()
                self._note_stall("checkpoint", t_save)
            return
        self.timers("save-checkpoint").start()
        self.drain_param_gathers()
        if self.layout is None:
            mgr.save(state.iteration, state.params,
                     None if self.tcfg.no_save_optim else state.opt_state,
                     self.cfg, self.scheduler.state_dict(),
                     state.consumed_train_samples, rng_key=self._dropout_seed)
        else:
            model, optim = self._state_pieces(state)
            mgr.save_pieces(state.iteration, model, optim, self.ctx.rank,
                            self.ctx.world_size,
                            barrier=lambda: host_barrier("checkpoint-save"),
                            model_cfg=self.cfg,
                            scheduler_state=self.scheduler.state_dict(),
                            consumed_train_samples=(
                                state.consumed_train_samples),
                            rng_key=self._dropout_seed)
        self.timers("save-checkpoint").stop()
        self._saved_iteration = state.iteration
        self.timers.gauge("ckpt_blocked_ms", round(mgr.last_blocked_ms, 2))
        self.tracer.instant("ckpt_blocked",
                            blocked_ms=round(mgr.last_blocked_ms, 3))
        if blocking:
            self._wait_for_commit()
        # the loop's whole save stall: the host copies, the previous
        # save's tail and (blocking) the commit
        self._note_stall("checkpoint", t_save)
        self._print(f"saved checkpoint at iteration {state.iteration} to "
                    f"{self.tcfg.save}"
                    f"{' (committed)' if blocking else ' (async)'}")

    def _note_stall(self, bucket: str, t0: float) -> None:
        """The goodput ledger's `bucket` gets the seconds since `t0`,
        once the loop has started its clock."""
        if self.ledger.started:
            self.ledger.note(bucket, time.perf_counter() - t0)

    def _flight_record_dir(self) -> Optional[str]:
        """Where the flight-record dumps land: --flight_record_dir, else
        the --save dir; None keeps them in memory and in the log."""
        return self.tcfg.flight_record_dir or self.tcfg.save

    def drain_param_gathers(self) -> None:
        """Wait for the parameter all-gathers in flight
        (`--overlap_param_gather`): before an eval, a save, a rollback
        and the end of training."""
        for step in self._train_steps.values():
            step.drain()

    def _state_pieces(self, state: TrainState):
        """This rank's pieces of the params and, unless --no_save_optim,
        of the optimizer state (StateLayout.pieces): what its save
        writes."""
        lay = self.layout
        full = flatten(self.model.abstract_params())
        shapes = {k: tuple(v.shape) for k, v in full.items()}
        shapes.update({p + k: v for k, v in list(shapes.items())
                       for p in ("m.", "v.")})
        model = lay.pieces(flatten(state.params), shapes)
        if self.tcfg.no_save_optim:
            return model, None
        return model, lay.pieces(optim_flat(state.opt_state), shapes)

    def _wait_for_commit(self) -> None:
        """Wait for this rank's save in flight (rank 0's commits the
        checkpoint once every rank's marker is there); then every rank
        waits for every other."""
        if self._ckpt_manager is not None:
            self._ckpt_manager.wait_until_finished()
        host_barrier("checkpoint-commit")

    def _gather_state(self, state: TrainState):
        """The whole params and optimizer state on rank 0's host (None,
        None elsewhere): a collective, leaf by leaf; the tests' reference
        for the per-rank files (no save gathers)."""
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
        t_roll = time.perf_counter()
        # the save in flight is the newest: it must land first
        self.drain_param_gathers()
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
        self.watchdog.note_rollback(step=iteration + poison,
                                    restored_step=iteration)
        self.tracer.instant("watchdog_rollback", restored_step=iteration,
                            poison_window=poison)
        # the reload's stall is the watchdog's; the dump (before training
        # resumes) names the failing step range
        self._note_stall("watchdog", t_roll)
        self.recorder.dump(
            self._flight_record_dir(), "watchdog-rollback",
            extra={"restored_step": iteration, "poison_window": poison,
                   "rollback": self.watchdog.rollbacks,
                   "goodput": self.ledger.snapshot()})
        self._print(f"LOSS WATCHDOG ROLLBACK: reloaded iteration "
                    f"{iteration} from {self.tcfg.save}; data iterator "
                    f"fast-forwarded past the {poison}-iteration poison "
                    f"window (rollback #{self.watchdog.rollbacks})")
        return True

    def _rank_tag(self) -> str:
        """`_rank<r>` across ranks, empty on one card: a per-rank file's
        name part."""
        return "" if self.ctx is None else f"_rank{self.ctx.rank}"

    def _start_profile(self) -> None:
        """Open the torch.profiler window: CUDA activity on a card, the
        host's ops on the CPU."""
        from torch.profiler import ProfilerActivity, profile

        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self._profiler = profile(activities=[act])
        self._profiler.start()
        self.recorder.record("profile_start")

    def _stop_profile(self) -> None:
        """Close the window and write its raw kineto events as Chrome
        trace JSON (the parsed event list of a long window takes the
        host minutes) into --profile_dir, else --tensorboard_dir, else
        ./profile."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        d = self.tcfg.profile_dir or self.tcfg.tensorboard_dir or "./profile"
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"profile_train{self._rank_tag()}_"
                               f"{os.getpid()}.json")
        prof.profiler.kineto_results.save(path)
        self.profile_path = path
        self.recorder.record("profile_done", path=path)
        self._print(f"profile window written to {path}")

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

        # the goodput clock starts with the loop: every second from here
        # lands in exactly one bucket
        self.ledger.start()
        while keep_going():
            # every span of this iteration carries the step it belongs to
            self.tracer.set_context(step=state.iteration + 1)
            self.timers("batch-generator").start()
            t_fetch = time.perf_counter()
            try:
                text = next(data_iter)
            except StopIteration:
                self._print("data iterator exhausted")
                break
            finally:
                self.timers("batch-generator").stop()
                self.ledger.note("data_wait", time.perf_counter() - t_fetch)
            step_rng = None if self._dropout_seed is None \
                else fold_in(self._dropout_seed, state.iteration)
            # the profile window (JAX :1029-1037)
            if (tcfg.profile and self._profiler is None
                    and tcfg.profile_step_start <= state.iteration
                    < tcfg.profile_step_end):
                self._start_profile()
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
            bad = self.watchdog.observe(loss_val, step=state.iteration)
            # the step's wall in one bucket: the first step of a
            # microbatch count, a skipped step, or productive
            bucket = ("compile" if self._last_step_minted
                      else "watchdog" if bad else "productive")
            self.ledger.note(bucket, elapsed)
            self._step_ms_hist.observe(elapsed * 1e3)
            self.recorder.record("step", step=state.iteration, loss=loss_val,
                                 ms=round(elapsed * 1e3, 3), bucket=bucket)
            if self._profiler is not None \
                    and state.iteration >= tcfg.profile_step_end:
                self._stop_profile()
            if bad:
                self.tracer.instant("watchdog_bad", loss=loss_val,
                                    streak=self.watchdog.consecutive_bad)
                self._print(f"loss watchdog: bad step at iteration "
                            f"{state.iteration} (loss {loss_val:.6E}, "
                            f"streak {self.watchdog.consecutive_bad})")
                if self.watchdog.should_rollback():
                    self._rollback(state)
            elif bucket == "productive" and self.sentinel.enabled \
                    and self.sentinel.observe(elapsed * 1e3,
                                              step=state.iteration):
                # productive steps only: a first step would poison the
                # latency baseline as a spike poisons the loss window
                self.timers.gauge("perf_sentinel_trips", self.sentinel.trips)
                self.tracer.instant("perf_regression",
                                    step_ms=round(elapsed * 1e3, 3))
                self.recorder.dump(
                    self._flight_record_dir(), "perf-regression",
                    extra={"step": state.iteration,
                           "trip": self.sentinel.trips,
                           "step_ms": round(elapsed * 1e3, 3),
                           "threshold_ms": round(
                               self.sentinel.last_threshold, 3),
                           "goodput": self.ledger.snapshot()})
            if state.iteration % tcfg.log_interval == 0:
                self._training_log(state, stats, elapsed)
            self._tb_log(state, stats, elapsed)
            if (tcfg.eval_interval and self.valid_data_iterator is not None
                    and state.iteration % tcfg.eval_interval == 0):
                val = self.evaluate(state)
                ppl = float(np.exp(min(20.0, val)))
                self._print(f"validation loss at iteration "
                            f"{state.iteration}: {val:.6E} | ppl: "
                            f"{ppl:.4f}")
                if self._tb_writer is not None \
                        and tcfg.log_validation_ppl_to_tensorboard:
                    self._tb_writer.add_scalar("lm-loss-validation", val,
                                               state.iteration)
                    self._tb_writer.add_scalar("lm-loss-validation-ppl",
                                               ppl, state.iteration)
                    self._tb_writer.flush()
            if tcfg.save_interval and state.iteration % tcfg.save_interval \
                    == 0:
                self._save(state)
            # the exits (JAX :1127-1186): signal, duration and autoresume
            # each make a blocking save first
            if self.signal_handler is not None and all_hosts_any(
                    self.signal_handler.signals_received()):
                self._print("exiting on termination signal - emergency "
                            "save")
                self.recorder.record("sigterm", step=state.iteration)
                self._save(state, blocking=True)
                # the killed run's last steps, after the committed save
                self.recorder.dump(
                    self._flight_record_dir(), "sigterm",
                    extra={"step": state.iteration,
                           "consumed_train_samples":
                               state.consumed_train_samples,
                           "goodput": self.ledger.snapshot(),
                           **({"costs": self.costs.snapshot()}
                              if self.costs is not None else {})})
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
        if self._profiler is not None:
            # an exit inside the window: its trace is written all the same
            self._stop_profile()
        # the parameter gathers and an interval save in flight land
        # before the loop returns
        self.drain_param_gathers()
        if self._ckpt_manager is not None or self.layout is not None:
            self._wait_for_commit()
        if self._tb_writer is not None:
            self._tb_writer.flush()
        if tcfg.trace_dir:
            self.trace_path = self.tracer.export(os.path.join(
                tcfg.trace_dir, f"trace_train{self._rank_tag()}_"
                f"{os.getpid()}.json"))
            if self.trace_path:
                print(f"span trace exported to {self.trace_path} "
                      f"(Perfetto / chrome://tracing)", flush=True)
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
