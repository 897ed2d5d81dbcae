"""Epoch-based classification finetuning shared by GLUE and RACE (port
of tasks/finetune_utils.py).

An epoch loop over the shuffled training set (RandomState(seed)), the
learning rate warmed up and decayed linearly over all steps by the
port's `OptimizerParamScheduler`, AdamW through the port's
`optimizer_step` on the fp32 params in place, validation accuracy after
every epoch, and the best epoch's params kept (ref
tasks/finetune_utils.py:141-337). The host stacks numpy batches; each
step is the trainer's train step (training/train_step.py) with one
microbatch: a forward and backward on the model's device, then AdamW.

Across ranks (a parallel context, JAX :117-139) the batch size is the
global batch and must divide by dp: each rank computes its batch / dp
rows, the loss is the global batch's mean (the model's `loss_terms`)
and the gradients are reduced once a step, each hidden-dropout mask its
rows' slice of world size 1's. Under tensor (and sequence) parallelism
each rank holds its slices of the leaves (`init_rank_state`), where the
JAX loop keeps every leaf replicated (P(), :132-134): the same numbers,
another layout (ROADMAP's accepted divergences). Validation runs the
whole set on every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from megatron_llm_tpu_torch.models.dropout import fold_in
from megatron_llm_tpu_torch.optimizer import OptimizerParamScheduler
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves, tree_map
from megatron_llm_tpu_torch.parallel.mesh import get_context


def _stack_batch(samples, device) -> dict:
    """The samples' fields as (b, ...) tensors on `device` (RACE's
    carry a (choices, s) axis pair; stacking is the same)."""
    return {
        "tokens": torch.as_tensor(np.stack(
            [s["text"] for s in samples]).astype(np.int32), device=device),
        "attention_mask": torch.as_tensor(np.stack(
            [s["padding_mask"] for s in samples]).astype(np.int32),
            device=device),
        "tokentype_ids": torch.as_tensor(np.stack(
            [s["types"] for s in samples]).astype(np.int32), device=device),
        "labels": torch.as_tensor(np.asarray(
            [s["label"] for s in samples], np.int32), device=device),
    }


def _batches(dataset, batch_size, rng=None, drop_last=True):
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    end = (len(order) // batch_size * batch_size if drop_last
           else len(order))
    for i in range(0, end, batch_size):
        yield [dataset[int(j)] for j in order[i:i + batch_size]]


def _device(params):
    return tree_leaves(params)[0].device


@torch.no_grad()
def accuracy(model, params, dataset, batch_size: int) -> float:
    """Exact-match accuracy of the argmax over the whole set (ref
    eval_utils.py calculate_correct_answers)."""
    total = n = 0
    dev = _device(params)
    for samples in _batches(dataset, batch_size, drop_last=False):
        b = _stack_batch(samples, dev)
        logits = model.forward(params, b["tokens"], b["attention_mask"],
                               b["tokentype_ids"])
        total += int((logits.argmax(-1) == b["labels"]).sum())
        n += len(samples)
    return total / max(n, 1)


def finetune(model, params, train_ds, valid_ds, *, epochs: int,
             batch_size: int, lr: float, weight_decay: float = 0.01,
             warmup_fraction: float = 0.065, seed: int = 1234,
             tcfg=None, pcfg=None, log_interval: int = 50, losses=None):
    """Run the loop from the whole tree `params`; returns (the best
    epoch's params, the last epoch's without a validation set, and the
    best validation accuracy), this rank's slices across ranks. Each
    step's loss, a float (the global batch's), is appended to `losses`
    when given. `pcfg` is the run's ParallelConfig (world size 1 by
    default)."""
    import dataclasses

    from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_tpu_torch.training.train_step import make_train_step
    from megatron_llm_tpu_torch.training.trainer import init_rank_state

    tcfg = tcfg or TrainConfig(micro_batch_size=batch_size,
                               global_batch_size=batch_size, lr=lr,
                               weight_decay=weight_decay)
    pcfg = dataclasses.replace(pcfg or ParallelConfig(), num_microbatches=1)
    ctx = get_context()
    ctx = ctx if ctx is not None and ctx.world_size > 1 else None
    dp, dp_rank = (ctx.dp, ctx.dp_rank) if ctx is not None else (1, 0)
    if batch_size % dp:
        raise ValueError(f"batch size {batch_size} must divide dp={dp}")
    rows = slice(dp_rank * batch_size // dp,
                 (dp_rank + 1) * batch_size // dp)
    dev = _device(params)
    _, params, opt_state = init_rank_state(ctx, model.cfg, params, tcfg,
                                           pcfg, dev)
    # the builder's keywords are `_stack_batch`'s
    step = make_train_step(model, tcfg, pcfg, batch_builder=_stack_batch)
    steps_per_epoch = len(train_ds) // batch_size
    total_steps = max(1, epochs * steps_per_epoch)
    sched = OptimizerParamScheduler(
        max_lr=lr, min_lr=0.0,
        lr_warmup_steps=int(warmup_fraction * total_steps),
        lr_decay_steps=total_steps, lr_decay_style="linear",
        start_wd=weight_decay, end_wd=weight_decay,
        wd_incr_steps=total_steps, wd_incr_style="constant")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rng = np.random.RandomState(seed)
    dropout_base = seed + 1
    best_acc, best_params, it = 0.0, None, 0
    for epoch in range(epochs):
        t0 = time.time()
        for samples in _batches(train_ds, batch_size, rng=rng):
            batch = {k: v[None] for k, v in
                     _stack_batch(samples[rows], dev).items()}
            # advance first, so step 1 trains at max_lr / warmup_steps
            sched.step()
            params, opt_state, stats = step(
                params, opt_state, batch, sched.get_lr(), weight_decay,
                rng=fold_in(dropout_base, it))
            it += 1
            if losses is not None or it % log_interval == 0:
                loss_val = float(stats["loss"])
                if losses is not None:
                    losses.append(loss_val)
                if it % log_interval == 0 and (ctx is None
                                               or ctx.rank == 0):
                    print(f"epoch {epoch} iter {it}/{total_steps} | "
                          f"loss {loss_val:.4f} | lr {sched.get_lr():.3E}",
                          flush=True)
        step.drain()
        if valid_ds is not None and len(valid_ds):
            acc = accuracy(model, params, valid_ds, batch_size)
            if acc >= best_acc:
                # the params change in place: keep a copy of the best
                best_acc = acc
                best_params = tree_map(lambda p: p.detach().clone(), params)
            if ctx is None or ctx.rank == 0:
                print(f"epoch {epoch} done in {time.time() - t0:.1f}s | "
                      f"validation accuracy: {acc:.4f}", flush=True)
    if best_params is None:
        return params, best_acc
    for p in tree_leaves(best_params):
        p.requires_grad_(True)
    return best_params, best_acc
