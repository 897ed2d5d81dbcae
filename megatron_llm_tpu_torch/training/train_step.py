"""The training step (port of training/train_step.py).

The JAX package jits one function: the microbatch loop as a `lax.scan`,
fp32 gradient accumulation, the averaged loss, the loss watchdog's skip
gate and the optimizer. Here it is eager PyTorch on one card: a Python
loop over microbatches, each a forward and a backward whose gradients
accumulate in the fp32 params' `.grad` (the first microbatch's gradient
is the sum's first term, as JAX's zeros + g1), divided by the
microbatch count, then `optimizer_step` in place. Nothing is read back
on the host: the loss, the skip flag and the gradient norm stay 0-d
tensors on the card for the caller to read when it logs.

Under fp16 each microbatch's loss is multiplied by the loss scaler's
scale before its backward; the accumulated gradients are divided by it
after, and a non-finite gradient norm skips the step and feeds the
scaler (JAX :191-316). Given a dropout stream `rng` (an integer seed,
models/dropout.py) microbatch i draws from fold_in(rng, i), or from
`rng` itself when there is one microbatch (JAX :253-281).

ZeRO-1, overlap scheduling, tensor/pipeline/context parallelism and a
`batch_builder` belong to later slices and raise.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.models.dropout import fold_in
from megatron_llm_tpu_torch.optimizer.optimizer import (
    OptimizerState,
    get_grad_scaler,
    optimizer_step,
    tree_leaves,
)


def make_train_step(model, tcfg: TrainConfig, pcfg: ParallelConfig,
                    batch_builder=None):
    """Returns train_step(params, opt_state, batch, lr, wd, rng=None,
    spike_threshold=None) -> (params, opt_state, stats).

    `params` is the fp32 parameter tree, its leaves requiring grad;
    `batch` a dict of (num_microbatches, batch, seq) tensors: tokens,
    labels, loss_mask, position_ids and optionally attention_mask.
    `spike_threshold` (a float, the loss watchdog's median + k sigma):
    a step whose mean loss is non-finite or above it is skipped on the
    card, params and state untouched. Params and state are updated in
    place and returned."""
    if batch_builder is not None:
        raise ValueError("a batch_builder (BERT/T5 batches) is not ported "
                         "yet: those models are ROADMAP.md A6")
    if pcfg.world_size != 1:
        raise ValueError("data/tensor/pipeline/context parallel training "
                         "is the parallelism slice (ROADMAP.md A4)")
    num_micro = pcfg.num_microbatches
    scaler = get_grad_scaler(tcfg)

    def train_step(params, opt_state: OptimizerState, batch, lr, wd,
                   rng=None, spike_threshold=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n != num_micro:
            raise ValueError(f"batch has {n} microbatches, the step was "
                             f"built for {num_micro}")
        dev = leaves[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        loss_scale = None if scaler is None else torch.as_tensor(
            scaler.scale(opt_state.scaler), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            for i in range(num_micro):
                micro = {k: v[i] for k, v in batch.items()}
                mrng = rng if rng is None or num_micro == 1 \
                    else fold_in(rng, i)
                l_i = model.loss(params, dropout_rng=mrng,
                                 deterministic=rng is None, **micro)
                (l_i if loss_scale is None else l_i * loss_scale).backward()
                loss = loss + l_i.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        if num_micro > 1:
            for g in grads:
                g.div_(num_micro)
            loss = loss / num_micro
        if loss_scale is not None:
            inv = 1.0 / loss_scale
            for g in grads:
                g.mul_(inv)
        found_inf = None
        if spike_threshold is not None:
            # NaN/inf losses and watchdog spikes skip the update on the
            # card, as an fp16 overflow would
            found_inf = ~torch.isfinite(loss) | (loss > spike_threshold)
        # grads: a list in the order of tree_leaves(params)
        params, opt_state, stats = optimizer_step(
            params, grads, opt_state, tcfg, lr, weight_decay=wd,
            found_inf=found_inf, scaler=scaler)
        for p in leaves:
            p.grad = None
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step


def make_eval_step(model):
    """The eval step (JAX :344-357): the mean masked loss, no gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch["tokens"], batch["labels"],
                          loss_mask=batch.get("loss_mask"))

    return eval_step
