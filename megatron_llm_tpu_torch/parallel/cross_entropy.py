"""Cross entropy, whole or over vocabulary shards (port of
parallel/cross_entropy.py).

At tp = 1 the vocab-parallel CE is `cross_entropy`, label smoothing
included (JAX :29-50). Over tp ranks each holding (..., V / tp) logits it
is the JAX package's explicit `_ce_shard` (:53-81), collective for
collective: the max all-reduced (no gradient flows through the shift),
the sum of exponentials all-reduced, the target logit taken from the
rank whose shard holds it and all-reduced, and under label smoothing
the sum of the shifted logits all-reduced. Each sum rides
`reduce_from_tp`, whose backward is the identity: every rank computes
the same loss, and its backward reaches that rank's shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.parallel.mappings import reduce_from_tp
from megatron_llm_tpu_torch.parallel.mesh import all_reduce, get_context


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token CE in fp32 over the last (vocab) axis; the max shift
    carries no gradient, as in the JAX package."""
    logits = logits.float()
    logits_max = logits.max(dim=-1, keepdim=True).values
    shifted = logits - logits_max.detach()
    log_z = torch.log(torch.exp(shifted).sum(dim=-1))
    target_logit = shifted.gather(-1, targets[..., None].long())[..., 0]
    loss = log_z - target_logit
    if label_smoothing > 0.0:
        vocab = logits.shape[-1]
        smoothing = label_smoothing * vocab / (vocab - 1)
        mean_log_prob = shifted.mean(dim=-1) - log_z
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


def _ce_shard(logits, targets, ctx, label_smoothing):
    logits = logits.float()
    per = logits.shape[-1]
    gmax = all_reduce(logits.detach().max(dim=-1).values, ctx.tp_group,
                      op=dist.ReduceOp.MAX, ctx=ctx)
    shifted = logits - gmax[..., None]
    log_z = torch.log(reduce_from_tp(torch.exp(shifted).sum(dim=-1)))
    local = targets.long() - ctx.tp_rank * per
    in_range = (local >= 0) & (local < per)
    picked = shifted.gather(-1, torch.where(in_range, local, 0)[..., None])
    target_logit = reduce_from_tp(
        torch.where(in_range, picked[..., 0], 0.0))
    loss = log_z - target_logit
    if label_smoothing > 0.0:
        vocab = per * ctx.tp
        smoothing = label_smoothing * vocab / (vocab - 1)
        mean_log_prob = reduce_from_tp(shifted.sum(dim=-1)) / vocab - log_z
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """CE of logits whose last axis is this rank's vocabulary shard (JAX
    :84-106); `cross_entropy` without a context or at tp = 1."""
    ctx = get_context()
    if ctx is None or ctx.tp == 1:
        return cross_entropy(logits, targets, label_smoothing)
    return _ce_shard(logits, targets, ctx, label_smoothing)
