"""Cross entropy at tensor parallel size 1 (port of
parallel/cross_entropy.py).

The JAX package computes the vocab-parallel CE once in jnp and lets GSPMD
insert the reductions across vocab shards; on one card the same math is
`cross_entropy`, label smoothing included (JAX :29-50). The vocab-sharded
form belongs to the parallelism slice (ROADMAP.md A4).
"""

from __future__ import annotations

import torch


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


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """At tp = 1 the vocab-parallel CE is `cross_entropy` (JAX :84-97)."""
    return cross_entropy(logits, targets, label_smoothing)
