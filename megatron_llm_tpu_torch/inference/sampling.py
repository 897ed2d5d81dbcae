"""Logit filters for sampling (port of inference/sampling.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e10  # the reference's masked_fill value


def modify_logits_for_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only the top-k logits of each row."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def modify_logits_for_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering with the reference's shift by one: the first
    token whose cumulative probability crosses top_p is kept. `top_p` is
    a float, or a (rows, 1) tensor of per-row thresholds (the engine's
    per-slot sampling)."""
    sorted_logits, sorted_indices = torch.sort(logits, dim=-1,
                                               descending=True)
    cum_probs = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    filt = cum_probs > top_p
    filt = torch.cat([torch.zeros_like(filt[..., :1]), filt[..., :-1]],
                     dim=-1)
    # back to vocab order
    filt = torch.zeros_like(filt).scatter(-1, sorted_indices, filt)
    return logits.masked_fill(filt, NEG_INF)
