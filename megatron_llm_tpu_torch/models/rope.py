"""Rotary position embeddings, Meta-Llama interleaved pairs (port of
models/rope.py).

Pairs are adjacent elements (x[2i], x[2i+1]), not the half-split layout.
The (cos, sin) table and the rotation are computed in fp32 and the result
is cast back to x's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch


@functools.lru_cache(maxsize=8)
def precompute_rope(head_dim: int, max_len: int, theta: float = 10000.0,
                    scaling_factor: float = 1.0,
                    device: str = "cuda") -> torch.Tensor:
    """(max_len, head_dim // 2, 2) fp32 table of (cos, sin). Cached: the
    table depends only on its arguments."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device) \
        / scaling_factor
    freqs = torch.outer(t, inv_freq)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, rope: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate x of shape (batch, seq, *head_dims, head_dim), seq at axis
    1. `position_ids` (batch, seq) selects table rows, default arange."""
    seq = x.shape[1]
    n_mid = x.dim() - 3
    cs = rope[:seq][None] if position_ids is None else rope[position_ids]
    cs = cs.reshape(cs.shape[0], seq, *((1,) * n_mid), -1, 2)
    cos, sin = cs[..., 0], cs[..., 1]
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
