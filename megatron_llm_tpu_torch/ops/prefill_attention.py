"""Dense masked-softmax attention core (port of ops/prefill_attention.py
`_xla_attend`).

Only the dense core is ported in this slice; the ragged paged kernel of
the JAX module belongs to the continuous-batching engine.
"""

from __future__ import annotations

import math

import torch


def _xla_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                row_pos: torch.Tensor) -> torch.Tensor:
    """q (b, s, g, qpk, d) against dense k/v (b, g, T, d). `row_pos`
    (rows,) is the last attendable cache position of each folded
    (position, head) row, head fastest. Scores in fp32, masked with the
    fp32 minimum (not -inf), probabilities normalised then cast to v's
    dtype before the PV product. Returns (b, s, g, qpk, d) in v's dtype."""
    b, s, g, qpk, d = q.shape
    T = k.shape[2]
    qb = q.permute(0, 2, 1, 3, 4).reshape(b, g, s * qpk, d)
    scores = torch.matmul(qb.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))  # (b, g, rows, T)
    cols = torch.arange(T, device=q.device)
    mask = cols[None, :] > row_pos[:, None]
    scores = scores.masked_fill(mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)  # (b, g, rows, d)
    return out.reshape(b, g, s, qpk, d).permute(0, 2, 1, 3, 4)
