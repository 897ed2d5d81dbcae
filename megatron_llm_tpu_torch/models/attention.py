"""GQA self-attention (port of models/attention.py).

Layout is (batch, seq, ...). GQA is computed grouped: q is
(b, s, groups, q_per_kv, d) against un-expanded k/v. The fused QKV weight
keeps the grouped layout [group g: q_g(0..qpk-1), k_g, v_g] along its
output dim.

Two branches of the JAX `attention_block` are ported: the no-cache branch
on the grouped einsum path (training-style full forward and scoring), and
the per-layer "k_gtd" KV-cache branch of the unrolled decode path, where a
single-token step runs decode kernel K1 and a prefill chunk the plain
masked softmax.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from megatron_llm_tpu_torch.models.rope import apply_rope
from megatron_llm_tpu_torch.ops.decode_attention import (
    _xla_decode,
    decode_attention,
)
from megatron_llm_tpu_torch.ops.quantization import qdot


def split_qkv(mixed: torch.Tensor, cfg):
    """(b, s, qkv_size) -> q (b,s,g,qpk,d), k (b,s,g,d), v (b,s,g,d)."""
    b, s, _ = mixed.shape
    g, qpk, d = cfg.num_query_groups, cfg.q_per_kv, cfg.head_dim
    qkv = mixed.reshape(b, s, g, qpk + 2, d)
    return qkv[:, :, :, :qpk], qkv[:, :, :, qpk], qkv[:, :, :, qpk + 1]


def causal_mask(s: int, t: Optional[int] = None, offset: int = 0,
                device="cuda") -> torch.Tensor:
    """(s, t) bool mask, True = masked out."""
    t = t if t is not None else s
    rows = torch.arange(s, device=device)[:, None] + offset
    cols = torch.arange(t, device=device)[None, :]
    return cols > rows


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor], cfg) -> torch.Tensor:
    """q (b,s,g,qpk,d), k/v (b,t,g,d); mask (s, t) or (b, 1, s, t), True =
    masked. Scores and softmax in fp32, probabilities cast to v's dtype
    before the PV product. Returns (b, s, g*qpk*d)."""
    b, s, g, qpk, d = q.shape
    scores = torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
        scores = scores.masked_fill(m, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bgqst,btgd->bsgqd", probs, v)
    return ctx.reshape(b, s, g * qpk * d)


def attention_block(attn_params: dict, cfg, hidden: torch.Tensor,
                    rope_table: Optional[torch.Tensor],
                    mask: Optional[torch.Tensor],
                    position_ids: Optional[torch.Tensor],
                    kv_cache: Optional[dict] = None,
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """qkv projection -> RoPE -> (cached) attention -> output projection.

    `kv_cache`, when given, is this layer's {"k_gtd": (b, g, T, d),
    "v_gtd": ..., "offset": int}; the step's K/V columns are written into
    it in place (the preallocated cache is the only copy, where the JAX
    package returned an updated array), and the returned cache dict holds
    the same tensors with the offset advanced."""
    b, s, _ = hidden.shape
    dt = cfg.compute_dtype
    mixed = qdot(hidden, attn_params["wqkv"], dt)
    if "bqkv" in attn_params:
        mixed = mixed + attn_params["bqkv"].to(dt)
    q, k, v = split_qkv(mixed, cfg)

    if kv_cache is not None:
        offset = int(kv_cache["offset"])
        if position_ids is None:
            position_ids = offset + torch.arange(s, device=hidden.device)[None]
        if rope_table is not None:
            q = apply_rope(q, rope_table, position_ids)
            k = apply_rope(k, rope_table, position_ids)
        kc, vc = kv_cache["k_gtd"], kv_cache["v_gtd"]
        kc[:, :, offset:offset + s].copy_(k.transpose(1, 2))
        vc[:, :, offset:offset + s].copy_(v.transpose(1, 2))
        new_cache = {"k_gtd": kc, "v_gtd": vc, "offset": offset + s}
        if s == 1 and cfg.use_decode_attn:
            ctx = decode_attention(q, kc, vc, offset + s)
        else:
            ctx = _xla_decode(q, kc, vc, offset + s)
        ctx = ctx.reshape(b, s, -1)
    else:
        if rope_table is not None:
            q = apply_rope(q, rope_table, position_ids)
            k = apply_rope(k, rope_table, position_ids)
        if mask is None:
            mask = causal_mask(s, device=hidden.device)
        ctx = grouped_attention(q, k, v, mask, cfg)
        new_cache = None

    out = qdot(ctx, attn_params["wo"], dt)
    if "bo" in attn_params:
        out = out + attn_params["bo"].to(dt)
    return out, new_cache
