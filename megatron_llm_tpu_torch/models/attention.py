"""GQA self-attention (port of models/attention.py).

Layout is (batch, seq, ...). GQA is computed grouped: q is
(b, s, groups, q_per_kv, d) against un-expanded k/v. The fused QKV weight
keeps the grouped layout [group g: q_g(0..qpk-1), k_g, v_g] along its
output dim.

Three branches of the JAX `attention_block` are ported: the no-cache
branch on the grouped einsum path (training-style full forward and
scoring); the per-layer "k_gtd" KV-cache branch of the unrolled decode
path, where a single-token step runs decode kernel K1 and a prefill chunk
the plain masked softmax; and the paged branch of the continuous-batching
engine, where every phase (decode rows, mixed prefill+decode rounds) goes
through the ragged paged attention of ops/prefill_attention.py (K7).
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
from megatron_llm_tpu_torch.ops.prefill_attention import (
    ragged_paged_attention,
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

    `kv_cache`, when given, is this layer's cache in one of two forms:
    - dense {"k_gtd": (b, g, T, d), "v_gtd": ..., "offset": int}: the
      step's K/V columns are written into it in place (the preallocated
      cache is the only copy, where the JAX package returned an updated
      array), and the returned dict holds the same tensors with the
      offset advanced;
    - paged {"k_pages": (P, page_size, g, d), "v_pages": ...,
      "page_table": (slots, max_pages) int32, "lengths": (slots,) int32,
      optionally "chunk_lens": (slots,) int32}: the batch axis is slots;
      slot i contributes chunk_lens[i] tokens (<= s; 0 = idle) at cache
      positions lengths[i] + t, scattered into its pages in place and
      attended in one ragged pass. Without "chunk_lens" every slot is a
      width-1 decode row (s == 1). The returned dict has
      lengths + chunk_lens. Nothing here reads a device value on the
      host."""
    b, s, _ = hidden.shape
    dt = cfg.compute_dtype
    mixed = qdot(hidden, attn_params["wqkv"], dt)
    if "bqkv" in attn_params:
        mixed = mixed + attn_params["bqkv"].to(dt)
    q, k, v = split_qkv(mixed, cfg)

    if kv_cache is not None and "k_pages" in kv_cache:
        lengths = kv_cache["lengths"]
        chunked = "chunk_lens" in kv_cache
        if chunked:
            chunk_lens = kv_cache["chunk_lens"]
        else:
            if s != 1:
                raise ValueError("a paged KV cache without chunk_lens serves "
                                 "single-token decode steps")
            chunk_lens = torch.ones_like(lengths)
        if position_ids is None:
            position_ids = lengths.long()[:, None] \
                + torch.arange(s, device=hidden.device)[None, :]
        if rope_table is not None:
            # pad rows of a wide chunk may sit past the table; JAX's
            # gather clamps such indices, and no valid row is affected
            position_ids = position_ids.clamp(max=rope_table.shape[0] - 1)
            q = apply_rope(q, rope_table, position_ids)
            k = apply_rope(k, rope_table, position_ids)
        ctx, kp, vp = ragged_paged_attention(
            q, k, v, kv_cache["k_pages"], kv_cache["v_pages"],
            kv_cache["page_table"], lengths, chunk_lens,
            use_kernel=cfg.use_decode_attn)
        new_cache = {"k_pages": kp, "v_pages": vp,
                     "page_table": kv_cache["page_table"],
                     "lengths": lengths + chunk_lens}
        if chunked:
            new_cache["chunk_lens"] = chunk_lens
        ctx = ctx.reshape(b, s, -1)
    elif kv_cache is not None:
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
