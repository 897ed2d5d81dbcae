"""GQA self-attention (port of models/attention.py).

Layout is (batch, seq, ...). GQA is computed grouped: q is
(b, s, groups, q_per_kv, d) against un-expanded k/v. The fused QKV weight
keeps the grouped layout [group g: q_g(0..qpk-1), k_g, v_g] along its
output dim.

Three branches of the JAX `attention_block` are ported: the no-cache
branch (training and scoring), which takes the flash kernels K4-K6
(ops/flash_attention.py) under the JAX package's condition (no mask, no
live attention dropout: JAX :472-475, :519) and the grouped einsum path,
with attention dropout on its probabilities, otherwise, and under
context parallelism (cp > 1) always the ring (parallel/ring_attention.py:
K4-K6 hop by hop, or the plain masked hop for packed documents), which
refuses a dense mask and live attention dropout as the JAX package does
(:476-512); the per-layer
"k_gtd" KV-cache branch of the unrolled decode path, where a
single-token step runs decode kernel K1 and a prefill chunk the plain
masked softmax; the stacked-cache branch of the pipeline's serving ring
(JAX :412-452), the same with the layer's (b, T, g, d) slice of a
stacked cache, which K1 reads in place in its "tgd" layout, with no
transpose; and the paged branch of the continuous-batching engine,
where every phase (decode rows, mixed prefill+decode rounds) goes
through the ragged paged attention of ops/prefill_attention.py (K7).

Under tensor parallelism (parallel/mesh.py) wqkv is column-parallel in
the grouped layout, so a rank holds g / tp whole groups and K4-K6 run at
that group count, and wo is row-parallel: the block reads the full
input (`tp_input`: a copy, or under sequence parallelism an all-gather
of the sequence shards) and sums its output over the tp group
(`tp_output`: an all-reduce, or a reduce-scatter into sequence shards)
before the output bias. The cached branches (serving) run at tp = 1.

The cached branches never take the ring: generation at cp > 1 runs the
one-rank route on every cp rank, whose parameters are whole.

The save points of models/remat.py are the JAX package's: the fused
QKV projection "qkv_proj", the attention context "attn_ctx" (the
grouped path's PV product; the flash forward tags its o and lse itself)
and the output projection "attn_dense".
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from megatron_llm_tpu_torch.models.dropout import dropout
from megatron_llm_tpu_torch.models.remat import tag
from megatron_llm_tpu_torch.models.rope import apply_rope
from megatron_llm_tpu_torch.ops.decode_attention import (
    _xla_decode,
    decode_attention,
)
from megatron_llm_tpu_torch.ops.flash_attention import flash_attention
from megatron_llm_tpu_torch.ops.prefill_attention import (
    ragged_paged_attention,
)
from megatron_llm_tpu_torch.ops.quantization import qdot
from megatron_llm_tpu_torch.parallel.mappings import tp_input, tp_output
from megatron_llm_tpu_torch.parallel.mesh import A4_TP_SERVING, get_context
from megatron_llm_tpu_torch.parallel.ring_attention import (
    ring_self_attention,
)


def split_qkv(mixed: torch.Tensor, cfg):
    """(b, s, qkv_size) -> q (b,s,g,qpk,d), k (b,s,g,d), v (b,s,g,d), g
    the groups `mixed` holds (a tp rank's g / tp)."""
    b, s, width = mixed.shape
    qpk, d = cfg.q_per_kv, cfg.head_dim
    g = width // ((qpk + 2) * d)
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
                      mask: Optional[torch.Tensor], cfg,
                      dropout_seed=None) -> torch.Tensor:
    """q (b,s,g,qpk,d), k/v (b,t,g,d); mask (s, t) or (b, 1, s, t), True =
    masked. Scores and softmax in fp32; with a dropout stream the
    probabilities take attention dropout (JAX :131-158); then they are
    cast to v's dtype before the PV product. Returns (b, s, g*qpk*d)."""
    b, s, g, qpk, d = q.shape
    scores = torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
        scores = scores.masked_fill(m, neg)
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, cfg.attention_dropout, dropout_seed).to(v.dtype)
    with tag("attn_ctx"):
        ctx = torch.einsum("bgqst,btgd->bsgqd", probs, v)
    return ctx.reshape(b, s, g * qpk * d)


def attention_block(attn_params: dict, cfg, hidden: torch.Tensor,
                    rope_table: Optional[torch.Tensor],
                    mask: Optional[torch.Tensor],
                    position_ids: Optional[torch.Tensor],
                    kv_cache: Optional[dict] = None,
                    dropout_seed=None,
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """qkv projection -> RoPE -> (cached) attention -> output projection.
    `dropout_seed` (models/dropout.py; None when deterministic) drives
    attention dropout on the no-cache branch.

    `kv_cache`, when given, is this layer's cache in one of two forms:
    - dense {"k_gtd": (b, g, T, d), "v_gtd": ..., "offset": an int or
      a 0-d integer tensor on the cache's device}: the step's K/V
      columns are written into it in place (the preallocated
      cache is the only copy, where the JAX package returned an updated
      array), and the returned dict holds the same tensors with the
      offset advanced; {"k_tgd": (b, T, g, d), ...} is the same in the
      stacked layout, a layer's slice of the ring's stacked cache;
    - paged {"k_pages": (P, page_size, g, d), "v_pages": ...,
      "page_table": (slots, max_pages) int32, "lengths": (slots,) int32,
      optionally "chunk_lens": (slots,) int32, "doc_starts": (slots,)
      int32 document floors, and for int8 pools "k_scales" /
      "v_scales" (P, page_size, g) fp32}: the batch axis is slots;
      slot i contributes chunk_lens[i] tokens (<= s; 0 = idle) at cache
      positions lengths[i] + t, scattered into its pages in place and
      attended in one ragged pass, within `cfg.attention_window_size`
      when it is set. Without "chunk_lens" every slot is a width-1
      decode row (s == 1). The returned dict has lengths + chunk_lens.
      Nothing here reads a device value on the host."""
    if kv_cache is not None:
        ctx = get_context()
        if ctx is not None and ctx.tp > 1:
            raise ValueError(f"tensor-parallel serving is not ported yet "
                             f"({A4_TP_SERVING})")
    hidden = tp_input(hidden)
    b, s, _ = hidden.shape
    dt = cfg.compute_dtype
    with tag("qkv_proj"):
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
        # int8 pools carry their scale pools; the window comes from the
        # model config and "doc_starts" (packed-document floors) is a
        # cache key like "chunk_lens", absent from the engine's rounds
        doc_starts = kv_cache.get("doc_starts")
        res = ragged_paged_attention(
            q, k, v, kv_cache["k_pages"], kv_cache["v_pages"],
            kv_cache["page_table"], lengths, chunk_lens,
            use_kernel=cfg.use_decode_attn,
            k_scales=kv_cache.get("k_scales"),
            v_scales=kv_cache.get("v_scales"),
            window_size=cfg.attention_window_size, doc_starts=doc_starts)
        ctx = res[0]
        new_cache = {"k_pages": res[1], "v_pages": res[2],
                     "page_table": kv_cache["page_table"],
                     "lengths": lengths + chunk_lens}
        if len(res) == 5:
            new_cache["k_scales"], new_cache["v_scales"] = res[3], res[4]
        if chunked:
            new_cache["chunk_lens"] = chunk_lens
        if doc_starts is not None:
            new_cache["doc_starts"] = doc_starts
        ctx = ctx.reshape(b, s, -1)
    elif kv_cache is not None:
        # a host int, or a 0-d tensor on the card (a captured decode step
        # replays at any offset): JAX's dynamic_update_slice at a traced
        # offset becomes a column write at device positions
        offset = kv_cache["offset"]
        if not isinstance(offset, torch.Tensor):
            offset = int(offset)
        cols = offset + torch.arange(s, device=hidden.device)
        if position_ids is None:
            position_ids = cols[None]
        if rope_table is not None:
            q = apply_rope(q, rope_table, position_ids)
            k = apply_rope(k, rope_table, position_ids)
        layout = "tgd" if "k_tgd" in kv_cache else "gtd"
        kc, vc = kv_cache["k_" + layout], kv_cache["v_" + layout]
        if layout == "tgd":
            kc.index_copy_(1, cols, k.to(kc.dtype))
            vc.index_copy_(1, cols, v.to(vc.dtype))
        else:
            kc.index_copy_(2, cols, k.transpose(1, 2).to(kc.dtype))
            vc.index_copy_(2, cols, v.transpose(1, 2).to(vc.dtype))
        new_cache = {"k_" + layout: kc, "v_" + layout: vc,
                     "offset": offset + s}
        length = offset + s
        if isinstance(length, torch.Tensor):
            length = length.to(torch.int32)
        if s == 1 and cfg.use_decode_attn:
            ctx = decode_attention(q, kc, vc, length, layout=layout)
        else:
            ctx = _xla_decode(q, kc, vc, length, layout=layout)
        ctx = ctx.reshape(b, s, -1)
    else:
        if rope_table is not None:
            q = apply_rope(q, rope_table, position_ids)
            k = apply_rope(k, rope_table, position_ids)
        # packed documents arrive as {"doc_start": (b, s)}; on one card it
        # expands to its dense form (JAX :513-518)
        doc_start = None
        if isinstance(mask, dict):
            doc_start = mask["doc_start"]
            mask = None
        # the flash kernels have no dropout: live attention dropout takes
        # the grouped path (JAX :472-475, :519)
        no_dropout = dropout_seed is None or cfg.attention_dropout == 0.0
        pctx = get_context()
        ring = pctx is not None and pctx.cp > 1
        if ring and mask is not None:
            raise ValueError(
                "cp>1 with a dense attention mask: pass packed-document "
                "masks as {'doc_start': (b, s)} (utils/masks.py "
                "get_document_starts) to keep the sequence sharded, or "
                "disable context parallelism for this model. "
                "BERT/T5-style PADDING masks have no doc_start "
                "equivalent — those model families must run with cp=1 "
                "(rejected at config construction on the CLI path; "
                "docs/GUIDE.md 'Masks')")
        if ring and not no_dropout:
            raise ValueError(
                "cp>1 attention requires attention_dropout == 0 (ring "
                "attention has no dropout path)")
        if doc_start is not None and not ring:
            rows = torch.arange(s, device=hidden.device)[None, :, None]
            cols = torch.arange(s, device=hidden.device)[None, None, :]
            mask = ((cols > rows) | (cols < doc_start[:, :, None]))[:, None]
        if ring:
            # RoPE above rotated q and k by their global positions
            ctx = ring_self_attention(q, k, v, causal=True,
                                      doc_start=doc_start,
                                      ctx=pctx).reshape(b, s, -1)
        elif cfg.use_flash_attn and mask is None and no_dropout:
            ctx = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
        else:
            if mask is None:
                mask = causal_mask(s, device=hidden.device)
            ctx = grouped_attention(q, k, v, mask, cfg, dropout_seed)
        new_cache = None

    with tag("attn_dense"):
        out = qdot(ctx, attn_params["wo"], dt)
    out = tp_output(out)
    if "bo" in attn_params:
        out = out + attn_params["bo"].to(dt)
    return out, new_cache
