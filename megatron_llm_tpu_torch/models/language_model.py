"""Embedding + transformer + LM head (port of models/language_model.py).

Given a dropout stream, the forward splits it between the embedding's
hidden dropout and the layer stack (JAX :188-192).

Under tensor parallelism (parallel/mesh.py) the word embeddings and an
untied head hold this rank's vocabulary shard (parallel/sharding.py):
the embedding looks up the tokens its shard owns, zeroes the rest and
all-reduces, or under sequence parallelism reduce-scatters into the
rank's sequence shard; the head reads the full hidden states
(`tp_input`) and leaves its logits vocab-sharded for the vocab-parallel
cross entropy. The logits `language_model_forward` returns (scoring and
every cached decode path: the whole-batch route, the engine's rounds)
are gathered over the tp group to the whole padded vocabulary, as the
JAX package's GSPMD forward returns them, so every rank samples from
the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from megatron_llm_tpu_torch.models.dropout import dropout, hidden_site, split
from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.models.transformer import (
    init_layer_params,
    init_norm_params,
    normal,
    transformer_stack,
)
from megatron_llm_tpu_torch.parallel import overlap
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.parallel.mappings import (
    gather_from_tp_last,
    sequence_shard,
    tp_input,
    tp_output,
)
from megatron_llm_tpu_torch.parallel.mesh import get_context


def init_language_model_params(cfg, generator: torch.Generator,
                               device="cuda") -> dict:
    """Parameter tree with the JAX package's leaf names and layouts;
    values are drawn from `generator` (they do not reproduce jax.random)."""
    dt, std = cfg.params_dtype, cfg.init_method_std
    params = {
        "embedding": {"word_embeddings": normal(
            (cfg.padded_vocab_size, cfg.hidden_size), std, dt, generator,
            device)},
        "layers": init_layer_params(cfg, generator, device=device),
        "final_norm": init_norm_params(cfg, device=device),
    }
    if cfg.position_embedding_type == "absolute":
        params["embedding"]["position_embeddings"] = normal(
            (cfg.max_position_embeddings, cfg.hidden_size), std, dt,
            generator, device)
    if cfg.num_tokentypes > 0:
        # segment (tokentype) embeddings, (num_tokentypes, h) (JAX :48-56)
        params["embedding"]["tokentype_embeddings"] = normal(
            (cfg.num_tokentypes, cfg.hidden_size), std, dt, generator,
            device)
    if not cfg.tie_embed_logits:
        # untied head, (h, V)
        params["lm_head"] = normal((cfg.hidden_size, cfg.padded_vocab_size),
                                   std, dt, generator, device)
    return params


def embed_tokens(params: dict, cfg, tokens: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None,
                 dropout_seed=None,
                 tokentype_ids: Optional[torch.Tensor] = None,
                 ) -> torch.Tensor:
    """(b, s) int -> (b, s, h) in the compute dtype: word, learned
    position and (given `tokentype_ids`) tokentype embeddings summed,
    then hidden dropout under a dropout stream (JAX :69-88); under
    sequence parallelism the rank's (b, s / tp, h) shard."""
    emb = params["embedding"]["word_embeddings"]
    ctx = get_context()
    if ctx is None or ctx.tp == 1:
        hidden = emb[tokens].to(cfg.compute_dtype)
    else:
        # vocab-parallel: the rows this rank owns, zeros elsewhere, then
        # the sum over the tp group (exact: one rank holds each token)
        per = emb.shape[0]
        local = tokens.long() - ctx.tp_rank * per
        owned = (local >= 0) & (local < per)
        hidden = torch.where(owned[..., None],
                             emb[torch.where(owned, local, 0)], 0.0)
        hidden = tp_output(hidden.to(cfg.compute_dtype))
    if cfg.position_embedding_type == "absolute":
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None]
        pos = params["embedding"]["position_embeddings"]
        hidden = hidden + pos[sequence_shard(position_ids)].to(
            cfg.compute_dtype)
    if tokentype_ids is not None:
        tt = params["embedding"]["tokentype_embeddings"]
        hidden = hidden + tt[sequence_shard(tokentype_ids)].to(
            cfg.compute_dtype)
    return dropout(hidden, cfg.hidden_dropout,
                   hidden_site(dropout_seed, hidden.shape[1]))


def chunked_head_cross_entropy(params: dict, cfg, hidden: torch.Tensor,
                               labels: torch.Tensor,
                               chunk_size: int = 1024) -> torch.Tensor:
    """Per-token CE computed chunk by chunk over the sequence (JAX
    :94-147): (b, s) fp32 losses, the values of
    cross_entropy(lm_logits(...), labels). Each chunk's head matmul and CE
    run under a non-reentrant checkpoint, so only (b, chunk, V) fp32
    logits are live in the forward and in the backward. Sequences of at
    most `chunk_size` take the direct path; a chunk size that does not
    divide s halves toward the largest divisor >= 256 (JAX :126-131).
    Under tensor parallelism `hidden` is gathered first (`tp_input`) and
    each chunk's logits are this rank's vocabulary shard. Under context
    parallelism the direct path runs on the rank's sequence shard (JAX
    :126-134: its logits are already divided by cp)."""
    hidden = tp_input(hidden)
    b, s, h = hidden.shape
    if s > chunk_size:
        while chunk_size >= 256 and s % chunk_size != 0:
            chunk_size //= 2
    ctx = get_context()
    if (ctx is not None and ctx.cp > 1) or s % chunk_size != 0 \
            or s <= chunk_size:
        return vocab_parallel_cross_entropy(lm_logits(params, cfg, hidden),
                                            labels)

    def chunk_fn(hid_c, lbl_c):
        return vocab_parallel_cross_entropy(lm_logits(params, cfg, hid_c),
                                            lbl_c)

    losses = []
    for c in range(s // chunk_size):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        if torch.is_grad_enabled():
            losses.append(checkpoint(chunk_fn, hidden[:, sl], labels[:, sl],
                                     use_reentrant=False,
                                     preserve_rng_state=False))
        else:
            losses.append(chunk_fn(hidden[:, sl], labels[:, sl]))
    return torch.cat(losses, dim=1)


def lm_logits(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """Tied: x @ E^T; untied: x @ lm_head. In the compute dtype; under
    tensor parallelism `hidden` is whole and the logits this rank's
    vocabulary shard."""
    if cfg.tie_embed_logits:
        w = params["embedding"]["word_embeddings"].to(cfg.compute_dtype)
        return hidden @ w.T
    return hidden @ params["lm_head"].to(cfg.compute_dtype)


def language_model_forward(params: dict, cfg, tokens: torch.Tensor,
                           position_ids: Optional[torch.Tensor] = None,
                           attention_mask: Optional[torch.Tensor] = None,
                           kv_caches: Optional[dict] = None,
                           dropout_rng=None, deterministic: bool = True,
                           return_hidden: bool = False,
                           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full forward to logits; returns (logits, new_kv_caches).
    `dropout_rng` is a dropout stream (models/dropout.py), read unless
    `deterministic`. Under context parallelism `tokens` is the rank's
    sequence shard and `position_ids` its global positions, which the
    caller passes. `return_hidden` stops after the final norm and
    returns the (b, s, h) hidden states instead (the training loss
    projects to the vocabulary chunk by chunk, see
    chunked_head_cross_entropy). Under tensor parallelism the logits are
    gathered to the whole padded vocabulary on every rank."""
    ctx = get_context()
    if position_ids is None and kv_caches is None and ctx is not None \
            and ctx.cp > 1:
        raise ValueError(
            "at context_parallel_size > 1 the tokens are one sequence "
            "shard: pass its global position_ids")
    rope_table = None
    if cfg.position_embedding_type == "rotary":
        rope_table = precompute_rope(cfg.head_dim,
                                     cfg.max_position_embeddings,
                                     cfg.rope_theta, cfg.rope_scaling_factor,
                                     tokens.device)
    emb_s = stack_s = None
    if dropout_rng is not None and not deterministic:
        emb_s, stack_s = split(dropout_rng)
    overlap.before_embedding()
    hidden = embed_tokens(params, cfg, tokens, position_ids, emb_s)
    hidden, new_caches = transformer_stack(
        params["layers"], cfg, hidden, rope_table, attention_mask,
        position_ids, kv_caches, stack_s)
    hidden = apply_norm(hidden, params["final_norm"], cfg)
    if return_hidden:
        return hidden, new_caches
    logits = lm_logits(params, cfg, tp_input(hidden))
    return gather_from_tp_last(logits), new_caches
