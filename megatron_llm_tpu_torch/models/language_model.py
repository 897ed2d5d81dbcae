"""Embedding + transformer + LM head (port of models/language_model.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.models.transformer import (
    init_layer_params,
    init_norm_params,
    normal,
    transformer_stack,
)


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
    if not cfg.tie_embed_logits:
        # untied head, (h, V)
        params["lm_head"] = normal((cfg.hidden_size, cfg.padded_vocab_size),
                                   std, dt, generator, device)
    return params


def embed_tokens(params: dict, cfg, tokens: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, s) int -> (b, s, h) in the compute dtype."""
    emb = params["embedding"]["word_embeddings"]
    hidden = emb[tokens].to(cfg.compute_dtype)
    if cfg.position_embedding_type == "absolute":
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None]
        pos = params["embedding"]["position_embeddings"]
        hidden = hidden + pos[position_ids].to(cfg.compute_dtype)
    return hidden


def lm_logits(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """Tied: x @ E^T; untied: x @ lm_head. In the compute dtype."""
    if cfg.tie_embed_logits:
        w = params["embedding"]["word_embeddings"].to(cfg.compute_dtype)
        return hidden @ w.T
    return hidden @ params["lm_head"].to(cfg.compute_dtype)


def language_model_forward(params: dict, cfg, tokens: torch.Tensor,
                           position_ids: Optional[torch.Tensor] = None,
                           attention_mask: Optional[torch.Tensor] = None,
                           kv_caches: Optional[dict] = None,
                           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full forward to logits; returns (logits, new_kv_caches)."""
    rope_table = None
    if cfg.position_embedding_type == "rotary":
        rope_table = precompute_rope(cfg.head_dim,
                                     cfg.max_position_embeddings,
                                     cfg.rope_theta, cfg.rope_scaling_factor,
                                     tokens.device)
    hidden = embed_tokens(params, cfg, tokens, position_ids)
    hidden, new_caches = transformer_stack(
        params["layers"], cfg, hidden, rope_table, attention_mask,
        position_ids, kv_caches)
    hidden = apply_norm(hidden, params["final_norm"], cfg)
    return lm_logits(params, cfg, hidden), new_caches
