"""T5: the encoder-decoder of span-corruption pretraining (port of
models/t5.py).

The encoder is BERT's stack without tokentypes (`transformer_stack`
under the padding mask, then `final_norm`). A decoder layer is three
pre-norm residual blocks (JAX :1-19):

    h = h + self_attn(input_norm(h))          (causal x padding mask)
    h = h + cross_attn(post_attention_norm(h), encoder_out)
    h = h + mlp(post_cross_norm(h))

The word embeddings are shared by both sides and tie the logits, which
add a vocabulary bias `lm_head_bias`; both sides have learned absolute
positions. As in the JAX package the model holds the config and the
parameters are a separate tree with the JAX leaf names: the encoder's
(`embedding`, `layers`, `final_norm`), `decoder_layers` (the shared
layer leaves plus `cross_attention` {wq, wkv, wo, bq, bkv, bo} and
`post_cross_norm`), `decoder_final_norm` and `lm_head_bias`.

Masks arrive as (b, s) keep vectors; the (b, 1, s, t) forms are built
here (JAX :188-193). Every attention carries a dense mask, so it takes
the grouped path and never the flash kernels, and the norms are
LayerNorm: this model launches none of K1-K7, as the JAX T5 reaches no
`pallas_call`.

Dropout follows the port's derived streams (models/dropout.py): the
forward splits its stream four ways (the encoder's embedding and stack,
the decoder's embedding and stack, JAX :170), and decoder layer i folds
the decoder's stream with i and splits it three ways (self-attention,
cross-attention, the MLP's, which draws nothing, JAX :91-92). The
decoder has attention dropout only, as in the JAX package. Each decoder
layer runs under the recompute policy (models/remat.py), whatever
`recompute_method` says, as the JAX scan does (JAX :113-119); a
recomputed layer derives the same seeds and redraws the same masks.

Under tensor and sequence parallelism both stacks are BERT's
(models/bert.py): column/row-parallel attention and MLP, the norms and
dropout on each side's own sequence shard. The cross-attention's wq and
wkv are column-parallel and wo row-parallel; every decoder layer reads
the whole encoder output, gathered once over the tp group (`tp_input`:
an all-gather of the encoder's sequence shards under sequence
parallelism, whose backward reduce-scatters the layers' summed
gradient). The logits are the rank's vocabulary shard plus its
`lm_head_bias` shard, into the vocab-parallel cross entropy;
`loss_terms` gives a data-parallel rank its masked decoder-token sum
and count. Pipeline and context parallelism are refused, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.models.attention import (
    attention_block,
    cross_attention_block,
    padding_mask_2d,
)
from megatron_llm_tpu_torch.models.dropout import fold_in, split
from megatron_llm_tpu_torch.models.language_model import (
    embed_tokens,
    init_language_model_params,
)
from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.models.remat import remat_wrap
from megatron_llm_tpu_torch.models.transformer import (
    init_layer_params,
    init_norm_params,
    mlp_block,
    normal,
    transformer_stack,
    unstack_layers,
)
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.parallel.mappings import (
    gather_from_tp_last,
    tp_input,
)


def init_decoder_layer_params(cfg, generator: torch.Generator,
                              num_layers: Optional[int] = None,
                              device="cuda") -> dict:
    """Stacked decoder layers: the shared layer leaves plus
    `cross_attention` (wq (L, h, g*qpk*d), the fused wkv (L, h, g*2*d),
    wo (L, g*qpk*d, h) at std / sqrt(2 num_layers) under scaled init;
    zero biases under `use_bias`) and a third norm, `post_cross_norm`."""
    L = num_layers if num_layers is not None else cfg.num_layers
    layers = init_layer_params(cfg, generator, num_layers=L, device=device)
    h, d = cfg.hidden_size, cfg.head_dim
    g, qpk = cfg.num_query_groups, cfg.q_per_kv
    std, dt = cfg.init_method_std, cfg.params_dtype
    out_std = std / math.sqrt(2.0 * cfg.num_layers) \
        if cfg.use_scaled_init_method else std
    cross = {
        "wq": normal((L, h, g * qpk * d), std, dt, generator, device),
        "wkv": normal((L, h, g * 2 * d), std, dt, generator, device),
        "wo": normal((L, g * qpk * d, h), out_std, dt, generator, device),
    }
    if cfg.use_bias:
        for name, width in (("bq", g * qpk * d), ("bkv", g * 2 * d),
                            ("bo", h)):
            cross[name] = torch.zeros((L, width), dtype=dt, device=device)
    layers["cross_attention"] = cross
    layers["post_cross_norm"] = init_norm_params(cfg, (L,), device)
    return layers


def decoder_stack(layer_params: dict, cfg, hidden: torch.Tensor,
                  encoder_output: torch.Tensor, self_mask: torch.Tensor,
                  cross_mask: torch.Tensor, dropout_seed=None
                  ) -> torch.Tensor:
    """The decoder layers in order (JAX :82-124): `self_mask` (b, 1, s, s)
    and `cross_mask` (b, 1, s, t), True = masked; `dropout_seed` the
    decoder stack's stream (None when deterministic)."""

    def body(p, x, i):
        r_self = r_cross = None
        if dropout_seed is not None:
            # the third site is the MLP's, which has no dropout
            r_self, r_cross, _ = split(fold_in(dropout_seed, i), 3)
        normed = apply_norm(x, p["input_norm"], cfg)
        attn_out, _ = attention_block(p["attention"], cfg, normed, None,
                                      self_mask, None, None, r_self)
        x = x + attn_out
        normed = apply_norm(x, p["post_attention_norm"], cfg)
        x = x + cross_attention_block(p["cross_attention"], cfg, normed,
                                      encoder_output, cross_mask, r_cross)
        normed = apply_norm(x, p["post_cross_norm"], cfg)
        return x + mlp_block(p["mlp"], cfg, normed)

    body = remat_wrap(body, cfg.resolved_remat_policy)
    for i, p in enumerate(unstack_layers(layer_params)):
        hidden = body(p, hidden, i)
    return hidden


class T5Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.position_embedding_type != "absolute":
            raise ValueError("T5 uses learned absolute positions")
        if not cfg.tie_embed_logits:
            raise ValueError("T5's LM head ties to the word embeddings")
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, seed: int = 0) -> dict:
        """Random weights on `self.device`, drawn from a torch.Generator
        seeded with `seed` (they do not reproduce jax.random)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._init(gen, self.device)

    def abstract_params(self) -> dict:
        """The parameter tree as meta tensors, with no storage."""
        return self._init(None, "meta")

    def _init(self, gen, device) -> dict:
        cfg = self.cfg
        params = init_language_model_params(cfg, gen, device)
        params["decoder_layers"] = init_decoder_layer_params(
            cfg, gen, device=device)
        params["decoder_final_norm"] = init_norm_params(cfg, device=device)
        params["lm_head_bias"] = torch.zeros(
            (cfg.padded_vocab_size,), dtype=cfg.params_dtype, device=device)
        return params

    def forward(self, params: dict, encoder_input_ids: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                encoder_attn_mask: Optional[torch.Tensor] = None,
                decoder_attn_mask: Optional[torch.Tensor] = None,
                dropout_rng=None, deterministic: bool = True,
                enc_hidden_states: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(LM logits (b, s_d, V), encoder output (b, s_e, h)), in the
        compute dtype (JAX :148-207); under tensor parallelism the logits
        gathered to the whole padded vocabulary, and under sequence
        parallelism the encoder output the rank's sequence shard. The
        masks are (b, s) keep vectors, all ones when None;
        `enc_hidden_states` stands in for the encoder's output (the
        encoder does not run)."""
        logits, enc_out = self._logits(
            params, encoder_input_ids, decoder_input_ids, encoder_attn_mask,
            decoder_attn_mask, dropout_rng, deterministic, enc_hidden_states)
        return gather_from_tp_last(logits), enc_out

    def _logits(self, params, encoder_input_ids, decoder_input_ids,
                encoder_attn_mask, decoder_attn_mask, dropout_rng,
                deterministic, enc_hidden_states=None):
        """`forward` with the logits this rank's vocabulary shard."""
        cfg = self.cfg
        b, s_e = encoder_input_ids.shape
        s_d = decoder_input_ids.shape[1]
        dev = decoder_input_ids.device
        if encoder_attn_mask is None:
            encoder_attn_mask = torch.ones((b, s_e), dtype=torch.int32,
                                           device=dev)
        if decoder_attn_mask is None:
            decoder_attn_mask = torch.ones((b, s_d), dtype=torch.int32,
                                           device=dev)
        r_enc_e = r_enc = r_dec_e = r_dec = None
        if dropout_rng is not None and not deterministic:
            r_enc_e, r_enc, r_dec_e, r_dec = split(dropout_rng, 4)

        if enc_hidden_states is None:
            enc_h = embed_tokens(params, cfg, encoder_input_ids, None,
                                 r_enc_e)
            enc_h, _ = transformer_stack(
                params["layers"], cfg, enc_h, None,
                padding_mask_2d(encoder_attn_mask), None, None, r_enc)
            enc_out = apply_norm(enc_h, params["final_norm"], cfg)
        else:
            enc_out = enc_hidden_states

        # the decoder's self mask: the padding keep-product times the
        # causal triangle, masked below 0.5 (JAX :188-192)
        causal = torch.tril(torch.ones((s_d, s_d), dtype=torch.float32,
                                       device=dev))
        dec_keep = decoder_attn_mask.float()
        self_keep = dec_keep[:, :, None] * dec_keep[:, None, :] * causal
        self_mask = (self_keep < 0.5)[:, None]
        cross_mask = padding_mask_2d(decoder_attn_mask, encoder_attn_mask)

        dec_h = embed_tokens(params, cfg, decoder_input_ids, None, r_dec_e)
        # the cross-attention's K/V read the whole encoder output
        dec_h = decoder_stack(params["decoder_layers"], cfg, dec_h,
                              tp_input(enc_out), self_mask, cross_mask,
                              r_dec)
        dec_h = apply_norm(dec_h, params["decoder_final_norm"], cfg)
        dt = cfg.compute_dtype
        emb = params["embedding"]["word_embeddings"].to(dt)
        logits = tp_input(dec_h) @ emb.T + params["lm_head_bias"].to(dt)
        return logits, enc_out

    def loss_terms(self, params: dict, encoder_input_ids: torch.Tensor,
                   decoder_input_ids: torch.Tensor, lm_labels: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None,
                   encoder_attn_mask: Optional[torch.Tensor] = None,
                   decoder_attn_mask: Optional[torch.Tensor] = None,
                   dropout_rng=None, deterministic: bool = True):
        """`loss` as (numerator, denominator), the masked sum of the
        decoder tokens' cross entropy over this rank's rows and their
        mask count, so that the data-parallel ranks rebuild the global
        batch's token mean."""
        logits, _ = self._logits(params, encoder_input_ids,
                                 decoder_input_ids, encoder_attn_mask,
                                 decoder_attn_mask, dropout_rng,
                                 deterministic)
        losses = vocab_parallel_cross_entropy(logits, lm_labels)
        lm = torch.ones_like(losses) if loss_mask is None \
            else loss_mask.float()
        return (losses * lm).sum(), lm.sum()

    def loss(self, params: dict, encoder_input_ids: torch.Tensor,
             decoder_input_ids: torch.Tensor, lm_labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             encoder_attn_mask: Optional[torch.Tensor] = None,
             decoder_attn_mask: Optional[torch.Tensor] = None,
             dropout_rng=None, deterministic: bool = True) -> torch.Tensor:
        """The masked mean of the cross entropy over decoder positions, a
        0-d fp32 tensor (JAX :209-231)."""
        num, den = self.loss_terms(params, encoder_input_ids,
                                   decoder_input_ids, lm_labels, loss_mask,
                                   encoder_attn_mask, decoder_attn_mask,
                                   dropout_rng, deterministic)
        return num / den.clamp(min=1.0)
