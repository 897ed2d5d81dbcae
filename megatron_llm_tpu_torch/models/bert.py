"""BERT: the bidirectional encoder, the masked-LM head and the binary
(sentence-order) head (port of models/bert.py).

As in the JAX package the model holds the config and the parameters are
a separate tree, with the JAX leaf names:

- the encoder: word, learned position and tokentype embeddings, the
  shared layer stack (`transformer_stack`: LayerNorm, biases, gelu; pre-
  or post-LN as the config says) under a padding mask, the final norm;
- `lm_head`: dense (h, h) -> gelu -> LayerNorm -> logits against the
  tied word-embedding table plus a vocabulary bias (JAX :83-92);
- `pooler` and `binary_head`: tanh(dense(hidden[:, 0])) -> 2 logits,
  present under `add_binary_head` (JAX :64-76, :110-118).

The padding mask is a dense (b, 1, s, s) mask, so attention takes the
grouped (plain) path and never the flash kernels, as in the JAX package
(its `flash_ok` requires no mask), and BERT's norms are LayerNorm, which
has no kernel: this model launches none of K1-K7.

Under tensor parallelism (parallel/mesh.py) the encoder is the shared
stack's column/row-parallel attention and MLP, every attention reading
the whole (b, 1, s, s) padding mask on the gathered sequence; under
sequence parallelism the embedding's sum (tokentypes and positions
too), the norms, dropout and the LM head's dense and norm run on the
rank's sequence shard. The LM head's logits are the rank's vocabulary
shard, the gathered hidden states against its word-embedding rows plus
its `bias` shard, and go to the vocab-parallel cross entropy; the
pooler and binary head read position 0 (`from_first_position`: tp rank
0's shard under sequence parallelism). `loss_terms` splits the loss
into the sums a data-parallel rank holds: the masked-LM token sum over
its `loss_mask` count and the sentence-order sample sum over its sample
count, so that the ranks rebuild the global batch's two means (JAX's
GSPMD loss is over the global batch). Pipeline and context parallelism
are refused for the encoder family, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.models.activations import ACTIVATIONS
from megatron_llm_tpu_torch.models.attention import padding_mask_2d
from megatron_llm_tpu_torch.models.dropout import split
from megatron_llm_tpu_torch.models.language_model import (
    embed_tokens,
    init_language_model_params,
)
from megatron_llm_tpu_torch.models.norms import apply_norm, layer_norm
from megatron_llm_tpu_torch.models.transformer import (
    normal,
    transformer_stack,
)
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    cross_entropy,
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.parallel.mappings import (
    from_first_position,
    gather_from_tp_last,
    tp_input,
)


def dense(x: torch.Tensor, p: dict, dt) -> torch.Tensor:
    """x @ w + b in the compute dtype `dt`, of a {"w", "b"} leaf pair."""
    return x @ p["w"].to(dt) + p["b"].to(dt)


def pool(params: dict, cfg, cls: torch.Tensor) -> torch.Tensor:
    """The pooler of the (b, h) position-0 states: tanh(dense(cls))."""
    return torch.tanh(dense(cls, params["pooler"], cfg.compute_dtype))


class BertModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.position_embedding_type != "absolute":
            raise ValueError("BERT uses learned absolute positions")
        if not cfg.tie_embed_logits:
            raise ValueError("BERT's LM head ties to the word embeddings")
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
        std, dt, h = cfg.init_method_std, cfg.params_dtype, cfg.hidden_size

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        params["lm_head"] = {
            "dense_w": normal((h, h), std, dt, gen, device),
            "dense_b": zeros(h),
            "norm": {"scale": torch.ones((h,), dtype=dt, device=device),
                     "bias": zeros(h)},
            "bias": zeros(cfg.padded_vocab_size),
        }
        if cfg.add_binary_head:
            params["pooler"] = {"w": normal((h, h), std, dt, gen, device),
                                "b": zeros(h)}
            params["binary_head"] = {
                "w": normal((h, 2), std, dt, gen, device), "b": zeros(2)}
        return params

    def encode(self, params: dict, tokens: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               tokentype_ids: Optional[torch.Tensor] = None,
               dropout_rng=None, deterministic: bool = True
               ) -> torch.Tensor:
        """The bidirectional encoder: (b, s) ids -> (b, s, h) hidden
        states after the final norm. `attention_mask` is the (b, s) keep
        mask (all ones when None); `dropout_rng` a dropout stream
        (models/dropout.py), split between the embedding and the stack
        (JAX :85-95), read unless `deterministic`."""
        cfg = self.cfg
        b, s = tokens.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=tokens.device)
        mask = padding_mask_2d(attention_mask)
        emb_s = stack_s = None
        if dropout_rng is not None and not deterministic:
            emb_s, stack_s = split(dropout_rng)
        hidden = embed_tokens(params, cfg, tokens, None, emb_s,
                              tokentype_ids=tokentype_ids)
        hidden, _ = transformer_stack(params["layers"], cfg, hidden, None,
                                      mask, None, None, stack_s)
        return apply_norm(hidden, params["final_norm"], cfg)

    def heads(self, params: dict, hidden: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The encoder output's (LM logits, binary logits or None): the
        logits this rank's vocabulary shard (the whole vocabulary at
        tp = 1), the binary logits (b, 2) on every rank."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        lh = params["lm_head"]
        x = hidden @ lh["dense_w"].to(dt) + lh["dense_b"].to(dt)
        x = ACTIVATIONS["gelu"](x)
        x = layer_norm(x, lh["norm"]["scale"], lh["norm"]["bias"],
                       cfg.layernorm_epsilon)
        emb = params["embedding"]["word_embeddings"].to(dt)
        logits = tp_input(x) @ emb.T + lh["bias"].to(dt)
        binary_logits = None
        if cfg.add_binary_head:
            binary_logits = from_first_position(hidden, lambda cls: dense(
                pool(params, cfg, cls), params["binary_head"], dt))
        return logits, binary_logits

    def forward(self, params: dict, tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                tokentype_ids: Optional[torch.Tensor] = None,
                dropout_rng=None, deterministic: bool = True,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(LM logits (b, s, V), binary logits (b, 2) or None), in the
        compute dtype (JAX :98-140); under tensor parallelism the logits
        gathered to the whole padded vocabulary."""
        hidden = self.encode(params, tokens, attention_mask, tokentype_ids,
                             dropout_rng, deterministic)
        logits, binary_logits = self.heads(params, hidden)
        return gather_from_tp_last(logits), binary_logits

    def loss_terms(self, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None,
                   attention_mask: Optional[torch.Tensor] = None,
                   tokentype_ids: Optional[torch.Tensor] = None,
                   sop_labels: Optional[torch.Tensor] = None,
                   dropout_rng=None, deterministic: bool = True):
        """`loss` as (numerators, denominators), 1-d fp32 tensors of
        sums over this rank's rows: [masked-LM CE sum, sentence-order CE
        sum] over [loss_mask count, sample count] (the second term only
        with the binary head and `sop_labels`). The loss is
        sum(num / den) with each den summed over the data-parallel
        ranks (JAX :142-168 over the global batch)."""
        hidden = self.encode(params, tokens, attention_mask, tokentype_ids,
                             dropout_rng, deterministic)
        logits, binary_logits = self.heads(params, hidden)
        losses = vocab_parallel_cross_entropy(logits, labels)
        lm = torch.ones_like(losses) if loss_mask is None \
            else loss_mask.float()
        nums, dens = [(losses * lm).sum()], [lm.sum()]
        if binary_logits is not None and sop_labels is not None:
            nums.append(cross_entropy(binary_logits.float(),
                                      sop_labels).sum())
            dens.append(torch.tensor(float(sop_labels.shape[0]),
                                     device=losses.device))
        return torch.stack(nums), torch.stack(dens)

    def loss(self, params: dict, tokens: torch.Tensor,
             labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             attention_mask: Optional[torch.Tensor] = None,
             tokentype_ids: Optional[torch.Tensor] = None,
             sop_labels: Optional[torch.Tensor] = None,
             dropout_rng=None, deterministic: bool = True
             ) -> torch.Tensor:
        """The masked mean of the LM cross entropy plus, with the binary
        head and `sop_labels`, the mean sentence-order cross entropy: a
        0-d fp32 tensor (JAX :142-168)."""
        num, den = self.loss_terms(params, tokens, labels, loss_mask,
                                   attention_mask, tokentype_ids,
                                   sop_labels, dropout_rng, deterministic)
        return (num / den.clamp(min=1.0)).sum()
