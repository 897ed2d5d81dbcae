"""The biencoder of ICT pretraining: a query tower and a context tower,
and the in-batch retrieval loss (port of models/biencoder.py).

A tower is a headless `BertModel` (no `lm_head`, `pooler` or
`binary_head`) with an optional `projection_enc` {w (h, p), b (p,)}; a
text's embedding is the CLS row of the tower's encoder output, projected
when `projection_dim > 0`. The parameter tree is {"query": tower,
"context": tower}, or {"shared": tower} when one tower serves both
sides, with the JAX leaf names. The loss is the cross entropy of each
query against every context of the batch, fp32 scores q @ c^T, its own
context the target (JAX :106-116).

A tower is BERT's encoder: it launches none of K1-K7 (models/bert.py),
and under tensor and sequence parallelism it is BERT's parallel encoder,
its CLS row and projection taken by `from_first_position`. Under data
parallelism the in-batch softmax sees the global batch's contexts, as
JAX's GSPMD loss over the whole batch does: each rank's context
embeddings are all-gathered over the dp group before q @ c^T
(`gather_from_data_parallel`, whose backward sums every rank's
gradient of a context back onto its rank), each query's target is its
own context's global row (its rank's row start plus its row), and
`loss_terms` gives the rank's query sum and count, so that the loss is
the mean over the global batch's queries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.models.bert import BertModel, dense
from megatron_llm_tpu_torch.models.dropout import split
from megatron_llm_tpu_torch.models.transformer import normal
from megatron_llm_tpu_torch.parallel.cross_entropy import cross_entropy
from megatron_llm_tpu_torch.parallel.mappings import (
    from_first_position,
    gather_from_data_parallel,
)
from megatron_llm_tpu_torch.parallel.mesh import get_context


class BiEncoderModel(nn.Module):
    def __init__(self, cfg: ModelConfig, projection_dim: int = 0,
                 shared_query_context_model: bool = False, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.projection_dim = projection_dim
        self.shared = shared_query_context_model
        self.device = torch.device(device)
        self.bert = BertModel(cfg, device=device)

    def init(self, seed: int = 0) -> dict:
        """Random weights on `self.device`, drawn from a torch.Generator
        seeded with `seed` (they do not reproduce jax.random)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._init(gen, self.device)

    def abstract_params(self) -> dict:
        """The parameter tree as meta tensors, with no storage."""
        return self._init(None, "meta")

    def _init(self, gen, device) -> dict:
        if self.shared:
            return {"shared": self._init_tower(gen, device)}
        return {"query": self._init_tower(gen, device),
                "context": self._init_tower(gen, device)}

    def _init_tower(self, gen, device) -> dict:
        params = self.bert._init(gen, device)
        for head in ("lm_head", "binary_head", "pooler"):
            params.pop(head, None)
        if self.projection_dim > 0:
            dt = self.cfg.params_dtype
            params["projection_enc"] = {
                "w": normal((self.cfg.hidden_size, self.projection_dim),
                            self.cfg.init_method_std, dt, gen, device),
                "b": torch.zeros((self.projection_dim,), dtype=dt,
                                 device=device)}
        return params

    def embed_text(self, tower_params: dict, tokens: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   tokentype_ids: Optional[torch.Tensor] = None,
                   dropout_rng=None, deterministic: bool = True
                   ) -> torch.Tensor:
        """(b, s) ids -> the (b, h) CLS embedding, or (b, projection_dim)
        projected (JAX :61-78)."""
        hidden = self.bert.encode(tower_params, tokens, attention_mask,
                                  tokentype_ids, dropout_rng, deterministic)

        def project(cls):
            if self.projection_dim > 0:
                return dense(cls, tower_params["projection_enc"],
                             self.cfg.compute_dtype)
            return cls

        return from_first_position(hidden, project)

    def forward(self, params: dict, query_tokens: torch.Tensor,
                query_attention_mask: Optional[torch.Tensor],
                query_types: Optional[torch.Tensor],
                context_tokens: torch.Tensor,
                context_attention_mask: Optional[torch.Tensor],
                context_types: Optional[torch.Tensor],
                dropout_rng=None, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(query embeddings, context embeddings), each (b, d) in the
        compute dtype (JAX :80-104); a dropout stream is split between the
        two towers."""
        qp = params["shared"] if self.shared else params["query"]
        cp = params["shared"] if self.shared else params["context"]
        rq = rc = None
        if dropout_rng is not None and not deterministic:
            rq, rc = split(dropout_rng)
        q = self.embed_text(qp, query_tokens, query_attention_mask,
                            query_types, rq, deterministic)
        c = self.embed_text(cp, context_tokens, context_attention_mask,
                            context_types, rc, deterministic)
        return q, c

    def loss_terms(self, params: dict, query_tokens: torch.Tensor,
                   query_mask: Optional[torch.Tensor],
                   context_tokens: torch.Tensor,
                   context_mask: Optional[torch.Tensor], dropout_rng=None,
                   deterministic: bool = True):
        """`loss` as (numerator, denominator): the sum of this rank's
        queries' cross entropies against the global batch's contexts,
        and its query count."""
        q, c = self.forward(params, query_tokens, query_mask, None,
                            context_tokens, context_mask, None, dropout_rng,
                            deterministic)
        ctx = get_context()
        row0 = ctx.dp_rank * q.shape[0] if ctx is not None else 0
        scores = q.float() @ gather_from_data_parallel(c.float()).T
        targets = row0 + torch.arange(q.shape[0], device=scores.device)
        return cross_entropy(scores, targets).sum(), torch.tensor(
            float(q.shape[0]), device=scores.device)

    def loss(self, params: dict, query_tokens: torch.Tensor,
             query_mask: Optional[torch.Tensor],
             context_tokens: torch.Tensor,
             context_mask: Optional[torch.Tensor], dropout_rng=None,
             deterministic: bool = True) -> torch.Tensor:
        """The in-batch retrieval cross entropy, a 0-d fp32 tensor: row i
        of q @ c^T (fp32) against target i (JAX :106-116); under data
        parallelism this rank's queries' mean against the global batch's
        contexts."""
        num, den = self.loss_terms(params, query_tokens, query_mask,
                                   context_tokens, context_mask,
                                   dropout_rng, deterministic)
        return num / den
