"""Classification and multiple-choice heads on the BERT encoder (port of
models/classification.py).

`Classification`: the pooled [CLS] state -> hidden dropout -> a
num_classes linear head. `MultipleChoice`: the same with one logit, over
(b * choices, s) flattened inputs, reshaped back to (b, choices). Both
reuse `BertModel.encode` and its pooler; tasks/ (GLUE and RACE) trains
them. Under tensor and sequence parallelism the encoder is BERT's
parallel one and the pooled head reads position 0 through
`from_first_position` (tp rank 0's shard under sequence parallelism);
`loss_terms` gives a data-parallel rank its rows' cross-entropy sum and
count.
"""

from __future__ import annotations

import torch
from torch import nn

from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.models.bert import BertModel, dense, pool
from megatron_llm_tpu_torch.models.dropout import (
    at,
    dropout,
    fold_in,
    offsets_of,
)
from megatron_llm_tpu_torch.models.transformer import normal
from megatron_llm_tpu_torch.parallel.cross_entropy import cross_entropy
from megatron_llm_tpu_torch.parallel.mappings import from_first_position


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(the rows' fp32 cross-entropy sum, their count)."""
    return cross_entropy(logits.float(), labels).sum(), torch.tensor(
        float(labels.shape[0]), device=logits.device)


class Classification(nn.Module):
    def __init__(self, cfg: ModelConfig, num_classes: int, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.bert = BertModel(cfg, device=device)

    def init(self, seed: int = 0) -> dict:
        """The encoder's weights and the pooler (drawn here when the
        config has no binary head) and the class head; BERT's LM and
        binary heads are dropped (JAX :33-52)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        device, cfg = self.device, self.cfg
        params = self.bert._init(gen, device)
        params.pop("lm_head", None)
        params.pop("binary_head", None)
        h, std, dt = cfg.hidden_size, cfg.init_method_std, cfg.params_dtype
        if "pooler" not in params:
            params["pooler"] = {
                "w": normal((h, h), std, dt, gen, device),
                "b": torch.zeros((h,), dtype=dt, device=device)}
        params["classification_head"] = {
            "w": normal((h, self.num_classes), std, dt, gen, device),
            "b": torch.zeros((self.num_classes,), dtype=dt, device=device)}
        return params

    def forward(self, params: dict, tokens: torch.Tensor,
                attention_mask=None, tokentype_ids=None, dropout_rng=None,
                deterministic: bool = True) -> torch.Tensor:
        """(b, s) -> (b, num_classes) logits in the compute dtype (JAX
        :54-75); the pooled state takes hidden dropout from the stream
        folded with 7."""
        cfg = self.cfg
        hidden = self.bert.encode(params, tokens, attention_mask,
                                  tokentype_ids, dropout_rng, deterministic)
        def head(cls):
            pooled = pool(params, cfg, cls)
            if not deterministic and dropout_rng is not None:
                pooled = dropout(pooled, cfg.hidden_dropout,
                                 fold_in(dropout_rng, 7))
            return dense(pooled, params["classification_head"],
                         cfg.compute_dtype)

        return from_first_position(hidden, head)

    def loss_terms(self, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, attention_mask=None,
                   tokentype_ids=None, dropout_rng=None,
                   deterministic: bool = True):
        """`loss` as (the rows' cross-entropy sum, their count)."""
        return _ce_terms(self.forward(params, tokens, attention_mask,
                                      tokentype_ids, dropout_rng,
                                      deterministic), labels)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             attention_mask=None, tokentype_ids=None, dropout_rng=None,
             deterministic: bool = True) -> torch.Tensor:
        """The mean cross entropy over the classes, 0-d fp32."""
        num, den = self.loss_terms(params, tokens, labels, attention_mask,
                                   tokentype_ids, dropout_rng, deterministic)
        return num / den


class MultipleChoice(nn.Module):
    """A one-logit head scored per choice; the inputs carry a choices
    axis after the batch axis (JAX :87-116)."""

    def __init__(self, cfg: ModelConfig, num_choices: int = 4,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.num_choices = num_choices
        self.device = torch.device(device)
        self._cls = Classification(cfg, num_classes=1, device=device)

    def init(self, seed: int = 0) -> dict:
        return self._cls.init(seed)

    def forward(self, params: dict, tokens: torch.Tensor,
                attention_mask=None, tokentype_ids=None, dropout_rng=None,
                deterministic: bool = True) -> torch.Tensor:
        """tokens (b, choices, s) -> (b, choices) logits."""
        b, c, s = tokens.shape

        def flat(x):
            return None if x is None else x.reshape(b * c, *x.shape[2:])

        offs = offsets_of(dropout_rng) if dropout_rng is not None else ()
        if offs:
            # the stream places rows by question: the flattened rows of
            # question i start at row i * choices
            dropout_rng = at(dropout_rng, offs[0] * c, *offs[1:])
        logits = self._cls.forward(params, tokens.reshape(b * c, s),
                                   flat(attention_mask), flat(tokentype_ids),
                                   dropout_rng, deterministic)
        return logits.reshape(b, c)

    def loss_terms(self, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, attention_mask=None,
                   tokentype_ids=None, dropout_rng=None,
                   deterministic: bool = True):
        """`loss` as (the questions' cross-entropy sum, their count)."""
        return _ce_terms(self.forward(params, tokens, attention_mask,
                                      tokentype_ids, dropout_rng,
                                      deterministic), labels)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             attention_mask=None, tokentype_ids=None, dropout_rng=None,
             deterministic: bool = True) -> torch.Tensor:
        num, den = self.loss_terms(params, tokens, labels, attention_mask,
                                   tokentype_ids, dropout_rng, deterministic)
        return num / den
