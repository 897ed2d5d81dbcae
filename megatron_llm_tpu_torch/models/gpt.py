"""GPT-family model (port of models/gpt.py).

As in the JAX package the model object holds the config and the
parameters live in a separate tree (a dict of tensors), so the same
weights can be served by models with different kernel switches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.models.language_model import (
    init_language_model_params,
    language_model_forward,
)
from megatron_llm_tpu_torch.models.transformer import layer_slice


class GPTModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self._check_config()

    def _check_config(self):
        pass

    def init(self, seed: int = 0) -> dict:
        """Random weights on `self.device`, drawn from a torch.Generator
        seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_language_model_params(self.cfg, gen, self.device)

    def forward(self, params: dict, tokens: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_caches: Optional[dict] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Returns (logits, new_kv_caches)."""
        return language_model_forward(params, self.cfg, tokens, position_ids,
                                      attention_mask, kv_caches)

    def prepare_decode_params(self, params: dict) -> dict:
        """Decode layout, built once before the token loop: the stacked
        layer tree becomes a tuple of per-layer views, the GLU weight
        (h, 2, ffn) its flat (h, 2 ffn) view, and every floating weight is
        cast to the compute dtype here instead of at each matmul. The cast
        is deterministic, so every value is the same as the per-matmul
        cast's; where params_dtype already is the compute dtype it is a
        no-op and nothing is copied."""
        dt = self.cfg.compute_dtype

        def cast(tree):
            return {k: cast(v) if isinstance(v, dict)
                    else (v.to(dt) if v.is_floating_point() else v)
                    for k, v in tree.items()}

        stacked = params["layers"]
        L = stacked["attention"]["wqkv"].shape[0]

        def one(i):
            layer = cast(layer_slice(stacked, i))
            if self.cfg.glu_activation:
                w1 = layer["mlp"]["w1"]
                layer["mlp"]["w1"] = w1.reshape(w1.shape[0], -1)
            return layer

        out = cast({k: v for k, v in params.items() if k != "layers"})
        out["layers"] = tuple(one(i) for i in range(L))
        return out

    def init_kv_caches(self, batch_size: int, max_len: int) -> dict:
        """Preallocated per-layer (b, g, T, d) caches in the compute dtype
        (the JAX package's layout="layers", the decode kernel's "gtd");
        each step writes its columns in place."""
        cfg = self.cfg
        shape = (batch_size, cfg.num_query_groups, max_len, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)

        return {"k_layers": tuple(zeros() for _ in range(cfg.num_layers)),
                "v_layers": tuple(zeros() for _ in range(cfg.num_layers)),
                "offset": 0}
