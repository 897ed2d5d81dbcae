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

    def init_paged_kv_caches(self, slots: int, num_pages: int,
                             page_size: int, max_pages_per_slot: int,
                             kv_dtype=None) -> dict:
        """Paged KV cache for the continuous-batching engine
        (inference/engine.py), on `self.device`: per-layer page pools
        (num_pages, page_size, g, d) shared by all slots, in the compute
        dtype; one (slots, max_pages_per_slot) int32 page table mapping
        each slot's logical pages to pool pages; per-slot int32 lengths.
        Pool page 0 is the null page, never allocated: fresh and retired
        slots point every table entry at it, so pad rows and idle slots
        write only to a dead page. int8 pools (with their scale pools)
        belong to the quantized-serving slice and raise."""
        cfg = self.cfg
        dt = cfg.compute_dtype if kv_dtype is None else kv_dtype
        if dt == torch.int8:
            raise NotImplementedError(
                "int8 KV pools are not ported yet: they belong to the "
                "quantized-serving slice of the engine (ROADMAP.md A2)")
        shape = (num_pages, page_size, cfg.num_query_groups, cfg.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {
            "k_pages_layers": tuple(zeros(shape, dt)
                                    for _ in range(cfg.num_layers)),
            "v_pages_layers": tuple(zeros(shape, dt)
                                    for _ in range(cfg.num_layers)),
            "page_table": zeros((slots, max_pages_per_slot), torch.int32),
            "lengths": zeros((slots,), torch.int32),
        }
