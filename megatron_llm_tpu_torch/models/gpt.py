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
    chunked_head_cross_entropy,
    init_language_model_params,
    language_model_forward,
)
from megatron_llm_tpu_torch.models.transformer import layer_slice
from megatron_llm_tpu_torch.parallel.mesh import get_context
from megatron_llm_tpu_torch.parallel.sharding import kv_pool_shard_shape
from megatron_llm_tpu_torch.ops.quantization import (
    is_quantized_weight,
    quantize_decode_layers,
)


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

    def abstract_params(self) -> dict:
        """The parameter tree's names, shapes and dtypes as meta tensors,
        with no storage (the JAX package's `jax.eval_shape(model.init)`):
        the template a checkpoint is restored against."""
        return init_language_model_params(self.cfg, None, "meta")

    def forward(self, params: dict, tokens: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_caches: Optional[dict] = None, dropout_rng=None,
                deterministic: bool = True,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Returns (logits, new_kv_caches). `dropout_rng` is a dropout
        stream (models/dropout.py), read unless `deterministic`."""
        return language_model_forward(params, self.cfg, tokens, position_ids,
                                      attention_mask, kv_caches, dropout_rng,
                                      deterministic)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             position_ids: Optional[torch.Tensor] = None,
             attention_mask: Optional[torch.Tensor] = None,
             dropout_rng=None, deterministic: bool = True) -> torch.Tensor:
        """Mean masked CE, a 0-d fp32 tensor (JAX :52-76): the head and CE
        run chunked over the sequence so the full (b, s, V) logits never
        materialise. `dropout_rng` is the dropout stream (an integer
        seed, models/dropout.py), read unless `deterministic`. Under
        context parallelism a rank holds one sequence shard, whose mean
        is not the loss: use `loss_terms` and sum them over the cp group
        (parallel/mesh.sum_over_tokens), as the train step does."""
        ctx = get_context()
        if ctx is not None and ctx.cp > 1:
            raise ValueError(
                "GPTModel.loss at context_parallel_size > 1 would be this "
                "rank's shard's mean: sum loss_terms over the cp group "
                "(parallel.mesh.sum_over_tokens)")
        hidden, _ = language_model_forward(
            params, self.cfg, tokens, position_ids, attention_mask,
            dropout_rng=dropout_rng, deterministic=deterministic,
            return_hidden=True)
        losses = chunked_head_cross_entropy(params, self.cfg, hidden, labels)
        if loss_mask is None:
            return losses.mean()
        loss_mask = loss_mask.float()
        return (losses * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)

    def loss_terms(self, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None,
                   position_ids: Optional[torch.Tensor] = None,
                   attention_mask: Optional[torch.Tensor] = None,
                   dropout_rng=None, deterministic: bool = True):
        """`loss` as (numerator, denominator), both sums over this rank's
        tokens (JAX :78-124), so that a data- or context-parallel rank
        holding some of the batch's tokens rebuilds the global loss as
        sum(num) / max(sum(den), 1) over the ranks."""
        hidden, _ = language_model_forward(
            params, self.cfg, tokens, position_ids, attention_mask,
            dropout_rng=dropout_rng, deterministic=deterministic,
            return_hidden=True)
        losses = chunked_head_cross_entropy(params, self.cfg, hidden, labels)
        if loss_mask is None:
            return losses.sum(), torch.tensor(
                float(losses.numel()), device=losses.device)
        loss_mask = loss_mask.float()
        return (losses * loss_mask).sum(), loss_mask.sum()

    def prepare_decode_params(self, params: dict,
                              quantize_int8: bool = False,
                              flatten_glu: bool = True) -> dict:
        """Decode layout, built once before the token loop: the stacked
        layer tree becomes a tuple of per-layer views, the GLU weight
        (h, 2, ffn) its flat (h, 2 ffn) view, and every floating weight is
        cast to the compute dtype here instead of at each matmul. The cast
        is deterministic, so every value is the same as the per-matmul
        cast's; where params_dtype already is the compute dtype it is a
        no-op and nothing is copied.

        `quantize_int8=True` (the engine's `quantize_weights`): each
        layer's wqkv, wo, flat w1 and w2 become weight-only int8 dicts
        with per-output-channel fp32 scales (ops/quantization.py),
        quantized from the tree as given, before any cast, as the JAX
        package quantizes its un-cast tree; the other leaves are cast as
        above.

        `flatten_glu=False` (the tensor-parallel serving engine, JAX
        :219-227) keeps the GLU weight (h, 2, ffn): the flat view joins
        gate and up along the axis tp splits
        (parallel/sharding.decode_param_specs)."""
        if quantize_int8 and not flatten_glu:
            raise ValueError(
                "quantize_int8 requires the flattened GLU decode "
                "layout (quantize_decode_layers quantizes the 2D "
                "view); tp-sharded engines serve the fp decode tree")
        dt = self.cfg.compute_dtype

        def cast(tree):
            return {k: v if is_quantized_weight(v)
                    else cast(v) if isinstance(v, dict)
                    else (v.to(dt) if v.is_floating_point() else v)
                    for k, v in tree.items()}

        stacked = params["layers"]
        L = stacked["attention"]["wqkv"].shape[0]

        def one(i):
            layer = layer_slice(stacked, i)
            if self.cfg.glu_activation and flatten_glu:
                w1 = layer["mlp"]["w1"]
                layer["mlp"]["w1"] = w1.reshape(w1.shape[0], -1)
            return layer

        layers = tuple(one(i) for i in range(L))
        if quantize_int8:
            layers = quantize_decode_layers(layers)
        out = cast({k: v for k, v in params.items() if k != "layers"})
        out["layers"] = tuple(cast(layer) for layer in layers)
        return out

    def init_kv_caches(self, batch_size: int, max_len: int) -> dict:
        """Preallocated per-layer (b, g, T, d) caches in the compute dtype
        (the JAX package's layout="layers", the decode kernel's "gtd");
        each step writes its columns in place. Under a tensor-parallel
        context g is this rank's g / tp groups."""
        cfg = self.cfg
        ctx = get_context()
        tp = ctx.tp if ctx is not None else 1
        shape = (batch_size, cfg.num_query_groups // tp, max_len,
                 cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)

        return {"k_layers": tuple(zeros() for _ in range(cfg.num_layers)),
                "v_layers": tuple(zeros() for _ in range(cfg.num_layers)),
                "offset": 0}

    def init_paged_kv_caches(self, slots: int, num_pages: int,
                             page_size: int, max_pages_per_slot: int,
                             kv_dtype=None, tp: int = 1) -> dict:
        """Paged KV cache for the continuous-batching engine
        (inference/engine.py), on `self.device`: per-layer page pools
        (num_pages, page_size, g, d) shared by all slots, in the compute
        dtype or `kv_dtype`; one (slots, max_pages_per_slot) int32 page
        table mapping each slot's logical pages to pool pages; per-slot
        int32 lengths. Pool page 0 is the null page, never allocated:
        fresh and retired slots point every table entry at it, so pad
        rows and idle slots write only to a dead page. int8 pools also
        get per-layer fp32 scale pools "k_scales_layers" /
        "v_scales_layers" of (num_pages, page_size, g): one scale per
        (token, group), written by the scatter that writes the data.

        At `tp` > 1 (the tensor-parallel engine, JAX `mesh_ctx`) every
        pool holds this rank's slice, `kv_pool_shard_shape`: g / tp
        groups, never the whole pool."""
        cfg = self.cfg
        dt = cfg.compute_dtype if kv_dtype is None else kv_dtype
        shape = kv_pool_shard_shape(
            (num_pages, page_size, cfg.num_query_groups, cfg.head_dim), tp)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def per_layer(shape, dtype):
            return tuple(zeros(shape, dtype) for _ in range(cfg.num_layers))

        caches = {
            "k_pages_layers": per_layer(shape, dt),
            "v_pages_layers": per_layer(shape, dt),
            "page_table": zeros((slots, max_pages_per_slot), torch.int32),
            "lengths": zeros((slots,), torch.int32),
        }
        if dt == torch.int8:
            caches["k_scales_layers"] = per_layer(shape[:-1], torch.float32)
            caches["v_scales_layers"] = per_layer(shape[:-1], torch.float32)
        return caches
