"""Pre-LN decoder layers (port of models/transformer.py).

Weights are stacked along a leading layer axis, as in the JAX package, so
the parameter trees match leaf for leaf. The layer loop is a Python loop
over per-layer views; the decode path passes a tuple of per-layer trees
(`GPTModel.prepare_decode_params`) and per-layer caches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from megatron_llm_tpu_torch.models.activations import (
    ACTIVATIONS,
    GLU_ACTIVATIONS,
)
from megatron_llm_tpu_torch.models.attention import attention_block
from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.ops.quantization import qdot


def normal(shape, std, dtype, generator, device) -> torch.Tensor:
    """N(0, std) drawn in fp32 from `generator`, cast to `dtype`."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(shape[0], -1)
    # blocks of leading rows bound the fp32 scratch at 2**26 elements
    step = max(1, (1 << 26) // flat.shape[1])
    for i in range(0, flat.shape[0], step):
        blk = flat[i:i + step]
        blk.copy_(torch.randn(blk.shape, generator=generator,
                              dtype=torch.float32, device=device) * std)
    return out


def init_norm_params(cfg, shape_prefix=(), device="cuda") -> dict:
    shape = tuple(shape_prefix) + (cfg.hidden_size,)
    p = {"scale": torch.ones(shape, dtype=cfg.params_dtype, device=device)}
    if not cfg.use_rms_norm:
        p["bias"] = torch.zeros(shape, dtype=cfg.params_dtype, device=device)
    return p


def init_layer_params(cfg, generator: torch.Generator,
                      num_layers: Optional[int] = None,
                      device="cuda") -> dict:
    """Stacked per-layer weights, leading axis = layer: N(0, std) inputs
    projections, N(0, std / sqrt(2 L)) residual-output projections (wo,
    w2) under use_scaled_init_method. GLU w1 is (L, h, 2, ffn): gate at
    index 0, up at index 1."""
    L = num_layers if num_layers is not None else cfg.num_layers
    h = cfg.hidden_size
    std = cfg.init_method_std
    out_std = std / math.sqrt(2.0 * cfg.num_layers) \
        if cfg.use_scaled_init_method else std
    dt = cfg.params_dtype

    def rnd(shape, s):
        return normal(shape, s, dt, generator, device)

    attn = {
        "wqkv": rnd((L, h, cfg.qkv_projection_size), std),
        "wo": rnd((L, cfg.num_attention_heads * cfg.head_dim, h), out_std),
    }
    if cfg.glu_activation:
        w1_shape = (L, h, 2, cfg.ffn_hidden_size)
        b1_shape = (L, 2, cfg.ffn_hidden_size)
    else:
        w1_shape = (L, h, cfg.ffn_hidden_size)
        b1_shape = (L, cfg.ffn_hidden_size)
    mlp = {
        "w1": rnd(w1_shape, std),
        "w2": rnd((L, cfg.ffn_hidden_size, h), out_std),
    }
    if cfg.use_bias:
        zeros = lambda shape: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
        attn["bqkv"] = zeros((L, cfg.qkv_projection_size))
        attn["bo"] = zeros((L, h))
        mlp["b1"] = zeros(b1_shape)
        mlp["b2"] = zeros((L, h))
    return {
        "input_norm": init_norm_params(cfg, (L,), device),
        "attention": attn,
        "mlp": mlp,
        "post_attention_norm": init_norm_params(cfg, (L,), device),
    }


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer i of a stacked tree, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def mlp_block(mlp_params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """h -> [2x]ffn -> act -> h. A GLU w1 of (h, 2, ffn) or its flat
    (h, 2 ffn) decode view is one matmul; gate and up come back on their
    own axis."""
    dt = cfg.compute_dtype
    w1 = mlp_params["w1"]
    if cfg.glu_activation:
        b, s, h = hidden.shape
        x = qdot(hidden, w1.reshape(h, -1), dt).reshape(b, s, 2, -1)
        if "b1" in mlp_params:
            x = x + mlp_params["b1"].to(dt)
        x = GLU_ACTIVATIONS[cfg.glu_activation](x[..., 0, :], x[..., 1, :])
    else:
        x = qdot(hidden, w1, dt)
        if "b1" in mlp_params:
            x = x + mlp_params["b1"].to(dt)
        x = ACTIVATIONS[cfg.hidden_act](x)
    x = qdot(x, mlp_params["w2"], dt)
    if "b2" in mlp_params:
        x = x + mlp_params["b2"].to(dt)
    return x


def transformer_layer(layer_params: dict, cfg, hidden: torch.Tensor,
                      rope_table, mask, position_ids,
                      kv_cache: Optional[dict] = None,
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One pre-LN decoder layer (no dropout: serving is deterministic)."""
    normed = apply_norm(hidden, layer_params["input_norm"], cfg)
    attn_out, new_cache = attention_block(
        layer_params["attention"], cfg, normed, rope_table, mask,
        position_ids, kv_cache)
    x = hidden + attn_out
    normed2 = apply_norm(x, layer_params["post_attention_norm"], cfg)
    return x + mlp_block(layer_params["mlp"], cfg, normed2), new_cache


def transformer_stack(layer_params, cfg, hidden: torch.Tensor,
                      rope_table=None, mask=None, position_ids=None,
                      kv_caches: Optional[dict] = None,
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the layers in order. `layer_params` is the stacked tree or a
    tuple of per-layer trees. `kv_caches` is None, the dense decode
    layout {"k_layers": (b, g, T, d) per layer, "v_layers": ...,
    "offset": int} (`GPTModel.init_kv_caches`), or the paged layout
    {"k_pages_layers": (P, page_size, g, d) per layer, "v_pages_layers":
    ..., "page_table", "lengths", optionally "chunk_lens"}
    (`GPTModel.init_paged_kv_caches`): per-layer pools, one shared page
    table, and the ragged chunk lengths through every layer."""
    if isinstance(layer_params, (list, tuple)):
        layers = layer_params
    else:
        L = next(iter(layer_params["attention"].values())).shape[0]
        layers = [layer_slice(layer_params, i) for i in range(L)]
    if kv_caches is None:
        for p in layers:
            hidden, _ = transformer_layer(p, cfg, hidden, rope_table, mask,
                                          position_ids)
        return hidden, None
    if "k_pages_layers" in kv_caches:
        pt, lens = kv_caches["page_table"], kv_caches["lengths"]
        cl = kv_caches.get("chunk_lens")
        ks, vs = kv_caches["k_pages_layers"], kv_caches["v_pages_layers"]
        for i, p in enumerate(layers):
            cache_l = {"k_pages": ks[i], "v_pages": vs[i],
                       "page_table": pt, "lengths": lens}
            if cl is not None:
                cache_l["chunk_lens"] = cl
            # the pools are written in place: ks[i] / vs[i] stay current
            hidden, _ = transformer_layer(p, cfg, hidden, rope_table, mask,
                                          position_ids, cache_l)
        new_caches = {"k_pages_layers": ks, "v_pages_layers": vs,
                      "page_table": pt,
                      "lengths": lens + (cl if cl is not None
                                         else hidden.shape[1])}
        if cl is not None:
            new_caches["chunk_lens"] = cl
        return hidden, new_caches
    offset = int(kv_caches["offset"])
    ks, vs = kv_caches["k_layers"], kv_caches["v_layers"]
    for i, p in enumerate(layers):
        cache_l = {"k_gtd": ks[i], "v_gtd": vs[i], "offset": offset}
        hidden, _ = transformer_layer(p, cfg, hidden, rope_table, mask,
                                      position_ids, cache_l)
    return hidden, {"k_layers": ks, "v_layers": vs,
                    "offset": offset + hidden.shape[1]}
