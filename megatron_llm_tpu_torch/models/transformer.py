"""Pre-LN decoder layers, sequential or Falcon's parallel attention
(port of models/transformer.py).

Weights are stacked along a leading layer axis, as in the JAX package, so
the parameter trees match leaf for leaf. The layer loop is a Python loop
over per-layer views; the decode path passes a tuple of per-layer trees
(`GPTModel.prepare_decode_params`) and per-layer caches. The training
forward splits each stacked leaf once with `unbind` (its backward stacks
the layers' gradients in one allocation; an index per layer would
allocate a stacked-size zero gradient per layer) and wraps each layer in
the recompute policy (models/remat.py) as `--recompute_method` says
(JAX :278-293): "uniform" remats every layer, "block" the first
`recompute_num_layers`.

Dropout (JAX :165-226, :252-274): given a dropout stream, layer i takes
the stream folded with i and splits it three ways, for the attention
probabilities, the attention (or, in a parallel layer, the joint)
residual branch and the MLP's; its hidden rate is `hidden_dropout`, or
under `lima_dropout` the ramp hidden_dropout * i / (num_layers - 1).
The matmul outputs are the save points "mlp_pre_act" and "mlp_out".

Under tensor parallelism the MLP's w1 is column-parallel (a GLU w1 on
its ffn axis, the GLU axis whole) and w2 row-parallel, read and summed
as the attention block's projections are (models/attention.py); under
sequence parallelism the norms, residual adds and dropout run on the
rank's sequence shard, and the replicated leaves' gradients are partial
sums that the train step all-reduces over the tp group.
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
from megatron_llm_tpu_torch.models.dropout import dropout, fold_in, split
from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.models.remat import remat_wrap, tag
from megatron_llm_tpu_torch.ops.quantization import (
    is_quantized_weight,
    qdot,
)
from megatron_llm_tpu_torch.parallel.mappings import tp_input, tp_output


def normal(shape, std, dtype, generator, device) -> torch.Tensor:
    """N(0, std) drawn in fp32 from `generator`, cast to `dtype`."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:  # a shape-only template (GPTModel.abstract_params)
        return out
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
    layers = {
        "input_norm": init_norm_params(cfg, (L,), device),
        "attention": attn,
        "mlp": mlp,
    }
    # parallel attention has no post-attention norm; the parallel
    # layernorm gives the MLP its own (JAX :101-106)
    if not cfg.parallel_attn:
        layers["post_attention_norm"] = init_norm_params(cfg, (L,), device)
    if cfg.parallel_layernorm:
        layers["mlp_norm"] = init_norm_params(cfg, (L,), device)
    return layers


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer i of a stacked tree, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def unstack_layers(stacked: dict) -> list:
    """The stacked tree as a list of per-layer trees of views, each leaf
    split once by `unbind`."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    parts = split(stacked)
    L = next(iter(stacked["attention"].values())).shape[0]
    return [pick(parts, i) for i in range(L)]


def mlp_block(mlp_params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """h -> [2x]ffn -> act -> h. A GLU w1 of (h, 2, ffn), its flat
    (h, 2 ffn) decode view or that view quantized to int8 is one matmul;
    gate and up come back on their own axis."""
    dt = cfg.compute_dtype
    hidden = tp_input(hidden)
    w1 = mlp_params["w1"]
    if cfg.glu_activation:
        b, s, h = hidden.shape
        if not is_quantized_weight(w1):  # int8 trees hold the flat view
            w1 = w1.reshape(h, -1)
        with tag("mlp_pre_act"):
            x = qdot(hidden, w1, dt).reshape(b, s, 2, -1)
        if "b1" in mlp_params:
            x = x + mlp_params["b1"].to(dt)
        x = GLU_ACTIVATIONS[cfg.glu_activation](x[..., 0, :], x[..., 1, :])
    else:
        with tag("mlp_pre_act"):
            x = qdot(hidden, w1, dt)
        if "b1" in mlp_params:
            x = x + mlp_params["b1"].to(dt)
        x = ACTIVATIONS[cfg.hidden_act](x)
    with tag("mlp_out"):
        x = qdot(x, mlp_params["w2"], dt)
    x = tp_output(x)
    if "b2" in mlp_params:
        x = x + mlp_params["b2"].to(dt)
    return x


def transformer_layer(layer_params: dict, cfg, hidden: torch.Tensor,
                      rope_table, mask, position_ids,
                      kv_cache: Optional[dict] = None, dropout_seed=None,
                      hidden_dropout_rate: Optional[float] = None,
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One pre-LN decoder layer. Under `parallel_attn` (Falcon, JAX
    :205-211) the MLP reads the attention's normed input (or its own
    `mlp_norm` of the layer input under `parallel_layernorm`) and both
    outputs join the residual once. With a dropout stream (None when
    deterministic) attention dropout and hidden dropout at
    `hidden_dropout_rate` (default `cfg.hidden_dropout`) apply on each
    residual branch (JAX :172-226)."""
    rate = cfg.hidden_dropout if hidden_dropout_rate is None \
        else hidden_dropout_rate
    attn_s, h1_s, h2_s = split(dropout_seed, 3) \
        if dropout_seed is not None else (None, None, None)
    normed = apply_norm(hidden, layer_params["input_norm"], cfg)
    attn_out, new_cache = attention_block(
        layer_params["attention"], cfg, normed, rope_table, mask,
        position_ids, kv_cache, attn_s)
    if cfg.parallel_attn:
        if cfg.parallel_layernorm:
            normed = apply_norm(hidden, layer_params["mlp_norm"], cfg)
        mlp_out = mlp_block(layer_params["mlp"], cfg, normed)
        return hidden + dropout(attn_out + mlp_out, rate, h1_s), new_cache
    x = hidden + dropout(attn_out, rate, h1_s)
    normed2 = apply_norm(x, layer_params["post_attention_norm"], cfg)
    mlp_out = mlp_block(layer_params["mlp"], cfg, normed2)
    return x + dropout(mlp_out, rate, h2_s), new_cache


def transformer_stack(layer_params, cfg, hidden: torch.Tensor,
                      rope_table=None, mask=None, position_ids=None,
                      kv_caches: Optional[dict] = None, dropout_seed=None,
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the layers in order. `layer_params` is the stacked tree or a
    tuple of per-layer trees. `kv_caches` is None, the dense decode
    layout {"k_layers": (b, g, T, d) per layer, "v_layers": ...,
    "offset": int or 0-d tensor} (`GPTModel.init_kv_caches`), or the
    paged layout
    {"k_pages_layers": (P, page_size, g, d) per layer, "v_pages_layers":
    ..., "page_table", "lengths", optionally "chunk_lens", "doc_starts",
    and for int8 pools "k_scales_layers" / "v_scales_layers"}
    (`GPTModel.init_paged_kv_caches`): per-layer pools (and scale pools),
    one shared page table, and the ragged chunk lengths and document
    floors through every layer.

    `dropout_seed` (None when deterministic) is the stack's dropout
    stream, read by the no-cache forward: layer i draws from
    fold_in(dropout_seed, i). A recomputed layer derives the same seeds
    and draws the same masks."""
    if isinstance(layer_params, (list, tuple)):
        layers = layer_params
    else:
        layers = unstack_layers(layer_params)
    if kv_caches is None:
        policy = cfg.resolved_remat_policy
        n_remat = 0 if policy == "none" else (
            min(cfg.recompute_num_layers, len(layers))
            if cfg.recompute_method == "block" else len(layers))

        L = cfg.num_layers

        def body(p, x, i):
            seed = None if dropout_seed is None else fold_in(dropout_seed, i)
            # LIMA: a linear ramp from 0 to hidden_dropout over depth
            rate = cfg.hidden_dropout * i / (L - 1) \
                if cfg.lima_dropout and L > 1 else None
            return transformer_layer(p, cfg, x, rope_table, mask,
                                     position_ids, dropout_seed=seed,
                                     hidden_dropout_rate=rate)[0]

        body_ck = remat_wrap(body, policy)
        for i, p in enumerate(layers):
            hidden = (body_ck if i < n_remat else body)(p, hidden, i)
        return hidden, None
    if "k_pages_layers" in kv_caches:
        pt, lens = kv_caches["page_table"], kv_caches["lengths"]
        cl = kv_caches.get("chunk_lens")
        dcs = kv_caches.get("doc_starts")
        ks, vs = kv_caches["k_pages_layers"], kv_caches["v_pages_layers"]
        kss = kv_caches.get("k_scales_layers")
        vss = kv_caches.get("v_scales_layers")
        for i, p in enumerate(layers):
            cache_l = {"k_pages": ks[i], "v_pages": vs[i],
                       "page_table": pt, "lengths": lens}
            if cl is not None:
                cache_l["chunk_lens"] = cl
            if dcs is not None:
                cache_l["doc_starts"] = dcs
            if kss is not None:
                cache_l["k_scales"], cache_l["v_scales"] = kss[i], vss[i]
            # the pools are written in place: ks[i] / vs[i] (and the
            # scale pools) stay current
            hidden, _ = transformer_layer(p, cfg, hidden, rope_table, mask,
                                          position_ids, cache_l)
        new_caches = {"k_pages_layers": ks, "v_pages_layers": vs,
                      "page_table": pt,
                      "lengths": lens + (cl if cl is not None
                                         else hidden.shape[1])}
        if cl is not None:
            new_caches["chunk_lens"] = cl
        if dcs is not None:
            new_caches["doc_starts"] = dcs
        if kss is not None:
            new_caches["k_scales_layers"] = kss
            new_caches["v_scales_layers"] = vss
        return hidden, new_caches
    offset = kv_caches["offset"]  # an int or a 0-d tensor on the card
    if not isinstance(offset, torch.Tensor):
        offset = int(offset)
    ks, vs = kv_caches["k_layers"], kv_caches["v_layers"]
    for i, p in enumerate(layers):
        cache_l = {"k_gtd": ks[i], "v_gtd": vs[i], "offset": offset}
        hidden, _ = transformer_layer(p, cfg, hidden, rope_table, mask,
                                      position_ids, cache_l)
    return hidden, {"k_layers": ks, "v_layers": vs,
                    "offset": offset + hidden.shape[1]}
