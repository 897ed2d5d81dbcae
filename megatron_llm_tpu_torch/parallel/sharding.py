"""Which axis of each parameter is split over which group (port of
parallel/sharding.py).

The JAX package gives each leaf a PartitionSpec and lets GSPMD hold the
shards; here a spec is a tuple of axis names (or None), one per array
axis, and each rank holds its slice of the leaf in `shard_params`:

- column-parallel (wqkv, w1): the output axis over "model"; wqkv in the
  grouped layout, so a rank holds g / tp whole [q.., k, v] groups, and a
  GLU w1 (L, h, 2, ffn) on its ffn axis behind the GLU axis;
- row-parallel (wo, w2): the input axis over "model";
- word embeddings on the vocabulary axis, an untied `lm_head` (h, V) on
  its vocabulary axis;
- norms, position and tokentype embeddings and the biases of
  row-parallel outputs: replicated;
- the encoder family (JAX :58-99): BERT's LM head {dense, norm, bias}
  with only the vocabulary `bias` on "model", T5's `lm_head_bias` on
  "model" and its decoder's `cross_attention` (wq, wkv column-parallel,
  wo row-parallel), the pooler, binary head and projections
  replicated; the biencoder's {query, context, shared} towers each by
  the tower rules.

Under pipeline parallelism `pipeline_param_specs` puts "stage" on the
layer axis that leads every stacked leaf (a stage holds num_layers / pp
consecutive layers); the embedding, the final norm and the head stay
whole on every stage (JAX parallel/pipeline.py:72-89). ZeRO-1
(optimizer/zero1.py) shards a leaf's optimizer state over "data" on the
axis `zero1_axis` picks: the one divisibility rule (JAX :113-140); under
`--overlap_grad_reduce` the stacked layer leaves skip the layer axis
(`optimizer_state_specs(..., overlap_grads=True)`, JAX :180).

Tensor-parallel serving (inference/engine.py at serving_tp > 1) cuts
two more trees: a paged KV pool leaf on its group axis (`kv_pool_axis`,
`kv_pool_spec`: rank r holds groups [r g / tp, (r + 1) g / tp), the
order of the grouped qkv layout's columns), and the decode tree
(`decode_param_specs`, `shard_decode_params`), whose per-layer leaves
follow `param_specs` without the layer axis (JAX :200-306).
"""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_tpu_torch.optimizer.optimizer import tree_map
from megatron_llm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    all_gather_rows,
)


def _replicated(tree):
    return {k: _replicated(v) if isinstance(v, dict) else ()
            for k, v in tree.items()}


def param_specs(cfg, params: dict) -> dict:
    """The spec tree of a parameter tree (JAX :31-102): GPT/Llama/Falcon,
    BERT with its heads, T5 with its decoder, and the biencoder's
    {query, context, shared} towers, each tower by the same rules;
    unknown leaves are replicated. `cfg` may be None: a GLU w1 is known
    by its four axes."""
    def layer_specs(layers: dict) -> dict:
        out = _replicated(layers)
        attn = layers["attention"]
        out["attention"].update(wqkv=(None, None, MODEL_AXIS),
                                wo=(None, MODEL_AXIS, None))
        if "bqkv" in attn:
            out["attention"]["bqkv"] = (None, MODEL_AXIS)
        w1 = layers["mlp"]["w1"]
        glu = w1.dim() == 4 if cfg is None else bool(cfg.glu_activation)
        out["mlp"].update(
            w1=(None, None, None, MODEL_AXIS) if glu
            else (None, None, MODEL_AXIS),
            w2=(None, MODEL_AXIS, None))
        if "b1" in layers["mlp"]:
            out["mlp"]["b1"] = (None, None, MODEL_AXIS) if glu \
                else (None, MODEL_AXIS)
        if "cross_attention" in layers:
            # T5's decoder: wq and the fused wkv column-parallel by KV
            # group, wo row-parallel, bo replicated
            cross = out["cross_attention"]
            cross.update(wq=(None, None, MODEL_AXIS),
                         wkv=(None, None, MODEL_AXIS),
                         wo=(None, MODEL_AXIS, None))
            for name in ("bq", "bkv"):
                if name in layers["cross_attention"]:
                    cross[name] = (None, MODEL_AXIS)
        return out

    def tower_specs(tree: dict) -> dict:
        specs = _replicated(tree)
        for key in ("layers", "decoder_layers"):
            if key in tree:
                specs[key] = layer_specs(tree[key])
        if "embedding" in tree:
            specs["embedding"]["word_embeddings"] = (MODEL_AXIS, None)
        head = tree.get("lm_head")
        if isinstance(head, dict):
            # BERT's LM head: the dense and its norm replicated, the
            # vocabulary bias on the vocabulary shards
            specs["lm_head"]["bias"] = (MODEL_AXIS,)
        elif head is not None:
            specs["lm_head"] = (None, MODEL_AXIS)
        if "lm_head_bias" in tree:
            specs["lm_head_bias"] = (MODEL_AXIS,)
        return specs

    if params and set(params) <= {"query", "context", "shared"}:
        return {k: tower_specs(v) for k, v in params.items()}
    return tower_specs(params)


def pipeline_param_specs(cfg, params: dict) -> dict:
    """`param_specs` with "stage" on the leading layer axis of every
    stacked leaf (JAX parallel/pipeline.py:72-89)."""
    specs = param_specs(cfg, params)

    def add_stage(spec):
        parts = list(spec) or [None]
        if parts[0] is not None:
            raise ValueError(f"the layer axis is already split: {spec}")
        parts[0] = STAGE_AXIS
        return tuple(parts)

    if "layers" in specs:
        specs["layers"] = tree_map(add_stage, specs["layers"])
    return specs


def layout_specs(cfg, params: dict, pp: int) -> dict:
    """The spec tree of a layout: `pipeline_param_specs` at pp > 1."""
    return pipeline_param_specs(cfg, params) if pp > 1 \
        else param_specs(cfg, params)


def spec_leaves(specs: dict) -> list:
    """A spec tree's specs in `tree_leaves` order (dict keys sorted; a
    spec tuple is a leaf)."""
    return [x for k in sorted(specs) for x in (
        spec_leaves(specs[k]) if isinstance(specs[k], dict)
        else [specs[k]])]


def model_axis(spec: tuple) -> Optional[int]:
    """The axis a spec splits over "model", or None (replicated)."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def stage_axis(spec: tuple) -> Optional[int]:
    """The axis a spec splits over "stage" (the layer axis), or None."""
    return spec.index(STAGE_AXIS) if STAGE_AXIS in spec else None


def zero1_axis(spec: tuple, shape: tuple, dp: int,
               skip_leading: bool = False) -> Optional[int]:
    """The axis ZeRO-1 shards over "data": the first axis the spec
    leaves free whose length divides by dp, or None (the replicated
    residue)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, n) in enumerate(zip(parts, shape)):
        if skip_leading and i == 0:
            continue
        if p is None and n % dp == 0 and n >= dp:
            return i
    return None


def zero1_spec(spec: tuple, shape: tuple, dp: int,
               skip_leading: bool = False) -> tuple:
    """`spec` with "data" on the ZeRO-1 axis (JAX :142-167)."""
    k = zero1_axis(spec, shape, dp, skip_leading)
    if k is None:
        return tuple(spec)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[k] = DATA_AXIS
    return tuple(parts)


def optimizer_state_specs(cfg, params: dict, dp: int,
                          distributed: bool,
                          overlap_grads: bool = False) -> dict:
    """The spec tree of one params-shaped moment (JAX :113-198). Under
    `--overlap_grad_reduce` (`overlap_grads`) the stacked layer leaves
    skip their leading (layer) axis, so that the moments follow the
    grads the per-group reduce-scatter delivers, each rank a block of a
    within-layer axis (optimizer/zero1.py `OverlapPlan`)."""
    specs = param_specs(cfg, params)
    if not distributed or dp <= 1:
        return specs

    def walk(spec_tree, tree, stacked):
        return {k: walk(spec_tree[k], v, stacked or k == "layers")
                if isinstance(v, dict) else zero1_spec(
                    spec_tree[k], tuple(v.shape), dp,
                    skip_leading=overlap_grads and stacked)
                for k, v in tree.items()}

    return walk(specs, params, False)


def batch_specs() -> tuple:
    """(batch, seq) host batch: rows over "data" (JAX :309-311)."""
    return (DATA_AXIS, None)


def check_tp(cfg, tp: int) -> None:
    """The divisibility tensor parallelism needs: whole KV groups per
    rank (so Falcon-7B's single group cannot split), the attention heads
    (with `kv_channels`, the width each rank's heads span), the ffn and
    the padded vocabulary (build_tokenizer pads it to a multiple of
    tp x make_vocab_size_divisible_by)."""
    if tp == 1:
        return
    for name, n in (("query groups (num_attention_heads_kv)",
                     cfg.num_query_groups),
                    ("attention heads", cfg.num_attention_heads),
                    ("ffn_hidden_size", cfg.ffn_hidden_size),
                    ("padded_vocab_size", cfg.padded_vocab_size)):
        if n % tp:
            raise ValueError(f"tensor parallel size {tp} does not divide "
                             f"the {n} {name}: each rank holds whole "
                             f"groups of the grouped qkv layout")


def slice_axis(x: torch.Tensor, axis: Optional[int], n: int,
               i: int) -> torch.Tensor:
    """Block i of n along `axis` (all of x for None)."""
    if axis is None or n == 1:
        return x
    step = x.shape[axis] // n
    return x.narrow(axis, i * step, step)


def shard_params(params: dict, ctx, cfg=None) -> dict:
    """This rank's slice of the full tree: each leaf's block pp_rank of
    pp along its "stage" axis, then tp_rank of tp along its "model"
    axis, as a contiguous tensor of its own (the full tree can be
    freed). Leaves split over neither are returned as they are. `ctx`
    needs `tp`, `tp_rank` and, for pp > 1, `pp` and `pp_rank`."""
    pp = getattr(ctx, "pp", 1) if ctx is not None else 1
    if ctx is None or (ctx.tp == 1 and pp == 1):
        return params
    specs = layout_specs(cfg, params, pp)

    def cut(x, s):
        k, m = stage_axis(s), model_axis(s)
        if k is None and m is None:
            return x
        if k is not None:
            x = slice_axis(x, k, pp, ctx.pp_rank)
        return slice_axis(x, m, ctx.tp, ctx.tp_rank).contiguous()

    return tree_map(cut, params, specs)


def gather_params(shards: dict, ctx, cfg=None, tp: bool = True) -> dict:
    """The full tree from every rank's slice: an all-gather over the tp
    group, then over the pp group for the stacked layers, leaf by leaf
    (the inverse of `shard_params`). With `tp` False the tensor-parallel
    slices stay as they are and only the layers are gathered."""
    pp = getattr(ctx, "pp", 1) if ctx is not None else 1
    if ctx is None or ((ctx.tp == 1 or not tp) and pp == 1):
        return shards
    specs = layout_specs(cfg, shards, pp)

    def gather(x, s):
        for k, group in ((model_axis(s) if tp else None, ctx.tp_group),
                         (stage_axis(s), ctx.pp_group)):
            if k is not None:
                rows = all_gather_rows(x.detach().movedim(k, 0).contiguous(),
                                       group, ctx)
                x = rows.movedim(0, k).contiguous()
        return x

    return tree_map(gather, shards, specs)


# ---------------------------------------------------------------------------
# tensor-parallel serving: the page pools and the decode tree
# ---------------------------------------------------------------------------

def kv_pool_axis(shape: tuple, tp: int) -> Optional[int]:
    """The axis a paged KV pool leaf splits over "model" at serving tp
    (JAX :200-217): the group axis, index 2 of both the (num_pages,
    page_size, g, d) data pools and the (num_pages, page_size, g) int8
    scale pools, when tp divides it; else None (replicated). Pages and
    page offsets stay whole, so every rank addresses the same page ids
    and holds only its groups of each page."""
    if tp <= 1:
        return None
    if len(shape) < 3 or shape[2] % tp != 0 or shape[2] < tp:
        return None
    return 2


def kv_pool_spec(shape: tuple, tp: int) -> tuple:
    """The spec of one pool leaf (JAX :220-229): "model" on
    `kv_pool_axis`, every other axis whole; () when replicated."""
    k = kv_pool_axis(shape, tp)
    if k is None:
        return ()
    parts: list = [None] * len(shape)
    parts[k] = MODEL_AXIS
    return tuple(parts)


def kv_pool_shard_shape(shape: tuple, tp: int) -> tuple:
    """The shape of one rank's slice of a pool leaf."""
    k = kv_pool_axis(shape, tp)
    if k is None:
        return tuple(shape)
    out = list(shape)
    out[k] //= tp
    return tuple(out)


def decode_param_specs(cfg, dec_params: dict) -> dict:
    """The spec tree of the decode tree (`GPTModel.prepare_decode_params`:
    the layers a tuple of per-layer dicts), the `param_specs` rules
    without the layer axis (JAX :232-297): wqkv (and bqkv) and w1 (and
    b1) column-parallel, wo and w2 row-parallel, the word embeddings and
    an untied head on their vocabulary axis, the rest replicated. A GLU
    w1 must keep its (h, 2, f) layout: the flat (h, 2f) view joins gate
    and up along the axis tp splits, so a contiguous split would hand
    rank 0 the gates and rank 1 the ups."""

    def layer(tree: dict) -> dict:
        specs = _replicated(tree)
        attn = {"wqkv": (None, MODEL_AXIS), "wo": (MODEL_AXIS, None)}
        if "bqkv" in tree["attention"]:
            attn["bqkv"] = (MODEL_AXIS,)
        specs["attention"].update(attn)
        w1 = tree["mlp"]["w1"]
        if cfg.glu_activation:
            if getattr(w1, "ndim", 3) != 3:
                raise AssertionError(
                    "tp-sharded decode params need the UNFLATTENED (h, 2, "
                    "f) GLU layout (prepare_decode_params(flatten_glu="
                    "False)): the flat (h, 2f) layout concatenates gate|up "
                    "along the axis tp would shard")
            mlp = {"w1": (None, None, MODEL_AXIS), "w2": (MODEL_AXIS, None)}
            if "b1" in tree["mlp"]:
                mlp["b1"] = (None, MODEL_AXIS)
        else:
            mlp = {"w1": (None, MODEL_AXIS), "w2": (MODEL_AXIS, None)}
            if "b1" in tree["mlp"]:
                mlp["b1"] = (MODEL_AXIS,)
        specs["mlp"].update(mlp)
        return specs

    specs: dict = {}
    for key, val in dec_params.items():
        if key == "layers":
            specs[key] = tuple(layer(x) for x in val)
        elif key == "embedding":
            specs[key] = _replicated(val)
            specs[key]["word_embeddings"] = (MODEL_AXIS, None)
        elif key == "lm_head" and not isinstance(val, dict):
            specs[key] = (None, MODEL_AXIS)
        else:
            specs[key] = _replicated(val) if isinstance(val, dict) else ()
    return specs


def shard_decode_params(dec_params: dict, cfg, tp: int, rank: int) -> dict:
    """Tensor-parallel rank `rank`'s slice of the decode tree, cut by
    `decode_param_specs` as `shard_params` cuts the training tree: each
    split leaf a contiguous tensor of its own (the whole tree can be
    freed), the replicated ones as they are."""
    specs = decode_param_specs(cfg, dec_params)
    if tp == 1:
        return dec_params

    def cut(x, s):
        m = model_axis(s)
        if m is None:
            return x
        return slice_axis(x, m, tp, rank).contiguous()

    def walk(x, s):
        if isinstance(x, dict):
            return {k: walk(v, s[k]) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(walk(v, t) for v, t in zip(x, s))
        return cut(x, s)

    return walk(dec_params, specs)
