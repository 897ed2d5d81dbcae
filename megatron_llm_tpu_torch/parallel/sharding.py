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
- norms, position embeddings and the biases of row-parallel outputs:
  replicated.

Under pipeline parallelism `pipeline_param_specs` puts "stage" on the
layer axis that leads every stacked leaf (a stage holds num_layers / pp
consecutive layers); the embedding, the final norm and the head stay
whole on every stage (JAX parallel/pipeline.py:72-89). ZeRO-1
(optimizer/zero1.py) shards a leaf's optimizer state over "data" on the
axis `zero1_axis` picks: the one divisibility rule (JAX :113-140).
`kv_pool_spec` and `decode_param_specs` wait for tp serving (the next
A4 PR).
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
    """The spec tree of a GPT/Llama/Falcon parameter tree (JAX :31-102);
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
        return out

    specs = _replicated(params)
    if "layers" in params:
        specs["layers"] = layer_specs(params["layers"])
    if "embedding" in params:
        specs["embedding"]["word_embeddings"] = (MODEL_AXIS, None)
    if "lm_head" in params and not isinstance(params["lm_head"], dict):
        specs["lm_head"] = (None, MODEL_AXIS)
    return specs


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
                          distributed: bool) -> dict:
    """The spec tree of one params-shaped moment (JAX :175-198)."""
    specs = param_specs(cfg, params)
    if not distributed or dp <= 1:
        return specs
    return tree_map(lambda s, p: zero1_spec(s, tuple(p.shape), dp), specs,
                params)


def batch_specs() -> tuple:
    """(batch, seq) host batch: rows over "data" (JAX :309-311)."""
    return (DATA_AXIS, None)


def check_tp(cfg, tp: int) -> None:
    """The divisibility tensor parallelism needs: whole KV groups per
    rank (so Falcon-7B's single group cannot split), heads, the ffn and
    the padded vocabulary."""
    if tp == 1:
        return
    for name, n in (("query groups (num_attention_heads_kv)",
                     cfg.num_query_groups),
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
