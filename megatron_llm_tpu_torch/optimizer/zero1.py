"""ZeRO-1 over the data-parallel group: reduce-scatter the gradients,
update the rank's shard, all-gather the parameters (port of
optimizer/zero1.py, its eager schedule).

- Buckets of about `grad_rs_bucket_mb` MB of fp32 gradient: each leaf
  with a dp-divisible free axis (parallel/sharding.py `zero1_axis`, the
  one divisibility rule) is moved so that axis leads and reshaped to
  (dp, n), so row r is rank r's block; a bucket is its leaves' rows side
  by side, a (dp, N) matrix (JAX :152-196).
- One `reduce_scatter_tensor` per bucket over the dp group leaves rank r
  the sum of row r; leaves with no such axis (norm scales) ride a plain
  all-reduce and keep whole optimizer state, as in the JAX package.
- AdamW runs on the fp32 shard (optimizer/optimizer.py), then one
  all-gather per bucket rebuilds every rank's parameters.
- `--quantized_grad_reduce` (pure dp only): each bucket row is
  chunk-quantized to int8 with one fp32 scale per QUANT_CHUNK elements
  (ops/quantization.quantize_rows), the rows are exchanged with
  `all_to_all` and the dp partials dequantized and summed in fp32 (JAX
  :379-404).

The replicated optimizer at dp > 1 reduces the same bucket matrices with
an all-reduce, whose sums are the reduce-scatter's element for element,
so ZeRO-1 and the replicated AdamW update from the same gradients. At
pp > 1 each stage's moments are sharded over that stage's dp group,
ZeRO-1's axis chosen past the stage's layer axis (the JAX package's
GSPMD form, its `optimizer_state_specs` with the stage specs). The
reduction runs once a step, after the microbatches' gradients have
accumulated (the reference's DDP; the JAX package reduces every
microbatch inside its scan). `OverlapPlan` and the overlap schedulers
wait for the next A4 PR.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce,
    all_to_all_rows,
    reduce_scatter_rows,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    layout_specs,
    spec_leaves,
    zero1_axis,
)

# one fp32 scale per this many gradient elements of the int8 wire
QUANT_CHUNK = 512


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _bucket_wire_bytes(elems: int, dp: int, quantized: bool) -> int:
    if not quantized:
        return elems * 4
    n_chunks = -(-elems // (dp * QUANT_CHUNK)) * dp
    return elems * 1 + n_chunks * 4


@dataclass(frozen=True)
class Zero1Plan:
    """The per-leaf layout and the buckets of one parameter tree, leaves
    in `tree_leaves` order (the JAX package's flatten order)."""

    dp: int
    leaf_axes: Tuple[Optional[int], ...]
    buckets: Tuple[Tuple[int, ...], ...]
    residue: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    def shard_shape(self, i: int) -> Tuple[int, ...]:
        k = self.leaf_axes[i]
        if k is None:
            return self.shapes[i]
        s = list(self.shapes[i])
        s[k] //= self.dp
        return tuple(s)

    def bucket_comm_bytes(self, quantized: bool) -> Tuple[int, ...]:
        return tuple(
            _bucket_wire_bytes(sum(_numel(self.shapes[i]) for i in b),
                               self.dp, quantized)
            for b in self.buckets)

    def comm_bytes_per_reduce(self, quantized: bool) -> int:
        res = sum(_numel(self.shapes[i]) for i in self.residue)
        return sum(self.bucket_comm_bytes(quantized)) + res * 4


def build_zero1_plan(cfg, params_tmpl, dp: int,
                     bucket_mb: float = 4.0, pp: int = 1) -> Zero1Plan:
    """Greedy buckets in leaf order, a leaf above the target in a bucket
    of its own (JAX :152-196). `params_tmpl` is this rank's tree (a tp
    rank's slices, a stage's layers): the plan is per rank. At pp > 1
    the stage's layer axis is taken, as in the stage specs."""
    flat = tree_leaves(params_tmpl)
    specs = spec_leaves(layout_specs(cfg, params_tmpl, pp))
    target = max(int(bucket_mb * (1 << 20)), 1)
    leaf_axes: List[Optional[int]] = []
    buckets: List[List[int]] = []
    residue: List[int] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, (leaf, spec) in enumerate(zip(flat, specs)):
        k = zero1_axis(spec, tuple(leaf.shape), dp)
        leaf_axes.append(k)
        if k is None:
            residue.append(i)
            continue
        nbytes = leaf.numel() * 4
        if cur and cur_bytes + nbytes > target:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        if cur_bytes >= target:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return Zero1Plan(
        dp=dp, leaf_axes=tuple(leaf_axes),
        buckets=tuple(tuple(b) for b in buckets), residue=tuple(residue),
        shapes=tuple(tuple(x.shape) for x in flat))


def to_dp_matrix(g: torch.Tensor, k: int, dp: int) -> torch.Tensor:
    """The zero1 axis moved to the front, reshaped to (dp, n) fp32: row r
    is rank r's block of axis k."""
    return g.movedim(k, 0).reshape(dp, -1).float()


def from_shard_row(row: torch.Tensor, shape, k: int,
                   dp: int) -> torch.Tensor:
    """One rank's row back to its block of `shape` (axis k / dp)."""
    moved = (shape[k] // dp,) + tuple(n for i, n in enumerate(shape)
                                      if i != k)
    return row.reshape(moved).movedim(0, k)


def from_dp_matrix(mat: torch.Tensor, shape, k: int) -> torch.Tensor:
    """The whole (dp, n) matrix back to `shape`."""
    rest = tuple(n for i, n in enumerate(shape) if i != k)
    return mat.reshape((shape[k],) + rest).movedim(0, k)


def quantized_bucket_reduce_scatter(mat: torch.Tensor, ctx) -> torch.Tensor:
    """Int8 reduce-scatter of a (dp, n) matrix of local partials: each
    row chunk-quantized, row j sent to rank j by all_to_all (int8 data
    and fp32 scales), the dp received rows dequantized and summed in
    fp32. Returns this rank's (n,) row of the sum."""
    from megatron_llm_tpu_torch.ops.quantization import quantize_rows

    dp, n = mat.shape
    pad = (-n) % QUANT_CHUNK
    if pad:
        mat = torch.nn.functional.pad(mat, (0, pad))
    nch = mat.shape[1] // QUANT_CHUNK
    data, scale = quantize_rows(mat.reshape(dp, nch, QUANT_CHUNK))
    data = all_to_all_rows(data, ctx.dp_group, ctx)
    scale = all_to_all_rows(scale, ctx.dp_group, ctx)
    red = (data.float() * scale[..., None]).sum(dim=0).reshape(-1)
    return red[:n] if pad else red


def reduce_gradients(grads: list, plan: Zero1Plan, ctx, zero1: bool,
                     quantized: bool = False) -> list:
    """Each rank's local gradients (a list in leaf order) summed over the
    dp group: under `zero1` the bucket leaves come back as this rank's
    blocks (shard shapes), else every leaf whole, all-reduced in the same
    bucket matrices. Residue leaves are all-reduced whole either way."""
    dp = plan.dp
    out = list(grads)
    for i in plan.residue:
        out[i] = all_reduce(grads[i].float().contiguous(), ctx.dp_group,
                            ctx=ctx)
    for bucket in plan.buckets:
        mats = [to_dp_matrix(grads[i], plan.leaf_axes[i], dp)
                for i in bucket]
        sizes = [m.shape[1] for m in mats]
        cat = mats[0].contiguous() if len(mats) == 1 \
            else torch.cat(mats, dim=1)
        if not zero1:
            full = all_reduce(cat, ctx.dp_group, ctx=ctx)
            off = 0
            for i, n in zip(bucket, sizes):
                out[i] = from_dp_matrix(full[:, off:off + n],
                                        plan.shapes[i], plan.leaf_axes[i])
                off += n
            continue
        if quantized:
            row = quantized_bucket_reduce_scatter(cat, ctx)
        else:
            row = reduce_scatter_rows(cat.reshape(-1), ctx.dp_group,
                                      ctx)
        off = 0
        for i, n in zip(bucket, sizes):
            out[i] = from_shard_row(row[off:off + n], plan.shapes[i],
                                    plan.leaf_axes[i], dp)
            off += n
    return out


def param_shards(params: list, plan: Zero1Plan, r: int) -> list:
    """This rank's blocks of the bucket leaves (views where the ZeRO-1
    axis leads, copies elsewhere) and the residue leaves whole: what
    AdamW updates."""
    out = []
    for i, p in enumerate(params):
        k = plan.leaf_axes[i]
        out.append(p if k is None else from_shard_row(
            to_dp_matrix(p.detach(), k, plan.dp)[r], plan.shapes[i], k,
            plan.dp))
    return out


@torch.no_grad()
def gather_param_shards(params: list, shards: list, plan: Zero1Plan,
                        ctx) -> None:
    """Every rank's updated blocks back into every rank's parameters:
    one all-gather per bucket."""
    for bucket in plan.buckets:
        rows = [shards[i].movedim(plan.leaf_axes[i], 0).reshape(-1)
                for i in bucket]
        sizes = [x.numel() for x in rows]
        row = rows[0] if len(rows) == 1 else torch.cat(rows)
        full = all_gather_rows(row.float().contiguous()[None],
                               ctx.dp_group, ctx)
        off = 0
        for i, n in zip(bucket, sizes):
            p = params[i]
            p.copy_(from_dp_matrix(full[:, off:off + n], plan.shapes[i],
                                   plan.leaf_axes[i]))
            off += n


def sum_over_layout(tp_sharded, dp_sharded, ctx, pp_sharded=None):
    """A function of per-leaf partial sums (0-d tensors, leaf order) to
    their sum over the whole model: a tp-sharded leaf's partial summed
    over the tp group, a ZeRO-1 block's over the dp group, a stage's
    layer slice over the pp group, a replicated leaf counted once.
    `tp_sharded`, `dp_sharded` and `pp_sharded` are per-leaf flags. The
    global gradient norm and zero count (JAX: the norm of the global
    gradient tree)."""
    pp_sharded = pp_sharded or [False] * len(tp_sharded)

    def reduce(vals: list) -> torch.Tensor:
        # bin 4 p + 2 d + t holds the leaves sharded as (p, d, t) say
        parts = torch.zeros(8, dtype=torch.float64, device=vals[0].device)
        for v, t, d, p in zip(vals, tp_sharded, dp_sharded, pp_sharded):
            parts[4 * int(p) + 2 * int(d) + int(t)] += v.double()
        for bit, group in ((2, ctx.dp_group), (1, ctx.tp_group),
                           (4, getattr(ctx, "pp_group", None))):
            if group is not None:
                bins = [i for i in range(8) if i & bit]
                parts[bins] = all_reduce(parts[bins].clone(), group,
                                         ctx=ctx)
        # the single-stage sum's order: replicated, dp, tp, both
        return sum(parts[i] for i in (0, 2, 1, 3, 4, 6, 5, 7))

    return reduce


def any_rank(flags: torch.Tensor, ctx) -> torch.Tensor:
    """Elementwise: True on every rank where any rank's flag is True (an
    all-reduce max over the whole world)."""
    out = all_reduce(flags.to(torch.int32), ctx.world_group,
                     op=dist.ReduceOp.MAX, ctx=ctx)
    return out.bool()


def map_indexed(fn, tree, start: int = 0):
    """`fn(i, leaf)` over a tree's leaves, i counting in `tree_leaves`
    order; returns (new tree, next index)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k], start = map_indexed(fn, tree[k], start)
        return {k: out[k] for k in tree}, start
    return fn(start, tree), start + 1
