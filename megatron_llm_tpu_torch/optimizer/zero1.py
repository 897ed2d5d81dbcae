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
  all-gather per bucket rebuilds every rank's parameters (`ParamGather`,
  each waited for at once unless `--overlap_param_gather`).
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
GSPMD form, its `optimizer_state_specs` with the stage specs). At
cp > 1 the moments stay sharded over dp only: the cp ranks of a
coordinate hold the same blocks and apply the same update to gradients
already summed over the cp group (JAX zero1.py:457, sharding.py:175),
and `sum_over_layout` counts each leaf once. The reduction runs once a
step, after the microbatches' gradients have
accumulated (the reference's DDP; the JAX package reduces every
microbatch inside its scan).

The overlap schedulers (pure dp, JAX :194-330, :464-, :592-, :722-):

- `--overlap_grad_reduce`: `OverlapPlan` cuts the layer stack into
  groups of at least 2 layers of about `grad_rs_bucket_mb` MB of fp32
  gradient, each leaf sharded on a within-layer axis (`zero1_axis(...,
  skip_leading=True)`), the other leaves on the eager plan (`aux`).
  `GradOverlap` issues each group's reduce-scatter asynchronously
  during the last microbatch's backward, as soon as every layer of the
  group has its final gradient (hooks on the per-layer views,
  parallel/overlap.py), and the aux buckets after the backward; the
  train step waits for every handle before the overflow check,
  clipping and AdamW. The moments follow the grads to the within-layer
  axis (parallel/sharding.py `optimizer_state_specs`).
- `--overlap_param_gather`: `ParamGather` issues the all-gathers of
  the updated blocks asynchronously in forward order (the buckets
  holding the embedding first, then the layer groups), and the forward
  waits for each just before it first reads its leaves.
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
    done,
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


@dataclass(frozen=True)
class OverlapPlan:
    """The layout of `--overlap_grad_reduce` (JAX :194-291): the stacked
    layer leaves cut into contiguous layer `groups` (forward order; the
    backward issues them last to first), each layer leaf sharded on its
    within-layer axis `layer_axes` (None: the residue, all-reduced
    whole), and the other leaves' eager plan `aux`."""

    dp: int
    num_layers: int
    groups: Tuple[Tuple[int, int], ...]
    layer_axes: Tuple[Optional[int], ...]
    layer_shapes: Tuple[Tuple[int, ...], ...]
    aux: Zero1Plan

    def layer_shard_shape(self, i: int) -> Tuple[int, ...]:
        k = self.layer_axes[i]
        if k is None:
            return self.layer_shapes[i]
        s = list(self.layer_shapes[i])
        s[k] //= self.dp
        return tuple(s)

    def _group_elems(self, lo: int, hi: int) -> int:
        return sum((hi - lo) * _numel(self.layer_shapes[i][1:])
                   for i, k in enumerate(self.layer_axes) if k is not None)

    def bucket_comm_bytes(self, quantized: bool) -> Tuple[int, ...]:
        """Per issue point: each layer group (forward order), then the
        aux buckets."""
        groups = tuple(
            _bucket_wire_bytes(self._group_elems(lo, hi), self.dp,
                               quantized)
            for lo, hi in self.groups)
        return groups + self.aux.bucket_comm_bytes(quantized)

    def comm_bytes_per_reduce(self, quantized: bool) -> int:
        res = sum(_numel(self.layer_shapes[i])
                  for i, k in enumerate(self.layer_axes) if k is None)
        res += sum(_numel(self.aux.shapes[i]) for i in self.aux.residue)
        return sum(self.bucket_comm_bytes(quantized)) + res * 4


def split_aux_layers(params: dict):
    """(the non-layer subtree, the stacked-layer subtree)."""
    return {k: v for k, v in params.items() if k != "layers"}, \
        params.get("layers", {})


def build_overlap_plan(cfg, params_tmpl, dp: int,
                       bucket_mb: float = 4.0) -> OverlapPlan:
    """Layer groups of about `bucket_mb` MB of fp32 gradient and at
    least 2 layers (a trailing single layer joins the group before it),
    and the aux subtree's eager plan (JAX :238-291; the same groups,
    axes and shapes)."""
    from megatron_llm_tpu_torch.parallel.sharding import param_specs

    aux_tmpl, layers_tmpl = split_aux_layers(params_tmpl)
    flat_l = tree_leaves(layers_tmpl)
    lspecs = spec_leaves(param_specs(cfg, params_tmpl)["layers"])
    L = int(flat_l[0].shape[0])
    layer_axes: List[Optional[int]] = []
    per_layer_bytes = 0
    for leaf, spec in zip(flat_l, lspecs):
        k = zero1_axis(spec, tuple(leaf.shape), dp, skip_leading=True)
        layer_axes.append(k)
        if k is not None:
            per_layer_bytes += _numel(leaf.shape[1:]) * 4
    target = max(int(bucket_mb * (1 << 20)), 1)
    per_group = min(L, max(2, target // max(per_layer_bytes, 1))) \
        if L > 1 else 1
    groups = [[lo, min(lo + per_group, L)] for lo in range(0, L, per_group)]
    if len(groups) > 1 and groups[-1][1] - groups[-1][0] < 2:
        groups[-2][1] = groups[-1][1]
        groups.pop()
    return OverlapPlan(
        dp=dp, num_layers=L, groups=tuple(tuple(g) for g in groups),
        layer_axes=tuple(layer_axes),
        layer_shapes=tuple(tuple(x.shape) for x in flat_l),
        aux=build_zero1_plan(cfg, aux_tmpl, dp, bucket_mb=bucket_mb))


def layer_leaf_indices(params: dict) -> Tuple[List[int], List[int]]:
    """(the `tree_leaves` indices of the aux leaves, of the layer
    leaves), each in its subtree's own leaf order."""
    index, _ = map_indexed(lambda i, _: i, params)
    aux, layers = split_aux_layers(index)
    return tree_leaves(aux), tree_leaves(layers)


def overlap_state_plan(plan: OverlapPlan, params: dict) -> Zero1Plan:
    """The whole tree's per-leaf ZeRO-1 axes under the overlap layout,
    as a `Zero1Plan` with no buckets: what the moments, the update's
    blocks and the gradient norm's dp flags follow."""
    aux_idx, layer_idx = layer_leaf_indices(params)
    flat = tree_leaves(params)
    axes: List[Optional[int]] = [None] * len(flat)
    for j, i in enumerate(aux_idx):
        axes[i] = plan.aux.leaf_axes[j]
    for j, i in enumerate(layer_idx):
        axes[i] = plan.layer_axes[j]
    return Zero1Plan(
        dp=plan.dp, leaf_axes=tuple(axes), buckets=(),
        residue=tuple(i for i, k in enumerate(axes) if k is None),
        shapes=tuple(tuple(x.shape) for x in flat))


def build_state_plan(cfg, params_tmpl, dp: int, bucket_mb: float = 4.0,
                     pp: int = 1, overlap_grads: bool = False) -> Zero1Plan:
    """The per-leaf layout the moments are kept in: the eager plan, or
    under `--overlap_grad_reduce` the overlap layout's."""
    if overlap_grads:
        return overlap_state_plan(
            build_overlap_plan(cfg, params_tmpl, dp, bucket_mb), params_tmpl)
    return build_zero1_plan(cfg, params_tmpl, dp, bucket_mb, pp=pp)


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


# ---------------------------------------------------------------------------
# the overlap schedulers
# ---------------------------------------------------------------------------

class GradOverlap:
    """`--overlap_grad_reduce` for one step (JAX :464-): the layer
    groups' reduce-scatters issued during the last microbatch's
    backward, the aux buckets after it. `hook(j, layer, grad)` receives
    the gradient of layer `layer` of layer leaf j (the per-layer views'
    taps, parallel/overlap.py); once every sharded layer leaf of a
    group has its gradient, the group's rows (the earlier microbatches'
    sum, set aside by `begin_last`, plus this one's) are packed as in
    the eager path and issued. `reduce(grads)` issues what the
    hooks did not (the aux buckets, a group a leaf had no gradient in),
    waits for every handle in issue order and returns the gradients in
    the state layout: this rank's blocks, the residue whole."""

    def __init__(self, plan: OverlapPlan, params: dict, ctx,
                 quantized: bool = False):
        self.plan, self.ctx, self.quantized = plan, ctx, quantized
        self.aux_idx, self.layer_idx = layer_leaf_indices(params)
        self.leaves = []  # the step's parameter leaves (begin_last)
        self.sharded = [j for j, k in enumerate(plan.layer_axes)
                        if k is not None]
        self.last_from_hooks = 0  # the last step's groups issued early
        # the last step's overlap gauges (analysis/overlap.py): works
        # issued while another group's backward had still to run, and
        # the most works issued and not yet waited for at once
        self.last_pairs = self.last_max_in_flight = 0
        self.group_of = {}
        for gi, (lo, hi) in enumerate(plan.groups):
            for layer in range(lo, hi):
                self.group_of[layer] = gi
        self.reset()

    def reset(self) -> None:
        self.grads = {}
        self.count = [0] * len(self.plan.groups)
        self.pending = []  # (group index or None, handle, entries), order
        self.prev = None
        self.from_hooks = 0  # groups issued inside the backward
        self.pairs = self.max_in_flight = 0

    def begin_last(self, leaves: list) -> None:
        """Before the last microbatch's backward of `leaves` (the
        parameter leaves, leaf order): the gradients summed so far are
        set aside (`.grad` to None), so that the backward's accumulation
        cannot change them under a group being packed."""
        self.leaves = leaves
        self.prev = [p.grad for p in self.leaves]
        for p in self.leaves:
            p.grad = None

    def end_last(self) -> None:
        """After it: each `.grad` is the earlier sum plus this
        microbatch's, the add the backward's accumulation makes."""
        for p, prev in zip(self.leaves, self.prev or ()):
            if prev is not None:
                p.grad = prev if p.grad is None else prev.add_(p.grad)

    def hook(self, j: int, layer: int, grad: torch.Tensor) -> None:
        if self.plan.layer_axes[j] is None:
            return
        self.grads[(j, layer)] = grad
        gi = self.group_of[layer]
        self.count[gi] += 1
        lo, hi = self.plan.groups[gi]
        if self.count[gi] == (hi - lo) * len(self.sharded):
            # a group issued while another still runs its backward has
            # compute to hide behind
            self.pairs += any(c >= 0 for g, c in enumerate(self.count)
                              if g != gi)
            self._issue_group(gi)
            self.from_hooks += 1

    def _group_rows(self, j: int, lo: int, hi: int) -> torch.Tensor:
        i = self.layer_idx[j]
        parts = [self.grads.pop((j, layer), None) for layer in range(lo, hi)]
        rows = torch.stack([torch.zeros_like(self.leaves[i][0]) if g is None
                            else g for g in parts])
        prev = None if self.prev is None else self.prev[i]
        if prev is not None:  # the earlier microbatches' sum
            rows = prev[lo:hi] + rows
        return rows

    def _issue(self, mats, entries, tag) -> None:
        cat = mats[0].contiguous() if len(mats) == 1 \
            else torch.cat(mats, dim=1)
        if self.quantized:
            handle = done(quantized_bucket_reduce_scatter(cat, self.ctx))
        else:
            handle = reduce_scatter_rows(cat.reshape(-1), self.ctx.dp_group,
                                         self.ctx, async_op=True)
        self.pending.append((tag, handle, entries))
        self.max_in_flight = max(self.max_in_flight, len(self.pending))

    def _issue_group(self, gi: int, grads: Optional[list] = None) -> None:
        """Pack and issue group gi: from the hooks' per-layer gradients,
        or with `grads` from the accumulated gradients (a group some
        leaf's hooks did not complete)."""
        lo, hi = self.plan.groups[gi]
        self.count[gi] = -1  # issued
        mats, entries = [], []
        for j in self.sharded:
            k = self.plan.layer_axes[j]
            rows = self._group_rows(j, lo, hi) if grads is None \
                else grads[self.layer_idx[j]][lo:hi]
            m = to_dp_matrix(rows, k, self.plan.dp)
            entries.append((j, k, m.shape[1]))
            mats.append(m)
        self._issue(mats, entries, gi)

    def reduce(self, grads: list) -> list:
        plan, dp = self.plan, self.plan.dp
        # a group whose hooks did not all fire: issued now, last to first
        for gi in reversed(range(len(plan.groups))):
            if self.count[gi] >= 0 and self.sharded:
                self._issue_group(gi, grads)
        aux = plan.aux
        for bucket in aux.buckets:
            mats = [to_dp_matrix(grads[self.aux_idx[b]], aux.leaf_axes[b],
                                 dp) for b in bucket]
            self._issue(mats, [(b, aux.leaf_axes[b], m.shape[1])
                               for b, m in zip(bucket, mats)], None)
        out = list(grads)
        for j, k in enumerate(plan.layer_axes):
            if k is None:
                i = self.layer_idx[j]
                out[i] = all_reduce(grads[i].float().contiguous(),
                                    self.ctx.dp_group, ctx=self.ctx)
        for b in aux.residue:
            i = self.aux_idx[b]
            out[i] = all_reduce(grads[i].float().contiguous(),
                                self.ctx.dp_group, ctx=self.ctx)
        shards = {}
        for tag, handle, entries in self.pending:
            row = handle.wait()
            off = 0
            if tag is None:
                for b, k, n in entries:
                    out[self.aux_idx[b]] = from_shard_row(
                        row[off:off + n], aux.shapes[b], k, dp)
                    off += n
                continue
            lo, hi = plan.groups[tag]
            for j, k, n in entries:
                shape = (hi - lo,) + plan.layer_shapes[j][1:]
                if j not in shards:
                    shards[j] = torch.empty(
                        plan.layer_shard_shape(j), dtype=torch.float32,
                        device=row.device)
                shards[j][lo:hi] = from_shard_row(row[off:off + n], shape,
                                                  k, dp)
                off += n
        for j, x in shards.items():
            out[self.layer_idx[j]] = x
        self.last_from_hooks = self.from_hooks
        self.last_pairs, self.last_max_in_flight = (self.pairs,
                                                    self.max_in_flight)
        self.reset()
        return out

    def drain(self) -> None:
        """Wait for every handle in flight and drop the step's state (a
        step that raised)."""
        for _, handle, _ in self.pending:
            handle.wait()
        self.reset()


class ParamGather:
    """The all-gather of the updated blocks as units, each one
    all-gather of its leaves' rows, in forward order (JAX :722-): the
    eager plan's buckets, or under the overlap layout the aux buckets
    and then the layer groups. `issue(params, shards)` starts them all
    (asynchronously with `overlap`, else each waited at once);
    `before_embedding()` and `before_layer(i)` wait for the units the
    forward reads next (parallel/overlap.py installs them), `drain()`
    for all."""

    def __init__(self, plan, params: dict, ctx, overlap: bool):
        self.ctx, self.overlap = ctx, overlap
        self.units = []  # (first layer read or -1, [(leaf, rows, k, shape)])
        if isinstance(plan, OverlapPlan):
            aux_idx, layer_idx = layer_leaf_indices(params)
            for bucket in plan.aux.buckets:
                self.units.append((-1, [
                    (aux_idx[b], slice(None), plan.aux.leaf_axes[b],
                     plan.aux.shapes[b]) for b in bucket]))
            for lo, hi in plan.groups:
                unit = [(layer_idx[j], slice(lo, hi), k,
                         (hi - lo,) + plan.layer_shapes[j][1:])
                        for j, k in enumerate(plan.layer_axes)
                        if k is not None]
                if unit:
                    self.units.append((lo, unit))
        else:
            aux_idx, _ = layer_leaf_indices(params)
            aux = set(aux_idx)
            for bucket in plan.buckets:
                first = -1 if any(i in aux for i in bucket) else 0
                self.units.append((first, [
                    (i, slice(None), plan.leaf_axes[i], plan.shapes[i])
                    for i in bucket]))
        self.pending = []  # (first layer, handle, unit, leaves), in order

    @torch.no_grad()
    def issue(self, leaves: list, shards: list) -> None:
        """Gather `shards` (this rank's updated blocks, leaf order) into
        `leaves` (the parameter leaves, updated when each unit lands)."""
        for first, unit in self.units:
            rows = [shards[i][sl].movedim(k, 0).reshape(-1)
                    for i, sl, k, _ in unit]
            row = rows[0] if len(rows) == 1 else torch.cat(rows)
            h = all_gather_rows(row.float().contiguous()[None],
                                self.ctx.dp_group, self.ctx, async_op=True)
            self.pending.append((first, h, unit, leaves))
            if not self.overlap:
                # one unit's gathered rows alive at a time
                self._consume(1)

    @torch.no_grad()
    def _consume(self, n: int) -> None:
        for _ in range(n):
            _, h, unit, leaves = self.pending.pop(0)
            full = h.wait()
            off = 0
            for i, sl, k, shape in unit:
                m = _numel(shape) // full.shape[0]
                # through .data: the layers before this unit already
                # saved views of the same leaf for their backward, and
                # these rows are not among what they read
                leaves[i].data[sl].copy_(from_dp_matrix(
                    full[:, off:off + m], shape, k))
                off += m

    def before_embedding(self) -> None:
        # units are in forward order: everything up to the last one that
        # holds a leaf the embedding's step reads
        last = max((j for j, p in enumerate(self.pending) if p[0] < 0),
                   default=-1)
        self._consume(last + 1)

    def before_layer(self, layer: int) -> None:
        last = max((j for j, p in enumerate(self.pending)
                    if p[0] <= layer), default=-1)
        self._consume(last + 1)

    def drain(self) -> None:
        self._consume(len(self.pending))
