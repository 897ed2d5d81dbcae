"""The tensor- and sequence-parallel collectives as conjugate autograd
pairs (the reference's core/tensor_parallel/mappings.py:253-278; the
JAX package gets the same collectives from GSPMD at its
`shard_activation` sites, parallel/mesh.py:273-290).

| function | forward | backward |
|---|---|---|
| `copy_to_tp` | identity | all-reduce |
| `reduce_from_tp` | all-reduce | identity |
| `scatter_to_sequence` | this rank's sequence chunk | all-gather |
| `gather_from_sequence` | all-gather along the sequence | reduce-scatter |
| `reduce_scatter_to_sequence` | reduce-scatter along the sequence | all-gather |

The sequence axis is axis 1 of (b, s, ...) activations. Every function
is the identity, and issues no collective, without a context or at
tp = 1. `tp_input` and `tp_output` are what a column-parallel matmul
reads and a row-parallel one writes: the replicated activation (copy /
all-reduce), or under sequence parallelism its sequence shard (gather /
reduce-scatter).
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce,
    get_context,
    reduce_scatter_rows,
)


def _tp():
    ctx = get_context()
    return ctx if ctx is not None and ctx.tp > 1 else None


def _seq_first(x):
    return x.transpose(0, 1).contiguous()


def _gather_seq(x, ctx):
    return all_gather_rows(_seq_first(x), ctx.tp_group, ctx).transpose(0, 1)


def _reduce_scatter_seq(x, ctx):
    return reduce_scatter_rows(_seq_first(x), ctx.tp_group,
                               ctx).transpose(0, 1)


def _chunk_seq(x, ctx):
    n = x.shape[1] // ctx.tp
    return x[:, ctx.tp_rank * n:(ctx.tp_rank + 1) * n]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(c, x, ctx):
        c.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(c, g):
        # a buffer of its own: autograd may hand the same gradient to
        # another consumer
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          c.ctx.tp_group, ctx=c.ctx), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(c, x, ctx):
        return all_reduce(x.clone(), ctx.tp_group, ctx=ctx)

    @staticmethod
    def backward(c, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(c, x, ctx):
        c.ctx = ctx
        return _chunk_seq(x, ctx).contiguous()

    @staticmethod
    def backward(c, g):
        return _gather_seq(g, c.ctx), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(c, x, ctx):
        c.ctx = ctx
        return _gather_seq(x, ctx)

    @staticmethod
    def backward(c, g):
        return _reduce_scatter_seq(g, c.ctx), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(c, x, ctx):
        c.ctx = ctx
        return _reduce_scatter_seq(x, ctx)

    @staticmethod
    def backward(c, g):
        return _gather_seq(g, c.ctx), None


def _mapping(fn):
    def apply(x):
        ctx = _tp()
        return x if ctx is None else fn.apply(x, ctx)
    apply.__name__ = fn.__name__
    return apply


copy_to_tp = _mapping(_Copy)
reduce_from_tp = _mapping(_Reduce)
scatter_to_sequence = _mapping(_Scatter)
gather_from_sequence = _mapping(_Gather)
reduce_scatter_to_sequence = _mapping(_ReduceScatter)


def sequence_parallel() -> bool:
    ctx = _tp()
    return ctx is not None and ctx.sequence_parallel


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel matmul: the full activation."""
    return gather_from_sequence(x) if sequence_parallel() else copy_to_tp(x)


def tp_output(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel matmul, its partial sums reduced:
    whole, or the rank's sequence shard under sequence parallelism."""
    if sequence_parallel():
        return reduce_scatter_to_sequence(x)
    return reduce_from_tp(x)


def sequence_shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's sequence chunk of a tensor every rank holds whole,
    without autograd (position ids, masks); `x` outside sequence
    parallelism."""
    return _chunk_seq(x, _tp()) if sequence_parallel() else x
