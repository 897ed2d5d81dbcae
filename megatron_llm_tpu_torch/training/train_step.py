"""The training step (port of training/train_step.py).

The JAX package jits one function: the microbatch loop as a `lax.scan`,
fp32 gradient accumulation, the averaged loss, the loss watchdog's skip
gate and the optimizer. Here it is eager PyTorch: a Python loop over
microbatches, each a forward and a backward whose gradients accumulate
in the fp32 params' `.grad` (the first microbatch's gradient is the
sum's first term, as JAX's zeros + g1), divided by the microbatch count,
then `optimizer_step` in place. Nothing is read back on the host: the
loss, the skip flag and the gradient norm stay 0-d tensors on the card
for the caller to read when it logs.

Under fp16 each microbatch's loss is multiplied by the loss scaler's
scale before its backward; the accumulated gradients are divided by it
after, and a non-finite gradient norm skips the step and feeds the
scaler (JAX :191-316). Given a dropout stream `rng` (an integer seed,
models/dropout.py) microbatch i draws from fold_in(rng, i), or from
`rng` itself when there is one microbatch (JAX :253-281).

Across ranks (a context from parallel/mesh.py) each rank holds its
tensor-parallel slices and its rows of every global microbatch, under
context parallelism its sequence shard of them. A microbatch's loss is
its tokens' masked sum over the denominator summed over the dp and cp
groups, so the ranks' gradients sum to the gradient of the global
token-weighted mean (never a mean of per-rank means: their mask counts
differ), and the reported loss is the global one. After the
accumulation: under sequence parallelism the replicated leaves'
gradients (norms, output biases), partial sums over sequence shards,
are all-reduced over the tp group; every gradient is summed over the cp
group (each cp rank holds every parameter whole, as the JAX package's
GSPMD path does); then the dp reduction, an all-reduce or ZeRO-1's
reduce-scatter with the update on the rank's block and an all-gather
(optimizer/zero1.py; the moments stay sharded over dp only); the
gradient norm is the global gradient's, each leaf counted once, and
the skip flags agree on every rank. At world size 1 nothing of this
runs. Live dropout across ranks raises: its masks would not be the
global mask's slices (the next A4 PR). At pp > 1 the microbatches run
through the pipeline's schedule (parallel/pipeline.py).

The overlap schedulers and a `batch_builder` belong to later slices and
raise.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.models.dropout import fold_in
from megatron_llm_tpu_torch.optimizer import zero1
from megatron_llm_tpu_torch.optimizer.optimizer import (
    OptimizerState,
    get_grad_scaler,
    optimizer_step,
    tree_leaves,
)
from megatron_llm_tpu_torch.parallel.mesh import (
    A4_DROPOUT,
    all_reduce,
    get_context,
    sum_over_tokens,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    layout_specs,
    model_axis,
    spec_leaves,
    stage_axis,
)


def check_layout(model, pcfg: ParallelConfig):
    """The installed context (parallel/mesh.py), checked against the
    ParallelConfig and the model; None at world size 1 with no
    context."""
    ctx = get_context()
    have = (1, 1, 1, 1) if ctx is None else (ctx.dp, ctx.pp, ctx.cp,
                                               ctx.tp)
    want = pcfg.mesh_shape
    if have != want:
        raise ValueError(f"the ParallelConfig asks dp, pp, cp, tp = {want}; "
                         f"the installed parallel context is {have}")
    if ctx is not None and ctx.sequence_parallel != pcfg.sequence_parallel:
        raise ValueError("sequence_parallel differs between the "
                         "ParallelConfig and the parallel context")
    cfg = model.cfg
    if ctx is not None and ctx.world_size > 1 and (
            cfg.hidden_dropout > 0 or cfg.attention_dropout > 0):
        raise ValueError(f"dropout across {ctx.world_size} ranks is not "
                         f"ported yet ({A4_DROPOUT}): a rank would not "
                         f"draw its slice of the global mask")
    return ctx if ctx is not None and ctx.world_size > 1 else None


def sequence_parallel_grads(grads: list, tp_sharded: list, ctx) -> list:
    """Under sequence parallelism, the replicated leaves' gradients
    (norms, position embeddings, output biases: partial sums over the
    rank's sequence shard) summed over the tp group in place, as the
    reference's sequence-parallel gradient all-reduce does."""
    if ctx is not None and ctx.sequence_parallel:
        for g, sharded in zip(grads, tp_sharded):
            if not sharded:
                all_reduce(g, ctx.tp_group, ctx=ctx)
    return grads


def make_train_step(model, tcfg: TrainConfig, pcfg: ParallelConfig,
                    batch_builder=None):
    """Returns train_step(params, opt_state, batch, lr, wd, rng=None,
    spike_threshold=None) -> (params, opt_state, stats).

    `params` is the fp32 parameter tree (this rank's slices), its leaves
    requiring grad; `batch` a dict of (num_microbatches, batch, seq)
    tensors (this rank's rows): tokens, labels, loss_mask, position_ids
    and optionally attention_mask. `spike_threshold` (a float, the loss
    watchdog's median + k sigma): a step whose mean loss is non-finite
    or above it is skipped on the card, params and state untouched.
    Params and state are updated in place and returned. Under ZeRO-1
    `opt_state`'s moments hold this rank's blocks (the trainer's
    `StateLayout` makes them)."""
    if batch_builder is not None:
        raise ValueError("a batch_builder (BERT/T5 batches) is not ported "
                         "yet: those models are ROADMAP.md A6")
    ctx = check_layout(model, pcfg)
    num_micro = pcfg.num_microbatches
    scaler = get_grad_scaler(tcfg)
    dp = 1 if ctx is None else ctx.dp
    pp = 1 if ctx is None else ctx.pp
    cp = 1 if ctx is None else ctx.cp
    use_zero1 = pcfg.use_distributed_optimizer and dp > 1
    layout = {}  # built at the first call, from this rank's params
    pipeline_loss = None
    if pp > 1:
        from megatron_llm_tpu_torch.parallel.pipeline import (
            make_pipelined_loss_fn,
        )

        pipeline_loss = make_pipelined_loss_fn(model, pcfg, ctx)

    def _layout(params):
        if not layout:
            specs = spec_leaves(layout_specs(model.cfg, params, pp))
            tp_sh = [model_axis(s) is not None for s in specs]
            pp_sh = [stage_axis(s) is not None for s in specs]
            plan = zero1.build_zero1_plan(
                model.cfg, params, dp, pcfg.grad_rs_bucket_mb, pp=pp) \
                if dp > 1 else None
            dp_sh = [use_zero1 and plan.leaf_axes[i] is not None
                     for i in range(len(specs))]
            layout.update(plan=plan, tp_sharded=tp_sh, pp_sharded=pp_sh,
                          reduce_fn=zero1.sum_over_layout(
                              tp_sh, dp_sh, ctx, pp_sh))
        return layout

    def reduce_grads(params, grads):
        """The cp sum, the pp sum of the stage-replicated leaves and the
        dp reduction; under ZeRO-1 also this rank's parameter blocks, the
        tensors the update writes."""
        lay = _layout(params)
        sequence_parallel_grads(grads, lay["tp_sharded"], ctx)
        if cp > 1:
            for g in grads:
                all_reduce(g, ctx.cp_group, ctx=ctx)
        if pp > 1:
            for g, staged in zip(grads, lay["pp_sharded"]):
                if not staged:
                    all_reduce(g, ctx.pp_group, ctx=ctx)
        if dp == 1:
            return grads, tree_leaves(params)
        grads = zero1.reduce_gradients(grads, lay["plan"], ctx, use_zero1,
                                       pcfg.quantized_grad_reduce)
        targets = tree_leaves(params)
        if use_zero1:
            targets = zero1.param_shards(targets, lay["plan"], ctx.dp_rank)
        return grads, targets

    def accumulate(params, batch, rng, loss_scale, dev):
        """The microbatch loop: each microbatch's forward and backward,
        the gradients summed in the params' `.grad`; returns the mean of
        the microbatch losses."""
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        nums, dens = [], []
        with torch.enable_grad():
            for i in range(num_micro):
                micro = {k: v[i] for k, v in batch.items()}
                mrng = rng if rng is None or num_micro == 1 \
                    else fold_in(rng, i)
                kw = dict(dropout_rng=mrng, deterministic=rng is None,
                          **micro)
                if dp == 1 and cp == 1:
                    l_i = model.loss(params, **kw)
                    loss = loss + l_i.detach()
                else:
                    num, den = model.loss_terms(params, **kw)
                    den = sum_over_tokens(den.detach().clone(),
                                          ctx).clamp(min=1.0)
                    l_i = num / den
                    nums.append(num.detach())
                    dens.append(den)
                (l_i if loss_scale is None else l_i * loss_scale).backward()
        if nums:
            # the reported loss: the numerators summed over dp and cp
            # before the division, as the JAX package reduces them
            nums = sum_over_tokens(torch.stack(nums), ctx)
            for num, den in zip(nums, dens):
                loss = loss + num / den
        return loss / num_micro if num_micro > 1 else loss

    def train_step(params, opt_state: OptimizerState, batch, lr, wd,
                   rng=None, spike_threshold=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n != num_micro:
            raise ValueError(f"batch has {n} microbatches, the step was "
                             f"built for {num_micro}")
        dev = leaves[0].device
        loss_scale = None if scaler is None else torch.as_tensor(
            scaler.scale(opt_state.scaler), dtype=torch.float32, device=dev)
        if pipeline_loss is not None:
            loss = pipeline_loss(params, batch, rng, loss_scale,
                                 backward=True)
        else:
            loss = accumulate(params, batch, rng, loss_scale, dev)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        targets, reduce_fn, any_rank = params, None, None
        if ctx is not None:
            grads, targets = reduce_grads(params, grads)
            reduce_fn = _layout(params)["reduce_fn"]

            def any_rank(flags):
                return zero1.any_rank(flags, ctx)
        if num_micro > 1:
            for g in grads:
                g.div_(num_micro)
        if loss_scale is not None:
            inv = 1.0 / loss_scale
            for g in grads:
                g.mul_(inv)
        found_inf = None
        if spike_threshold is not None:
            # NaN/inf losses and watchdog spikes skip the update on the
            # card, as an fp16 overflow would
            found_inf = ~torch.isfinite(loss) | (loss > spike_threshold)
        # grads: a list in the order of tree_leaves(params)
        targets, opt_state, stats = optimizer_step(
            targets, grads, opt_state, tcfg, lr, weight_decay=wd,
            found_inf=found_inf, scaler=scaler, reduce_fn=reduce_fn,
            any_rank=any_rank)
        if use_zero1:
            zero1.gather_param_shards(leaves, targets,
                                      _layout(params)["plan"], ctx)
        for p in leaves:
            p.grad = None
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step


def make_eval_step(model):
    """The eval step (JAX :344-357): the mean masked loss, no gradients;
    across dp and cp ranks the global token-weighted mean of their rows'
    shards. At pp > 1 the pipelined loss of (num_micro, rows, s)
    batches, forward only (JAX training/trainer.py:607-690)."""
    ctx = get_context()
    if ctx is not None and ctx.pp > 1:
        from megatron_llm_tpu_torch.parallel.pipeline import (
            make_pipelined_loss_fn,
        )

        return torch.no_grad()(make_pipelined_loss_fn(model, None, ctx))

    @torch.no_grad()
    def eval_step(params, batch):
        kw = {k: batch[k] for k in ("loss_mask", "position_ids",
                                    "attention_mask") if k in batch}
        if ctx is None or (ctx.dp == 1 and ctx.cp == 1):
            return model.loss(params, batch["tokens"], batch["labels"], **kw)
        num, den = model.loss_terms(params, batch["tokens"], batch["labels"],
                                    **kw)
        terms = sum_over_tokens(torch.stack([num, den]), ctx)
        return terms[0] / terms[1].clamp(min=1.0)

    return eval_step
