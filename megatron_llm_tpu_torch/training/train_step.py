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
models/dropout.py) every microbatch draws from `rng` with its rows'
global offsets: the index in the step's global batch of its first row
(microbatch i of b rows a dp rank: (i dp + dp_rank) b) and of its first
position (cp_rank s), so that every layout draws its slice of world
size 1's masks (the JAX package folds the microbatch, the dp rank and
the cp rank into its keys instead).

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
runs. At pp > 1 the microbatches run through the pipeline's schedule
(parallel/pipeline.py).

The overlap schedulers (pure dp with ZeRO-1, optimizer/zero1.py):
under `--overlap_grad_reduce` the reduction still runs once a step, as
the reference's DDP does, but each layer group's reduce-scatter is
issued during the last microbatch's backward as soon as the group's
gradients are final (after any recompute), the aux buckets after the
backward, and every handle is waited for before the overflow check,
clipping and AdamW. Under `--overlap_param_gather` the updated blocks'
all-gathers are issued after AdamW in forward order and each is waited
for just before the next forward first reads its leaves;
`train_step.drain()` waits for all of them (the trainer calls it before
an eval, a save and the end of training). With a `batch_builder` (the
encoder family) each microbatch's dict is the model's loss keywords,
reduced across ranks through the model's `loss_terms` as GPT's batch
is; the overlap and quantized-reduce flags are refused with it, as the
JAX step refuses them. `loss_terms` returns (numerator, denominator),
0-d or 1-d: a loss of several means (BERT's masked-LM token mean and
sentence-order sample mean) is sum(num / den), each denominator summed
over the dp and cp groups.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.analysis.contracts import (
    CompileContract,
    register_contract,
)
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.models.dropout import at
from megatron_llm_tpu_torch.optimizer import zero1
from megatron_llm_tpu_torch.optimizer.optimizer import (
    OptimizerState,
    get_grad_scaler,
    optimizer_step,
    tree_leaves,
)
from megatron_llm_tpu_torch.parallel import overlap
from megatron_llm_tpu_torch.parallel.mesh import (
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


# The JAX package's train-step contracts (JAX :32-120, :335-342): one
# step function a microbatch count under a trainer, and at most four
# eval flavours. The port's own collective inventory of one step at the
# audit's reference config (analysis/audit.py): every reduction over tp
# and dp is an all-reduce (the tp forward's partial sums and the
# backward of `copy_to_tp`, the gradient sums, the loss and norm
# scalars); ZeRO-1 adds the bucket reduce-scatter (quantized: the int8
# all-to-all) and the parameters' all-gather. JAX's tp rows also list
# all-gather: GSPMD gathers parameters and logits there, where the
# port's unsharded-sequence tp step keeps every operand whole or
# vocab-parallel and gathers nothing. The step allows float64, where the
# JAX one does not: the gradient norm's per-leaf norms accumulate in
# fp64 so that the sum does not depend on a device's reduction order
# (optimizer/optimizer.global_grad_norm, zero1.sum_over_layout).
_ZERO1 = frozenset({"all-reduce", "all-gather", "reduce-scatter"})
register_contract(CompileContract(
    "train.step", max_variants=12,
    collectives={
        "single": frozenset(),
        "tp2": frozenset({"all-reduce"}),
        "dp2": frozenset({"all-reduce"}),
        "dp2+telemetry": frozenset({"all-reduce"}),
        "dp2+costs": frozenset({"all-reduce"}),
        "dp2+zero1": _ZERO1,
        "dp2+zero1-quant": frozenset({"all-reduce", "all-gather",
                                      "all-to-all"}),
        "dp2+zero1+overlap": _ZERO1,
        "dp2tp2": frozenset({"all-reduce"}),
        "dp2tp2+zero1": _ZERO1,
    },
    tmp_bytes_budget=4 << 20, allow_f64=True,
    notes="num_microbatches buckets a trainer; the audit's specialisations "
          "mint in the global bucket"))
# JAX parallel/pipeline.py:1071-1078: the pp > 1 train step, one a
# microbatch count under a trainer (declared here, beside train.step,
# where the trainer that records it always imports it)
register_contract(CompileContract(
    "train.pipeline_step", max_variants=8,
    notes="the pp > 1 train step; its collectives need a stage-sharded "
          "model and are held by the pipeline suites"))
register_contract(CompileContract(
    "train.eval_step", max_variants=4,
    notes="one per eval flavour a trainer builds: plain, pp, generic"))


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
    and optionally attention_mask, or with a `batch_builder` whatever
    keywords the model's loss takes (BERT: tokentype_ids, sop_labels).
    `spike_threshold` (a float, the loss watchdog's median + k sigma): a
    step whose mean loss is non-finite or above it is skipped on the
    card, params and state untouched.
    Params and state are updated in place and returned. Under ZeRO-1
    `opt_state`'s moments hold this rank's blocks (the trainer's
    `StateLayout` makes them)."""
    if batch_builder is not None:
        # the builder's batch is the model's own loss keywords, not the
        # loss_terms surface the reductions across ranks split (JAX
        # :157-180 refuses the explicit ZeRO-1 flags by the same rule)
        flags = [f for f in ("quantized_grad_reduce", "overlap_grad_reduce",
                             "overlap_param_gather") if getattr(pcfg, f)]
        if flags:
            raise ValueError(
                f"{', '.join(flags)} require(s) the explicit ZeRO-1 path, "
                "which this run cannot take: a batch_builder is installed "
                "(its batch is not the loss_terms surface)")
    ctx = check_layout(model, pcfg)
    num_micro = pcfg.num_microbatches
    scaler = get_grad_scaler(tcfg)
    dp = 1 if ctx is None else ctx.dp
    pp = 1 if ctx is None else ctx.pp
    cp = 1 if ctx is None else ctx.cp
    use_zero1 = pcfg.use_distributed_optimizer and dp > 1
    overlap_grads = use_zero1 and pcfg.overlap_grad_reduce
    overlap_gather = use_zero1 and pcfg.overlap_param_gather
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
            state_plan = plan
            if overlap_grads:
                plan = zero1.build_overlap_plan(model.cfg, params, dp,
                                                pcfg.grad_rs_bucket_mb)
                state_plan = zero1.overlap_state_plan(plan, params)
                layout["grad_overlap"] = zero1.GradOverlap(
                    plan, params, ctx, pcfg.quantized_grad_reduce)
            if use_zero1:
                layout["gather"] = zero1.ParamGather(plan, params, ctx,
                                                     overlap_gather)
            dp_sh = [use_zero1 and state_plan.leaf_axes[i] is not None
                     for i in range(len(specs))]
            layout.update(plan=plan, state_plan=state_plan,
                          tp_sharded=tp_sh, pp_sharded=pp_sh,
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
        if overlap_grads:
            grads = lay["grad_overlap"].reduce(grads)
        else:
            grads = zero1.reduce_gradients(grads, lay["plan"], ctx,
                                           use_zero1,
                                           pcfg.quantized_grad_reduce)
        targets = tree_leaves(params)
        if use_zero1:
            targets = zero1.param_shards(targets, lay["state_plan"],
                                         ctx.dp_rank)
        return grads, targets

    def accumulate(params, batch, rng, loss_scale, dev):
        """The microbatch loop: each microbatch's forward and backward,
        the gradients summed in the params' `.grad`; returns the mean of
        the microbatch losses."""
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        nums, dens = [], []
        hooks = layout["grad_overlap"].hook if overlap_grads else None
        with torch.enable_grad(), overlap.param_gate(layout.get("gather")):
            for i in range(num_micro):
                micro = {k: v[i] for k, v in batch.items()}
                # a batch builder's keywords need not hold "tokens"
                # (T5, ICT): any (rows, seq) leaf gives the row count
                b, s = micro.get("tokens",
                                 next(iter(micro.values()))).shape[:2]
                # the rows' global offsets: sample, position
                mrng = None if rng is None else at(
                    rng, (i * dp + (ctx.dp_rank if ctx else 0)) * b,
                    (ctx.cp_rank if ctx else 0) * s)
                kw = dict(dropout_rng=mrng, deterministic=rng is None,
                          **micro)
                last = hooks if i == num_micro - 1 else None
                with overlap.grad_hooks(last):
                    if dp == 1 and cp == 1:
                        l_i = model.loss(params, **kw)
                        loss = loss + l_i.detach()
                    else:
                        num, den = model.loss_terms(params, **kw)
                        den = sum_over_tokens(den.detach().clone(),
                                              ctx).clamp(min=1.0)
                        l_i = (num / den).sum()
                        nums.append(num.detach())
                        dens.append(den)
                    if last is not None:
                        layout["grad_overlap"].begin_last(
                            tree_leaves(params))
                    (l_i if loss_scale is None
                     else l_i * loss_scale).backward()
                    if last is not None:
                        layout["grad_overlap"].end_last()
        if nums:
            # the reported loss: the numerators summed over dp and cp
            # before the division, as the JAX package reduces them
            nums = sum_over_tokens(torch.stack(nums), ctx)
            for num, den in zip(nums, dens):
                loss = loss + (num / den).sum()
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
            if ctx is not None:
                _layout(params)
            try:
                loss = accumulate(params, batch, rng, loss_scale, dev)
            except BaseException:
                if "grad_overlap" in layout:  # no handle left in flight
                    layout["grad_overlap"].drain()
                raise
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
            layout["gather"].issue(leaves, targets)
        for p in leaves:
            p.grad = None
        stats["loss"] = loss
        return params, opt_state, stats

    def drain():
        """Wait for the parameter all-gathers in flight."""
        if "gather" in layout:
            layout["gather"].drain()

    def groups_in_backward():
        """How many layer groups the last step's backward issued before
        it ended (--overlap_grad_reduce)."""
        return layout["grad_overlap"].last_from_hooks \
            if "grad_overlap" in layout else 0

    def in_flight():
        """(reduce-scatters, all-gathers) issued and not waited for."""
        return (len(layout["grad_overlap"].pending)
                if "grad_overlap" in layout else 0,
                len(layout["gather"].pending) if "gather" in layout else 0)

    def overlap_gauges():
        """(works issued inside the backward with a later group still
        to run, the most in flight at once) of the last step's
        gradient reduction, (0, 0) without --overlap_grad_reduce."""
        if "grad_overlap" not in layout:
            return 0, 0
        g = layout["grad_overlap"]
        return g.last_pairs, g.last_max_in_flight

    train_step.drain = drain
    train_step.overlap_gauges = overlap_gauges
    train_step.in_flight = in_flight
    train_step.groups_in_backward = groups_in_backward
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
