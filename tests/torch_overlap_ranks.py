"""Rank programs of the port's overlap, cross-rank dropout and per-rank
checkpoint tests (tests/test_torch_overlap.py,
test_torch_parallel_dropout.py, test_torch_sharded_checkpoint.py).

Each function here runs in every rank of a gloo CPU process group that
`megatron_llm_tpu_torch.utils.virtual_mesh.spawn_cpu_group` starts (or,
for world size 1, in the test's own process), so this module imports
torch and the port only: a rank never imports JAX. Inputs and results
are numpy arrays and plain Python values.
"""

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    tiny_config,
)
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.models import dropout as dr
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    initialize_parallel,
)

SEQ = 16
LAYERS = 4
# small enough that the 4-layer model's layers form two groups of 2
BUCKET_MB = 0.05


def model_cfg(**kw):
    base = dict(num_layers=LAYERS, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=2, ffn_hidden_size=128,
                seq_length=SEQ, max_position_embeddings=SEQ,
                padded_vocab_size=256, compute_dtype=torch.float32,
                use_flash_attn=True)
    base.update(kw)
    return tiny_config(**base)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def batches(steps, num_micro, rows, seed=5, vocab=256):
    """(steps, num_micro, rows, SEQ + 1) int32 global batches."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, vocab, (steps, num_micro, rows, SEQ + 1)).astype(
        np.int32)


def params_np(seed=0):
    """The whole tree of a seeded init, numpy."""
    return _np(LlamaModel(model_cfg(), device="cpu").init(seed=seed))


# what a run may set, besides the layout (dp, pp, cp, tp, sp)
RUN = dict(dp=1, pp=1, cp=1, tp=1, sp=False, zero1=True, grads=False,
           gather=False, quant=False, async_dispatch=False, remat=None,
           fp16=False, hidden=0.0, attn=0.0, lima=False, optimizer="adam",
           lr=1e-3, clip=1.0, wd=0.1, steps=3, save=None, load=None,
           save_interval=None, masks=False, whole_state=True,
           pipeline_remat="tick", log_memory=False)


class _Masks:
    """Records every dropout mask drawn: (seed, offsets, shape, mask)."""

    def __init__(self):
        self.drawn = []
        self.inner = dr.bernoulli

    def __call__(self, seed, p, shape, device):
        mask = self.inner(seed, p, shape, device)
        self.drawn.append((int(dr._seed(seed)), tuple(dr.offsets_of(seed)),
                           tuple(int(n) for n in shape), float(p),
                           mask.numpy().copy()))
        return mask


def train(opts, params, data):
    """A Trainer run at one layout (`RUN`'s keys): `data` the global
    batches (steps, num_micro, rows, SEQ + 1), each rank its dp rows.
    Returns per step loss, grad norm, skip flag and loss scale; the
    masks drawn (with `masks`); on rank 0 the whole final state
    (`Trainer._gather_state`) with `whole_state`."""
    from megatron_llm_tpu_torch.training.trainer import Trainer

    o = dict(RUN, **opts)
    extra = {}
    if o["remat"]:
        extra["remat_policy"] = o["remat"]
    cfg = model_cfg(hidden_dropout=o["hidden"], attention_dropout=o["attn"],
                    lima_dropout=o["lima"],
                    compute_dtype=torch.float16 if o["fp16"]
                    else torch.float32, **extra)
    world = o["dp"] * o["pp"] * o["cp"] * o["tp"]
    ctx = None
    if world > 1:
        ctx = initialize_parallel(dp=o["dp"], pp=o["pp"], cp=o["cp"],
                                  tp=o["tp"], sequence_parallel=o["sp"],
                                  device="cpu")
    masks = _Masks()
    try:
        steps, num_micro, rows = data.shape[:3]
        dp_rank = ctx.dp_rank if ctx is not None else 0
        n = rows // o["dp"]
        # at 2^20 this model's first step overflows and the next are clean
        fp16 = {"fp16": True, "bf16": False,
                "initial_loss_scale": 2.0 ** 20, "hysteresis": 1} \
            if o["fp16"] else {}
        tcfg = TrainConfig(
            micro_batch_size=n, global_batch_size=num_micro * rows,
            lr=o["lr"], lr_decay_style="constant", train_iters=o["steps"],
            log_interval=100, eval_interval=0, clip_grad=o["clip"],
            weight_decay=o["wd"], seed=0, optimizer=o["optimizer"],
            save=o["save"], load=o["load"],
            save_interval=(o["save_interval"] or o["steps"])
            if o["save"] else None,
            async_save=True, log_memory_to_tensorboard=o["log_memory"],
            **fp16)
        pcfg = ParallelConfig(
            data_parallel_size=o["dp"], pipeline_parallel_size=o["pp"],
            context_parallel_size=o["cp"], tensor_parallel_size=o["tp"],
            sequence_parallel=o["sp"], use_distributed_optimizer=o["zero1"],
            quantized_grad_reduce=o["quant"],
            overlap_grad_reduce=o["grads"],
            overlap_param_gather=o["gather"],
            async_pipeline_dispatch=o["async_dispatch"],
            grad_rs_bucket_mb=BUCKET_MB, num_microbatches=num_micro,
            pipeline_remat=o["pipeline_remat"])
        rank_data = [b[:, dp_rank * n:(dp_rank + 1) * n] for b in data]
        trainer = Trainer(LlamaModel(cfg, device="cpu"), tcfg, pcfg,
                          train_data_iterator=rank_data)
        log = []
        inner = trainer.train_step

        def step(state, text, *a):
            stats = inner(state, text, *a)
            log.append({"loss": float(stats["loss"]),
                        "grad_norm": float(stats["grad_norm"]),
                        "skipped": int(stats["skipped"]),
                        "loss_scale": float(stats.get("loss_scale", 0.0))})
            return stats

        trainer.train_step = step
        if o["masks"]:
            dr.bernoulli = masks
        state = trainer.setup(params=_t(params))
        start = state.iteration
        state = trainer.train(state)
        out = {"log": log, "start": start, "iteration": state.iteration,
               "masks": masks.drawn, "groups_in_backward": [
                   f.groups_in_backward()
                   for f in trainer._train_steps.values()],
               "gauges": {k: v for k, v in trainer.timers.gauges().items()
                          if k.startswith("grad-comm-overlap")}}
        if o["whole_state"]:
            if ctx is None:
                whole, opt = state.params, state.opt_state
            else:
                whole, opt = trainer._gather_state(state)
            if whole is not None:
                out.update(params=_np(whole), m=_np(opt.m),
                           v=_np(opt.v) if opt.v is not None else None,
                           step=int(opt.step))
        return out
    finally:
        dr.bernoulli = masks.inner
        if ctx is not None:
            destroy_parallel()


def skip_step(opts, params, data):
    """One step whose loss is above the watchdog's threshold: returns
    whether it was skipped, whether params, moments and step are this
    rank's as before bit for bit, and how many handles were left in
    flight (reduce-scatters; all-gathers after a drain)."""
    from megatron_llm_tpu_torch.training.trainer import Trainer, get_batch

    o = dict(RUN, **opts)
    ctx = initialize_parallel(dp=o["dp"], device="cpu")
    try:
        num_micro, rows = data.shape[1:3]
        n = rows // o["dp"]
        tcfg = TrainConfig(micro_batch_size=n,
                           global_batch_size=num_micro * rows, lr=1e-3)
        pcfg = ParallelConfig(
            data_parallel_size=o["dp"], use_distributed_optimizer=True,
            overlap_grad_reduce=o["grads"], overlap_param_gather=o["gather"],
            grad_rs_bucket_mb=BUCKET_MB, num_microbatches=num_micro)
        trainer = Trainer(LlamaModel(model_cfg(), device="cpu"), tcfg, pcfg)
        state = trainer.setup(params=_t(params))
        step = trainer._get_step_fn(num_micro)
        text = data[0][:, ctx.dp_rank * n:(ctx.dp_rank + 1) * n]
        batch = get_batch(text, None, device="cpu")
        # a normal step first, so that gathers are in flight at the skip
        step(state.params, state.opt_state, batch, 1e-3, 0.0)
        in_flight = step.in_flight()[1]
        step.drain()
        before = [x.detach().clone() for x in tree_leaves(state.params)]
        m0 = [x.clone() for x in tree_leaves(state.opt_state.m)]
        step0 = int(state.opt_state.step)
        _, opt, stats = step(state.params, state.opt_state, batch, 1e-3,
                             0.0, None, 1e-6)
        reduces = step.in_flight()[0]
        step.drain()
        after = tree_leaves(state.params)
        return {"skipped": int(stats["skipped"]),
                "params_same": all(torch.equal(a, b)
                                   for a, b in zip(before, after)),
                "m_same": all(torch.equal(a, b) for a, b in zip(
                    m0, tree_leaves(opt.m))),
                "step_same": int(opt.step) == step0,
                "in_flight": (reduces, step.in_flight()[1]),
                "gathers_after_a_step": in_flight}
    finally:
        destroy_parallel()


def pipe_loss(async_dispatch, params, data, rng, remat):
    """The pp 2 pipelined loss and backward of one batch (num_micro, rows,
    SEQ + 1), with the dropout stream `rng` (None: deterministic): the
    loss and, on rank 0, every stage's gradients gathered whole."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_loss_fn,
    )
    from megatron_llm_tpu_torch.parallel.sharding import (
        gather_params,
        shard_params,
    )
    from megatron_llm_tpu_torch.training.trainer import get_batch

    cfg = model_cfg(hidden_dropout=0.1 if rng is not None else 0.0)
    ctx = initialize_parallel(pp=2, device="cpu")
    try:
        model = LlamaModel(cfg, device="cpu")
        local = shard_params(_t(params), ctx, cfg)
        for p in tree_leaves(local):
            p.requires_grad_(True)
        batch = get_batch(data, None, device="cpu")
        pcfg = ParallelConfig(pipeline_parallel_size=2,
                              num_microbatches=data.shape[0],
                              async_pipeline_dispatch=async_dispatch,
                              pipeline_remat=remat)
        loss = make_pipelined_loss_fn(model, pcfg, ctx)(
            local, batch, dropout_rng=rng, backward=True)
        grads = {k: v for k, v in local.items()}

        def g(tree):
            return {k: g(v) if isinstance(v, dict) else (
                torch.zeros_like(v) if v.grad is None else v.grad)
                for k, v in tree.items()}

        whole = gather_params(g(grads), ctx, cfg)
        return {"loss": float(loss),
                "grads": _np(whole) if ctx.rank == 0 else None}
    finally:
        destroy_parallel()


def load_state(opts, load_dir):
    """Set up a Trainer at one layout from the checkpoint in `load_dir`:
    the iteration and, on rank 0, the whole state (`_gather_state`)."""
    from megatron_llm_tpu_torch.training.trainer import Trainer

    o = dict(RUN, **opts)
    world = o["dp"] * o["pp"] * o["cp"] * o["tp"]
    ctx = None if world == 1 else initialize_parallel(
        dp=o["dp"], pp=o["pp"], cp=o["cp"], tp=o["tp"],
        sequence_parallel=o["sp"], device="cpu")
    try:
        tcfg = TrainConfig(micro_batch_size=1, global_batch_size=o["dp"],
                           lr=1e-3, load=load_dir)
        pcfg = ParallelConfig(
            data_parallel_size=o["dp"], pipeline_parallel_size=o["pp"],
            context_parallel_size=o["cp"], tensor_parallel_size=o["tp"],
            sequence_parallel=o["sp"], use_distributed_optimizer=o["zero1"],
            overlap_grad_reduce=o["grads"], grad_rs_bucket_mb=BUCKET_MB)
        trainer = Trainer(LlamaModel(model_cfg(), device="cpu"), tcfg, pcfg)
        state = trainer.setup()
        if ctx is None:
            whole, opt = state.params, state.opt_state
        else:
            whole, opt = trainer._gather_state(state)
        out = {"iteration": state.iteration}
        if whole is not None:
            out.update(params=_np(whole), m=_np(opt.m), v=_np(opt.v),
                       step=int(opt.step))
        return out
    finally:
        if ctx is not None:
            destroy_parallel()


def train_error(opts, params, data):
    """The error a `train` run raises, as text (None: it trained)."""
    try:
        train(opts, params, data)
    except ValueError as e:
        return str(e)
    return None


def async_timeout():
    """An async all-reduce that only rank 0 enters, on a group with a 2 s
    timeout: its handle's `wait()` must raise on rank 0 (rank 1 never
    issues it). Returns on rank 0 whether it raised."""
    import datetime

    import torch.distributed as dist

    from megatron_llm_tpu_torch.parallel.mesh import all_reduce

    group = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=2))
    out = None
    if dist.get_rank() == 0:
        h = all_reduce(torch.ones(4), group, async_op=True)
        try:
            h.wait()
            out = False
        except RuntimeError:
            out = True
    dist.barrier()
    return out


def suite(jobs):
    """Run `jobs`, a list of (function name, args) of this module, in
    order in the same ranks; their results in order."""
    return [globals()[name](*args) for name, args in jobs]
