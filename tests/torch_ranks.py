"""Rank programs of the port's parallel tests (tests/test_torch_tensor_
parallel.py, test_torch_vocab_parallel_ce.py, test_torch_zero1.py,
test_torch_parallel_finetune.py).

Each function here runs in every rank of a gloo CPU process group that
`megatron_llm_tpu_torch.utils.virtual_mesh.spawn_cpu_group` starts, so
this module imports torch and the port only: a rank never imports JAX.
Inputs and results are numpy arrays and plain Python values.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    tiny_config,
)
from megatron_llm_tpu_torch.convert.from_jax import rank_params_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    destroy_parallel,
    initialize_parallel,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    gather_params,
    model_axis,
    param_specs,
    spec_leaves,
)
from megatron_llm_tpu_torch.training.train_step import sequence_parallel_grads


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def model_cfg(kv, **kw):
    return tiny_config(num_layers=2, hidden_size=64, num_attention_heads=8,
                       num_attention_heads_kv=kv, ffn_hidden_size=128,
                       seq_length=32, max_position_embeddings=32,
                       padded_vocab_size=256, compute_dtype=torch.float32,
                       use_flash_attn=True, **kw)


# ---------------------------------------------------------------------------
# tensor and sequence parallelism
# ---------------------------------------------------------------------------

def tp_loss_and_grads(cases, params_by_kv, tokens, labels):
    """For each (kv, tp, sp, remat) case: the loss and the gathered
    gradient tree of the port at that layout (rank 0's), this rank's
    shards of the params, and the tree gathered back from them."""
    out = []
    for kv, tp, sp, remat in cases:
        cfg = model_cfg(kv, remat_policy=remat)
        model = LlamaModel(cfg, device="cpu")
        ctx = initialize_parallel(dp=4 // tp, tp=tp, sequence_parallel=sp,
                                  device="cpu")
        try:
            shards = rank_params_from_jax(params_by_kv[kv], cfg, ctx,
                                          device="cpu")
            leaves = tree_leaves(shards)
            # tensors of their own: replicated leaves are the full tree's
            own = [x.clone().requires_grad_(True) for x in leaves]
            local = _rebuild(shards, own)
            loss = model.loss(local, torch.from_numpy(tokens),
                              torch.from_numpy(labels))
            loss.backward()
            specs = spec_leaves(param_specs(cfg, local))
            grads = sequence_parallel_grads(
                [p.grad for p in own], [model_axis(s) is not None
                                        for s in specs], ctx)
            gathered = gather_params(_rebuild(local, grads), ctx, cfg)
            back = gather_params(_rebuild(local, [x.detach() for x in own]),
                                 ctx, cfg)
            out.append({"loss": float(loss), "grads": _np(gathered),
                        "shards": _np(_rebuild(local, [x.detach()
                                                       for x in own])),
                        "back": _np(back), "tp_rank": ctx.tp_rank})
        finally:
            destroy_parallel()
    return out


def _rebuild(template, leaves):
    """`template`'s tree with `leaves` (tree_leaves order)."""
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else None
                for k in sorted(t)}

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return fill(walk(template))


# ---------------------------------------------------------------------------
# vocab-parallel cross entropy
# ---------------------------------------------------------------------------

def vocab_ce(logits, targets, weights, cases):
    """For each (tp, label_smoothing): the per-token losses and the
    gathered gradient of sum(loss * weights) over the vocabulary
    shards."""
    from megatron_llm_tpu_torch.parallel.cross_entropy import (
        vocab_parallel_cross_entropy,
    )

    out = []
    for tp, ls in cases:
        ctx = initialize_parallel(dp=4 // tp, tp=tp, device="cpu")
        try:
            per = logits.shape[-1] // tp
            local = torch.from_numpy(
                logits[..., ctx.tp_rank * per:(ctx.tp_rank + 1) * per]
                .copy()).requires_grad_(True)
            loss = vocab_parallel_cross_entropy(
                local, torch.from_numpy(targets), ls)
            (loss * torch.from_numpy(weights)).sum().backward()
            grad = all_gather_rows(local.grad.movedim(-1, 0).contiguous(),
                                   ctx.tp_group, ctx).movedim(0, -1)
            out.append({"loss": loss.detach().numpy(),
                        "grad": grad.numpy()})
        finally:
            destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# ZeRO-1 against the replicated optimizer
# ---------------------------------------------------------------------------

def _batches(steps, micro, rows, seq, seed, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (micro, rows, seq + 1)).astype(np.int32)
            for _ in range(steps)]


def train_runs(runs, params_np):
    """Each run (name, dp, tp, compute dtype name, zero1, quantized, fp16
    scaler fields or None): 3 steps of the port's Trainer from
    `params_np` on the same global batches (2 microbatches of 2 rows a
    dp rank), this rank's rows; returns per step loss, grad norm,
    skipped and loss scale, and on rank 0 the final params and moments
    gathered whole."""
    from megatron_llm_tpu_torch.training.trainer import Trainer

    out = {}
    for name, dp, tp, dtype, zero1, quantized, fp16 in runs:
        cfg = dataclasses.replace(model_cfg(2), compute_dtype=getattr(
            torch, dtype))
        ctx = initialize_parallel(dp=dp, tp=tp, sequence_parallel=tp > 1,
                                  device="cpu")
        try:
            tcfg = TrainConfig(
                micro_batch_size=2, global_batch_size=4 * dp, lr=1e-3,
                train_iters=3, log_interval=100, eval_interval=0,
                clip_grad=1.0, weight_decay=0.1, seed=0,
                **(fp16 or {}))
            pcfg = ParallelConfig(
                data_parallel_size=dp, tensor_parallel_size=tp,
                sequence_parallel=tp > 1, use_distributed_optimizer=zero1,
                quantized_grad_reduce=quantized, grad_rs_bucket_mb=0.05,
                num_microbatches=2)
            lo = ctx.dp_rank * 2
            data = [b[:, lo:lo + 2] for b in _batches(3, 2, 2 * dp, 32, 5)]
            trainer = Trainer(LlamaModel(cfg, device="cpu"), tcfg, pcfg,
                              train_data_iterator=data)
            log = []
            inner = trainer.train_step

            def step(state, text, *a, _inner=inner, _log=log):
                stats = _inner(state, text, *a)
                _log.append({"loss": float(stats["loss"]),
                             "grad_norm": float(stats["grad_norm"]),
                             "skipped": int(stats["skipped"]),
                             "loss_scale": float(stats.get("loss_scale",
                                                           0.0))})
                return stats

            trainer.train_step = step
            state = trainer.train(trainer.setup(params=_t(params_np)))
            params, opt = trainer._gather_state(state)
            out[name] = {"log": log}
            if params is not None:
                out[name].update(params=_np(params), m=_np(opt.m),
                                 v=_np(opt.v))
        finally:
            destroy_parallel()
    return out


def quantized_reduce(trees_by_dp):
    """For dp in {2, 4}: the int8 reduce-scatter of the plan's buckets,
    rank r's gradients `tree * (1 + 0.1 r)`; returns this rank's reduced
    shards as whole-shape blocks and the plan's leaf axes."""
    from megatron_llm_tpu_torch.optimizer.zero1 import (
        build_zero1_plan,
        reduce_gradients,
    )

    out = {}
    for dp, tree in trees_by_dp.items():
        ctx = initialize_parallel(dp=dp, tp=4 // dp, device="cpu")
        try:
            local = {k: torch.from_numpy(v * (1 + 0.1 * ctx.dp_rank))
                     for k, v in tree.items()}
            leaves = tree_leaves(local)
            plan = build_zero1_plan(None, local, dp, bucket_mb=0.001)
            red = reduce_gradients(leaves, plan, ctx, zero1=True,
                                   quantized=True)
            names = sorted(local)
            out[dp] = {"dp_rank": ctx.dp_rank, "axes": plan.leaf_axes,
                       "reduced": {n: r.numpy() for n, r in zip(names,
                                                               red)}}
        finally:
            destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def finetune_runs(argvs, init=None):
    """`finetune.main(argv, device="cpu")` for each argv in turn, with
    fp32 compute (the parser has no flag for it) and the initial weights
    `init` (numpy, the whole tree) where given; per run: each step's
    (iteration, loss, grad norm), the rows the rank loaded and its row
    range, and the JAX modules in sys.modules (none)."""
    from megatron_llm_tpu_torch import finetune
    from megatron_llm_tpu_torch.models.gpt import GPTModel
    from megatron_llm_tpu_torch.parallel import multihost
    from megatron_llm_tpu_torch.parallel.mesh import get_context
    from megatron_llm_tpu_torch.training.trainer import Trainer

    inner_cfg = finetune.args_to_configs

    def fp32(*a, **kw):
        m, p, t, d = inner_cfg(*a, **kw)
        return dataclasses.replace(m, compute_dtype=torch.float32), p, t, d

    finetune.args_to_configs = fp32
    inner_step = Trainer.train_step
    log = []

    def train_step(self, state, text, *a):
        stats = inner_step(self, state, text, *a)
        ctx = get_context()
        log.append((state.iteration, float(stats["loss"]),
                    float(stats["grad_norm"]), np.array(text),
                    multihost.process_row_range(
                        ctx if ctx and ctx.world_size > 1 else None,
                        text.shape[1] * (ctx.dp if ctx else 1))))
        return stats

    Trainer.train_step = train_step
    inner_init = GPTModel.init
    if init is not None:
        GPTModel.init = lambda self, seed=0: _t(init)
    out = []
    try:
        for argv in argvs:
            log.clear()
            state = finetune.main(argv, device="cpu")
            out.append({"steps": list(log), "iteration": state.iteration,
                        "consumed": state.consumed_train_samples})
    finally:
        Trainer.train_step = inner_step
        GPTModel.init = inner_init
        finetune.args_to_configs = inner_cfg
    jax_mods = sorted(k for k, v in sys.modules.items() if v is not None
                      and (k == "jax" or k.startswith(("jax.", "jaxlib",
                                                       "megatron_llm_tpu."))))
    return {"runs": out, "jax_modules": jax_mods, "pid": os.getpid()}


def layout_error(argv):
    """The error `finetune.main` raises for `argv` in a rank, as text."""
    from megatron_llm_tpu_torch import finetune

    try:
        finetune.main(argv, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def zero1_ranks(runs, params_np, trees):
    """The ZeRO-1 test's rank program: the trainer runs, then the
    quantized reductions."""
    return {"runs": train_runs(runs, params_np),
            "quant": quantized_reduce(trees)}


def rank_modules():
    """Import every module of the port in a rank; the JAX modules then
    in sys.modules (none) and the world size."""
    import importlib
    import pkgutil

    import torch.distributed as dist

    import megatron_llm_tpu_torch

    for m in pkgutil.walk_packages(megatron_llm_tpu_torch.__path__,
                                   "megatron_llm_tpu_torch."):
        importlib.import_module(m.name)
    return {"world": dist.get_world_size(), "jax": sorted(
        k for k, v in sys.modules.items() if v is not None and (
            k == "jax" or k.startswith(("jax.", "megatron_llm_tpu."))))}
