"""Rank programs of tests/test_torch_encoder_parallel.py: the encoder
family (BERT, T5, the ICT biencoder) at tensor, sequence and data
parallelism in gloo CPU ranks (utils/virtual_mesh.spawn_cpu_group).

This module imports torch and the port only: a rank never imports JAX.
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
    bert_config,
    t5_config,
)
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import BertModel, T5Model
from megatron_llm_tpu_torch.models import biencoder
from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves, tree_map
from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    initialize_parallel,
    sum_over_tokens,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    gather_params,
    model_axis,
    param_specs,
    shard_params,
    slice_axis,
    spec_leaves,
)
from megatron_llm_tpu_torch.training.train_step import (
    make_train_step,
    sequence_parallel_grads,
)
from megatron_llm_tpu_torch.training.trainer import init_rank_state

# the tiny widths of every kind; the vocabulary is padded to 128, which
# tp 2 divides
WIDTHS = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              ffn_hidden_size=128, padded_vocab_size=128,
              hidden_dropout=0.0, attention_dropout=0.0,
              compute_dtype=torch.float32)
SEQ, DEC_SEQ, ROWS = 16, 8, 4
PROJ = 16
STEP = dict(lr=1e-3, weight_decay=0.1, clip_grad=1.0)


def port_model(kind):
    """The port's model of `kind` ("bert", "t5", "ict") on the CPU."""
    if kind == "t5":
        return T5Model(t5_config(seq_length=SEQ, max_position_embeddings=SEQ,
                                 decoder_seq_length=DEC_SEQ, **WIDTHS),
                       device="cpu")
    cfg = bert_config(seq_length=SEQ, max_position_embeddings=SEQ,
                      add_binary_head=kind == "bert", **WIDTHS)
    if kind == "bert":
        return BertModel(cfg, device="cpu")
    return BiEncoderModel(cfg, projection_dim=PROJ, device="cpu")


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


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


def _rows(batch, ctx):
    n = next(iter(batch.values())).shape[0] // ctx.dp
    lo = ctx.dp_rank * n
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n]))
            for k, v in batch.items()}


def _shard_mismatches(model, shards, whole, ctx):
    """Leaves whose rank slice is not the whole leaf's block tp_rank of
    tp along its "model" axis (or the whole leaf when replicated)."""
    specs = spec_leaves(param_specs(model.cfg, whole))
    bad = []
    names = _names(whole)
    for name, s, w, x in zip(names, specs, tree_leaves(whole),
                             tree_leaves(shards)):
        want = slice_axis(w, model_axis(s), ctx.tp, ctx.tp_rank)
        if not torch.equal(want, x):
            bad.append(name)
    return bad, len(specs)


def _names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _names(v, f"{prefix}{k}.") if isinstance(v, dict) \
            else [prefix + k]
    return out


def _loss_and_grads(model, shards, batch, ctx):
    """The global loss and the whole gradient tree at the layout: the
    train step's reductions (the dp sum of the loss terms, the sequence
    parallel and dp sums of the gradients) by hand."""
    own = [x.clone().requires_grad_(True) for x in tree_leaves(shards)]
    local = _rebuild(shards, own)
    num, den = model.loss_terms(local, **batch)
    den = sum_over_tokens(den.detach().clone(), ctx).clamp(min=1.0)
    loss = (num / den).sum()
    loss.backward()
    glob = (sum_over_tokens(num.detach().clone(), ctx) / den).sum()
    tp_sh = [model_axis(s) is not None
             for s in spec_leaves(param_specs(model.cfg, local))]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in own]
    grads = sequence_parallel_grads(grads, tp_sh, ctx)
    if ctx.dp > 1:
        from megatron_llm_tpu_torch.parallel.mesh import all_reduce

        for g in grads:
            all_reduce(g, ctx.dp_group, ctx=ctx)
    return float(glob), gather_params(_rebuild(local, grads), ctx, model.cfg)


def _adamw_step(model, whole, batch, ctx, pcfg):
    """One train step (training/train_step.py, AdamW) from the whole
    tree at the layout: (loss, grad norm, the whole updated tree)."""
    tcfg = TrainConfig(micro_batch_size=ROWS, global_batch_size=ROWS,
                       **STEP)
    _, params, opt = init_rank_state(ctx, model.cfg, tree_map(
        lambda x: x.clone(), whole), tcfg, pcfg, torch.device("cpu"))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    step = make_train_step(model, tcfg, pcfg, batch_builder=dict)
    params, opt, stats = step(params, opt, {k: v[None] for k, v in
                                            batch.items()},
                              STEP["lr"], STEP["weight_decay"])
    return (float(stats["loss"]), float(stats["grad_norm"]),
            gather_params(params, ctx, model.cfg))


def _rank_local_ict_loss(model, shards, batch, ctx):
    """ICT's global loss with each rank's softmax over its own contexts
    only (no all-gather over dp): the defect the gather prevents."""
    inner = biencoder.gather_from_data_parallel
    biencoder.gather_from_data_parallel = lambda x: x
    try:
        with torch.no_grad():
            q, c = model.forward(shards, batch["query_tokens"],
                                 batch["query_mask"], None,
                                 batch["context_tokens"],
                                 batch["context_mask"], None)
            scores = q.float() @ c.float().T
            targets = torch.arange(q.shape[0])
            num = torch.nn.functional.cross_entropy(scores, targets,
                                                    reduction="sum")
            terms = sum_over_tokens(torch.stack(
                [num, torch.tensor(float(q.shape[0]))]), ctx)
    finally:
        biencoder.gather_from_data_parallel = inner
    return float(terms[0] / terms[1])


def layouts(cases, trees, batches):
    """For each case (name, dp, tp, sequence parallel, ZeRO-1) and each
    kind of `trees` (numpy JAX trees): the shard check, the global loss
    and whole gradients, one AdamW step (rank 0's results; the others'
    shard checks and losses)."""
    out = {}
    for name, dp, tp, sp, zero1 in cases:
        ctx = initialize_parallel(dp=dp, tp=tp, sequence_parallel=sp,
                                  device="cpu")
        pcfg = ParallelConfig(data_parallel_size=dp, tensor_parallel_size=tp,
                              sequence_parallel=sp,
                              use_distributed_optimizer=zero1,
                              grad_rs_bucket_mb=0.01, num_microbatches=1)
        try:
            for kind, tree in trees.items():
                model = port_model(kind)
                whole = params_from_jax(tree, model.cfg, device="cpu")
                shards = shard_params(whole, ctx, model.cfg)
                batch = _rows(batches[kind], ctx)
                bad, n = _shard_mismatches(model, shards, whole, ctx)
                loss, grads = _loss_and_grads(model, shards, batch, ctx)
                res = {"bad_shards": bad, "leaves": n, "loss": loss,
                       "tp_rank": ctx.tp_rank, "dp_rank": ctx.dp_rank}
                step_loss, gnorm, stepped = _adamw_step(model, whole, batch,
                                                        ctx, pcfg)
                res.update(step_loss=step_loss, grad_norm=gnorm)
                if kind == "ict" and dp > 1:
                    res["rank_local_loss"] = _rank_local_ict_loss(
                        model, shards, batch, ctx)
                if ctx.rank == 0:
                    res.update(grads=_np(grads), stepped=_np(stepped))
                out[(name, kind)] = res
        finally:
            destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _patched(obj, name, value, undo):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def entries(jobs):
    """Each job (entry module name, argv, numpy init tree): the entry's
    `main(argv, device="cpu")` in fp32 from that tree; per step the
    iteration, loss, grad norm, the rank's batch and consumed samples;
    and the per-rank files of its save."""
    import importlib

    from megatron_llm_tpu_torch import pretrain_bert
    from megatron_llm_tpu_torch.parallel.mesh import get_context
    from megatron_llm_tpu_torch.training.trainer import Trainer

    out = []
    for module, argv, tree in jobs:
        entry = importlib.import_module(f"megatron_llm_tpu_torch.{module}")
        undo, log = [], []
        inner_cfg = pretrain_bert.args_to_configs

        def fp32(*a, _inner=inner_cfg, **kw):
            m, p, t, d = _inner(*a, **kw)
            return dataclasses.replace(m, compute_dtype=torch.float32), \
                p, t, d

        def init(self, seed=0, _tree=tree):
            return params_from_jax(_tree, self.cfg, device=self.device)

        inner_step = Trainer.train_step

        def train_step(self, state, text, *a, _inner=inner_step, **kw):
            stats = _inner(self, state, text, *a, **kw)
            log.append((state.iteration, float(stats["loss"]),
                        float(stats["grad_norm"]),
                        {k: np.array(v) for k, v in text.items()},
                        state.consumed_train_samples))
            return stats

        _patched(pretrain_bert, "args_to_configs", fp32, undo)
        for cls in (BertModel, T5Model, BiEncoderModel):
            _patched(cls, "init", init, undo)
        _patched(Trainer, "train_step", train_step, undo)
        layout = {}
        inner_setup = Trainer.setup

        def setup(self, *a, _inner=inner_setup, **kw):
            ctx = get_context()
            layout.update(dp=ctx.dp, tp=ctx.tp, rank=ctx.rank,
                          sp=ctx.sequence_parallel, dp_rank=ctx.dp_rank)
            return _inner(self, *a, **kw)

        _patched(Trainer, "setup", setup, undo)
        try:
            state = entry.main(argv, device="cpu")
        finally:
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
        save = argv[argv.index("--save") + 1] if "--save" in argv else None
        files = None
        if save is not None:
            it_dir = os.path.join(save, f"iter_{state.iteration:07d}")
            files = {d: sorted(os.listdir(os.path.join(it_dir, d)))
                     for d in ("model", "optim", "done")}
        out.append({"steps": log, "iteration": state.iteration,
                    "consumed": state.consumed_train_samples,
                    "layout": layout, "save_files": files})
    jax_mods = sorted(k for k, v in sys.modules.items() if v is not None
                      and (k == "jax" or k.startswith(("jax.",
                                                       "megatron_llm_tpu."))))
    return {"runs": out, "jax_modules": jax_mods}


def tasks(jobs):
    """Each job (argv, numpy heads tree or None): `tasks.main.main(argv,
    device="cpu")` in fp32 with the task model's init returning the
    heads tree; per step losses, and the best and final accuracy (the
    classification tasks) or each split's hit rates and top-k hits (the
    retrieval evaluation)."""
    from megatron_llm_tpu_torch import arguments
    from megatron_llm_tpu_torch.models import Classification
    from megatron_llm_tpu_torch.tasks import main as tasks_main

    out = []
    for argv, heads in jobs:
        undo = []
        inner_cfg = arguments.args_to_configs

        def fp32(*a, _inner=inner_cfg, **kw):
            m, p, t, d = _inner(*a, **kw)
            return dataclasses.replace(m, compute_dtype=torch.float32), \
                p, t, d

        _patched(arguments, "args_to_configs", fp32, undo)
        if heads is not None:
            def init(self, seed=0, _tree=heads):
                return params_from_jax(_tree, self.cfg, device=self.device)

            _patched(Classification, "init", init, undo)
        losses = []
        try:
            res = tasks_main.main(argv, device="cpu", losses=losses)
        finally:
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
        rec = {"losses": losses}
        if isinstance(res, tuple) and len(res) == 3:
            rec.update(best=res[1], final=res[2])
        elif isinstance(res, tuple):
            rec["rates"] = {split: (rates, list(stats.top_k_hits))
                            for split, (rates, stats) in res[1].items()}
        out.append(rec)
    return out


def suite(cases, trees, batches, entry_jobs, task_jobs):
    """One spawn's work: `layouts`, then `entries` and `tasks` of the
    jobs given (each part skipped when it has none)."""
    out = {"layouts": layouts(cases, trees, batches) if cases else {}}
    out["entries"] = entries(entry_jobs) if entry_jobs else None
    out["tasks"] = tasks(task_jobs) if task_jobs else []
    return out
