"""Rank programs of the port's pipeline-parallel tests
(tests/test_torch_pipeline.py, tests/test_torch_pp_inference.py).

Each function here runs in every rank of a gloo CPU process group that
`megatron_llm_tpu_torch.utils.virtual_mesh.spawn_cpu_group` starts, so
this module imports torch and the port only: a rank never imports JAX.
Inputs and results are numpy arrays and plain Python values.
"""

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
    destroy_parallel,
    initialize_parallel,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    gather_params,
    shard_params,
)

SEQ = 16


def model_cfg(**kw):
    base = dict(num_layers=4, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=2, ffn_hidden_size=128,
                seq_length=SEQ, max_position_embeddings=SEQ,
                padded_vocab_size=256, compute_dtype=torch.float32)
    base.update(kw)
    return tiny_config(**base)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


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


def _layout(dp, pp, tp, sp=False):
    return initialize_parallel(dp=dp, pp=pp, tp=tp, sequence_parallel=sp,
                               device="cpu")


def _rows(x, ctx):
    """This dp rank's rows of (num_micro, rows, ...) host arrays."""
    n = x.shape[1] // ctx.dp
    return x[:, ctx.dp_rank * n:(ctx.dp_rank + 1) * n]


# ---------------------------------------------------------------------------
# the pipelined loss and its gradients
# ---------------------------------------------------------------------------

def loss_and_grads(cases, params_np, batch_np):
    """For each (dp, pp, tp, sp, pipeline_remat, masked) case: the
    pipelined loss (on every rank) and, on rank 0, the gradient tree
    gathered whole (stage-replicated leaves summed over pp, SP partials
    over tp, dp rows summed), the gradient of the mean over microbatches
    of each one's masked mean."""
    from megatron_llm_tpu_torch.parallel.mesh import all_reduce
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_loss_fn,
    )
    from megatron_llm_tpu_torch.parallel.sharding import (
        model_axis,
        pipeline_param_specs,
        spec_leaves,
        stage_axis,
    )
    from megatron_llm_tpu_torch.training.train_step import (
        sequence_parallel_grads,
    )

    out = []
    for dp, pp, tp, sp, remat, masked in cases:
        cfg = model_cfg(use_flash_attn=True)
        ctx = _layout(dp, pp, tp, sp)
        try:
            model = LlamaModel(cfg, device="cpu")
            local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
            own = [x.clone().requires_grad_(True) for x in tree_leaves(local)]
            local = _rebuild(local, own)
            batch = {k: torch.from_numpy(np.ascontiguousarray(_rows(v, ctx)))
                     for k, v in batch_np.items()
                     if masked or k != "loss_mask"}
            pcfg = ParallelConfig(data_parallel_size=dp,
                                  pipeline_parallel_size=pp,
                                  tensor_parallel_size=tp,
                                  sequence_parallel=sp,
                                  num_microbatches=batch["tokens"].shape[0],
                                  pipeline_remat=remat)
            loss = make_pipelined_loss_fn(model, pcfg, ctx)(
                local, batch, backward=True)
            n = batch["tokens"].shape[0]
            specs = spec_leaves(pipeline_param_specs(cfg, local))
            grads = sequence_parallel_grads(
                [torch.zeros_like(p) if p.grad is None else p.grad / n
                 for p in own],
                [model_axis(s) is not None for s in specs], ctx)
            for g, s in zip(grads, specs):
                if stage_axis(s) is None:
                    all_reduce(g, ctx.pp_group, ctx=ctx)
                all_reduce(g, ctx.dp_group, ctx=ctx)
            whole = gather_params(_rebuild(local, grads), ctx, cfg)
            out.append({"loss": float(loss),
                        "grads": _np(whole) if ctx.rank == 0 else None})
        finally:
            destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# the trainer at pp > 1
# ---------------------------------------------------------------------------

def _stats_hook(trainer, log):
    inner = trainer.train_step

    def step(state, text, *a):
        stats = inner(state, text, *a)
        log.append({"loss": float(stats["loss"]),
                    "grad_norm": float(stats["grad_norm"])})
        return stats

    trainer.train_step = step


def _replicas_agree(state, ctx, cfg):
    """Whether every stage holds the same stage-replicated leaves (params
    and moments), bit for bit."""
    from megatron_llm_tpu_torch.parallel.mesh import all_gather_rows
    from megatron_llm_tpu_torch.parallel.sharding import (
        pipeline_param_specs,
        spec_leaves,
        stage_axis,
    )

    specs = spec_leaves(pipeline_param_specs(cfg, state.params))
    trees = [state.params, state.opt_state.m, state.opt_state.v]
    ok = True
    for tree in trees:
        for x, s in zip(tree_leaves(tree), specs):
            if stage_axis(s) is not None:
                continue
            got = all_gather_rows(x.detach()[None].contiguous(),
                                  ctx.pp_group, ctx)
            ok &= bool((got == got[:1]).all())
    return ok


def _trainer(cfg, tcfg, pcfg, data, valid=None):
    from megatron_llm_tpu_torch.training.trainer import Trainer

    return Trainer(LlamaModel(cfg, device="cpu"), tcfg, pcfg,
                   train_data_iterator=data, valid_data_iterator=valid)


def train_runs(cases, params_np, batches, valid):
    """For each (name, dp, pp, tp, sp, zero1, remat): three steps of the
    port's Trainer from `params_np` on the global (num_micro, rows,
    seq + 1) `batches` (this dp rank's rows), then `Trainer.evaluate` on
    `valid`; per step loss and grad norm, the eval loss, whether the
    stages' replicated leaves agree bit for bit, and on rank 0 the final
    params gathered whole."""
    from megatron_llm_tpu_torch.convert.from_jax import params_from_jax

    out = {}
    for name, dp, pp, tp, sp, zero1, remat in cases:
        cfg = model_cfg(use_flash_attn=True)
        ctx = _layout(dp, pp, tp, sp)
        try:
            micro, rows = batches[0].shape[:2]
            tcfg = TrainConfig(
                micro_batch_size=rows // dp, global_batch_size=micro * rows,
                lr=1e-3, lr_decay_style="constant",
                train_iters=len(batches), log_interval=100,
                eval_interval=0, eval_iters=len(valid), clip_grad=1.0,
                weight_decay=0.1, seed=0)
            pcfg = ParallelConfig(
                data_parallel_size=dp, pipeline_parallel_size=pp,
                tensor_parallel_size=tp, sequence_parallel=sp,
                use_distributed_optimizer=zero1, num_microbatches=micro,
                pipeline_remat=remat, grad_rs_bucket_mb=0.05)
            trainer = _trainer(cfg, tcfg, pcfg,
                               [_rows(b, ctx) for b in batches],
                               [_rows(v, ctx) for v in valid])
            log = []
            _stats_hook(trainer, log)
            state = trainer.train(trainer.setup(
                params=params_from_jax(params_np, cfg, device="cpu")))
            agree = _replicas_agree(state, ctx, cfg)
            eval_loss = trainer.evaluate(state)
            params, _ = trainer._gather_state(state)
            out[name] = {"log": log, "eval": eval_loss, "agree": agree,
                         "params": None if params is None else _np(params)}
        finally:
            destroy_parallel()
    return out


def checkpoint_runs(params_np, batches, ck_dir, ck1_dir, dp=1,
                    zero1=False):
    """pp 2 x dp `dp` (ZeRO-1 with `zero1`): step 1 and a save with the
    optimizer state to `ck_dir`, then steps 2 and 3 resumed from it, and
    steps 2 and 3 resumed from `ck1_dir` (a pp 1 checkpoint of step 1).
    Step 3 and the final params depend on the saved Adam moments and
    step count. Per run its steps' losses and grad norms; the saved and
    the resumed runs' final params gathered on rank 0."""
    from megatron_llm_tpu_torch.convert.from_jax import params_from_jax

    cfg = model_cfg(use_flash_attn=True)
    ctx = _layout(dp, 2, 1)
    try:
        micro, rows = batches[0].shape[:2]
        out = {}
        for run, iters, load in (("saved", 1, ck_dir),
                                 ("resumed", 3, ck_dir),
                                 ("from_pp1", 3, ck1_dir)):
            tcfg = TrainConfig(
                micro_batch_size=rows // dp, global_batch_size=micro * rows,
                lr=1e-3, lr_decay_style="constant", train_iters=iters,
                log_interval=100, eval_interval=0, clip_grad=1.0,
                weight_decay=0.1, seed=0, load=load,
                save=ck_dir if run == "saved" else None, save_interval=1)
            pcfg = ParallelConfig(data_parallel_size=dp,
                                  pipeline_parallel_size=2,
                                  use_distributed_optimizer=zero1,
                                  num_microbatches=micro,
                                  grad_rs_bucket_mb=0.05)
            trainer = _trainer(cfg, tcfg, pcfg, [
                _rows(b, ctx) for b in batches[1 if iters > 1 else 0:]])
            log = []
            _stats_hook(trainer, log)
            state = trainer.setup(params=params_from_jax(params_np, cfg,
                                                         device="cpu"))
            state = trainer.train(state)
            params, _ = trainer._gather_state(state)
            out[run] = log
            out[run + "_params"] = None if params is None else _np(params)
        return out
    finally:
        destroy_parallel()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_cfg(**kw):
    return model_cfg(seq_length=64, max_position_embeddings=64, **kw)


def scores(cases, params_np, tokens):
    """For each (dp, pp, tp, sp): the pipelined scorer's (num_micro, b,
    s - 1) log-probs."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_score_fn,
    )

    out = []
    for dp, pp, tp, sp in cases:
        cfg = serve_cfg()
        ctx = _layout(dp, pp, tp, sp)
        try:
            local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
            lp = make_pipelined_score_fn(LlamaModel(cfg, device="cpu"), None,
                                         ctx)(local, torch.from_numpy(tokens))
            out.append(lp.numpy())
        finally:
            destroy_parallel()
    return out


def ring_decodes(cases, params_np, tokens, lengths, prefill):
    """For each (pp, tp, num_micro, termination_id, rows): the stage
    ring's (tokens, generated lengths, log-probs) of those rows of
    `tokens`, or the error it raises."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_decode_fn,
    )

    import torch.distributed as dist

    out = []
    for pp, tp, nm, term, rows in cases:
        cfg = serve_cfg()
        ctx = _layout(dist.get_world_size() // (pp * tp), pp, tp)
        try:
            model = LlamaModel(cfg, device="cpu")
            local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
            dec = make_pipelined_decode_fn(
                model, None, ctx, prefill_len=prefill,
                max_len=tokens.shape[1], num_micro=nm, termination_id=term,
                return_log_probs=True)
            toks, lens, lps = dec(local, tokens[rows], lengths[rows])
            out.append((toks.numpy(), lens.numpy(), lps.numpy()))
        except ValueError as e:
            out.append(str(e))
        finally:
            destroy_parallel()
    return out


class ByteTokenizer:
    """Integer pass-through text ("12 7 3"), eod 255."""

    vocab_size = 256
    eod = 255

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(int(t)) for t in ids)


def api_requests(params_np, prompts, limits):
    """The API at pp 2 (every rank the same request) under each reshard
    limit of `limits`: a score, a greedy request with log-probs, a
    sampled one (seed 7) and a beam request; each result, or the error
    it raised, as text. Also K1's launches by layout (0 on the CPU)."""
    from megatron_llm_tpu_torch.inference import api
    from megatron_llm_tpu_torch.ops import decode_attention as dec

    cfg = serve_cfg()
    ctx = _layout(1, 2, 1)
    tok = ByteTokenizer()
    out = {}
    try:
        model = LlamaModel(cfg, device="cpu")
        local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
        for limit in limits:
            api.PP_DECODE_RESHARD_LIMIT_BYTES = limit
            res = {}
            for name, call in (
                    ("score", lambda: api.generate_and_post_process(
                        model, local, tok, prompts, 0)),
                    ("greedy", lambda: api.generate_and_post_process(
                        model, local, tok, prompts, 12,
                        return_output_log_probs=True, top_k_sampling=1)),
                    ("sampled", lambda: api.generate_and_post_process(
                        model, local, tok, prompts, 12, top_k_sampling=4,
                        random_seed=7)),
                    ("beam", lambda: api.beam_search_and_post_process(
                        model, local, tok, prompts[:1], 6, beam_size=2))):
                try:
                    texts, _, lp, toks = call()
                    res[name] = (texts, None if lp is None
                                 else np.asarray(lp), np.asarray(toks))
                except ValueError as e:
                    res[name] = str(e)
            out[limit] = res
        out["k1"] = dict(dec.decode_attention.launches_by_layout)
        return out
    finally:
        destroy_parallel()


def refusals():
    """The pp paths' refusals in a rank of a 2-rank group, each as the
    error's text."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_loss_fn,
    )
    from megatron_llm_tpu_torch.training.train_step import make_train_step

    out = {}
    ctx = _layout(1, 2, 1)
    try:
        for name, cfg_kw, call in (
                ("dropout", dict(hidden_dropout=0.1), "step"),
                ("odd_layers", dict(num_layers=3), "loss")):
            cfg = model_cfg(**cfg_kw)
            model = LlamaModel(cfg, device="cpu")
            pcfg = ParallelConfig(pipeline_parallel_size=2)
            try:
                if call == "step":
                    make_train_step(model, TrainConfig(), pcfg)
                else:
                    make_pipelined_loss_fn(model, pcfg, ctx)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        model = LlamaModel(model_cfg(), device="cpu")
        loss = make_pipelined_loss_fn(model, None, ctx)
        b = torch.zeros((1, 1, SEQ), dtype=torch.long)
        try:
            loss({}, {"tokens": b, "labels": b,
                      "attention_mask": torch.ones(1, 1, 1, SEQ, SEQ)})
        except ValueError as e:
            out["reset_attention_mask"] = str(e)
    finally:
        destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# one spawn per group size (each spawn pays the interpreters' start)
# ---------------------------------------------------------------------------

def finetune_runs(argvs, init):
    """tests/torch_ranks.py's `finetune.main` runs (fp32, the initial
    weights `init`) in these ranks."""
    import torch_ranks

    return torch_ranks.finetune_runs(argvs, init)


def memory_table():
    """tools/pipeline_memory_table.py's `measure` of every policy and
    microbatch count in these ranks, at pp 2 on the tiny model."""
    from megatron_llm_tpu_torch.tools import pipeline_memory_table as T

    cfg = model_cfg(use_flash_attn=True)
    ctx = _layout(1, 2, 1)
    try:
        model = LlamaModel(cfg, device="cpu")
        params = shard_params(model.init(seed=0), ctx, cfg)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return [T.measure(model, params, ctx, policy, nm, 1, SEQ,
                          torch.device("cpu"))
                for policy in T.POLICIES for nm in T.MICROBATCHES]
    finally:
        destroy_parallel()


def suite(jobs):
    """Run `jobs`, a list of (function name, args) of this module, in
    order in the same ranks; their results in order."""
    return [globals()[name](*args) for name, args in jobs]
