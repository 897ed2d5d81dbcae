"""Rank programs of the port's context-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_context_parallel.py).

Each function here runs in every rank of a gloo CPU process group that
`megatron_llm_tpu_torch.utils.virtual_mesh.spawn_cpu_group` starts (or
torchrun, see the bottom of the file), so this module imports torch and
the port only: a rank never imports JAX. Inputs and results are numpy
arrays and plain Python values.
"""

import os
import pickle
import sys

import numpy as np
import torch

import torch_pp_ranks as R
from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    tiny_config,
)
from megatron_llm_tpu_torch.convert.from_jax import (
    params_from_jax,
    rank_params_from_jax,
)
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.parallel.mesh import (
    all_reduce,
    destroy_parallel,
    initialize_parallel,
    sum_over_tokens,
)
from megatron_llm_tpu_torch.parallel.sharding import gather_params

SEQ = 64


def model_cfg(**kw):
    """The JAX package's cp tests' tiny fp32 Llama
    (tests/test_context_parallel.py:36-50)."""
    base = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=2, ffn_hidden_size=128,
                seq_length=SEQ, max_position_embeddings=SEQ,
                padded_vocab_size=256, compute_dtype=torch.float32,
                use_flash_attn=True)
    base.update(kw)
    return tiny_config(**base)


def _layout(dp=1, pp=1, tp=1, cp=1, sp=False):
    return initialize_parallel(dp=dp, pp=pp, tp=tp, cp=cp,
                               sequence_parallel=sp, device="cpu")


def _seq(x, ctx, axis=-1):
    """This cp rank's shard of a host array's sequence axis."""
    n = x.shape[axis] // ctx.cp
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(ctx.cp_rank * n, (ctx.cp_rank + 1) * n)
    return np.ascontiguousarray(x[tuple(idx)])


def _positions(b, ctx):
    """This cp rank's global positions, (b, SEQ / cp)."""
    return torch.from_numpy(_seq(np.broadcast_to(np.arange(SEQ), (b, SEQ)),
                                 ctx))


def _cp_loss(model, params, tokens, labels, ctx, **kw):
    """The whole sequence's loss from this rank's shard, as the train step
    forms it: `loss_terms` with the denominator summed over dp and cp,
    and the summed numerator over it for the value. Returns (the loss
    whose backward is this rank's share, the global loss as a float)."""
    num, den = model.loss_terms(params, tokens, labels, **kw)
    den = sum_over_tokens(den.detach().clone(), ctx).clamp(min=1.0)
    return num / den, float(sum_over_tokens(num.detach().clone(), ctx) / den)


def _rows(x, ctx, axis=0):
    """This dp rank's rows along `axis`."""
    n = x.shape[axis] // ctx.dp
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(ctx.dp_rank * n, (ctx.dp_rank + 1) * n)
    return x[tuple(idx)]


def _whole_grads(local, own, ctx, cfg, pp=False):
    """The gradient tree made whole on rank 0: SP partials over tp, every
    leaf over cp and dp, a stage's replicated leaves over pp."""
    from megatron_llm_tpu_torch.parallel.sharding import (
        layout_specs,
        model_axis,
        spec_leaves,
        stage_axis,
    )
    from megatron_llm_tpu_torch.training.train_step import (
        sequence_parallel_grads,
    )

    specs = spec_leaves(layout_specs(cfg, local, ctx.pp))
    grads = sequence_parallel_grads(
        [torch.zeros_like(p) if p.grad is None else p.grad for p in own],
        [model_axis(s) is not None for s in specs], ctx)
    for g, s in zip(grads, specs):
        all_reduce(g, ctx.cp_group, ctx=ctx)
        all_reduce(g, ctx.dp_group, ctx=ctx)
        if pp and stage_axis(s) is None:
            all_reduce(g, ctx.pp_group, ctx=ctx)
    whole = gather_params(R._rebuild(local, grads), ctx, cfg)
    return R._np(whole) if ctx.rank == 0 else None


# ---------------------------------------------------------------------------
# the ring alone
# ---------------------------------------------------------------------------

def ring(cases):
    """For each (causal, q, k, v, cotangent, doc_start or None) on the
    whole sequence, cp = the group's size: this rank's shards of the
    ring's output and of dq, dk, dv of sum(o * cotangent)."""
    from megatron_llm_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
    )

    import torch.distributed as dist

    out = []
    ctx = _layout(cp=dist.get_world_size())
    try:
        for causal, q, k, v, cot, ds in cases:
            sh = [torch.from_numpy(_seq(x, ctx, 1)).requires_grad_(True)
                  for x in (q, k, v)]
            dloc = None if ds is None else torch.from_numpy(_seq(ds, ctx))
            o = ring_self_attention(*sh, causal=causal, doc_start=dloc)
            (o * torch.from_numpy(_seq(cot, ctx, 1))).sum().backward()
            out.append([o.detach().numpy()] + [x.grad.numpy() for x in sh])
    finally:
        destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

def model_loss_and_grads(cases, params_np, data):
    """For each (dp, tp, cp, sp, batch key) case: the global loss and rank
    0's whole gradient tree of the masked mean over `data[key]` (tokens,
    labels, loss_mask and optionally position_ids and doc_start, each
    (b, s)) through `loss_terms` with the train step's sums over dp and
    cp."""
    out = []
    for dp, tp, cp, sp, key in cases:
        cfg = model_cfg()
        ctx = _layout(dp=dp, tp=tp, cp=cp, sp=sp)
        try:
            model = LlamaModel(cfg, device="cpu")
            local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
            own = [x.clone().requires_grad_(True) for x in tree_leaves(local)]
            local = R._rebuild(local, own)
            b = {k: torch.from_numpy(_seq(_rows(v, ctx), ctx))
                 for k, v in data[key].items()}
            pos = b.get("position_ids")
            kw = dict(loss_mask=b["loss_mask"], position_ids=_positions(
                b["tokens"].shape[0], ctx) if pos is None else pos)
            if "doc_start" in b:
                kw["attention_mask"] = {"doc_start": b["doc_start"]}
            loss, value = _cp_loss(model, local, b["tokens"], b["labels"],
                                   ctx, **kw)
            loss.backward()
            out.append({"loss": value,
                        "grads": _whole_grads(local, own, ctx, cfg)})
        finally:
            destroy_parallel()
    return out


def pipelined_loss_and_grads(cases, params_np, batch_np):
    """For each (dp, pp, tp, cp, sp, pipeline_remat) case: the pipelined
    loss of the (num_micro, b, s) batch (each rank its rows' sequence
    shard) and rank 0's whole gradient tree."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_loss_fn,
    )

    out = []
    for dp, pp, tp, cp, sp, remat in cases:
        cfg = model_cfg(num_layers=4)
        ctx = _layout(dp=dp, pp=pp, tp=tp, cp=cp, sp=sp)
        try:
            model = LlamaModel(cfg, device="cpu")
            local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
            own = [x.clone().requires_grad_(True) for x in tree_leaves(local)]
            local = R._rebuild(local, own)
            batch = {k: torch.from_numpy(_seq(_rows(v, ctx, 1), ctx))
                     for k, v in batch_np.items()}
            n = batch["tokens"].shape[0]
            pcfg = ParallelConfig(data_parallel_size=dp,
                                  pipeline_parallel_size=pp,
                                  tensor_parallel_size=tp,
                                  context_parallel_size=cp,
                                  sequence_parallel=sp, num_microbatches=n,
                                  pipeline_remat=remat)
            loss = make_pipelined_loss_fn(model, pcfg, ctx)(
                local, batch, backward=True)
            for p in own:
                if p.grad is not None:
                    p.grad.div_(n)
            out.append({"loss": float(loss),
                        "grads": _whole_grads(local, own, ctx, cfg, pp=True)})
        finally:
            destroy_parallel()
    return out


def refusals():
    """The cp paths' refusals in a rank of a 2-rank cp group, each as the
    error's text: a dense attention mask, live attention dropout, a
    shard without its positions, and `model.loss` (one shard's mean)."""
    out = {}
    ctx = _layout(cp=2)
    try:
        b = torch.zeros((1, SEQ // 2), dtype=torch.long)
        for name, cfg_kw, mask, seed in (
                ("dense_mask", {}, torch.zeros(1, 1, SEQ // 2, SEQ // 2,
                                               dtype=torch.bool), None),
                ("dropout", dict(attention_dropout=0.1), None, 5)):
            cfg = model_cfg(**cfg_kw)
            model = LlamaModel(cfg, device="cpu")
            params = model.init(seed=0)
            try:
                model.loss_terms(params, b, b, attention_mask=mask,
                                 position_ids=_positions(1, ctx),
                                 dropout_rng=seed,
                                 deterministic=seed is None)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        for name, fn, kw in (
                ("positions", model.loss_terms, {}),
                ("loss", model.loss, dict(position_ids=_positions(1, ctx)))):
            try:
                fn(params, b, b, **kw)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    finally:
        destroy_parallel()
    return out


def remat_counts(tokens):
    """At cp 2, one forward and backward of a 1-layer tiny model (the
    same weights on each rank) under each recompute policy, the loss
    formed as the train step forms it (`_cp_loss`): the ring's hop forwards (the flash forward `_fwd`, K4's
    stand-in on the CPU) and hop backwards (`_plain_bwd_rows`, K5's and
    K6's) by mask, and the loss."""
    from megatron_llm_tpu_torch.config import REMAT_POLICIES
    from megatron_llm_tpu_torch.ops import flash_attention as fa
    from megatron_llm_tpu_torch.parallel import ring_attention as ra

    fwd, bwd = fa._fwd, ra._plain_bwd_rows
    counts = {}

    def tally(kind, causal):
        key = "causal" if causal else "full"
        counts[kind][key] = counts[kind].get(key, 0) + 1

    def counted_fwd(q, k, v, causal):
        tally("fwd", causal)
        return fwd(q, k, v, causal)

    def counted_bwd(q, k, v, lse, delta, do, causal, mask=None):
        tally("bwd", causal)
        return bwd(q, k, v, lse, delta, do, causal, mask)

    fa._fwd, ra._plain_bwd_rows = counted_fwd, counted_bwd
    ctx = _layout(cp=2)
    out = {}
    try:
        tok = torch.from_numpy(_seq(tokens[:, :-1], ctx))
        lab = torch.from_numpy(_seq(tokens[:, 1:], ctx))
        for policy in REMAT_POLICIES:
            model = LlamaModel(model_cfg(num_layers=1, remat_policy=policy),
                               device="cpu")
            params = model.init(seed=0)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            counts.update(fwd={}, bwd={})
            loss, value = _cp_loss(model, params, tok, lab, ctx,
                                   position_ids=_positions(1, ctx))
            loss.backward()
            out[policy] = {"fwd": dict(counts["fwd"]),
                           "bwd": dict(counts["bwd"]), "loss": value}
    finally:
        fa._fwd, ra._plain_bwd_rows = fwd, bwd
        destroy_parallel()
    return out


# ---------------------------------------------------------------------------
# the trainer and its checkpoints
# ---------------------------------------------------------------------------

def trainer(cfg, dp, cp, zero1, steps, iters, eod, load=None, save=None,
            valid=None):
    """A Trainer of the tiny model at (dp, cp), fed this dp rank's rows of
    the global (num_micro, rows, s + 1) `steps`, with --eod_mask_loss."""
    from megatron_llm_tpu_torch.training.trainer import Trainer

    from megatron_llm_tpu_torch.parallel.mesh import get_context

    ctx = get_context()
    micro, rows = steps[0].shape[:2]
    tcfg = TrainConfig(micro_batch_size=rows // dp,
                       global_batch_size=micro * rows, lr=1e-3,
                       lr_decay_style="constant", train_iters=iters,
                       log_interval=100, eval_interval=0, eval_iters=1,
                       clip_grad=1.0, weight_decay=0.1, seed=0, load=load,
                       save=save, save_interval=1)
    pcfg = ParallelConfig(data_parallel_size=dp, context_parallel_size=cp,
                          use_distributed_optimizer=zero1,
                          num_microbatches=micro, grad_rs_bucket_mb=0.05)
    cut = (lambda x: x) if ctx is None or ctx.world_size == 1 else \
        (lambda x: _rows(x, ctx, 1))
    return Trainer(LlamaModel(cfg, device="cpu"), tcfg, pcfg,
                   train_data_iterator=[cut(x) for x in steps],
                   valid_data_iterator=None if valid is None
                   else [cut(x) for x in valid],
                   eod_token=eod, eod_mask_loss=True)


def train_runs(cases, params_np, steps, valid, eod, ck_dir):
    """For each (name, dp, cp, zero1): three steps from `params_np`, the
    eval loss after them, per step loss and grad norm, and rank 0's
    final params. Then at (dp, cp) of the first case: step 1 saved with
    the optimizer state to `ck_dir`, and steps 2 and 3 resumed from it."""
    out = {}
    for name, dp, cp, zero1 in cases:
        cfg = model_cfg()
        _layout(dp=dp, cp=cp)
        try:
            tr = trainer(cfg, dp, cp, zero1, steps, len(steps), eod,
                         valid=valid)
            log = []
            R._stats_hook(tr, log)
            state = tr.train(tr.setup(params=params_from_jax(
                params_np, cfg, device="cpu")))
            ev = tr.evaluate(state)
            params, _ = tr._gather_state(state)
            out[name] = {"log": log, "eval": ev,
                         "params": None if params is None else R._np(params)}
            if name != cases[0][0]:
                continue
            for run, iters, data in (("saved", 1, steps[:1]),
                                     ("resumed", 3, steps[1:])):
                tr = trainer(cfg, dp, cp, zero1, data, iters, eod,
                             load=ck_dir,
                             save=ck_dir if run == "saved" else None)
                log = []
                R._stats_hook(tr, log)
                state = tr.train(tr.setup(params=params_from_jax(
                    params_np, cfg, device="cpu")))
                params, _ = tr._gather_state(state)
                out[run] = {"log": log, "params": None if params is None
                            else R._np(params)}
        finally:
            destroy_parallel()
    return out


def resume_from(params_np, steps, eod, ck_dir):
    """Steps 2 and 3 at cp 2 resumed from `ck_dir` (a checkpoint saved at
    another layout): per step loss and grad norm, rank 0's final
    params."""
    cfg = model_cfg()
    _layout(cp=2)
    try:
        tr = trainer(cfg, 1, 2, False, steps[1:], 3, eod, load=ck_dir)
        log = []
        R._stats_hook(tr, log)
        state = tr.train(tr.setup(params=params_from_jax(params_np, cfg,
                                                         device="cpu")))
        params, _ = tr._gather_state(state)
        return {"log": log,
                "params": None if params is None else R._np(params)}
    finally:
        destroy_parallel()


class NumberTokenizer:
    """Texts of space-separated token ids."""

    vocab_size, eod = 256, 0

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(int(i)) for i in ids)


def scores(params_np, tokens, pp):
    """`generate_and_post_process` scoring (tokens_to_generate 0) at cp 2
    (x pp `pp`): the API's log-probs of a (b, s) int token array through
    `NumberTokenizer`; and a greedy generation's tokens, at pp 1."""
    from megatron_llm_tpu_torch.inference import api

    cfg = model_cfg(num_layers=4)
    ctx = _layout(pp=pp, cp=2)
    try:
        model = LlamaModel(cfg, device="cpu")
        local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
        prompts = [" ".join(str(int(t)) for t in row) for row in tokens]
        out = {"score": api.generate_and_post_process(
            model, local, NumberTokenizer(), prompts,
            tokens_to_generate=0)[2]}
        if pp == 1:
            out["greedy"] = api.generate_and_post_process(
                model, local, NumberTokenizer(), prompts[:1],
                tokens_to_generate=4, top_k_sampling=1)[3]
        return out
    finally:
        destroy_parallel()


def suite(jobs):
    """Run `jobs`, a list of (function name, args) of this module, in
    order in the same ranks; their results in order."""
    return [globals()[name](*args) for name, args in jobs]


# ---------------------------------------------------------------------------
# under torchrun
# ---------------------------------------------------------------------------

if __name__ == "__main__":
    # python -m torch.distributed.run --standalone --nproc_per_node N \
    #     tests/torch_cp_ranks.py <dir>: runs torch_ranks.finetune_runs
    # with the argvs and initial weights of <dir>/spec.pkl and writes
    # each rank's result to <dir>/rank<r>.pkl
    import torch_ranks

    d = sys.argv[1]
    with open(os.path.join(d, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    try:
        res = torch_ranks.finetune_runs(spec["argvs"], spec["init"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(d, f"rank{os.environ['RANK']}.pkl"), "wb") as f:
        pickle.dump(res, f)
