"""Pipeline parallelism: the GPipe tick schedule over the stacked layer
axis, stage to stage by point-to-point transfers (port of
parallel/pipeline.py).

The JAX package runs the pipeline as one program: a `shard_map` over the
"stage" mesh axis, a `lax.scan` over num_micro + pp - 1 ticks that
rotates the boundary with `ppermute`, and `jax.grad` of that scan as the
backward schedule. Here each rank is one stage of one pipeline (its
num_layers / pp layers, parallel/sharding.py `pipeline_param_specs`,
with the embedding, the final norm and the head whole on every stage),
and the schedule is written out:

- forward: at tick t a stage runs microbatch t - stage, if there is one:
  stage 0 embeds its tokens in the tick (no (num_micro, b, s, h) input
  buffer), any other stage receives the boundary from the stage before;
  the last stage runs the final norm, the head and the cross entropy in
  the tick and banks the microbatch's masked loss sum, no logits buffer;
  the others send the boundary on (parallel/mesh.py `send_boundary`,
  in the compute dtype; staged through pinned host buffers under gloo);
- backward: the ticks in reverse; a stage receives the output gradient
  from the stage after (the last stage starts from its loss), runs the
  microbatch's backward and sends the input gradient back.

Sends never wait for their receiver, and every pair of stages sends and
receives the same microbatches in the same order, so no tick can
deadlock; a transfer that fails raises, nothing retries it.

What a tick keeps for the backward is `pipeline_remat` (JAX
:1-47, :364-377): "tick" / "full" keeps only the tick's input boundary
and recomputes the stage in the backward, its layers under the model's
own recompute policy; "selective", "save_dots" ("dots") and "offload"
wrap the tick in that named-save-point policy (models/remat.py), which
then alone decides what the stage keeps (the layers' own policy is off
inside it); "none" keeps every tick's autograd graph. All give the same
gradients. As in the JAX package the schedule is GPipe: no 1F1B and no
interleaving (its `config.py:276-280`).

Under context parallelism (cp > 1) every stage holds its cp rank's
sequence shard: the boundaries are (b, s / cp, h) between the same
(dp, cp, tp) coordinate of adjacent stages, and in the stage body the
ring (parallel/ring_attention.py) runs over the stage's cp group (JAX
:185-196, :300-330).

The loss is the reference's: the mean over microbatches of each
microbatch's masked mean (JAX :158-161), each microbatch's numerator
and denominator summed over the dp and cp groups first. It is the last
stage's, broadcast to every stage. The stage-replicated leaves'
gradients are summed over the pp group by the train step
(training/train_step.py), the transpose of the JAX shard_map's
replicated inputs and the reference's embedding-group all-reduce.

Serving (JAX :436-631): `make_pipelined_score_fn` streams microbatches
through the same forward ticks and the last stage banks each one's
target log-probs (under cp each rank its shard's, the targets shifted
on the whole sequence so that a shard's last target is the next
shard's first token, JAX :494-506, then gathered over the cp group);
`make_pipelined_decode_fn` is the round-robin stage ring, each stage
holding only its layers' stacked "tgd" KV cache, whose single-token
ticks launch decode kernel K1 on each layer's cache slice in place
(models/attention.py). `reshard_params_for_inference` gathers the
layers over the pp group for the whole-batch routes. Every rank calls
these with the same arguments and gets the last stage's result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from megatron_llm_tpu_torch.config import ParallelConfig
from megatron_llm_tpu_torch.inference.generation import select_next_token
from megatron_llm_tpu_torch.models.language_model import (
    chunked_head_cross_entropy,
    embed_tokens,
    lm_logits,
)
from megatron_llm_tpu_torch.models.norms import apply_norm
from megatron_llm_tpu_torch.models.remat import remat_wrap
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.models.transformer import transformer_stack
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.parallel.mappings import tp_input
from megatron_llm_tpu_torch.parallel.mesh import (
    A4_DROPOUT,
    A4_TP_SERVING,
    all_gather_rows,
    broadcast,
    get_context,
    p2p_wait,
    recv_boundary,
    send_boundary,
    sum_over_tokens,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    gather_params,
    pipeline_param_specs,
)

__all__ = ["make_pipelined_loss_fn", "make_pipelined_score_fn",
           "make_pipelined_decode_fn", "pipeline_param_specs",
           "reshard_params_for_inference"]


class _Stage:
    """This rank's stage of the pipeline: its neighbours, its first
    layer's global index and the boundary's shape."""

    def __init__(self, model, ctx):
        ctx = ctx or get_context()
        if ctx is None or ctx.pp == 1:
            raise ValueError("a pipelined function needs a parallel context "
                             "with pp > 1 (parallel/mesh.py "
                             "initialize_parallel)")
        self.ctx, self.model, self.cfg = ctx, model, model.cfg
        if self.cfg.num_layers % ctx.pp:
            raise ValueError(f"pp={ctx.pp} does not divide num_layers="
                             f"{self.cfg.num_layers}")
        self.layers = self.cfg.num_layers // ctx.pp
        self.stage = ctx.pp_rank
        self.first, self.last = ctx.first_stage, ctx.last_stage
        self.prev = None if self.first else ctx.pp_ranks[self.stage - 1]
        self.next = None if self.last else ctx.pp_ranks[self.stage + 1]
        self.dtype = self.cfg.compute_dtype

    def rope(self, device):
        cfg = self.cfg
        if cfg.position_embedding_type != "rotary":
            return None
        return precompute_rope(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, cfg.rope_scaling_factor,
                               device)

    def boundary_shape(self, b: int, s: int) -> tuple:
        """(b, s, h) of the rank's s positions (its cp shard), their
        tp shard under sequence parallelism."""
        ctx = self.ctx
        if ctx.sequence_parallel:
            s //= ctx.tp
        return (b, s, self.cfg.hidden_size)

    def recv(self, shape):
        return recv_boundary(shape, self.dtype, self.prev, self.ctx)

    def send(self, x):
        send_boundary(x.to(self.dtype), self.next, self.ctx)

    def positions(self, n: int, b: int, s: int, device) -> torch.Tensor:
        """(n, b, s) global position ids of this rank's cp shard."""
        start = self.ctx.cp_rank * s
        return torch.arange(start, start + s, device=device).expand(n, b, s)

    def from_last(self, x: torch.Tensor) -> torch.Tensor:
        """`x` as the last stage holds it, on every stage (in place)."""
        return broadcast(x, self.ctx.pp_ranks[-1], self.ctx.pp_group,
                         self.ctx)

    def forward_ticks(self, n: int, shape: tuple, run) -> None:
        """The GPipe forward ticks of `n` microbatches: at tick m + stage
        this stage runs `run(m, inp)`, `inp` the boundary received from
        the stage before (None on stage 0), and sends what it returns on
        to the next stage (the last stage keeps it)."""
        for m in range(n):
            inp = None if self.first else self.recv(shape)
            out = run(m, inp)
            if not self.last:
                self.send(out.detach())


class _Pipeline(_Stage):
    """The training and evaluation schedule of one stage."""

    def __init__(self, model, pcfg: Optional[ParallelConfig], ctx):
        super().__init__(model, ctx)
        policy = "full" if pcfg is None else pcfg.resolved_pipeline_remat
        self.policy = policy
        cfg = self.cfg
        # under a named tick policy that policy alone decides what the
        # stage keeps: its layers run without their own
        self.stage_cfg = cfg if policy in ("full", "none") else \
            dataclasses.replace(cfg, remat_policy=None,
                                recompute_granularity=None,
                                recompute_method="uniform",
                                recompute_num_layers=1)

    def tick(self, params, inp, micro: dict, rope, stage_cfg=None):
        """One stage pass of one microbatch: the boundary it sends on,
        or on the last stage the microbatch's masked loss sum."""
        cfg = self.cfg
        if self.first:
            inp = embed_tokens(params, cfg, micro["tokens"],
                               micro["position_ids"])
        hidden, _ = transformer_stack(
            params["layers"], stage_cfg or cfg, inp, rope, None,
            micro["position_ids"], layer_offset=self.stage * self.layers)
        if not self.last:
            return hidden.to(self.dtype)
        hidden = apply_norm(hidden, params["final_norm"], cfg)
        losses = chunked_head_cross_entropy(params, cfg, hidden,
                                            micro["labels"])
        return (losses * micro["loss_mask"]).sum()

    def loss(self, params, batch, dropout_rng=None, loss_scale=None,
             backward: bool = False) -> torch.Tensor:
        """The mean over microbatches of each microbatch's masked mean
        loss, on every stage. `batch` holds (num_micro, b, s) tensors:
        tokens, labels and optionally loss_mask and position_ids (global
        ones; under cp the rank's sequence shard of each). With
        `backward` the schedule's backward runs too: the gradient of the
        microbatches' summed losses (times `loss_scale`, under fp16)
        accumulates in the `.grad` of this stage's params, as the
        single-stage step's microbatch loop leaves it."""
        if dropout_rng is not None:
            raise ValueError(f"dropout across pipeline stages is not "
                             f"ported yet ({A4_DROPOUT})")
        if "attention_mask" in batch:  # JAX training/trainer.py:533-540
            raise ValueError(
                "pp>1 training does not support --reset_attention_mask "
                "(the pipelined loss has no attention-mask path); drop "
                "the flag or train with pp=1")
        ctx = self.ctx
        tokens = batch["tokens"]
        n, b, s = tokens.shape
        dev = tokens.device
        lmask = batch.get("loss_mask")
        lmask = torch.ones((n, b, s), dtype=torch.float32, device=dev) \
            if lmask is None else lmask.float()
        pids = batch.get("position_ids")
        if pids is None:
            pids = self.positions(n, b, s, dev)
        micro = [{"tokens": tokens[m], "labels": batch["labels"][m],
                  "loss_mask": lmask[m], "position_ids": pids[m]}
                 for m in range(n)]
        rope = self.rope(dev)
        shape = self.boundary_shape(b, s)
        dens = None
        if self.last:
            dens = sum_over_tokens(lmask.sum(dim=(1, 2)), ctx).clamp(min=1.0)
        keep = backward and self.policy != "full"
        tick = self.tick
        if keep and self.policy != "none":
            tick = remat_wrap(self.tick, self.policy)
        saved, nums = [None] * n, []

        def run(m, inp):
            if keep:
                if inp is not None:
                    inp.requires_grad_(True)
                with torch.enable_grad():
                    out = tick(params, inp, micro[m], rope, self.stage_cfg)
                saved[m] = (inp, out)
            else:
                with torch.no_grad():
                    out = self.tick(params, inp, micro[m], rope)
                if backward:
                    saved[m] = inp
            if self.last:
                nums.append(out.detach())
            return out

        self.forward_ticks(n, shape, run)
        if backward:
            self._backward(params, micro, rope, saved, dens, loss_scale,
                           shape)
        p2p_wait(ctx)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if self.last:
            nums = sum_over_tokens(torch.stack(nums), ctx)
            total = (nums / dens).sum() / n
        return self.from_last(total)

    def _backward(self, params, micro, rope, saved, dens, loss_scale,
                  shape):
        for m in reversed(range(len(micro))):
            if self.policy == "full":
                inp = saved[m]
                if inp is not None:
                    inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = self.tick(params, inp, micro[m], rope)
            else:
                inp, out = saved[m]
            saved[m] = None
            with torch.enable_grad():
                if self.last:
                    loss = out / dens[m]
                    if loss_scale is not None:
                        loss = loss * loss_scale
                    loss.backward()
                else:
                    torch.autograd.backward(out, self.recv_grad(shape))
            if not self.first:
                send_boundary(inp.grad.to(self.dtype), self.prev, self.ctx)

    def recv_grad(self, shape):
        return recv_boundary(shape, self.dtype, self.next, self.ctx)


def make_pipelined_loss_fn(model, pcfg: Optional[ParallelConfig] = None,
                           ctx=None):
    """loss(params, batch, dropout_rng=None, loss_scale=None,
    backward=False) of this rank's stage (JAX :140-433): `params` the
    stage's tree (its layers, the replicated embedding, final norm and
    head), `batch` (num_micro, b, s) tensors of this dp rank's rows.
    Returns the mean of the microbatches' masked means on every stage;
    with `backward` the schedule's backward accumulates the stage's
    gradients (module doc). JAX returns a differentiable function; in
    torch the backward crosses processes, so the schedule runs it."""
    return _Pipeline(model, pcfg, ctx).loss


def make_pipelined_score_fn(model, pcfg: Optional[ParallelConfig] = None,
                            ctx=None):
    """score(params, tokens (num_micro, b, s)) -> (num_micro, b, s - 1)
    fp32 target log-probs, lp[..., i] = log P(tokens[..., i + 1] |
    tokens[..., :i + 1]), on every stage (JAX :436-601): forward GPipe
    ticks, no gradient; the last stage's head computes each microbatch's
    log-probs as the negative vocab-parallel cross entropy (whole or over
    tp shards). Every rank passes the whole tokens; under cp, s is a
    multiple of cp and each rank runs its shard."""
    stage = _Stage(model, ctx)
    cfg = model.cfg

    @torch.no_grad()
    def score(params, tokens):
        ctx = stage.ctx
        tokens = torch.as_tensor(tokens, device=ctx.device).long()
        # the targets of the whole sequence, then this rank's shard of
        # both: a shard's last target is the next shard's first token
        targets = torch.roll(tokens, -1, dims=-1)
        n, b, s = tokens.shape
        if s % ctx.cp:
            raise ValueError(f"cp={ctx.cp} does not divide the scored "
                             f"length {s}")
        s //= ctx.cp
        sl = slice(ctx.cp_rank * s, (ctx.cp_rank + 1) * s)
        tokens, targets = tokens[..., sl], targets[..., sl]
        rope = stage.rope(tokens.device)
        pids = stage.positions(1, b, s, tokens.device)[0]
        shape = stage.boundary_shape(b, s)
        banked = torch.zeros((n, b, s), dtype=torch.float32,
                             device=tokens.device)

        def run(m, inp):
            if stage.first:
                inp = embed_tokens(params, cfg, tokens[m], pids)
            out, _ = transformer_stack(
                params["layers"], cfg, inp, rope, None, pids,
                layer_offset=stage.stage * stage.layers)
            if stage.last:
                h = apply_norm(out, params["final_norm"], cfg)
                logits = lm_logits(params, cfg, tp_input(h))
                banked[m] = -vocab_parallel_cross_entropy(logits, targets[m])
            return out

        stage.forward_ticks(n, shape, run)
        p2p_wait(ctx)
        banked = all_gather_rows(banked.movedim(2, 0).contiguous(),
                                 ctx.cp_group, ctx).movedim(0, 2)
        return stage.from_last(banked.contiguous())[:, :, :-1]

    return score


def make_pipelined_decode_fn(model, pcfg: Optional[ParallelConfig] = None,
                             ctx=None, *, prefill_len: int, max_len: int,
                             num_micro: Optional[int] = None,
                             greedy: bool = True, top_k: int = 0,
                             top_p: float = 0.0, temperature: float = 1.0,
                             vocab_size: Optional[int] = None,
                             termination_id: Optional[int] = None,
                             use_eod_for_early_termination: bool = True,
                             return_log_probs: bool = False):
    """KV-cached decode on the stage-sharded layout, the round-robin
    stage ring (JAX :601-631). Returns decode(params, tokens (b,
    max_len), lengths (b,), generator=None) -> (tokens, generated
    lengths, log-probs or None), `generate_tokens`'s semantics, on every
    stage.

    The batch splits into `num_micro` (default pp) groups of b / num_micro
    rows. A prefill runs GPipe ticks over the groups' common prefix; then
    at every tick each stage advances another group by one token, the
    boundary goes on to the next stage, and the last stage picks the next
    token (teacher-forced while a row's prompt runs), keeps the EOD
    bookkeeping and broadcasts the token and "every row done" to the
    stages, stage 0 feeding it in when it next serves that group: with
    num_micro == pp nothing waits. Each stage holds its layers' stacked
    cache, (L / pp, num_micro, b / num_micro, max_len, g, d) in the
    compute dtype. The JAX ring runs fill and drain ticks on garbage and
    gives them a scratch tail past max_len; here a stage with no group
    at a tick skips it, so nothing writes past max_len and there is no
    tail. Decode ticks (s == 1) launch K1
    on each layer's "tgd" slice in place; the prefill takes the plain
    masked softmax. The token and the done flag cross from the last
    stage every tick, the host reading the flag only under early
    termination. Sampling draws from `generator` in the ring's order,
    not the JAX ring's keys. Tensor-parallel decode raises (ROADMAP.md
    A4), and so does cp > 1 (JAX :646: generation at cp > 1 takes the
    whole-batch route, inference/api.py)."""
    stage = _Stage(model, ctx)
    sctx = stage.ctx
    if sctx.cp > 1:
        raise ValueError("pipelined decode: cp axis unsupported (the "
                         "stage ring serves at cp = 1; generation at "
                         "cp > 1 takes the whole-batch route)")
    if sctx.tp > 1:
        raise ValueError(f"pipelined decode at tp={sctx.tp}: "
                         f"tensor-parallel serving is not ported yet "
                         f"({A4_TP_SERVING})")
    pp = sctx.pp
    nm = num_micro or pp
    if nm < pp:
        raise ValueError(f"num_micro={nm} < pp={pp}: the ring returns a "
                         f"token to stage 0 pp - 1 ticks after it left")
    steps = max_len - prefill_len - 1  # decode rounds after the seed
    if steps < 0 or prefill_len < 1:
        raise ValueError(f"prefill_len={prefill_len} max_len={max_len}")
    cfg = model.cfg
    early = termination_id is not None and use_eod_for_early_termination

    def head(dec, hidden):
        h = apply_norm(hidden, dec["final_norm"], cfg)
        return lm_logits(dec, cfg, h).float()

    def choose(logits, prev, generator):
        return select_next_token(
            logits, prev, generator, top_p, greedy=greedy, top_k=top_k,
            top_p=top_p, temperature=temperature, vocab_size=vocab_size)

    @torch.no_grad()
    def decode(params, tokens, lengths, generator=None):
        dev = sctx.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        lengths = torch.as_tensor(lengths, device=dev).long()
        b = tokens.shape[0]
        if b % nm:
            raise ValueError(f"batch {b} does not split into {nm} groups")
        bm = b // nm
        toks = tokens.reshape(nm, bm, max_len).clone()
        lens = lengths.reshape(nm, bm)
        dec = model.prepare_decode_params(params)
        rope = stage.rope(dev)
        kshape = (stage.layers, nm, bm, max_len, cfg.num_query_groups,
                  cfg.head_dim)
        kc = torch.zeros(kshape, dtype=cfg.compute_dtype, device=dev)
        vc = torch.zeros(kshape, dtype=cfg.compute_dtype, device=dev)
        offset0 = stage.stage * stage.layers
        h = cfg.hidden_size

        def run_stage(inp, m, off):
            out, _ = transformer_stack(
                dec["layers"], cfg, inp, rope, None, None,
                {"k_stacked": kc[:, m], "v_stacked": vc[:, m],
                 "offset": off}, layer_offset=offset0)
            return out

        lps = torch.zeros((nm, bm, max_len - 1), dtype=torch.float32,
                          device=dev)
        seeds = torch.zeros((nm, bm), dtype=torch.long, device=dev)

        def pick_prefill(out, m):
            """The last stage: group m's first token after the prefix."""
            if return_log_probs:
                logits = head(dec, out)
                lp_all = torch.log_softmax(logits, dim=-1)
                lps[m, :, :prefill_len - 1] = torch.gather(
                    lp_all[:, :-1], -1,
                    toks[m, :, 1:prefill_len, None]).squeeze(-1)
                last_logits = logits[:, -1]
            else:
                last_logits = head(dec, out[:, -1:])[:, 0]
            chosen = choose(last_logits, toks[m, :, prefill_len - 1],
                            generator)
            if prefill_len < max_len:
                chosen = torch.where(lens[m] <= prefill_len, chosen,
                                     toks[m, :, prefill_len])
                toks[m, :, prefill_len] = chosen
            seeds[m] = chosen
            if return_log_probs:
                lps[m, :, prefill_len - 1] = torch.gather(
                    torch.log_softmax(last_logits, -1), -1,
                    chosen[:, None]).squeeze(-1)

        # ---- prefill: GPipe ticks over the common prefix ---------------
        def prefill(m, inp):
            if stage.first:
                inp = embed_tokens(dec, cfg, toks[m, :, :prefill_len])
            out = run_stage(inp, m, 0)
            if stage.last:
                pick_prefill(out, m)
            return out

        stage.forward_ticks(nm, (bm, prefill_len, h), prefill)
        p2p_wait(sctx)
        next_tok = stage.from_last(seeds)
        # ---- decode: round-robin single-token ticks --------------------
        if termination_id is not None:
            done = (seeds == termination_id) & (lens <= prefill_len)
            glens = torch.where(done, prefill_len + 1, max_len)
        else:
            done = torch.zeros((nm, bm), dtype=torch.bool, device=dev)
            glens = torch.full((nm, bm), max_len, dtype=torch.long,
                               device=dev)
        offsets = [prefill_len] * nm
        total = steps * nm + pp - 1
        msg = torch.zeros(1 + bm, dtype=torch.long, device=dev)

        def pick(out, m, pos):
            """The last stage: group m's token at position pos (the tick
            fed it pos - 1), its log-prob and EOD bookkeeping."""
            logits = head(dec, out)[:, 0]
            row = toks[m]
            col = min(pos, max_len - 1)
            started = lens[m] <= pos
            chosen = torch.where(
                started, choose(logits, row[:, max(pos - 1, 0)], generator),
                row[:, col])
            row[:, col] = chosen
            if return_log_probs:
                lps[m, :, min(pos - 1, max_len - 2)] = torch.gather(
                    torch.log_softmax(logits, -1), -1,
                    chosen[:, None]).squeeze(-1)
            if termination_id is not None:
                hit = (chosen == termination_id) & started
                glens[m] = torch.where(hit & ~done[m], pos + 1, glens[m])
                done[m] |= hit
            msg[1:] = chosen

        def live(st, t):  # whether stage st advances a group at tick t
            return t >= st and t - st < steps * nm

        t = 0
        while t < total:
            m = (t - stage.stage) % nm
            if live(stage.stage, t):
                off = offsets[m]
                if stage.first:
                    pos = torch.full((1, 1), off, dtype=torch.long,
                                     device=dev)
                    inp = embed_tokens(dec, cfg, next_tok[m][:, None], pos)
                else:
                    inp = stage.recv((bm, 1, h))
                out = run_stage(inp, m, off)
                offsets[m] = off + 1
                if stage.last:
                    pick(out, m, offsets[m])
                else:
                    stage.send(out)
            if stage.last and termination_id is not None:
                msg[0] = done.all()
            stage.from_last(msg)
            m_l = (t - (pp - 1)) % nm
            if stage.first and t >= pp - 1:
                next_tok[m_l] = msg[1:]
            t += 1
            if early and bool(msg[0]):
                # the boundary the stage before sent in this last tick
                # has no tick left to take it: receive it and drop it
                if not stage.first and live(stage.stage - 1, t - 1):
                    stage.recv((bm, 1, h))
                break
        p2p_wait(sctx)
        out_toks = stage.from_last(toks).reshape(b, max_len)
        out_lens = stage.from_last(glens).reshape(b)
        out_lps = stage.from_last(lps).reshape(b, max_len - 1) \
            if return_log_probs else None
        return out_toks, out_lens, out_lps

    return decode


def reshard_params_for_inference(params: dict, ctx=None, cfg=None) -> dict:
    """The stage's tree with its stacked layers gathered over the pp group
    (tensor-parallel slices kept): every stage then holds the whole
    stack, pp x the layers' memory, for the whole-batch routes (JAX
    :634-650, its stage-replicated reshard)."""
    ctx = ctx or get_context()
    if ctx is None or ctx.pp == 1:
        return params
    return gather_params(params, ctx, cfg, tp=False)
