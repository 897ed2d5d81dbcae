"""Public inference API (port of inference/api.py): the whole-batch
route, and on a pipeline-parallel layout (pp > 1) the JAX package's pp
branches and request contract (JAX :63-88, :231-314, :439-467).

On a context-parallel layout (cp > 1) every rank calls the API with the
same request as well. Scoring pads the sequence to a multiple of cp
(JAX :271) and runs the ring, each cp rank its shard, the log-probs
gathered over the cp group; generation runs the one-rank cached route on
every cp rank, whose parameters are whole (at pp > 1 after the reshard
below: the stage ring needs cp == 1, JAX :292).

On a stage-sharded layout every rank of the layout calls the API with
the same request (SPMD; the JAX package's one controller drives the
mesh) and every rank returns the last stage's result, broadcast:

- scoring (tokens_to_generate == 0) runs the pipelined scorer with the
  stage-sharded params in place;
- plain greedy requests (top_k == 1, no prevent_newline_after_colon, no
  top_p_decay) of a model above `PP_DECODE_RESHARD_LIMIT_BYTES` (env
  MEGATRON_TPU_PP_RESHARD_LIMIT_BYTES, default 2 GiB, the whole model's
  bytes) decode through the stage ring, its tokens those of the
  whole-batch route;
- sampled and beam requests, and greedy ones at or under the limit,
  gather the layers over the pp group (pp x the layers' memory a rank)
  and take the whole-batch route; above the limit they raise, naming
  the alternatives. The limit is part of the request contract: it
  decides which requests a deployment accepts, never what a successful
  one returns.

The JAX package memoises its pipelined executables in bounded LRU
caches and counts them against its compile contracts; nothing here is
compiled, so there is no cache (ROADMAP.md C, accepted divergences).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.inference.generation import (
    _gather_lp,
    beam_search,
    bucket_prefill_len,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.inference.tokenization import (
    detokenize_generations,
    tokenize_prompts,
)
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.parallel.mesh import all_gather_rows, get_context
from megatron_llm_tpu_torch.parallel.pipeline import (
    make_pipelined_decode_fn,
    make_pipelined_score_fn,
    reshard_params_for_inference,
)
from megatron_llm_tpu_torch.parallel.sharding import (
    model_axis,
    pipeline_param_specs,
    spec_leaves,
    stage_axis,
)

# the request contract's limit (JAX :63-88): above it a pp > 1 layout
# serves only ring-eligible requests
PP_DECODE_RESHARD_LIMIT_BYTES = int(os.environ.get(
    "MEGATRON_TPU_PP_RESHARD_LIMIT_BYTES", 2 << 30))


def _pp_context():
    ctx = get_context()
    return ctx if ctx is not None and ctx.pp > 1 else None


def _params_nbytes(params, ctx) -> int:
    """The whole model's bytes (the JAX package's global array sizes)
    from this stage's slices: a stage's layers count pp times, a
    tensor-parallel slice tp times."""
    specs = spec_leaves(pipeline_param_specs(None, params))
    total = 0
    for x, spec in zip(tree_leaves(params), specs):
        n = x.numel() * x.element_size()
        if stage_axis(spec) is not None:
            n *= ctx.pp
        if model_axis(spec) is not None:
            n *= ctx.tp
        total += n
    return total


def _pad_to_cp(tokens: np.ndarray, cp: int) -> np.ndarray:
    """(b, s) padded at the end to a multiple of cp (JAX :271); causal
    attention keeps the pads out of every real position."""
    pad = (-tokens.shape[1]) % cp
    return np.pad(tokens, ((0, 0), (0, pad))) if pad else tokens


@torch.inference_mode()
def _cp_score_tokens(model, ctx, params, tokens) -> np.ndarray:
    """`score_tokens` through the ring: (b, s - 1) target log-probs."""
    tokens = np.asarray(tokens)
    s = tokens.shape[1]
    x = _pad_to_cp(tokens[:, :-1], ctx.cp)
    t = _pad_to_cp(tokens[:, 1:], ctx.cp)
    n = x.shape[1] // ctx.cp
    sl = slice(ctx.cp_rank * n, (ctx.cp_rank + 1) * n)
    dev = model.device
    pos = torch.arange(sl.start, sl.stop, device=dev)[None].expand(
        x.shape[0], n)
    logits, _ = model.forward(params, torch.as_tensor(x[:, sl], device=dev),
                              position_ids=pos)
    lp = _gather_lp(logits, torch.as_tensor(t[:, sl], device=dev).long())
    lp = all_gather_rows(lp.T.contiguous(), ctx.cp_group, ctx).T
    return lp.cpu().numpy()[:, :s - 1]


def _pp_score(model, ctx, params, tokens, lengths, tokenizer):
    tokens = np.asarray(tokens)
    s = tokens.shape[1]
    lp = make_pipelined_score_fn(model, None, ctx)(
        params, torch.as_tensor(_pad_to_cp(tokens, ctx.cp)[None]))[0]
    texts, segments = detokenize_generations(tokenizer, tokens, lengths,
                                             return_segments=True)
    return texts, segments, lp.cpu().numpy()[:, :s - 1], tokens


def _pp_ring(model, ctx, params, tokenizer, tokens, lengths,
             tokens_to_generate, prefill_len, return_log_probs,
             use_eod_early):
    """A plain greedy request through the stage ring (JAX :439-467):
    rows padded to a multiple of pp, max_len bucketed to 64."""
    toks_in = np.asarray(tokens)
    lens_in = np.asarray(lengths)
    b, max_len = toks_in.shape
    nm = ctx.pp
    pad_rows = (-b) % nm
    if pad_rows:
        toks_in = np.concatenate([toks_in, np.repeat(toks_in[-1:], pad_rows,
                                                     0)])
        lens_in = np.concatenate([lens_in, np.repeat(lens_in[-1:], pad_rows,
                                                     0)])
    max_len_b = -(-max_len // 64) * 64
    if max_len_b > max_len:
        toks_in = np.concatenate([toks_in, np.zeros(
            (toks_in.shape[0], max_len_b - max_len), toks_in.dtype)], axis=1)
    dec = make_pipelined_decode_fn(
        model, None, ctx, prefill_len=prefill_len, max_len=max_len_b,
        greedy=True, vocab_size=tokenizer.vocab_size,
        termination_id=tokenizer.eod,
        use_eod_for_early_termination=use_eod_early,
        return_log_probs=return_log_probs)
    out_toks, out_lens, out_lps = dec(params, toks_in, lens_in)
    out_tokens = out_toks.cpu().numpy().astype(np.int32)[:b, :max_len]
    out_lengths = np.minimum(out_lens.cpu().numpy()[:b],
                             lengths + tokens_to_generate)
    texts, segments = detokenize_generations(tokenizer, out_tokens,
                                             out_lengths, return_segments=True)
    lp = out_lps.cpu().numpy()[:b, :max_len - 1] \
        if return_log_probs else None
    return texts, segments, lp, out_tokens


def generate_and_post_process(
    model,
    params,
    tokenizer,
    prompts: List[str],
    tokens_to_generate: int = 0,
    return_output_log_probs: bool = False,
    top_k_sampling: int = 0,
    top_p_sampling: float = 0.0,
    top_p_decay: float = 0.0,
    top_p_bound: float = 0.0,
    temperature: float = 1.0,
    add_BOS: bool = False,
    use_eod_token_for_early_termination: bool = True,
    stop_on_eol: bool = False,  # accepted for API parity, as in the JAX
    stop_on_double_eol: bool = False,  # package (tokenizer-specific ids)
    prevent_newline_after_colon: bool = False,
    random_seed: int = -1,
):
    """Returns (prompts_plus_generations, segments, output_log_probs,
    tokens), the reference's return contract. On a pp > 1 layout, the
    module doc's request contract."""
    tokens, lengths = tokenize_prompts(tokenizer, prompts, tokens_to_generate,
                                       add_BOS)
    ctx = _pp_context()
    if ctx is not None:
        if tokens_to_generate == 0:
            return _pp_score(model, ctx, params, tokens, lengths, tokenizer)
        nbytes = _params_nbytes(params, ctx)
        ring = (ctx.cp == 1 and top_k_sampling == 1
                and not prevent_newline_after_colon and top_p_decay == 0.0)
        if ring and nbytes > PP_DECODE_RESHARD_LIMIT_BYTES:
            return _pp_ring(
                model, ctx, params, tokenizer, tokens, lengths,
                tokens_to_generate,
                bucket_prefill_len(int(np.min(lengths))),
                return_output_log_probs, use_eod_token_for_early_termination)
        if nbytes > PP_DECODE_RESHARD_LIMIT_BYTES:
            raise ValueError(
                "pp>1 generate: only plain greedy requests (top_k == 1, no "
                "prevent_newline_after_colon / top_p_decay) ride the stage "
                f"ring, and this model ({nbytes} bytes) exceeds "
                "PP_DECODE_RESHARD_LIMIT_BYTES "
                f"({PP_DECODE_RESHARD_LIMIT_BYTES}) so it cannot reshard "
                "stage-replicated without pp x the per-device param "
                "memory. Use greedy decoding, raise "
                "MEGATRON_TPU_PP_RESHARD_LIMIT_BYTES to accept the "
                "reshard, or serve these requests from a pp=1 layout")
        params = reshard_params_for_inference(params, ctx, model.cfg)

    if tokens_to_generate == 0:
        cctx = get_context()
        if cctx is not None and cctx.cp > 1:
            lp = _cp_score_tokens(model, cctx, params, tokens)
        else:
            lp = score_tokens(model, params, tokens).cpu().numpy()
        texts, segments = detokenize_generations(tokenizer, tokens, lengths,
                                                 return_segments=True)
        return texts, segments, lp, tokens

    pnac_ids = None
    if prevent_newline_after_colon:
        colon = tokenizer.tokenize(":")
        newline = tokenizer.tokenize("\n")
        if colon and newline:
            pnac_ids = (colon[0], newline[0])

    generator = None
    if top_k_sampling != 1:
        # random_seed < 0 means unseeded: fresh OS entropy per request
        seed = (random_seed if random_seed >= 0
                else int.from_bytes(os.urandom(4), "little"))
        generator = torch.Generator(device=model.device).manual_seed(seed)

    out = generate_tokens(
        model, params, tokens, lengths,
        prefill_len=bucket_prefill_len(int(np.min(lengths))),
        generator=generator,
        top_k=top_k_sampling,
        top_p=top_p_sampling,
        top_p_decay=top_p_decay,
        top_p_bound=top_p_bound,
        temperature=temperature,
        vocab_size=tokenizer.vocab_size,
        termination_id=tokenizer.eod,
        return_log_probs=return_output_log_probs,
        use_eod_for_early_termination=use_eod_token_for_early_termination,
        prevent_newline_after_colon_ids=pnac_ids,
    )
    out_tokens = out.tokens.cpu().numpy().astype(np.int32)
    out_lengths = np.minimum(out.lengths.cpu().numpy(),
                             lengths + tokens_to_generate)
    texts, segments = detokenize_generations(tokenizer, out_tokens,
                                             out_lengths, return_segments=True)
    lp = out.log_probs.cpu().numpy() if out.log_probs is not None else None
    return texts, segments, lp, out_tokens


def beam_search_and_post_process(
    model,
    params,
    tokenizer,
    prompts: List[str],
    tokens_to_generate: int = 0,
    beam_size: int = 0,
    add_BOS: bool = False,
    stop_token: Optional[int] = None,
    num_return_gen: int = 1,
    length_penalty: float = 1.0,
    prevent_newline_after_colon: bool = False,
):
    """Returns (texts, segments, scores, tokens) for one prompt. On a
    pp > 1 layout beam search has no ring path (its per-step beam reorder
    would reshuffle stage-sharded caches): at or under the reshard limit
    the layers are gathered, above it the request raises (JAX
    :481-520)."""
    assert len(prompts) == 1, "beam search: batch size must be 1"
    ctx = _pp_context()
    if ctx is not None:
        nbytes = _params_nbytes(params, ctx)
        if nbytes > PP_DECODE_RESHARD_LIMIT_BYTES:
            raise ValueError(
                "beam search on a pp>1 layout requires stage-replicated "
                f"params, but the model ({nbytes} bytes) exceeds "
                "PP_DECODE_RESHARD_LIMIT_BYTES "
                f"({PP_DECODE_RESHARD_LIMIT_BYTES}): no stage-ring beam "
                "path exists (the per-step beam reorder would reshuffle "
                "stage-sharded KV caches across the ring). Raise "
                "MEGATRON_TPU_PP_RESHARD_LIMIT_BYTES to accept the pp x "
                "param-memory reshard, serve beam requests from a pp=1 "
                "layout, or use greedy `generate`, which does pipeline")
        params = reshard_params_for_inference(params, ctx, model.cfg)
    tokens, lengths = tokenize_prompts(tokenizer, prompts, tokens_to_generate,
                                       add_BOS)
    stop = stop_token if stop_token is not None else tokenizer.eod
    out_tokens, scores = beam_search(
        model, params, tokens[:1],
        prompt_length=int(lengths[0]),
        beam_size=beam_size,
        stop_token=stop,
        num_return_gen=num_return_gen,
        length_penalty=length_penalty,
        vocab_size=tokenizer.vocab_size,
        max_new_tokens=tokens_to_generate,
    )
    out_lengths = np.full((out_tokens.shape[0],), out_tokens.shape[1],
                          np.int32)
    # trim trailing stop padding per row
    for i, row in enumerate(out_tokens):
        n = len(row)
        while n > int(lengths[0]) and row[n - 1] == stop:
            n -= 1
        out_lengths[i] = n
    texts, segments = detokenize_generations(tokenizer, out_tokens,
                                             out_lengths, return_segments=True)
    return texts, segments, scores, out_tokens
