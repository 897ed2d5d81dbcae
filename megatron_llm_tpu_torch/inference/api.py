"""Public inference API (port of inference/api.py, single-device whole-batch
route; the pipeline-parallel branches wait for the parallelism slice)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.inference.generation import (
    beam_search,
    bucket_prefill_len,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.inference.tokenization import (
    detokenize_generations,
    tokenize_prompts,
)


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
    tokens), the reference's return contract."""
    tokens, lengths = tokenize_prompts(tokenizer, prompts, tokens_to_generate,
                                       add_BOS)
    if tokens_to_generate == 0:
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
    """Returns (texts, segments, scores, tokens) for one prompt."""
    assert len(prompts) == 1, "beam search: batch size must be 1"
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
