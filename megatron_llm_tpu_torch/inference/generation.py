"""Autoregressive generation: scoring, sampling decode, beam search (port
of inference/generation.py).

The JAX package runs the whole decode as one jitted program with a
`lax.while_loop`; here the loop is eager Python. Each step selects the
next token on the device, and the host checks "every row done" once per
step. The KV cache is preallocated once per request
(`GPTModel.init_kv_caches`) and each step writes its token's column in
place. Single-token steps run decode-attention kernel K1 on the card
(models/attention.py).

Semantics kept from the JAX package: prefill of the bucketed common
prefix (`bucket_prefill_len`), teacher-forcing of rows whose prompt is
still running, eod bookkeeping, log-probs in fp32, pad-vocab masking and
top-p decay. Sampling draws from a `torch.Generator` seeded from the
request; it does not reproduce JAX's random bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from megatron_llm_tpu_torch.inference.sampling import (
    NEG_INF,
    modify_logits_for_top_k,
    modify_logits_for_top_p,
)


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor  # (b, max_len) prompt + generated
    lengths: torch.Tensor  # (b,) total generated length incl. prompt
    log_probs: Optional[torch.Tensor]  # (b, max_len - 1) fp32 or None


def bucket_prefill_len(min_len: int) -> int:
    """Round the common prefill length down to a multiple of 64 (>= 64)
    or a power of two (< 64). The positions past the bucket are
    teacher-forced by the decode loop, so tokens and log-probs do not
    depend on it; the JAX package bounds its compile shapes with it, and
    the port keeps it so both run the same prefill."""
    if min_len >= 64:
        return (min_len // 64) * 64
    return 1 << (max(min_len, 1).bit_length() - 1)


def _categorical(logits: torch.Tensor, generator: torch.Generator):
    """One sample per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1)


def select_next_token(logits: torch.Tensor, prev_token: torch.Tensor,
                      generator: Optional[torch.Generator], cur_top_p: float,
                      *, greedy: bool, top_k: int, top_p: float,
                      temperature: float, vocab_size: Optional[int] = None,
                      prevent_newline_after_colon_ids=None) -> torch.Tensor:
    """One sampling decision for a (b, V) block of logits."""
    logits = logits.float()
    V = logits.shape[-1]
    cols = torch.arange(V, device=logits.device)
    if prevent_newline_after_colon_ids is not None:
        colon_id, newline_id = prevent_newline_after_colon_ids
        hit = prev_token == colon_id
        logits = logits.masked_fill(hit[:, None] & (cols == newline_id)[None],
                                    NEG_INF)
    if vocab_size is not None and vocab_size < V:
        logits = logits.masked_fill(cols >= vocab_size, NEG_INF)
    if greedy:
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k > 1:
        logits = modify_logits_for_top_k(logits, top_k)
    elif top_p > 0.0:
        logits = modify_logits_for_top_p(logits, cur_top_p)
    return _categorical(logits, generator)


def _ids(x, device) -> torch.Tensor:
    """A fresh int64 copy on `device` of token ids given as a numpy array
    or a tensor (the decode loop writes into it)."""
    return torch.as_tensor(x).to(device=device, dtype=torch.long, copy=True)


def _gather_lp(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, targets[..., None]).squeeze(-1)


@torch.inference_mode()
def score_tokens(model, params: dict, tokens) -> torch.Tensor:
    """(b, s-1) fp32: lp[:, i] = log P(tokens[:, i+1] | tokens[:, :i+1])."""
    tokens = _ids(tokens, model.device)
    logits, _ = model.forward(params, tokens[:, :-1])
    return _gather_lp(logits, tokens[:, 1:])


@torch.inference_mode()
def generate_tokens(model, params: dict, tokens, lengths, prefill_len: int,
                    generator: Optional[torch.Generator] = None,
                    top_k: int = 0, top_p: float = 0.0,
                    top_p_decay: float = 0.0, top_p_bound: float = 0.0,
                    temperature: float = 1.0,
                    vocab_size: Optional[int] = None,
                    termination_id: Optional[int] = None,
                    return_log_probs: bool = False,
                    use_eod_for_early_termination: bool = True,
                    prevent_newline_after_colon_ids: Optional[Tuple[int, int]] = None,
                    ) -> GenerateOutput:
    """Decode `tokens` (b, max_len), prompts left-aligned and padded, with
    prompt `lengths` (b,). Greedy when top_k == 1 or no generator is
    given. Runs to max_len or until every row that has started
    generating emitted `termination_id`."""
    dev = model.device
    tokens = _ids(tokens, dev)
    lengths = _ids(lengths, dev)
    b, max_len = tokens.shape
    greedy = top_k == 1 or generator is None

    params = model.prepare_decode_params(params)
    caches = model.init_kv_caches(b, max_len)
    log_probs = torch.zeros((b, max_len - 1), dtype=torch.float32,
                            device=dev)

    logits, caches = model.forward(params, tokens[:, :prefill_len],
                                   kv_caches=caches)
    if return_log_probs:
        log_probs[:, :prefill_len - 1] = _gather_lp(
            logits[:, :-1], tokens[:, 1:prefill_len])
    last_logits = logits[:, -1]

    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    gen_lens = torch.full((b,), max_len, dtype=torch.long, device=dev)
    cur_top_p = np.float32(top_p)
    early = use_eod_for_early_termination and termination_id is not None
    for t in range(prefill_len, max_len):
        if early and t > prefill_len and bool(done.all()):
            break
        new_sample = select_next_token(
            last_logits, tokens[:, t - 1], generator, float(cur_top_p),
            greedy=greedy, top_k=top_k, top_p=top_p,
            temperature=temperature, vocab_size=vocab_size,
            prevent_newline_after_colon_ids=prevent_newline_after_colon_ids)
        started = lengths <= t  # past this row's prompt?
        chosen = torch.where(started, new_sample, tokens[:, t])
        tokens[:, t] = chosen
        if return_log_probs:
            log_probs[:, t - 1] = _gather_lp(last_logits, chosen)
        if termination_id is not None:
            done_token = (chosen == termination_id) & started
            gen_lens = torch.where(done_token & ~done,
                                   torch.full_like(gen_lens, t + 1), gen_lens)
            done |= done_token
        if top_p > 0.0 and top_p_decay > 0.0:
            # fp32, as the JAX loop carries it
            cur_top_p = max(cur_top_p * np.float32(top_p_decay),
                            np.float32(top_p_bound))
        if t + 1 < max_len:  # the last position's logits are never read
            logits, caches = model.forward(params, chosen[:, None],
                                           kv_caches=caches)
            last_logits = logits[:, -1]
    return GenerateOutput(tokens=tokens, lengths=gen_lens,
                          log_probs=log_probs if return_log_probs else None)


class BeamHypotheses:
    """Sorted pool of finished hypotheses (JAX: generation.py)."""

    def __init__(self, num_beams: int, length_penalty: float = 1.0,
                 early_stopping: bool = False):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.early_stopping = early_stopping
        self.beams: list = []
        self.worst_score = 1e9

    def __len__(self):
        return len(self.beams)

    def add(self, hyp, sum_logprobs: float):
        score = sum_logprobs / max(len(hyp), 1) ** self.length_penalty
        if len(self) < self.num_beams or score > self.worst_score:
            self.beams.append((score, hyp))
            if len(self) > self.num_beams:
                sorted_scores = sorted(
                    (s, idx) for idx, (s, _) in enumerate(self.beams))
                del self.beams[sorted_scores[0][1]]
                self.worst_score = sorted_scores[1][0]
            else:
                self.worst_score = min(score, self.worst_score)

    def is_done(self, best_sum_logprobs: float, cur_len: int) -> bool:
        if len(self) < self.num_beams:
            return False
        if self.early_stopping:
            return True
        return self.worst_score >= (
            best_sum_logprobs / cur_len ** self.length_penalty)


@torch.inference_mode()
def beam_search(model, params: dict, tokens, prompt_length: int,
                beam_size: int, stop_token: int, num_return_gen: int = 1,
                length_penalty: float = 1.0,
                vocab_size: Optional[int] = None,
                max_new_tokens: Optional[int] = None):
    """Batch-1 beam search. Returns numpy (tokens (num_return_gen,
    out_len) int32, scores (num_return_gen,) fp32)."""
    dev = model.device
    tokens = _ids(tokens, dev)
    assert tokens.shape[0] == 1, "beam search: batch size must be 1"
    max_len = tokens.shape[1]
    if max_new_tokens is not None:
        max_len = min(max_len, prompt_length + max_new_tokens)
    tokens = tokens.expand(beam_size, -1).clone()

    params = model.prepare_decode_params(params)
    caches = model.init_kv_caches(beam_size, max_len)
    logits, caches = model.forward(params, tokens[:, :prompt_length],
                                   kv_caches=caches)
    last_logits = logits[:, -1]
    vocab = last_logits.shape[-1]
    cols = torch.arange(vocab, device=dev)
    # first step: all beams identical, only beam 0 counts
    scores = torch.full((beam_size,), NEG_INF, dtype=torch.float32,
                        device=dev)
    scores[0] = 0.0
    hyps = BeamHypotheses(beam_size, length_penalty)
    done = False

    for t in range(prompt_length, max_len):
        lp = torch.log_softmax(last_logits.float(), dim=-1)
        if vocab_size is not None and vocab_size < vocab:
            lp = lp.masked_fill(cols >= vocab_size, NEG_INF)
        best = torch.topk((lp + scores[:, None]).reshape(-1), 2 * beam_size)
        best_scores = best.values.cpu().numpy()
        best_idx = best.indices.cpu().numpy()

        next_beams = []  # (score, beam, token)
        for sc, idx in zip(best_scores, best_idx):
            beam, tok = divmod(int(idx), vocab)
            if tok == stop_token:
                hyps.add(tokens[beam, prompt_length:t].cpu().numpy(),
                         float(sc))
            else:
                next_beams.append((float(sc), beam, tok))
            if len(next_beams) == beam_size:
                break
        if hyps.is_done(float(best_scores[0]), t - prompt_length + 1):
            done = True
            break
        if not next_beams:
            break
        beam_idx = torch.tensor([bm for _, bm, _ in next_beams], device=dev)
        token_idx = torch.tensor([tk for _, _, tk in next_beams], device=dev)
        scores = torch.tensor([s for s, _, _ in next_beams],
                              dtype=torch.float32, device=dev)
        # reorder beams (tokens and every layer's cache), bank the tokens,
        # then one KV-cached step
        tokens = tokens[beam_idx]
        caches = {"k_layers": tuple(c[beam_idx] for c in caches["k_layers"]),
                  "v_layers": tuple(c[beam_idx] for c in caches["v_layers"]),
                  "offset": caches["offset"]}
        tokens[:, t] = token_idx
        logits, caches = model.forward(params, token_idx[:, None],
                                       kv_caches=caches)
        last_logits = logits[:, -1]

    if not done:
        scores_h = scores.cpu().numpy()
        for i in range(beam_size):
            hyps.add(tokens[i, prompt_length:max_len].cpu().numpy(),
                     float(scores_h[i]))

    best = sorted(hyps.beams, key=lambda x: -x[0])[:num_return_gen]
    prompt = tokens[0, :prompt_length].cpu().numpy()
    seqs = [np.concatenate([prompt, np.asarray(h)]).astype(np.int32)
            for _, h in best]
    out = np.full((len(seqs), max(len(s) for s in seqs)), stop_token,
                  np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, np.asarray([s for s, _ in best], np.float32)
