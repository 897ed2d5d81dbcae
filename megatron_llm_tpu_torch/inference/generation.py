"""Autoregressive generation: scoring, sampling decode, beam search (port
of inference/generation.py).

The JAX package runs the whole decode as one jitted program with a
`lax.while_loop`. Here one decode step (selection, the eod bookkeeping
and one forward) is a function of static device buffers, captured once
into a CUDA graph and replayed (inference/graph_capture.py): the step
index `t`, the top-p threshold, the done mask, the tokens, log-probs and
KV caches all live on the card, the step writes at the device `t` and
K1 reads the cache to a device length, so one graph replays at every
step. The host reads "every row done" every `DONE_CHECK_EVERY` steps
only: a step replayed after every row is done, or past max_len, changes
nothing, which is the while_loop's exit moved to the host at a coarser
grain. Each call captures its own step and frees it, its caches and its
graph's memory as it returns: no idle call holds a dense cache of
(b, max_len) on the card. The captures are made on one stream per
device, one call at a time, so the kernels' per-stream state (arrival
counters, cuBLAS workspaces) is made once. `decode_log` keeps a record
of the last calls (batch, max_len, steps, capture seconds, the static
caches' bytes). The prefill stays one eager forward. On a CPU tensor
the same step runs eagerly on the same buffers.
Single-token steps run decode-attention kernel K1 on the card
(models/attention.py).

Semantics kept from the JAX package: prefill of the bucketed common
prefix (`bucket_prefill_len`), teacher-forcing of rows whose prompt is
still running, eod bookkeeping, log-probs in fp32, pad-vocab masking and
top-p decay. Sampling draws from a `torch.Generator` seeded from the
request (a captured step draws from a generator registered with its
graph, set to the request's state before the first replay, so a stream
is a function of its seed alone); it does not reproduce JAX's random
bits.
"""

from __future__ import annotations

import collections
import functools
import logging
import threading
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from megatron_llm_tpu_torch.analysis.contracts import (
    CompileContract,
    record_variant,
    register_contract,
)
from megatron_llm_tpu_torch.inference.graph_capture import (
    WARMUP_RUNS,
    CapturedFn,
)
from megatron_llm_tpu_torch.inference.sampling import (
    NEG_INF,
    modify_logits_for_top_k,
    modify_logits_for_top_p,
)
from megatron_llm_tpu_torch.parallel.mesh import get_context

_logger = logging.getLogger(__name__)

# steps between the host's reads of "every row done"
DONE_CHECK_EVERY = 8
# one record a call of the last whole-batch decodes, newest last
decode_log: collections.deque = collections.deque(maxlen=256)
# the whole-batch decodes' capture stream of each device, and the lock
# that keeps them to one call at a time
_streams: dict = {}
_lock = threading.Lock()


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
                      generator: Optional[torch.Generator], cur_top_p,
                      *, greedy: bool, top_k: int, top_p: float,
                      temperature: float, vocab_size: Optional[int] = None,
                      prevent_newline_after_colon_ids=None) -> torch.Tensor:
    """One sampling decision for a (b, V) block of logits. `cur_top_p`
    is a float or a 0-d fp32 tensor (the decayed threshold)."""
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


# JAX :49-62. The whole-batch decode step of one call is one variant
# under its call's loop (freed with it, so the live count is the calls
# running); unbounded, as the JAX jit cache is.
register_contract(CompileContract(
    "generate.tokens", collectives={"single": frozenset()},
    tmp_bytes_budget=4 << 20,
    notes="the whole-batch decode: one captured step a call"))
register_contract(CompileContract(
    "generate.beam", notes="beam search rides generate.tokens' forward"))


class _DecodeLoop:
    """The whole-batch decode of one call: its state in static device
    buffers and its one step, captured (`CapturedFn`) unless `capture` is
    False or the device is the CPU."""

    def __init__(self, model, dec_params, b: int, max_len: int,
                 settings: tuple, capture: bool):
        dev = model.device
        self.model = model
        self.dec_params = dec_params
        (self.greedy, self.top_k, self.top_p, self.top_p_decay,
         self.top_p_bound, self.temperature, self.vocab_size,
         self.termination_id, self.return_log_probs, self.early,
         self.pnac_ids) = settings
        self.max_len = max_len
        self.tokens = torch.zeros((b, max_len), dtype=torch.long, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.long, device=dev)
        self.log_probs = torch.zeros((b, max_len - 1), dtype=torch.float32,
                                     device=dev)
        self.last_logits = torch.zeros((b, model.cfg.padded_vocab_size),
                                       dtype=torch.float32, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.gen_lens = torch.full((b,), max_len, dtype=torch.long,
                                   device=dev)
        # t = max_len: the warm-up runs and the capture step past the end,
        # which changes no output
        self.t = torch.full((), max_len, dtype=torch.long, device=dev)
        self.cur_top_p = torch.zeros((), dtype=torch.float32, device=dev)
        self.caches = model.init_kv_caches(b, max_len)
        self.cache_bytes = sum(x.numel() * x.element_size()
                               for x in self.caches["k_layers"]
                               + self.caches["v_layers"])
        captured = capture and dev.type == "cuda"
        self.generator = None
        if captured and not self.greedy:
            self.generator = torch.Generator(device=dev)
        stream = None
        if captured:
            stream = _streams.get(dev)
            if stream is None:
                stream = _streams[dev] = torch.cuda.Stream(dev)
        record_variant("generate.tokens", (b, max_len, settings, captured),
                       owner=self)
        # the runner holds the loop weakly: no reference cycle keeps the
        # caches and the graph's memory past the call
        # graft-contract: generate.tokens
        self.step = CapturedFn(
            functools.partial(type(self)._step, weakref.proxy(self)), {},
            device=dev, capture=captured, stream=stream,
            generators=() if self.generator is None else (self.generator,))
        if self.step.captured:
            _logger.info(
                "captured a whole-batch decode step: batch %d, max_len %d, "
                "static caches %d bytes", b, max_len, self.cache_bytes)

    def _step(self):
        """One decode step at the device index t: a no-op once t reaches
        max_len or (early termination) every row is done."""
        t, L = self.t, self.max_len
        live = t < L
        if self.early:
            live = live & ~self.done.all()
        col = t.clamp(max=L - 1).view(1)
        prev = self.tokens.index_select(1, (col - 1).clamp(min=0))[:, 0]
        new_sample = select_next_token(
            self.last_logits, prev, self.generator, self.cur_top_p,
            greedy=self.greedy, top_k=self.top_k, top_p=self.top_p,
            temperature=self.temperature, vocab_size=self.vocab_size,
            prevent_newline_after_colon_ids=self.pnac_ids)
        started = (self.lengths <= t) & live  # past this row's prompt?
        chosen = torch.where(started, new_sample,
                             self.tokens.index_select(1, col)[:, 0])
        self.tokens.index_copy_(1, col, chosen[:, None])
        if self.return_log_probs:
            lp_col = (col - 1).clamp(min=0)
            lp = torch.where(live, _gather_lp(self.last_logits, chosen),
                             self.log_probs.index_select(1, lp_col)[:, 0])
            self.log_probs.index_copy_(1, lp_col, lp[:, None])
        if self.termination_id is not None:
            done_token = (chosen == self.termination_id) & started
            self.gen_lens.copy_(torch.where(done_token & ~self.done, t + 1,
                                            self.gen_lens))
            self.done.logical_or_(done_token)
        if self.top_p > 0.0 and self.top_p_decay > 0.0:
            # fp32, as the JAX loop carries it
            decayed = (self.cur_top_p * float(np.float32(self.top_p_decay))
                       ).clamp(min=float(np.float32(self.top_p_bound)))
            self.cur_top_p.copy_(torch.where(live, decayed, self.cur_top_p))
        logits, _ = self.model.forward(
            self.dec_params, chosen[:, None],
            kv_caches=dict(self.caches, offset=col[0]))
        self.last_logits.copy_(torch.where(live, logits[:, -1].float(),
                                           self.last_logits))
        self.t.add_(live.long())

    def run(self, tokens, lengths, prefill_len, generator):
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        logits, _ = self.model.forward(
            self.dec_params, self.tokens[:, :prefill_len],
            kv_caches=dict(self.caches, offset=0))
        self.log_probs.zero_()
        if self.return_log_probs:
            self.log_probs[:, :prefill_len - 1] = _gather_lp(
                logits[:, :-1], self.tokens[:, 1:prefill_len])
        self.last_logits.copy_(logits[:, -1].float())
        self.done.zero_()
        self.gen_lens.fill_(self.max_len)
        self.cur_top_p.fill_(float(np.float32(self.top_p)))
        self.t.fill_(prefill_len)
        # a captured sampled step draws from the loop's own generator,
        # registered with its graph: it takes the request's state and
        # hands it back (a greedy step draws nothing)
        own = self.step.captured and self.generator is not None
        if own:
            self.generator.set_state(generator.get_state())
        elif not self.step.captured:
            self.generator = generator
        n = self.max_len - prefill_len
        steps = 0
        while steps < n:
            self.step()
            steps += 1
            if (self.early and steps % DONE_CHECK_EVERY == 0 and steps < n
                    and bool(self.done.all())):
                break
        if own:
            generator.set_state(self.generator.get_state())
        decode_log.append({
            "batch": self.tokens.shape[0], "max_len": self.max_len,
            "prefill_len": prefill_len, "steps": steps,
            "captured": self.step.captured,
            "warmup_steps": WARMUP_RUNS if self.step.captured else 0,
            "capture_s": self.step.capture_s,
            "cache_bytes": self.cache_bytes})
        return GenerateOutput(
            tokens=self.tokens.clone(), lengths=self.gen_lens.clone(),
            log_probs=self.log_probs.clone() if self.return_log_probs
            else None)


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
                    _eager: bool = False,
                    ) -> GenerateOutput:
    """Decode `tokens` (b, max_len), prompts left-aligned and padded, with
    prompt `lengths` (b,). Greedy when top_k == 1 or no generator is
    given. Runs to max_len or until every row that has started
    generating emitted `termination_id`. On the card the call captures
    one decode step into a CUDA graph and replays it at every step; the
    private `_eager=True` runs the same step uncaptured (the same-call
    comparison of the smoke run). Under a tensor-parallel context
    (every rank of the tp group calls it with the same request) the
    caches hold the rank's g / tp groups and the step runs uncaptured.
    Calls run one at a time."""
    dev = model.device
    tokens = _ids(tokens, dev)
    lengths = _ids(lengths, dev)
    b, max_len = tokens.shape
    greedy = top_k == 1 or generator is None
    early = use_eod_for_early_termination and termination_id is not None
    settings = (greedy, top_k, top_p, top_p_decay, top_p_bound, temperature,
                vocab_size, termination_id, return_log_probs, early,
                prevent_newline_after_colon_ids)
    # a tensor-parallel step all-reduces and gathers: gloo collectives
    # cannot be captured, so at tp > 1 the step runs uncaptured
    ctx = get_context()
    tp = ctx is not None and ctx.tp > 1
    with _lock:
        loop = _DecodeLoop(model, model.prepare_decode_params(params), b,
                           max_len, settings, capture=not (_eager or tp))
        return loop.run(tokens, lengths, prefill_len, generator)


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
