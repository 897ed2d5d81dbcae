"""Continuous-batching decode engine on a paged KV cache (port of
inference/engine.py, the configuration the serving launcher runs by
default, and its int8, sliding-window, speculative and whole-prompt
modes).

- The cache is a page pool per layer (num_pages, page_size, g, d) plus
  one (slots, max_pages) page table and per-slot lengths
  (`GPTModel.init_paged_kv_caches`); page 0 is the dead null page.
- A fixed number of slots decode in lockstep. A decode round runs up to
  `step_horizon` single-token forwards with sampling on the device,
  clamped to the nearest slot completion and bucketed to a power of two.
- Admission is chunked by default: while any slot is admitting, each
  round is one MIXED forward in which the oldest admitting prompt
  contributes a chunk of at most `prefill_chunk_tokens` tokens at its
  saved offset and every other live slot one decode token. Every phase
  runs through the one ragged paged attention (ops/prefill_attention.py,
  kernel K7 on the card). `prefill_chunk_tokens=0` admits whole
  prompts: a dense causal forward over the prompt's bucket prefix
  (`bucket_prefill_len`), its K/V scattered straight into the slot's
  pages, the rest of the prompt teacher-forced by the decode rounds.
- Finished slots return their pages to a free list (refcounted through
  the prefix cache when it is on) and queued requests are admitted into
  free slots mid-flight. Pages are reserved up front for a request's
  whole reach, so a running request is never starved.
- `prefix_cache=True` shares full prompt pages across requests, with a
  copy-on-write page copy where a match ends mid-page
  (inference/prefix_cache.py).
- `spec_decode_k > 0`: a prompt-lookup n-gram drafter proposes up to k
  tokens per greedy slot, verified in one width-(k+1) ragged chunk per
  slot; every emitted token is the greedy pick the decode round would
  have made, and a rejection rolls the host's length mirror back.
- `kv_dtype="int8"`: the pools hold int8 K/V with per-(token, group)
  fp32 scale pools beside them (quantized at write, dequantized in K7);
  `quantize_weights=True` serves weight-only int8 decode GEMMs.
- A model with `attention_window_size` W attends the last W positions;
  windowed slots are priced and reserved at the window's page bound,
  topped up lazily before each round, and pages wholly out of every
  live window go back to the pool after each round (`window_reclaim`).
- `submit(..., stream=True)` pushes every booked token to a per-request
  queue (the HTTP layer's SSE feed); `cancel()` retires a request
  mid-flight and reclaims its pages.

Greedy decode gives the tokens of `generate_tokens` run alone on the same
prompt: every position's compute is row-independent, so the chunking of
a prompt changes op shapes, not the answer.

How the JAX engine maps here. A jitted step function is a Python
function captured into a CUDA graph per bucket (inference/
graph_capture.py), minted by `_step_fn` / `_mixed_fn` / `_spec_fn` as
JAX mints its programs, and `warmup()` captures them all; the `lax.scan`
over the horizon is a Python loop of `horizon` single-token forwards
inside the captured function. The JAX steps donate the page pools; here the
preallocated per-layer pools (and scale pools) are written in place
(`index_put_` in the scatters, `copy_` in the page copy) and are the
only copy. The host syncs once per round, when it copies the chosen
tokens back; log-probs are copied only when a live request asked for
them. Page table, lengths and chunk lengths reach the forward as device
int32 tensors, and nothing in a forward reads a device value on the
host. Sampling draws come from a counter-based hash of (request seed,
the request's own sampling step, vocab id), so a request's stream does
not depend on its slot or its neighbours; they are not JAX's random
bits. K7 takes any page size, so the JAX engine's warning that int8
pools want pages of a multiple of 32 (a TPU tiling rule) is dropped.

Left out (the constructor raises ValueError naming the slice when one is
set to a non-default value): tp serving and replicas, the KV
export/import hand-off, the cost registry and
perf sentinel, the flight recorder, span tracer and profiler hook,
Prometheus histograms.
"""

from __future__ import annotations

import collections
import functools
import logging
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.inference.generation import bucket_prefill_len
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn
from megatron_llm_tpu_torch.inference.prefix_cache import PrefixCache
from megatron_llm_tpu_torch.inference.sampling import (
    NEG_INF,
    modify_logits_for_top_p,
)
from megatron_llm_tpu_torch.ops.quantization import scatter_quantized_rows

_logger = logging.getLogger(__name__)

# knob -> (default, the later slice that ports it)
_LEFT_OUT = {
    "serving_tp": (1, "tp serving and replicas"),
    "devices": (None, "tp serving and replicas"),
    "replica_id": (None, "tp serving and replicas"),
    "timers": (None, "observability"),
    "trace_dir": (None, "observability"),
    "record_dir": (None, "observability"),
    "flight_recorder_size": (4096, "observability"),
    "cost_registry": (False, "observability"),
    "chip_spec": (None, "observability"),
    "perf_sentinel_ksigma": (0.0, "observability"),
    "perf_sentinel_window": (64, "observability"),
    "perf_sentinel_patience": (8, "observability"),
}


def _not_ported(what: str, slice_name: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it belongs to the "
                      f"{slice_name} slice of the engine (ROADMAP.md A2)")


def horizon_buckets(step_horizon: int) -> list:
    """The power-of-two decode horizons an engine with this step_horizon
    can run: {1, 2, 4, ..., pow2floor(step_horizon)}."""
    top = 1 << (max(step_horizon, 1).bit_length() - 1)
    out, h = [], 1
    while h <= top:
        out.append(h)
        h *= 2
    return out


def mixed_width_buckets(prefill_chunk_tokens: int) -> list:
    """The mixed-round chunk widths `_chunk_width` can return: every power
    of two below the budget plus the budget itself."""
    c = prefill_chunk_tokens
    if c <= 0:
        return []
    widths = {c}
    w = 1
    while w < c:
        widths.add(w)
        w *= 2
    return sorted(widths)


class QueueFull(RuntimeError):
    """Raised by submit() when the admission queue is at capacity; the
    HTTP layer maps it to 503 + Retry-After."""


def _vocab_clamp(logits: torch.Tensor, vocab_size) -> torch.Tensor:
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    return logits


def _greedy_pick(last_logits: torch.Tensor, vocab_size) -> torch.Tensor:
    """The greedy token decision, argmax of the vocab-clamped logits. One
    definition for decode and mixed rounds, so a request's tokens do not
    depend on which round served them."""
    return torch.argmax(_vocab_clamp(last_logits.float(), vocab_size), -1)


_MASK32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix on int64 tensors holding values < 2**32 (no
    product exceeds 2**59, so CPU and CUDA agree bit for bit)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def _uniform(seeds: torch.Tensor, steps: torch.Tensor, V: int):
    """(rows, V) uniforms in (0, 1), a pure function of (seed, step,
    vocab id) per row: the counter-based draw of the sampled decode."""
    cols = torch.arange(V, device=seeds.device, dtype=torch.int64)
    h = _hash32(_hash32(seeds.long() & _MASK32) ^ (steps.long() & _MASK32))
    h = _hash32(h[:, None] ^ _hash32(cols)[None, :])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _per_slot_sample(logits, greedy, temperature, top_k, top_p, seeds,
                     steps, vocab_size):
    """One sampling decision per slot, with per-slot knobs as device
    tensors: temperature, a per-row top-k threshold (the k-th largest
    logit), per-row top-p through `modify_logits_for_top_p` with a
    (rows, 1) threshold, the pad-vocab mask, then a Gumbel-max draw from
    `_uniform`. Greedy rows take the argmax."""
    V = logits.shape[-1]
    logits = _vocab_clamp(logits.float(), vocab_size)
    greedy_tok = torch.argmax(logits, -1)
    l = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    kth_idx = (top_k.long() - 1).clamp(0, V - 1)
    kth = torch.gather(sorted_l, 1, kth_idx[:, None])
    l = l.masked_fill((top_k > 1)[:, None] & (l < kth), NEG_INF)
    filt = modify_logits_for_top_p(l, top_p[:, None])
    l = torch.where((top_p > 0.0)[:, None], filt, l)
    u = _uniform(seeds, steps, V)
    sampled = torch.argmax(l - torch.log(-torch.log(u)), -1)
    return torch.where(greedy, greedy_tok, sampled)


def _decision(last_logits, all_greedy, greedy, temperature, top_k, top_p,
              seeds, steps, vocab_size):
    if all_greedy:
        # every live request is greedy: skip the per-row sort
        return _greedy_pick(last_logits, vocab_size)
    return _per_slot_sample(last_logits, greedy, temperature, top_k, top_p,
                            seeds, steps, vocab_size)


def _paged_caches(pools, page_table, lengths, chunk_lens):
    """The paged cache dict of one forward. `pools` is (k pools, v pools,
    k scale pools, v scale pools); the scale tuples are empty for fp
    pools."""
    pools_k, pools_v, pools_ks, pools_vs = pools
    out = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
           "page_table": page_table, "lengths": lengths,
           "chunk_lens": chunk_lens}
    if pools_ks:
        out["k_scales_layers"] = pools_ks
        out["v_scales_layers"] = pools_vs
    return out


def _decode_step(model, dec_params, pools, last_logits, *, page_table,
                 lengths, active, forced, use_forced, greedy, temperature,
                 top_k, top_p, seeds, sample_steps, vocab_size, horizon,
                 all_greedy):
    """The decode round (JAX `_make_step_fn`): `horizon` single-token
    paged forwards. Each step decides one token per slot from the
    carried fp32 logits (teacher-forcing `forced` where `use_forced`),
    and runs it through the stack. Inactive slots ride as idle chunks
    (chunk_lens 0: no page read, exact-zero attention, writes only to
    the null page) and keep their carried logits, so a round of idle
    slots changes nothing a live slot reads. Updates `last_logits` in
    place and returns (chosen (slots, horizon), its log-probs)."""
    chunk_lens = active.to(torch.int32)
    chosen_h, lp_h = [], []
    steps = sample_steps
    carried = last_logits
    for t in range(horizon):
        lp_full = torch.log_softmax(carried, -1)
        sampled = _decision(carried, all_greedy, greedy, temperature,
                            top_k, top_p, seeds, steps, vocab_size)
        chosen = torch.where(use_forced[:, t], forced[:, t], sampled)
        chosen = torch.where(active, chosen, torch.zeros_like(chosen))
        lp_h.append(torch.gather(lp_full, 1, chosen[:, None])[:, 0])
        chosen_h.append(chosen)
        logits, caches = model.forward(
            dec_params, chosen[:, None],
            kv_caches=_paged_caches(pools, page_table, lengths, chunk_lens),
            position_ids=lengths.long()[:, None])
        lengths = caches["lengths"]
        steps = steps + (active & ~use_forced[:, t]).long()
        carried = torch.where(active[:, None], logits[:, 0].float(), carried)
    last_logits.copy_(carried)
    return torch.stack(chosen_h, 1), torch.stack(lp_h, 1)


def _mixed_step(model, dec_params, pools, last_logits, *, page_table,
                lengths, chunk_tokens, chunk_lens, is_prefill, chunk_idx,
                greedy, temperature, top_k, top_p, seeds, sample_steps,
                vocab_size, width, all_greedy):
    """The mixed prefill+decode round (JAX `_make_mixed_step_fn`): every
    slot contributes one ragged span to one paged forward of width
    `width`: the admitting slot `chunk_idx` (a (1,) device index) a
    prompt chunk at its saved offset, each decoding slot one token
    decided from the carried logits, idle slots nothing. Updates
    `last_logits` in place (idle slots keep theirs) and returns per-slot
    (first token, its log-prob) and the chunk row's in-chunk log-probs
    (log-prob of chunk token p+1 under the logits at p; (width - 1,),
    computed at every width > 1, as JAX's program does)."""
    active = chunk_lens > 0
    lp_full = torch.log_softmax(last_logits, -1)
    sampled = _decision(last_logits, all_greedy, greedy, temperature, top_k,
                        top_p, seeds, sample_steps, vocab_size)
    first = torch.where(is_prefill, chunk_tokens[:, 0], sampled)
    first = torch.where(active, first, torch.zeros_like(first))
    first_lp = torch.gather(lp_full, 1, first[:, None])[:, 0]
    toks = torch.cat([first[:, None], chunk_tokens[:, 1:]], 1)
    pos = lengths.long()[:, None] \
        + torch.arange(width, device=lengths.device)[None, :]
    logits, _ = model.forward(
        dec_params, toks,
        kv_caches=_paged_caches(pools, page_table, lengths, chunk_lens),
        position_ids=pos)
    chunk_lps = torch.zeros(0, device=logits.device)
    if width > 1:
        row = logits.index_select(0, chunk_idx)[0, :-1]
        lp_in = torch.log_softmax(row.float(), -1)
        chunk_lps = torch.gather(
            lp_in, 1, toks.index_select(0, chunk_idx)[0, 1:, None])[:, 0]
    last_idx = (chunk_lens.long() - 1).clamp(0, width - 1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    new_last = logits[rows, last_idx].float()
    last_logits.copy_(torch.where(active[:, None], new_last, last_logits))
    return first, first_lp, chunk_lps


def _spec_step(model, dec_params, pools, last_logits, *, page_table,
               lengths, chunk_tokens, chunk_lens, is_spec, greedy,
               temperature, top_k, top_p, seeds, sample_steps, vocab_size,
               width, all_greedy):
    """The speculative verify round (JAX `_make_spec_step_fn`): every
    live slot contributes one ragged chunk of width `width` = k + 1, a
    spec slot [its next token, decided from the carried logits as a
    decode row would, then its draft], any other a width-1 decode row.
    The greedy target at chunk position j (`_greedy_pick`) is checked
    against the draft at j + 1; the accepted count is the leading run of
    matches (a cumulative product), and the carried logits come from the
    accepted position, so a rejection simply does not advance past it.
    Updates `last_logits` in place (idle slots keep theirs) and returns
    (first token, its log-prob, the per-position greedy targets and their
    log-probs, the accepted counts)."""
    active = chunk_lens > 0
    lp_full = torch.log_softmax(last_logits, -1)
    sampled = _decision(last_logits, all_greedy, greedy, temperature, top_k,
                        top_p, seeds, sample_steps, vocab_size)
    first = torch.where(active, sampled, torch.zeros_like(sampled))
    first_lp = torch.gather(lp_full, 1, first[:, None])[:, 0]
    toks = torch.cat([first[:, None], chunk_tokens[:, 1:]], 1)
    pos = lengths.long()[:, None] \
        + torch.arange(width, device=lengths.device)[None, :]
    logits, _ = model.forward(
        dec_params, toks,
        kv_caches=_paged_caches(pools, page_table, lengths, chunk_lens),
        position_ids=pos)
    n, _, V = logits.shape
    gt = _greedy_pick(logits.reshape(n * width, V), vocab_size) \
        .reshape(n, width)
    glp = torch.log_softmax(logits.float(), -1)
    gt_lp = torch.gather(glp, 2, gt[..., None])[..., 0]
    j = torch.arange(1, width, device=lengths.device)[None, :]
    matches = (toks[:, 1:] == gt[:, :-1]) & (j < chunk_lens[:, None])
    acc = torch.cumprod(matches.long(), 1).sum(1)
    acc = torch.where(is_spec, acc, torch.zeros_like(acc))
    last_idx = torch.where(is_spec, acc,
                           (chunk_lens.long() - 1).clamp(0, width - 1))
    rows = torch.arange(n, device=logits.device)
    new_last = logits[rows, last_idx].float()
    last_logits.copy_(torch.where(active[:, None], new_last, last_logits))
    return first, first_lp, gt, gt_lp, acc


def _prefill(model, dec_params, pools, tokens, pt_row, page_size):
    """Whole-prompt admission (JAX `_make_prefill_fn`): one causal
    forward of the prompt's bucket prefix `tokens` (1, plen) through
    per-layer dense caches, whose K/V rows are then scattered straight
    into the slot's pages `pt_row` (quantized at write for int8 pools).
    Returns (the next-token logits (V,), the prompt log-probs (plen -
    1,))."""
    plen = tokens.shape[1]
    caches = model.init_kv_caches(1, plen)
    logits, caches = model.forward(dec_params, tokens, kv_caches=caches)
    lp = torch.log_softmax(logits[0].float(), -1)
    prompt_lp = torch.gather(lp[:-1], 1, tokens[0, 1:, None])[:, 0]
    pos = torch.arange(plen, device=tokens.device)
    pages = pt_row.long()[pos // page_size]
    offs = pos % page_size
    pools_k, pools_v, pools_ks, pools_vs = pools
    for i, (kl, vl) in enumerate(zip(caches["k_layers"],
                                     caches["v_layers"])):
        rows_k, rows_v = kl[0].transpose(0, 1), vl[0].transpose(0, 1)
        if pools_ks:
            scatter_quantized_rows(pools_k[i], pools_ks[i], pages, offs,
                                   rows_k)
            scatter_quantized_rows(pools_v[i], pools_vs[i], pages, offs,
                                   rows_v)
        else:
            pools_k[i].index_put_((pages, offs), rows_k.to(pools_k[i].dtype))
            pools_v[i].index_put_((pages, offs), rows_v.to(pools_v[i].dtype))
    return logits[0, -1], prompt_lp


def _page_copy(pools, src: int, dst: int) -> None:
    """The prefix cache's copy-on-write (JAX `_make_page_copy_fn`): pool
    page `dst` becomes a private replica of shared page `src` in every
    layer's K and V pool and, for int8 pools, scale pool (a quantized
    page is its data and its scales), in place."""
    for group in pools:
        for pool in group:
            pool[dst].copy_(pool[src])


@dataclass
class EngineRequest:
    """One queued or running generation. `tokens` grows to prompt +
    generated; `log_probs[i]` (when requested) is log P(tokens[i+1] |
    tokens[:i+1]), the generate_tokens layout."""

    rid: int
    prompt: List[int]
    tokens_to_generate: int
    greedy: bool = True
    top_k: int = 0
    top_p: float = 0.0
    temperature: float = 1.0
    seed: int = 0
    return_log_probs: bool = False
    use_eod_for_early_termination: bool = True
    # wall-clock budget from submit(); an expired request fails its
    # waiter with TimeoutError and retires its slot (pages come back)
    deadline_s: Optional[float] = None
    # stream=True: every generated token id is put here as it is booked;
    # a None sentinel closes the stream at completion, failure, timeout
    # or cancel
    stream_q: Optional["queue_mod.SimpleQueue"] = None
    cancelled: bool = False

    tokens: List[int] = field(default_factory=list)
    log_probs: List[float] = field(default_factory=list)
    error: Optional[str] = None
    timed_out: bool = False
    done: threading.Event = field(default_factory=threading.Event)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # first generated token (TTFT = t_first - t_submit)
    t_done: float = 0.0

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.t_submit > self.deadline_s)

    def result(self, timeout: Optional[float] = None):
        """Block until the request finishes; returns (tokens, log_probs).
        A request past its `deadline_s` raises TimeoutError; other engine
        failures raise RuntimeError."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still running")
        if self.error is not None:
            if self.timed_out:
                raise TimeoutError(self.error)
            raise RuntimeError(self.error)
        return self.tokens, (self.log_probs if self.return_log_probs
                             else None)


@dataclass
class _Slot:
    req: Optional[EngineRequest] = None
    # physical pages of logical pages [reclaimed, mapped)
    pages: List[int] = field(default_factory=list)
    # prompt tokens still owed as teacher-forced decode steps (whole-
    # prompt admission: the prompt past its prefill bucket)
    forced: collections.deque = field(default_factory=collections.deque)
    generated: int = 0
    sample_step: int = 0
    # next prompt position to prefill; starts at the prefix-cache match
    prefill_pos: int = 0
    # full prompt pages of this slot registered in (or mapped from) the
    # prefix cache
    registered: int = 0
    # speculative drafting: bigram -> up to the 8 most recent start
    # indices in req.tokens, kept incrementally; `bigram_next` is the
    # next start to fold in (the final bigram stays unindexed, so a
    # lookup never matches the occurrence it extends)
    bigram: dict = field(default_factory=dict)
    bigram_next: int = 0
    # sliding window: logical pages [reclaimed, mapped) hold physical
    # pages (windowed slots allocate lazily and top up before each round
    # writes past the frontier); [0, reclaimed) fell out of every live
    # window and went back (their table entries park on page 0)
    mapped: int = 0
    reclaimed: int = 0

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.prefill_pos < len(
            self.req.prompt)


class DecodeEngine:
    """Fixed-slot continuous-batching decode engine over a paged pool.

    Knobs: `slots` (requests decoding per round), `page_size` (tokens per
    KV page; K7 takes any size), `page_budget` (KV positions in the pool,
    default slots * max_context; page 0 is added as the null page),
    `max_context` (prompt + generation cap per slot; sets the page-table
    width), `max_queue` (submit() past it raises QueueFull),
    `step_horizon` (decode steps per round), `prefill_chunk_tokens` (the
    mixed round's prompt-token budget; 0 admits whole prompts),
    `prefix_cache` (needs chunked admission), `spec_decode_k` (draft
    tokens per greedy slot and verify round; 0 off), `kv_dtype` ("bf16":
    pools in the model's compute dtype; "int8": int8 pools with fp32
    scale pools), `quantize_weights` (weight-only int8 decode GEMMs),
    `window_reclaim` (with a model's `attention_window_size`: return
    pages wholly out of every live window mid-flight; False keeps the
    window mask and frees nothing, the control its bitwise equality is
    held against), `warmup_compile` (`start()` captures every round
    bucket first, `warmup()`; without it a bucket is captured at its
    first use). The device is the model's. Every knob of the JAX engine
    that the port leaves out raises ValueError when set to a non-default
    value.

    Rounds run as CUDA graphs on a CUDA device (inference/
    graph_capture.py): each round kind and bucket, (horizon,
    all_greedy), (width, all_greedy) or (k + 1, all_greedy), is captured
    once into one memory pool on the engine's own stream and replayed
    with the round's host arrays copied into its static buffers; the
    carried logits are one buffer every round updates in place. On a CPU
    device the same runners call the round eagerly on their buffers, as
    they do on the card under the private `_eager = True`, set before the
    first round (the same-call comparison of the card's smoke run); no
    public knob selects it."""

    def __init__(self, model, params, *, slots: int = 4,
                 page_size: int = 64, max_context: int = 1024,
                 page_budget: Optional[int] = None, max_queue: int = 64,
                 step_horizon: int = 8,
                 prefill_chunk_tokens: int = 256,
                 prefix_cache: bool = False,
                 spec_decode_k: int = 0,
                 window_reclaim: bool = True,
                 kv_dtype: str = "bf16",
                 quantize_weights: bool = False,
                 termination_id: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 warmup_compile: bool = False,
                 **left_out):
        for name, value in left_out.items():
            if name not in _LEFT_OUT:
                raise TypeError(f"DecodeEngine got an unexpected keyword "
                                f"argument {name!r}")
            default, slice_name = _LEFT_OUT[name]
            if value != default:
                raise _not_ported(f"{name}={value!r}", slice_name)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' (the model compute "
                             f"dtype) or 'int8' (quantized pages), got "
                             f"{kv_dtype!r}")
        if max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        if prefill_chunk_tokens < 0 or spec_decode_k < 0:
            raise ValueError("prefill_chunk_tokens and spec_decode_k must "
                             "be >= 0")
        if prefix_cache and not prefill_chunk_tokens:
            raise ValueError(
                "prefix_cache requires chunked admission "
                "(prefill_chunk_tokens > 0): a cache-hit suffix prefill "
                "must attend to pooled prefix K/V, which the whole-prompt "
                "dense prefill cannot")
        self.model = model
        self.cfg = model.cfg
        # sliding window: static per model; windowed slots are priced and
        # reserved at `_window_slot_pages`, topped up before each round
        # (`_ensure_pages`) and give pages back after it
        # (`_reclaim_window_pages`)
        w = self.cfg.attention_window_size
        self.window = int(w) if w else None
        self.window_reclaim = bool(window_reclaim)
        if self.window is not None and not prefill_chunk_tokens:
            raise ValueError(
                "attention_window_size requires chunked admission "
                "(prefill_chunk_tokens > 0): whole-prompt admission "
                "prefills through the dense path, which carries no "
                "window mask, so its cache would disagree with every "
                "windowed chunked and decode round")
        self.device = torch.device(model.device)
        self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
        self.slots = slots
        self.page_size = page_size
        self.max_pages_per_slot = max_context // page_size
        self.max_context = max_context
        if page_budget is None:
            page_budget = slots * max_context
        if page_budget % page_size:
            raise ValueError("page_budget must be a multiple of page_size")
        self.num_pages = 1 + page_budget // page_size  # +1: null page 0
        self.max_queue = max_queue
        self.step_horizon = max(1, step_horizon)
        self.prefill_chunk_tokens = min(prefill_chunk_tokens, max_context)
        self._prefix = PrefixCache(page_size) if prefix_cache else None
        self.spec_decode_k = spec_decode_k
        self.kv_dtype = kv_dtype
        self.termination_id = termination_id
        self.vocab_size = vocab_size
        self.warmup_compile = bool(warmup_compile)

        # the int8 decode tree is built once and serves every round kind
        self._dec_params = model.prepare_decode_params(
            params, quantize_int8=quantize_weights)
        caches = model.init_paged_kv_caches(
            slots, self.num_pages, page_size, self.max_pages_per_slot,
            kv_dtype=torch.int8 if kv_dtype == "int8" else None)
        # (k pools, v pools, k scale pools, v scale pools): one tuple per
        # layer each, the scale tuples empty for fp pools
        self._pools = (caches["k_pages_layers"], caches["v_pages_layers"],
                       caches.get("k_scales_layers", ()),
                       caches.get("v_scales_layers", ()))
        self._last_logits = torch.zeros(
            (slots, self.cfg.padded_vocab_size), dtype=torch.float32,
            device=self.device)
        # host-authoritative mirrors, copied to the device each round
        self._pt = np.zeros((slots, self.max_pages_per_slot), np.int32)
        self._lengths = np.zeros((slots,), np.int32)
        self._free_pages = list(range(self.num_pages - 1, 0, -1))
        # captured rounds by (bucket, all_greedy), as the JAX mint caches
        self._step_fns: dict = {}
        self._mixed_fns: dict = {}
        self._spec_fns: dict = {}
        self._eager = False
        self._graph_pool = self._graph_stream = None
        if self._cuda_index is not None:
            dev = torch.device("cuda", self._cuda_index)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(dev)

        self._slots = [_Slot() for _ in range(slots)]
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._next_rid = 0
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._broken: Optional[str] = None

        self._admitted = 0
        self._retired = 0
        self._timed_out = 0
        self._steps = 0
        self._tokens_out = 0
        self._prefill_tokens = 0
        self._cancelled = 0
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._window_reclaimed = 0
        self._t0 = time.perf_counter()
        # recent-window latency gauges: submit -> first generated token,
        # and wall ms per decode-token advance per round (a mixed round
        # is one decode step: its wall is the chunked-prefill
        # interference)
        self._ttft_ms: collections.deque = collections.deque(maxlen=256)
        self._decode_ms: collections.deque = collections.deque(maxlen=256)
        # per-round accounting: prefill/decode token split and wall ms
        self._round_log: collections.deque = collections.deque(maxlen=4096)

    def _dev(self, x, dtype=None) -> torch.Tensor:
        """Host operand -> a fresh device tensor (a copy, so the host
        mirrors can change under it; the copy does not wait for the
        card)."""
        return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(
            self.device, non_blocking=True)

    # -- admission ---------------------------------------------------------

    def submit(self, prompt: List[int], tokens_to_generate: int, *,
               top_k: int = 1, top_p: float = 0.0,
               temperature: float = 1.0, seed: int = 0,
               return_log_probs: bool = False,
               use_eod_for_early_termination: bool = True,
               deadline_s: Optional[float] = None,
               stream: bool = False) -> EngineRequest:
        """Queue one request. Raises ValueError when it can never fit
        (prompt + generation past max_context or the pool) and QueueFull
        when the queue is at capacity. `stream=True` attaches
        `req.stream_q`: every generated token id is pushed as it is
        booked, and a None sentinel closes the stream."""
        total = len(prompt) + tokens_to_generate
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if tokens_to_generate < 1:
            raise ValueError("tokens_to_generate must be >= 1 (score-only "
                             "requests take the whole-batch path)")
        if total > self.max_context:
            raise ValueError(
                f"prompt ({len(prompt)}) + tokens_to_generate "
                f"({tokens_to_generate}) exceeds the engine max_context "
                f"({self.max_context})")
        # it must also fit the pool; a windowed engine prices a request
        # at the window's page bound, since out-of-window pages go back
        # mid-flight
        need = -(-total // self.page_size)
        if self.window is not None and self.window_reclaim:
            need = min(need, self._window_slot_pages())
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool holds only "
                f"{self.num_pages - 1} (page_budget "
                f"{(self.num_pages - 1) * self.page_size} tokens); raise "
                f"page_budget or shrink the request")
        if self._broken is not None:
            raise RuntimeError(f"engine is stopped: {self._broken}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        req = EngineRequest(
            rid=-1, prompt=list(prompt),
            tokens_to_generate=tokens_to_generate,
            greedy=(top_k == 1), top_k=top_k, top_p=top_p,
            temperature=temperature, seed=seed,
            return_log_probs=return_log_probs,
            use_eod_for_early_termination=use_eod_for_early_termination,
            deadline_s=deadline_s,
            stream_q=queue_mod.SimpleQueue() if stream else None,
        )
        req.t_submit = time.perf_counter()
        with self._lock:
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"engine queue at capacity ({self.max_queue})")
            req.rid = self._next_rid
            self._next_rid += 1
            self._queue.append(req)
            self._work.notify()
        return req

    @staticmethod
    def _finish(req: EngineRequest):
        """The one completion point: wake the waiter and close the token
        stream, so an SSE consumer never hangs on a finished request."""
        req.done.set()
        if req.stream_q is not None:
            req.stream_q.put(None)

    def cancel(self, req: EngineRequest):
        """Abandon a request: a queued one fails at once; a running one is
        reaped by the next round (its slot retires and its pages come
        back, refcounts intact). Idempotent."""
        with self._lock:
            if req.done.is_set():
                return
            req.cancelled = True
            try:
                self._queue.remove(req)
            except ValueError:
                self._work.notify()  # running: the serve loop reaps it
                return
            self._cancelled += 1
        req.error = f"request {req.rid} cancelled"
        self._finish(req)

    def _admit(self) -> int:
        """Move queued requests into free slots while pages allow, FIFO:
        a request that does not fit blocks the ones behind it. With the
        prefix cache, hit pages are mapped instead of allocated and a
        mid-page match starts as a copy-on-write replica; the prompt
        suffix then prefills through the mixed rounds. Whole-prompt
        admission prefills here. Returns the prompt tokens prefilled on
        the device in this call (whole-prompt admission only)."""
        prefilled = 0
        for si, slot in enumerate(self._slots):
            if slot.req is not None:
                continue
            with self._lock:
                if not self._queue:
                    return prefilled
                req = self._queue[0]
                need = -(-(len(req.prompt) + req.tokens_to_generate)
                         // self.page_size)
                # requests with log-probs bypass matching (their prompt
                # log-probs need the full forward) but still register
                match = None
                if self._prefix is not None and not req.return_log_probs:
                    match = self._prefix.lookup(req.prompt)
                    if match.matched == 0:
                        match = None
                matched_pages = match.full_pages if match else 0
                # windowed engines reserve only the window bound up
                # front; a prefix hit larger than it still maps whole
                # (its out-of-window pages go back to the cache on the
                # first reclaim), and a COW divergence gets its page
                cap = need
                if self.window is not None and self.window_reclaim:
                    cap = max(min(need, self._window_slot_pages()),
                              matched_pages
                              + (1 if match is not None
                                 and match.cow_src is not None else 0))
                need_new = max(cap - matched_pages, 0)
                if match is not None:
                    # pin the hit (and the COW source) before any eviction
                    self._prefix.acquire(match)
                if len(self._free_pages) < need_new \
                        and self._prefix is not None:
                    self._free_pages.extend(self._prefix.evict(
                        need_new - len(self._free_pages)))
                if len(self._free_pages) < need_new:
                    if match is not None:
                        self._prefix.unacquire(match)
                    return prefilled
                self._queue.popleft()
                # claim the slot inside the lock: stop(drain=True) polls
                # "queue empty and no slot busy"
                slot.req = req
            fresh = [self._free_pages.pop() for _ in range(need_new)]
            pages = (list(match.pages) if match is not None else []) + fresh
            self._pt[si] = 0
            self._pt[si, :len(pages)] = pages
            slot.pages = pages
            slot.mapped = len(pages)
            slot.reclaimed = 0
            slot.generated = 0
            slot.sample_step = 0
            slot.registered = match.full_pages if match is not None else 0
            slot.bigram = {}
            slot.bigram_next = 0
            slot.forced = collections.deque()
            req.tokens = list(req.prompt)
            if self.prefill_chunk_tokens:
                matched = 0
                if match is not None:
                    matched = match.matched
                    if match.cow_src is not None:
                        # the divergent page starts as a private replica
                        # of the shared one; prefill resumes inside it
                        _page_copy(self._pools, match.cow_src,
                                   pages[match.full_pages])
                        self._prefix.release_page(match.cow_src)
                        self._prefix.cow_copies += 1
                if self._prefix is not None:
                    self._prefix.note(len(req.prompt), matched)
                slot.prefill_pos = matched
                self._lengths[si] = matched
            else:
                plen = bucket_prefill_len(len(req.prompt))
                row_logits, plp = _prefill(
                    self.model, self._dec_params, self._pools,
                    self._dev([req.prompt[:plen]], np.int64),
                    self._dev(self._pt[si]), self.page_size)
                self._last_logits[si] = row_logits.float()
                self._lengths[si] = plen
                slot.prefill_pos = len(req.prompt)
                slot.forced = collections.deque(req.prompt[plen:])
                self._prefill_tokens += plen
                prefilled += plen
                if req.return_log_probs:
                    req.log_probs = plp.cpu().tolist()
            req.t_admit = time.perf_counter()
            self._admitted += 1
        return prefilled

    def _retire(self, si: int):
        slot = self._slots[si]
        if self._prefix is None:
            self._free_pages.extend(slot.pages)
        else:
            # refcounted returns: registered and shared pages stay with
            # the cache; untracked pages go back to the free list
            for pg in slot.pages:
                if not self._prefix.release(pg):
                    self._free_pages.append(pg)
        slot.pages = []
        slot.registered = 0
        slot.mapped = 0
        slot.reclaimed = 0
        self._pt[si] = 0
        self._lengths[si] = 0
        req = slot.req
        slot.req = None
        req.t_done = time.perf_counter()
        self._retired += 1
        self._finish(req)

    # -- sliding-window pages ------------------------------------------------

    def _window_slot_pages(self) -> int:
        """Peak physical pages a windowed slot holds: the pages
        overlapping [L - window + 1, L + width) at any length L, where
        width is the widest span one round writes (decode horizon,
        prefill chunk, verify chunk), plus a boundary page. The windowed
        capacity unit: submit() prices requests with it and _admit
        reserves it."""
        width = max(self.step_horizon, self.prefill_chunk_tokens,
                    self.spec_decode_k + 1)
        return min(self.max_pages_per_slot,
                   -(-(self.window + width) // self.page_size) + 1)

    def _ensure_pages(self, si: int, upto: int) -> None:
        """Top slot `si`'s page frontier up to cover positions [0, upto)
        before a round writes them (windowed slots allocate lazily). A
        no-op when the frontier already covers them, always for
        engines without a window (admission mapped the full reach)."""
        if self.window is None:
            return
        want = min(-(-int(upto) // self.page_size), self.max_pages_per_slot)
        s = self._slots[si]
        while s.mapped < want:
            if not self._free_pages and self._prefix is not None:
                self._free_pages.extend(self._prefix.evict(want - s.mapped))
            if not self._free_pages:
                # unreachable while submit() and _admit price the window
                # bound: reclamation returns a page for every page the
                # frontier takes past the window
                raise RuntimeError(
                    f"page pool exhausted topping slot {si} up to {want} "
                    f"pages: window admission accounting fault")
            pg = self._free_pages.pop()
            self._pt[si, s.mapped] = pg
            s.pages.append(pg)
            s.mapped += 1

    def _reclaim_window_pages(self) -> None:
        """After each round, give back the pages wholly below every live
        window. At length L the next query attends no position below
        L - window + 1, and lengths only grow, so logical pages [0, (L +
        1 - window) // page_size) are dead: K7 starts its walk above
        them and its plain version zeroes their columns, so freeing and
        reusing them cannot change a bit of the stream. Registered or
        shared prefix pages go back to the cache (another slot may read
        them inside its own window), private ones to the free list; the
        table entries park on the null page and `registered` moves past
        them, so a freed page is never registered."""
        W = self.window
        if W is None or not self.window_reclaim:
            return
        ps = self.page_size
        for si, s in enumerate(self._slots):
            if s.req is None:
                continue
            dead = min(max(0, int(self._lengths[si]) + 1 - W) // ps,
                       s.mapped)
            if dead <= s.reclaimed:
                continue
            for p in range(s.reclaimed, dead):
                pg = int(self._pt[si, p])
                self._pt[si, p] = 0
                if s.pages and s.pages[0] == pg:
                    s.pages.pop(0)
                if pg == 0:
                    continue
                if self._prefix is None or not self._prefix.release(pg):
                    self._free_pages.append(pg)
                self._window_reclaimed += 1
            s.reclaimed = dead
            s.registered = max(s.registered, dead)

    # -- the rounds --------------------------------------------------------

    def _chunk_width(self, remaining: int) -> int:
        """Power-of-two width for a chunk covering `remaining` prompt
        tokens, capped at the budget."""
        c = self.prefill_chunk_tokens
        if remaining >= c:
            return c
        return min(1 << (max(remaining, 1) - 1).bit_length(), c)

    def _book_token(self, i: int, tok: int, now: Optional[float] = None
                    ) -> bool:
        """Record one generated token for slot i (TTFT on the first);
        retires the slot on eod or budget. Returns True if it retired."""
        s = self._slots[i]
        r = s.req
        r.tokens.append(tok)
        if r.stream_q is not None:
            r.stream_q.put(tok)
        s.generated += 1
        s.sample_step += 1
        self._tokens_out += 1
        if s.generated == 1:
            r.t_first = now if now is not None else time.perf_counter()
            with self._lock:  # counters() sorts this window concurrently
                self._ttft_ms.append((r.t_first - r.t_submit) * 1e3)
        hit_eod = (r.use_eod_for_early_termination
                   and self.termination_id is not None
                   and tok == self.termination_id)
        if hit_eod or s.generated >= r.tokens_to_generate:
            self._retire(i)
            return True
        return False

    def _expire_deadlines(self) -> None:
        """Fail every queued or running request past its deadline, and
        reap cancelled running requests; running slots retire and their
        pages come back. Once per round."""
        now = time.perf_counter()
        expired_q: List[EngineRequest] = []
        with self._lock:
            if any(r.expired(now) for r in self._queue):
                keep = collections.deque()
                for r in self._queue:
                    (expired_q if r.expired(now) else keep).append(r)
                self._queue = keep
        for r in expired_q:
            r.error = (f"request {r.rid} exceeded deadline_s="
                       f"{r.deadline_s} while queued")
            r.timed_out = True
            self._timed_out += 1
            self._finish(r)
        for i, s in enumerate(self._slots):
            r = s.req
            if r is None:
                continue
            if r.cancelled:
                r.error = (f"request {r.rid} cancelled after "
                           f"{len(r.tokens) - len(r.prompt)}"
                           f"/{r.tokens_to_generate} generated tokens; "
                           f"slot retired, pages reclaimed")
                with self._lock:  # cancel() (HTTP thread) counts too
                    self._cancelled += 1
                self._retire(i)
                continue
            if r.expired(now):
                r.error = (f"request {r.rid} exceeded deadline_s="
                           f"{r.deadline_s} after "
                           f"{len(r.tokens) - len(r.prompt)}"
                           f"/{r.tokens_to_generate} generated tokens; "
                           f"slot retired, pages reclaimed")
                r.timed_out = True
                self._timed_out += 1
                self._retire(i)

    def step(self) -> bool:
        """One scheduler round, under `torch.inference_mode()`: reap
        deadlines and cancels, admit, then one mixed round while any slot
        is admitting, else a speculative round when a slot has a draft,
        else one decode round; after a round, give back the pages out of
        every live window. Returns False when there was nothing to do."""
        with torch.inference_mode():
            did = self._step_inner()
        if did:
            self._reclaim_window_pages()
        return did

    def _step_inner(self) -> bool:
        t0 = time.perf_counter()
        self._expire_deadlines()
        admit_prefilled = self._admit()
        if any(s.prefilling for s in self._slots):
            dec_slots, pf_tokens = self._mixed_round()
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:  # counters() reads these windows concurrently
                self._round_log.append({
                    "prefill_tokens": pf_tokens, "decode_steps": 1,
                    "decode_slots": dec_slots, "ms": dt_ms})
                if dec_slots:
                    self._decode_ms.append(dt_ms)
            return True
        if self.spec_decode_k:
            drafts = self._collect_drafts()
            if drafts:
                self._spec_round(drafts, t0, admit_prefilled)
                return True
        return self._decode_round(t0, admit_prefilled)

    def _sampling_arrays(self, idx) -> dict:
        """Per-slot knob arrays for the live slots `idx` (host arrays,
        named as the round functions take them); other slots greedy."""
        n = self.slots
        greedy = np.ones(n, bool)
        temperature = np.ones(n, np.float32)
        top_k = np.zeros(n, np.int64)
        top_p = np.zeros(n, np.float32)
        seeds = np.zeros(n, np.int64)
        steps = np.zeros(n, np.int64)
        for i in idx:
            r = self._slots[i].req
            greedy[i] = r.greedy
            temperature[i] = r.temperature
            top_k[i] = r.top_k
            top_p[i] = r.top_p
            seeds[i] = r.seed & 0xFFFFFFFF
            steps[i] = self._slots[i].sample_step
        return {"greedy": greedy, "temperature": temperature,
                "top_k": top_k, "top_p": top_p, "seeds": seeds,
                "sample_steps": steps}

    # -- captured rounds (JAX: the mint caches and warmup) -------------------

    def _capture(self, step, null_args: dict, **static) -> CapturedFn:
        """The runner of one round kind and bucket: `step` bound to the
        model, decode tree, pools and carried logits, captured on the
        engine's stream into its pool with the idle round `null_args` as
        the static buffers' first values (called uncaptured on them under
        the private `_eager` switch)."""
        fn = functools.partial(step, self.model, self._dec_params,
                               self._pools, self._last_logits,
                               vocab_size=self.vocab_size, **static)
        return CapturedFn(fn, null_args, device=self.device,
                          pool=self._graph_pool, stream=self._graph_stream,
                          capture=not self._eager)

    def _step_fn(self, horizon: int, all_greedy: bool) -> CapturedFn:
        key = (horizon, all_greedy)
        if key not in self._step_fns:
            self._step_fns[key] = self._capture(
                _decode_step, self._null_scan_args(horizon),
                horizon=horizon, all_greedy=all_greedy)
        return self._step_fns[key]

    def _mixed_fn(self, width: int, all_greedy: bool) -> CapturedFn:
        key = (width, all_greedy)
        if key not in self._mixed_fns:
            self._mixed_fns[key] = self._capture(
                _mixed_step, self._null_mixed_args(width), width=width,
                all_greedy=all_greedy)
        return self._mixed_fns[key]

    def _spec_fn(self, width: int, all_greedy: bool) -> CapturedFn:
        key = (width, all_greedy)
        if key not in self._spec_fns:
            self._spec_fns[key] = self._capture(
                _spec_step, self._null_spec_args(width), width=width,
                all_greedy=all_greedy)
        return self._spec_fns[key]

    # Idle rounds (JAX :2975-3040): all-zero page-table rows and chunk
    # lengths, so every K/V write lands on the dead null page 0 and every
    # slot keeps its carried logits.

    def _null_args(self) -> dict:
        n = self.slots
        return {"page_table": np.zeros_like(self._pt),
                "lengths": np.zeros(n, np.int32),
                **self._sampling_arrays(())}

    def _null_scan_args(self, h: int) -> dict:
        n = self.slots
        return {**self._null_args(), "active": np.zeros(n, bool),
                "forced": np.zeros((n, h), np.int64),
                "use_forced": np.zeros((n, h), bool)}

    def _null_mixed_args(self, w: int) -> dict:
        n = self.slots
        return {**self._null_args(),
                "chunk_tokens": np.zeros((n, w), np.int64),
                "chunk_lens": np.zeros(n, np.int32),
                "is_prefill": np.zeros(n, bool),
                "chunk_idx": np.zeros(1, np.int64)}

    def _null_spec_args(self, w: int) -> dict:
        n = self.slots
        return {**self._null_args(),
                "chunk_tokens": np.zeros((n, w), np.int64),
                "chunk_lens": np.zeros(n, np.int32),
                "is_spec": np.zeros(n, bool)}

    def warmup(self):
        """Capture every round the configured buckets can reach, greedy
        and sampled: the decode horizons, the mixed widths (chunked
        admission) and the verify width (spec mode), each replayed once
        as an idle round, so no request waits for a capture. Idle rounds
        write only to the dead null page and leave every slot's carried
        logits, the host mirrors and the prefix cache as they were, so
        warmup is invisible to traffic. `warmup_compile=True` runs it
        inside `start()`."""
        with torch.inference_mode():
            self._warmup_scoped()

    def _warmup_scoped(self):
        # a bucket minted earlier holds its last round in its buffers:
        # every replay here is given the idle round
        for all_greedy in (True, False):
            for h in horizon_buckets(self.step_horizon):
                self._step_fn(h, all_greedy)(**self._null_scan_args(h))
            for w in mixed_width_buckets(self.prefill_chunk_tokens):
                self._mixed_fn(w, all_greedy)(**self._null_mixed_args(w))
            if self.spec_decode_k:
                w = self.spec_decode_k + 1
                self._spec_fn(w, all_greedy)(**self._null_spec_args(w))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def graph_stats(self) -> dict:
        """The captured rounds: how many, and the seconds their captures
        took (warm-up runs included)."""
        runners = [*self._step_fns.values(), *self._mixed_fns.values(),
                   *self._spec_fns.values()]
        return {"graphs": sum(1 for r in runners if r.captured),
                "capture_s": sum(r.capture_s for r in runners)}

    def _decode_round(self, t0: float, prefill_tokens: int = 0) -> bool:
        """Up to `step_horizon` decode steps over every live slot, clamped
        to the nearest slot completion and bucketed to a power of two.
        `prefill_tokens`: whole-prompt prefill that `_admit` ran inside
        this round's wall time."""
        live = [i for i, s in enumerate(self._slots) if s.req is not None]
        if not live:
            return False
        remaining = min(
            len(self._slots[i].forced) + self._slots[i].req
            .tokens_to_generate - self._slots[i].generated for i in live)
        hor = min(self.step_horizon, max(remaining, 1))
        hor = 1 << (hor.bit_length() - 1)
        for i in live:  # windowed slots: pages for the hor writes
            self._ensure_pages(i, self._lengths[i] + hor)

        n = self.slots
        active = np.zeros(n, bool)
        forced = np.zeros((n, hor), np.int64)
        use_forced = np.zeros((n, hor), bool)
        for i in live:
            s = self._slots[i]
            active[i] = True
            nf = min(len(s.forced), hor)
            if nf:
                forced[i, :nf] = [s.forced[t] for t in range(nf)]
                use_forced[i, :nf] = True
        all_greedy = all(self._slots[i].req.greedy for i in live)
        chosen, chosen_lp = self._step_fn(hor, all_greedy)(
            page_table=self._pt, lengths=self._lengths, active=active,
            forced=forced, use_forced=use_forced,
            **self._sampling_arrays(live))
        chosen = chosen.cpu().numpy()  # the round's one wait for the card
        want_lp = any(self._slots[i].req.return_log_probs for i in live)
        chosen_lp = chosen_lp.cpu().numpy() if want_lp else None
        self._steps += hor

        now = time.perf_counter()
        for t in range(hor):
            for i in live:
                s = self._slots[i]
                r = s.req
                if r is None:
                    continue  # retired earlier in this horizon (eod)
                self._lengths[i] += 1
                if r.return_log_probs:
                    r.log_probs.append(float(chosen_lp[i, t]))
                if s.forced:
                    s.forced.popleft()  # prompt token, already in tokens
                    continue
                self._book_token(i, int(chosen[i, t]), now)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._round_log.append({
                "prefill_tokens": prefill_tokens, "decode_steps": hor,
                "decode_slots": len(live), "ms": dt_ms})
            self._decode_ms.append(dt_ms / hor)
        return True

    def _mixed_round(self):
        """One mixed round: the oldest admitting slot (by rid) contributes
        a prompt chunk at its saved offset, every fully prefilled live
        slot one decode token, other admitting slots sit idle. Returns
        (decode slots advanced, prefill tokens consumed)."""
        n = self.slots
        pref = [i for i, s in enumerate(self._slots) if s.prefilling]
        ci = min(pref, key=lambda i: self._slots[i].req.rid)
        s_c = self._slots[ci]
        remaining = len(s_c.req.prompt) - s_c.prefill_pos
        width = self._chunk_width(remaining)
        ln = min(remaining, width)
        dec = [i for i, s in enumerate(self._slots)
               if s.req is not None and not s.prefilling]
        # windowed slots: pages for the chunk and the decode tokens
        self._ensure_pages(ci, self._lengths[ci] + ln)
        for i in dec:
            self._ensure_pages(i, self._lengths[i] + 1)

        chunk_tokens = np.zeros((n, width), np.int64)
        chunk_lens = np.zeros((n,), np.int32)
        is_prefill = np.zeros((n,), bool)
        chunk_tokens[ci, :ln] = s_c.req.prompt[
            s_c.prefill_pos:s_c.prefill_pos + ln]
        chunk_lens[ci] = ln
        is_prefill[ci] = True
        chunk_lens[dec] = 1
        all_greedy = all(self._slots[i].req.greedy for i in dec)
        want_chunk = s_c.req.return_log_probs
        first, first_lp, chunk_lps = self._mixed_fn(width, all_greedy)(
            page_table=self._pt, lengths=self._lengths,
            chunk_tokens=chunk_tokens, chunk_lens=chunk_lens,
            is_prefill=is_prefill, chunk_idx=np.asarray([ci], np.int64),
            **self._sampling_arrays(dec))
        first = first.cpu().numpy()  # the round's one wait for the card
        want_lp = want_chunk or any(self._slots[i].req.return_log_probs
                                    for i in dec)
        first_lp = first_lp.cpu().numpy() if want_lp else None
        chunk_lps = chunk_lps.cpu().numpy() if want_chunk else None
        self._steps += 1
        self._prefill_tokens += ln

        # the prefill slot: position p predicts prompt token p+1; the
        # chunk's first token was predicted by last round's final logits
        r = s_c.req
        if r.return_log_probs:
            if s_c.prefill_pos > 0:
                r.log_probs.append(float(first_lp[ci]))
            if ln > 1:
                r.log_probs.extend(float(x) for x in chunk_lps[:ln - 1])
        s_c.prefill_pos += ln
        self._lengths[ci] += ln
        self._register_prefix(ci)

        now = time.perf_counter()
        for i in dec:
            r = self._slots[i].req
            self._lengths[i] += 1
            if r.return_log_probs:
                r.log_probs.append(float(first_lp[i]))
            self._book_token(i, int(first[i]), now)
        return len(dec), ln

    # -- speculative decoding ----------------------------------------------

    def _draft(self, si: int) -> List[int]:
        """Prompt-lookup (n-gram) drafter: the continuation of the most
        recent earlier occurrence of the request's trailing bigram in its
        own tokens. Greedy slots only. Capped so the verify chunk writes
        no position past the request's prompt + tokens_to_generate, and,
        with a window, so the chunk stays inside one window of its first
        position."""
        s = self._slots[si]
        r = s.req
        if not r.greedy:
            return []
        cap = min(self.spec_decode_k,
                  r.tokens_to_generate - s.generated - 1)
        if self.window is not None:
            cap = min(cap, self.window - 1)
        if cap <= 0:
            return []
        toks = r.tokens
        if len(toks) < 3:
            return []
        # fold newly booked tokens into the bigram index; the trailing
        # bigram at len - 2 stays out, or the lookup would match itself
        while s.bigram_next <= len(toks) - 3:
            j = s.bigram_next
            occ = s.bigram.setdefault((toks[j], toks[j + 1]), [])
            occ.append(j)
            if len(occ) > 8:
                del occ[0]
            s.bigram_next += 1
        # position len(toks) is decided inside the round from the carried
        # logits, so drafts cover the positions after it. Prefer the
        # newest occurrence whose continuation fills the cap, else the
        # longest available
        occ = s.bigram.get((toks[-2], toks[-1]))
        if not occ:
            return []
        best_j, best_avail = None, 0
        for j in reversed(occ):
            avail = len(toks) - (j + 3)
            if avail >= cap:
                best_j, best_avail = j, avail
                break
            if avail > best_avail:
                best_j, best_avail = j, avail
        if best_j is None:
            return []
        return list(toks[best_j + 3: best_j + 3 + cap])

    def _collect_drafts(self) -> dict:
        """{slot: draft} for every live slot with one; empty means a plain
        decode round. None while a slot still owes teacher-forced prompt
        tokens: the verify round has no forcing."""
        if any(s.req is not None and s.forced for s in self._slots):
            return {}
        drafts = {}
        for i, s in enumerate(self._slots):
            if s.req is not None:
                d = self._draft(i)
                if d:
                    drafts[i] = d
        return drafts

    def _spec_round(self, drafts: dict, t0: float,
                    prefill_tokens: int = 0) -> None:
        """One speculative round: spec slots verify [next token + draft],
        the other live slots ride as width-1 decode rows, in one width
        k + 1 forward. The host books the first token and the accepted
        run and advances the slot's length mirror by exactly the booked
        count, which is the rollback of a rejection: the next round's
        writes overwrite the stale K/V past it, which no query reads."""
        width = self.spec_decode_k + 1
        n = self.slots
        live = [i for i, s in enumerate(self._slots) if s.req is not None]
        for i in live:  # windowed slots: pages for the verify chunk
            self._ensure_pages(
                i, self._lengths[i] + 1 + len(drafts.get(i, [])))
        chunk_tokens = np.zeros((n, width), np.int64)
        chunk_lens = np.zeros((n,), np.int32)
        is_spec = np.zeros((n,), bool)
        for i in live:
            d = drafts.get(i, [])
            chunk_tokens[i, 1:1 + len(d)] = d
            chunk_lens[i] = 1 + len(d)
            is_spec[i] = bool(d)
        all_greedy = all(self._slots[i].req.greedy for i in live)
        first, first_lp, gt, gt_lp, acc = self._spec_fn(width, all_greedy)(
            page_table=self._pt, lengths=self._lengths,
            chunk_tokens=chunk_tokens, chunk_lens=chunk_lens,
            is_spec=is_spec, **self._sampling_arrays(live))
        first = first.cpu().numpy()  # the round's wait for the card
        gt = gt.cpu().numpy()
        acc = acc.cpu().numpy()
        want_lp = any(self._slots[i].req.return_log_probs for i in live)
        first_lp = first_lp.cpu().numpy() if want_lp else None
        gt_lp = gt_lp.cpu().numpy() if want_lp else None
        self._steps += 1
        self._spec_rounds += 1

        now = time.perf_counter()
        emitted_total = 0
        for i in live:
            s = self._slots[i]
            r = s.req
            d_n = int(chunk_lens[i]) - 1
            a = int(acc[i]) if d_n else 0
            self._spec_proposed += d_n
            # the first token (a decode row's), then the accepted run:
            # each accepted token is the greedy target at its position
            emit = [(int(first[i]), float(first_lp[i]) if want_lp else 0.0)]
            emit += [(int(gt[i, j]), float(gt_lp[i, j]) if want_lp else 0.0)
                     for j in range(a)]
            booked = 0
            for tok, lp in emit:
                self._lengths[i] += 1
                if r.return_log_probs:
                    r.log_probs.append(lp)
                booked += 1
                if self._book_token(i, tok, now):
                    break  # eod or budget: the chunk's tail is not booked
            emitted_total += booked
            # acceptance counts only the draft tokens actually booked
            self._spec_accepted += booked - 1

        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:  # counters() reads these windows concurrently
            self._round_log.append({
                "prefill_tokens": prefill_tokens, "decode_steps": 1,
                "decode_slots": len(live), "ms": dt_ms,
                "spec_emitted": emitted_total})
            # per decode-token advance: emitted / live tokens a slot
            self._decode_ms.append(dt_ms * len(live)
                                   / max(emitted_total, 1))

    def _register_prefix(self, si: int) -> None:
        """Register every completed full prompt page of slot `si` in the
        prefix cache, as chunked prefill passes each page boundary. A
        page that also receives decode writes is never registered."""
        if self._prefix is None:
            return
        s = self._slots[si]
        r = s.req
        ps = self.page_size
        limit = min(s.prefill_pos, len(r.prompt))
        while (s.registered + 1) * ps <= limit:
            pg = int(self._pt[si, s.registered])
            self._prefix.insert(r.prompt[: (s.registered + 1) * ps], pg)
            s.registered += 1

    def drain(self):
        """Run until the queue and every slot are empty."""
        while self.step():
            pass

    def reset_prefix_cache(self):
        """Drop every cached prefix and return its pages to the free
        list. Only on an idle engine: a live slot's shared pages would be
        freed twice."""
        if self._prefix is None:
            return
        busy = [i for i, s in enumerate(self._slots) if s.req is not None]
        if busy:
            raise RuntimeError(
                f"reset_prefix_cache on a busy engine (slots {busy} "
                f"live): drain() first")
        self._free_pages.extend(self._prefix.evict(self.num_pages))
        self._prefix = PrefixCache(self.page_size)

    # -- serve thread --------------------------------------------------------

    def _fail_all(self, msg: str):
        """Fail every queued and in-flight request, so no waiter hangs on
        a dead engine."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.error = msg
            self._finish(req)
        for i, s in enumerate(self._slots):
            if s.req is not None:
                s.req.error = msg
                self._retire(i)

    def start(self):
        """Start the serve thread: the only thread that touches the pools.
        It runs the rounds under `torch.inference_mode()` on the engine's
        device; a failing round fails every request and refuses new
        ones."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self.warmup_compile:
            self.warmup()
        self._running = True

        def loop():
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while self._running:
                try:
                    did = self.step()
                except Exception as e:  # noqa: BLE001: fail loudly, never hang
                    self._broken = f"engine step failed: {e!r}"
                    _logger.exception("serve loop died; failing all "
                                      "in-flight requests")
                    self._fail_all(self._broken)
                    self._running = False
                    return
                if not did:
                    with self._work:
                        if self._running:
                            self._work.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the serve thread; drain=True finishes every admitted and
        queued request first, drain=False fails them."""
        if self._thread is None:
            return
        if drain:
            while self._thread.is_alive() and self._broken is None:
                with self._lock:
                    busy = bool(self._queue) or any(
                        s.req is not None for s in self._slots)
                if not busy:
                    break
                time.sleep(0.005)
        self._running = False
        with self._work:
            self._work.notify_all()
        self._thread.join()
        self._thread = None
        if not drain:
            self._fail_all("engine stopped")

    # -- observability -------------------------------------------------------

    def kv_pool_dtype(self) -> str:
        """The pools' storage dtype as the JAX engine names it
        ('bfloat16', 'float32', 'int8')."""
        return str(self._pools[0][0].dtype).replace("torch.", "")

    def kv_pool_bytes(self) -> int:
        """Device bytes the paged KV pools hold, data and (int8) scale
        pools, summed over layers."""
        return sum(x.numel() * x.element_size()
                   for group in self._pools for x in group)

    def kv_bytes_per_token(self) -> int:
        """KV bytes one cached token costs across all layers (K and V
        data and any scales)."""
        return round(self.kv_pool_bytes()
                     / (self.num_pages * self.page_size))

    @staticmethod
    def _pct(window, p: float) -> float:
        xs = sorted(window)
        if not xs:
            return 0.0
        return xs[min(int(p * len(xs)), len(xs) - 1)]

    def health(self) -> dict:
        """Liveness snapshot for GET /health."""
        alive = self._thread is not None and self._thread.is_alive()
        return {
            "alive": alive,
            "broken": self._broken,
            "queue_depth": len(self._queue),
            "slots_busy": sum(1 for s in self._slots if s.req is not None),
        }

    def counters(self) -> dict:
        """Live serving counters under the JAX engine's key names (GET
        /metrics). Latency gauges are percentiles of the last 256:
        `serve_ttft_*` submit -> first generated token, and
        `serve_decode_p95_ms` wall ms per decode-token advance per
        round."""
        occupied = sum(1 for s in self._slots if s.req is not None)
        dt = max(time.perf_counter() - self._t0, 1e-9)
        with self._lock:
            ttft = list(self._ttft_ms)
            decode_ms = list(self._decode_ms)
        out = {
            "serve_kv_dtype": self.kv_pool_dtype(),
            "serve_kv_pool_bytes": self.kv_pool_bytes(),
            "serve_kv_bytes_per_token": self.kv_bytes_per_token(),
            "serve_slot_occupancy": occupied / self.slots,
            "serve_queue_depth": len(self._queue),
            "serve_pages_in_use": self.num_pages - 1
            - len(self._free_pages),
            "serve_pages_free": len(self._free_pages),
            "serve_admitted": self._admitted,
            "serve_retired": self._retired,
            "serve_timed_out": self._timed_out,
            "serve_cancelled": self._cancelled,
            "serve_steps": self._steps,
            "serve_tok_s": round(self._tokens_out / dt, 2),
            "serve_prefill_tokens": self._prefill_tokens,
            "serve_ttft_p50_ms": round(self._pct(ttft, 0.50), 2),
            "serve_ttft_p95_ms": round(self._pct(ttft, 0.95), 2),
            "serve_decode_p95_ms": round(self._pct(decode_ms, 0.95), 2),
        }
        if self._prefix is not None:
            for k, v in self._prefix.stats().items():
                out["serve_" + k] = v
        if self.spec_decode_k:
            out["serve_spec_rounds"] = self._spec_rounds
            out["serve_spec_proposed"] = self._spec_proposed
            out["serve_spec_accepted"] = self._spec_accepted
            out["serve_spec_accept_rate"] = round(
                self._spec_accepted / max(self._spec_proposed, 1), 4)
        if self.window is not None:
            # present only on windowed engines, as in JAX
            out["serve_window_size"] = self.window
            out["serve_window_reclaimed_pages"] = self._window_reclaimed
        return out
