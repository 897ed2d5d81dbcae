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

Tensor-parallel serving (`serving_tp` > 1; JAX :944-1008, where one
controller runs every step under pjit on a tp mesh). Torch has no such
controller, so one rank drives and the others follow:

- every rank of the tp group (`parallel/mesh.serving_context`, ranks
  0..tp-1 of the process group, launched with torchrun) builds the
  engine with the same arguments. Each holds its slice of the decode
  tree (`parallel/sharding.decode_param_specs`, the GLU kept (h, 2, f))
  and of every page pool and int8 scale pool (`kv_pool_spec`: g / tp
  groups), so the gauges `kv_pool_bytes` and `kv_bytes_per_token`
  report a rank's bytes, 1 / tp of one card's;
- tp rank 0, the leader, runs everything on the host: the queue,
  admission, page allocation, the prefix cache, window reclaim, the
  drafter and the booking of tokens. Every call that touches the device
  goes through one choke point, `_dispatch(kind, key, host arrays)`:
  the round runners, the whole-prompt prefill and the prefix cache's
  page copy (and the warm-up). At tp > 1 it first broadcasts that
  descriptor (`mesh.broadcast_object`), and the other ranks, the
  followers, make the same call on their shard (`follow()`), holding no
  scheduler state, until the stop descriptor that `stop()` (or the
  serve loop's death) sends. An idle leader sends a no-op every
  `HEARTBEAT_S`, so a follower never waits out a collective's timeout
  and a dead follower fails the serve loop (GET /health answers 503);
- the forward gathers the logits over tp to the whole padded
  vocabulary (models/language_model.py), so every rank carries the same
  bits in `_last_logits` and samples the same tokens from the same
  per-slot draw state; each rank logs its chosen tokens a round
  (`_round_tokens`), which the tests hold equal across ranks;
- rounds at tp > 1 run uncaptured: gloo collectives cannot be captured
  in a CUDA graph, and NCCL refuses two ranks on one card, so on one
  H100 the ranks are gloo processes sharing it. `counters()` says so
  (`serve_captured: False`), as does the start line.

`devices` maps tp rank r to its device (`devices[0]` pins a tp = 1
engine, whose rounds capture as on the model's device); `replica_id`
tags the engine: the serve thread's name and `serve_replica_id` in
`counters()`.

Telemetry (JAX :1141-1319, the telemetry package): a span tracer
(`trace_dir`, exported as Chrome trace JSON at `stop()`), a flight
recorder that is always on (its ring dumped into `record_dir` when the
serve loop dies, served at GET /flight_record), the TTFT, decode-round
and queue-wait histograms behind the Prometheus /metrics, an opt-in cost
registry (`cost_registry`: FLOPs and bytes per round kind and bucket,
counted once when the bucket is minted, telemetry/costs.py, and the
modeled backlog the router places requests by) with the card's spec
(`chip_spec`, telemetry/chipspec.py), the perf sentinel on the decode
rounds' ms per advance (`perf_sentinel_*`), and `request_profile`, a
`torch.profiler` trace of the next N rounds. A round's wall runs from
its start to its tokens on the host (a replay returns before the card
finishes, so nothing times a launch alone). All of it is host
bookkeeping: a telemetry-on round runs the same kernels, and with every
knob off `counters()` keeps the schema it had without telemetry.

The KV hand-off (JAX :2664-2890): `export_prefix(prompt)` gathers the
full prompt pages a prefix-cache hit maps into a host payload (CPU
tensors, int8 data and scales together), `import_prefix(payload)` writes
them into free pages of this engine's existing pools in place (the
captured rounds read the pools by address) and registers the chain in
its prefix cache. Both run on the serve thread between rounds (or
inline without one), as plain torch gathers and scatters of whole pages
(`index_select` / `index_copy_`; XLA ran them outside Pallas). At tp > 1
they raise (ROADMAP.md A5).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.analysis.contracts import (
    CompileContract,
    record_variant,
    register_contract,
)
from megatron_llm_tpu_torch.inference.generation import bucket_prefill_len
from megatron_llm_tpu_torch.inference.graph_capture import CapturedFn
from megatron_llm_tpu_torch.inference.prefix_cache import PrefixCache
from megatron_llm_tpu_torch.inference.sampling import (
    NEG_INF,
    modify_logits_for_top_p,
)
from megatron_llm_tpu_torch.ops.quantization import scatter_quantized_rows
from megatron_llm_tpu_torch.parallel.mesh import (
    broadcast_object,
    release_context,
    serving_context,
    use_mesh,
)
from megatron_llm_tpu_torch.parallel.sharding import shard_decode_params
from megatron_llm_tpu_torch.telemetry import (
    NULL_TRACER,
    FlightRecorder,
    Histogram,
    SpanTracer,
    render_prometheus,
)

_logger = logging.getLogger(__name__)


# seconds an idle tp leader waits before it sends the followers a no-op
HEARTBEAT_S = 1.0
# the device calls of `_dispatch`: the round kinds, whose first output is
# the round's chosen tokens, and the rest
_ROUNDS = ("step", "mixed", "spec")


def _leaves(tree):
    """The tensors of a decode tree (dicts, tuples, tensors)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_device(tree, device):
    """A decode tree (dicts, tuples, tensors) on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    return tree.to(device)


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


def _page_export(pools, ids: torch.Tensor):
    """The donor half of the KV hand-off (JAX `_make_page_export_fn`):
    pages `ids` of every layer's K and V pool and, for int8 pools, scale
    pool, gathered into (n, page_size, ...) blocks on the device; the
    pools are only read."""
    return tuple(tuple(pool.index_select(0, ids) for pool in group)
                 for group in pools)


def _page_import(pools, ids: torch.Tensor, rows) -> None:
    """The receiver half (JAX `_make_page_import_fn`): the payload's
    blocks written into pages `ids` of every pool in place, data and
    scales together."""
    for group, blocks in zip(pools, rows):
        for pool, block in zip(group, blocks):
            pool.index_copy_(0, ids, block)


# the round kinds' compile-contract names (the JAX engine's), under
# which each captured runner is counted and costed
_COST_NAMES = {_decode_step: "engine.decode_scan",
               _mixed_step: "engine.mixed_step",
               _spec_step: "engine.spec_verify"}

# The JAX engine's compile contracts (JAX :350-764), their budgets the
# JAX declarations': a round kind mints one captured runner a bucket and
# greedy specialisation, under the engine, as the JAX engine mints one
# program. At tp 2 every round reduces its row-parallel products and
# gathers its logits over the tp group (`gather_from_tp_last`), so the
# mixed round issues an all-gather where the JAX one (GSPMD) lowers
# all-reduce only. The whole-prompt prefill and the page copy, export
# and import run uncaptured, one function each: the port mints no
# per-bucket executable for them, and records the page functions once.
_ROUND_COLLECTIVES = {"single": frozenset(),
                      "tp2": frozenset({"all-reduce", "all-gather"})}
_PAGE_COLLECTIVES = {"single": frozenset(), "tp2": frozenset()}
for _c in (
        CompileContract(
            "engine.decode_scan", max_variants=16,
            collectives=_ROUND_COLLECTIVES, tmp_bytes_budget=1 << 20,
            notes="pow2 horizons x {greedy, sampled}; the engine passes "
                  "2 * len(horizon_buckets(step_horizon))"),
        CompileContract(
            "engine.mixed_step", max_variants=24,
            collectives=_ROUND_COLLECTIVES, tmp_bytes_budget=4 << 20,
            notes="pow2 chunk widths x {greedy, sampled}; the engine passes "
                  "2 * len(mixed_width_buckets(prefill_chunk_tokens))"),
        CompileContract(
            "engine.prefill_bucket", max_variants=8,
            collectives={"single": frozenset(),
                         "tp2": frozenset({"all-reduce", "all-gather"})},
            tmp_bytes_budget=8 << 20,
            notes="whole-prompt prefill; uncaptured in the port, no "
                  "per-bucket executable is minted"),
        CompileContract(
            "engine.spec_verify", max_variants=2,
            collectives=_ROUND_COLLECTIVES, tmp_bytes_budget=4 << 20,
            notes="one width (spec_decode_k + 1) x {greedy, sampled}"),
        CompileContract(
            "engine.page_copy", max_variants=1,
            collectives=_PAGE_COLLECTIVES, tmp_bytes_budget=1 << 20,
            notes="the prefix cache's copy on write"),
        CompileContract(
            "engine.page_export", max_variants=1,
            collectives=_PAGE_COLLECTIVES, tmp_bytes_budget=1 << 20,
            notes="the KV hand-off's donor-side page gather"),
        CompileContract(
            "engine.page_import", max_variants=1,
            collectives=_PAGE_COLLECTIVES, tmp_bytes_budget=1 << 20,
            notes="the KV hand-off's receiver-side page scatter")):
    register_contract(_c)


@dataclass
class EngineRequest:
    """One queued or running generation. `tokens` grows to prompt +
    generated; `log_probs[i]` (when requested) is log P(tokens[i+1] |
    tokens[:i+1]), the generate_tokens layout."""

    rid: int
    prompt: List[int]
    tokens_to_generate: int
    # the replica whose engine owns this request (None on an untagged
    # engine): the router routes cancel() by it, the SSE `id:` carries it
    replica_id: Optional[int] = None
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
    # the retire event's cost record (cost registry on): the round the
    # slot admitted at, the prompt offset its prefill started from (cache
    # hits never compute), the prompt tokens prefilled on the device, and
    # the draft tokens speculative rounds booked
    admit_round: int = 0
    prefill_start: int = 0
    prefilled: int = 0
    spec_accepted: int = 0
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
    first use), `serving_tp` (tensor-parallel ranks; every rank of the
    group builds the engine, tp rank 0 serves and the others call
    `follow()`: the module doc), `devices` (tp rank r's device; default
    the model's), `replica_id` (the engine's tag: serve thread name,
    `serve_replica_id`, the SSE id, every span and flight-record event);
    the telemetry knobs `timers` (the gauges' sink, `export_gauges`),
    `trace_dir`, `record_dir` (default trace_dir), `flight_recorder_size`,
    `cost_registry`, `chip_spec` (a chipspec table key; default: detect
    from the engine's card), `perf_sentinel_ksigma` (0 off),
    `perf_sentinel_window`, `perf_sentinel_patience` (the module doc and
    the JAX engine's knob list).

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
                 serving_tp: int = 1,
                 devices=None,
                 replica_id: Optional[int] = None,
                 timers=None,
                 trace_dir: Optional[str] = None,
                 record_dir: Optional[str] = None,
                 flight_recorder_size: int = 4096,
                 cost_registry: bool = False,
                 chip_spec: Optional[str] = None,
                 perf_sentinel_ksigma: float = 0.0,
                 perf_sentinel_window: int = 64,
                 perf_sentinel_patience: int = 8):
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
        # -- the tp group (JAX :967-1008) -----------------------------------
        self.serving_tp = max(1, serving_tp)
        self.replica_id = replica_id
        if self.serving_tp > 1 or devices is not None:
            if self.cfg.num_query_groups % self.serving_tp != 0:
                raise ValueError(
                    f"serving_tp={self.serving_tp} must divide the KV "
                    f"group count ({self.cfg.num_query_groups}): the "
                    f"page pools shard over the group axis "
                    f"(parallel/sharding.kv_pool_spec) — use a tp that "
                    f"divides num_query_groups, or replicate the "
                    f"engine behind the router instead")
            if quantize_weights and self.serving_tp > 1:
                raise ValueError(
                    "quantize_weights is single-chip-layout only (the "
                    "weight-only int8 decode tree bakes the flattened "
                    "(h, 2f) GLU view, whose gate|up concat crosses "
                    "the tp shard boundary); serve the fp decode tree "
                    "on a tp mesh, or quantize at tp=1")
            if devices is not None and len(devices) != self.serving_tp:
                raise ValueError(f"devices lists {len(devices)} devices "
                                 f"for serving_tp={self.serving_tp}: one "
                                 f"per tp rank")
        if devices is None:
            device = model.device
        else:
            device = devices[dist.get_rank() if self.serving_tp > 1
                             and dist.is_initialized() else 0]
        self._ctx = None if self.serving_tp == 1 \
            else serving_context(self.serving_tp, device)
        self.tp_rank = 0 if self._ctx is None else self._ctx.tp_rank
        # the followers' stop descriptor went out (`_release`)
        self._released = False
        self._last_dispatch = time.monotonic()
        # this rank's chosen tokens a round (tp > 1): the leader's and
        # every follower's must agree
        self._round_tokens: collections.deque = collections.deque(
            maxlen=4096)
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
        self.device = torch.device(device)
        if self.device != torch.device(model.device):
            # the model object holds its config and device only: the
            # engine's twin on its own device allocates the caches there
            self.model = model = type(model)(self.cfg, device=self.device)
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
        self.quantize_weights = bool(quantize_weights)
        self.termination_id = termination_id
        self.vocab_size = vocab_size
        self.warmup_compile = bool(warmup_compile)
        self.timers = timers

        # the int8 decode tree is built once and serves every round kind;
        # a tp engine keeps the (h, 2, f) GLU and holds its rank's slice
        dec = model.prepare_decode_params(
            params, quantize_int8=quantize_weights,
            flatten_glu=self.serving_tp == 1)
        # the whole tree's parameter count (the cost records' 2 N)
        self._n_dec = sum(x.numel() for x in _leaves(dec))
        if self.serving_tp > 1:
            dec = shard_decode_params(dec, self.cfg, self.serving_tp,
                                      self.tp_rank)
        self._dec_params = _to_device(dec, self.device)
        caches = model.init_paged_kv_caches(
            slots, self.num_pages, page_size, self.max_pages_per_slot,
            kv_dtype=torch.int8 if kv_dtype == "int8" else None,
            tp=self.serving_tp)
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
        # gloo collectives cannot be captured: tp > 1 rounds run
        # uncaptured (`serve_captured` in counters())
        self._eager = self.serving_tp > 1
        self._graph_pool = self._graph_stream = None
        if self._cuda_index is not None and not self._eager:
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

        # -- the cost registry and the perf sentinel (JAX :1141-1188) -------
        self.costs = None
        self.chip = None
        if cost_registry:
            from megatron_llm_tpu_torch.telemetry.chipspec import detect_chip
            from megatron_llm_tpu_torch.telemetry.costs import CostRegistry

            self.chip = detect_chip(devices=[self.device],
                                    override=chip_spec)
            self.costs = CostRegistry(chip=self.chip, owner=self).attach()
        # the per-request cost record's analytic decode FLOPs: 2 N a
        # computed token over the whole decode tree and 4 L h a cached
        # position (telemetry/chipspec.decode_flops_per_token)
        self._cost_fpt_linear = 0.0
        self._cost_attn_coeff = 0.0
        if self.costs is not None:
            self._cost_fpt_linear = 2.0 * self._n_dec
            self._cost_attn_coeff = (4.0 * self.cfg.num_layers
                                     * self.cfg.hidden_size)
        self._modeled_device_ms = 0.0
        self._measured_round_ms = 0.0
        self._modeled_gflops = 0.0
        self._page_rounds = 0
        self._sentinel = None
        if perf_sentinel_ksigma > 0:
            from megatron_llm_tpu_torch.telemetry.sentinel import PerfSentinel

            self._sentinel = PerfSentinel(
                k_sigma=perf_sentinel_ksigma,
                window=max(perf_sentinel_window, 4),
                patience=max(perf_sentinel_patience, 1),
                recorder=None, name="decode_round_ms")
        # the KV hand-off's inbox: export and import run on the serve
        # thread between rounds (the prefix cache and the pools are the
        # serve thread's), or inline when no serve loop runs
        self._xfers: collections.deque = collections.deque()
        self._transfers_out = 0
        self._transfer_pages_out = 0
        self._transfers_in = 0
        self._transfer_pages_in = 0

        # -- telemetry (JAX :1260-1318) -------------------------------------
        self.trace_dir = trace_dir
        self.record_dir = record_dir if record_dir is not None else trace_dir
        self.tracer = (SpanTracer(enabled=True) if trace_dir
                       else NULL_TRACER)
        if replica_id is not None:
            self.tracer.set_context(replica=replica_id)
        self.recorder = FlightRecorder(
            flight_recorder_size,
            base=None if replica_id is None else {"replica": replica_id})
        if self._sentinel is not None:
            self._sentinel.recorder = self.recorder
        self._hists = {
            "serve_ttft_ms": Histogram(
                "serve_ttft_ms", help_text="submit -> first generated "
                "token, per request"),
            "serve_decode_round_ms": Histogram(
                "serve_decode_round_ms", help_text="wall ms per decode-"
                "token advance per round (mixed rounds included: the "
                "chunked-prefill interference distribution)"),
            "serve_queue_wait_ms": Histogram(
                "serve_queue_wait_ms", help_text="submit -> slot "
                "admission, per request"),
        }
        self._rounds = 0  # rounds that did work (the telemetry clock)
        # the fault hook chaos installs (inference/chaos.py): called at
        # the top of every round inside its timed window, so an injected
        # stall rides the wall the sentinel measures and an injected
        # raise kills the serve loop through its poison path
        self._fault_hook = None
        # the profiler hook (POST /profile): armed, started before the
        # next round, stopped after N rounds that did work
        self._profile_pending: Optional[tuple] = None
        self._profile_active = False
        self._profile_left = 0
        self._profile_dir: Optional[str] = None
        self._profiler = None
        self._profile_path: Optional[str] = None
        for name in ("engine.page_copy", "engine.page_export",
                     "engine.page_import"):
            record_variant(name, (), owner=self, budget=1)
        if self.costs is not None:
            # the copy, export and import cost: counted once here, on
            # the dead null page (JAX :1197-1212)
            null = torch.zeros(1, dtype=torch.long, device=self.device)
            with torch.inference_mode():
                self._costed("engine.page_copy", (),
                             lambda: _page_copy(self._pools, 0, 0))
                rows = self._costed("engine.page_export", (),
                                    lambda: _page_export(self._pools, null))
                self._costed("engine.page_import", (),
                             lambda: _page_import(self._pools, null, rows))

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
            replica_id=self.replica_id,
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
        # the request id is the correlation key of the SSE `id:`, the
        # server's error logs, the spans and these events
        self.recorder.record(
            "submit", rid=req.rid, prompt_tokens=len(req.prompt),
            tokens_to_generate=tokens_to_generate, stream=stream)
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
                    evicted = self._prefix.evict(
                        need_new - len(self._free_pages))
                    if evicted:
                        self.tracer.instant("prefix_evict", rid=req.rid,
                                            pages=len(evicted))
                        self.recorder.record("prefix_evict", rid=req.rid,
                                             pages=len(evicted))
                    self._free_pages.extend(evicted)
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
            slot.admit_round = self._rounds
            slot.prefill_start = 0
            slot.prefilled = 0
            slot.spec_accepted = 0
            req.tokens = list(req.prompt)
            if self.prefill_chunk_tokens:
                matched = 0
                if match is not None:
                    matched = match.matched
                    if match.cow_src is not None:
                        # the divergent page starts as a private replica
                        # of the shared one; prefill resumes inside it
                        with self.tracer.span(
                                "cow_copy", rid=req.rid, src=match.cow_src,
                                dst=pages[match.full_pages]):
                            self._dispatch("copy", (match.cow_src,
                                                    pages[match.full_pages]))
                        self._prefix.release_page(match.cow_src)
                        self._prefix.cow_copies += 1
                if self._prefix is not None:
                    self._prefix.note(len(req.prompt), matched)
                slot.prefill_pos = matched
                slot.prefill_start = matched
                self._lengths[si] = matched
            else:
                plen = bucket_prefill_len(len(req.prompt))
                with self.tracer.span("prefill_bucket", rid=req.rid,
                                      slot=si, tokens=plen):
                    plp = self._dispatch("prefill", (si,), {
                        "tokens": np.asarray([req.prompt[:plen]], np.int64),
                        "pt_row": self._pt[si].copy()})
                self._lengths[si] = plen
                slot.prefill_pos = len(req.prompt)
                slot.forced = collections.deque(req.prompt[plen:])
                slot.prefilled = plen
                self._prefill_tokens += plen
                prefilled += plen
                if req.return_log_probs:
                    req.log_probs = plp
            req.t_admit = time.perf_counter()
            # queue wait: a span from the request's own stamps, and the
            # histogram behind the Prometheus exposition
            wait_ms = (req.t_admit - req.t_submit) * 1e3
            self.tracer.complete("queue_wait", req.t_submit, req.t_admit,
                                 rid=req.rid, slot=si)
            self._hists["serve_queue_wait_ms"].observe(wait_ms)
            self.recorder.record(
                "admit", rid=req.rid, slot=si,
                queue_wait_ms=round(wait_ms, 3),
                prefill_start=slot.prefill_pos, pages=need)
            self._admitted += 1
        return prefilled

    def _request_cost(self, si: int) -> Optional[dict]:
        """The per-request cost record of the retire event (cost registry
        on; JAX :1694-1728): host arithmetic over the slot's counters and
        the length mirror. `modeled_mflops` is the analytic decode model
        over every position computed past the cache hit, plus the
        attention integral over the context's growth: a modeled number,
        not a measurement."""
        if self.costs is None:
            return None
        slot = self._slots[si]
        req = slot.req
        final_len = int(self._lengths[si])
        start = slot.prefill_start
        computed = max(final_len - start, 0)
        rounds_held = self._rounds - slot.admit_round + 1
        pages = len(slot.pages)
        modeled = (self._cost_fpt_linear * computed
                   + 0.5 * self._cost_attn_coeff
                   * (final_len * final_len - start * start))
        return {
            "prompt_tokens": len(req.prompt),
            "cached_tokens": start,
            "prefill_tokens": slot.prefilled,
            "decode_tokens": slot.generated,
            "spec_accepted": slot.spec_accepted,
            "rounds_held": rounds_held,
            "pages": pages,
            "page_rounds": pages * rounds_held,
            "modeled_mflops": round(modeled / 1e6, 3),
        }

    def _retire(self, si: int):
        slot = self._slots[si]
        # the cost record first: it reads what this method resets
        cost = self._request_cost(si)
        if cost is not None:
            self._modeled_gflops += cost["modeled_mflops"] / 1e3
            self._page_rounds += cost["page_rounds"]
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
        self.tracer.instant("retire", rid=req.rid, slot=si,
                            generated=slot.generated,
                            error=req.error is not None)
        self.recorder.record("retire", rid=req.rid, slot=si,
                             generated=slot.generated, error=req.error,
                             **({"cost": cost} if cost is not None
                                else {}))
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
            n = dead - s.reclaimed
            s.reclaimed = dead
            s.registered = max(s.registered, dead)
            self.tracer.instant("window_reclaim", rid=s.req.rid, slot=si,
                                pages=n)

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
            ttft = (r.t_first - r.t_submit) * 1e3
            with self._lock:  # counters() sorts this window concurrently
                self._ttft_ms.append(ttft)
            self._hists["serve_ttft_ms"].observe(ttft)
            self.tracer.instant("first_token", rid=r.rid,
                                ttft_ms=round(ttft, 3))
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
            self.recorder.record("timeout_queued", rid=r.rid,
                                 deadline_s=r.deadline_s)
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
        every live window. Returns False when there was nothing to do.
        It also keeps the telemetry clock (JAX :1977-2004): the profiler
        hook starts before and stops after the requested rounds, and
        every 256 rounds the flight recorder takes a counters()
        snapshot."""
        if self._profile_pending is not None:
            self._start_profile()
        with torch.inference_mode():
            did = self._step_inner()
        if did:
            self._reclaim_window_pages()
            self._rounds += 1
            if self._rounds % 256 == 0:
                self.recorder.note_counters(self.counters())
        if self._profile_active:
            self._tick_profile(did)
        return did

    def _step_inner(self) -> bool:
        t0 = time.perf_counter()
        if self._fault_hook is not None:
            self._fault_hook(self)
        self._expire_deadlines()
        did_xfer = self._apply_transfers()
        admitted_before = self._admitted
        t_adm = time.perf_counter()
        admit_prefilled = self._admit()
        if self._admitted != admitted_before:
            self.tracer.complete(
                "admit", t_adm, time.perf_counter(),
                admitted=self._admitted - admitted_before,
                prefilled_tokens=admit_prefilled)
        if any(s.prefilling for s in self._slots):
            dec_slots, pf_tokens, chunk_rid, mixed_key = self._mixed_round()
            t1 = time.perf_counter()
            dt_ms = (t1 - t0) * 1e3
            with self._lock:  # counters() reads these windows concurrently
                self._round_log.append({
                    "prefill_tokens": pf_tokens, "decode_steps": 1,
                    "decode_slots": dec_slots, "ms": dt_ms})
                if dec_slots:
                    self._decode_ms.append(dt_ms)
            if dec_slots:
                self._hists["serve_decode_round_ms"].observe(dt_ms)
            # not fed to the sentinel: a mixed round's wall carries a
            # prefill chunk, which is interference, not a regression
            self._note_dispatch("engine.mixed_step", mixed_key, dt_ms)
            self.tracer.complete(
                "round.mixed", t0, t1, round=self._rounds, rid=chunk_rid,
                prefill_tokens=pf_tokens, decode_slots=dec_slots)
            self.recorder.record(
                "round.mixed", round=self._rounds, rid=chunk_rid,
                prefill_tokens=pf_tokens, decode_slots=dec_slots,
                ms=round(dt_ms, 3))
            return True
        if self.spec_decode_k:
            drafts = self._collect_drafts()
            if drafts:
                self._spec_round(drafts, t0, admit_prefilled)
                return True
        return self._decode_round(t0, admit_prefilled) or did_xfer

    def _note_dispatch(self, name: str, key, dt_ms: float) -> None:
        """The modeled-against-measured round accounting behind the
        serve_dispatch_overhead_pct gauge (JAX :2136-2152): the cost
        record's roofline device time of the round this call ran against
        its measured wall. A dict lookup and float adds."""
        if self.costs is None:
            return
        self._measured_round_ms += dt_ms
        rec = self.costs.record(name, key)
        if rec is None:
            return
        modeled = rec.modeled_seconds(self.chip, n_chips=self.serving_tp)
        if modeled is not None:
            self._modeled_device_ms += modeled * 1e3

    def _sentinel_observe(self, ms_per_advance: float) -> None:
        """Feed the perf sentinel one decode round's ms per advance, the
        one homogeneous series (JAX :2154-2172); a trip dumps the flight
        ring as the poison path does."""
        if self._sentinel is None:
            return
        if self._sentinel.observe(ms_per_advance, step=self._rounds):
            self.recorder.note_counters(self.counters())
            self.recorder.dump(
                self.record_dir, self._name("perf-regression"),
                extra={"trip": self._sentinel.trips,
                       "threshold_ms": round(
                           self._sentinel.last_threshold, 3),
                       "round": self._rounds})

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
        the private `_eager` switch). Each runner is a variant of the
        round kind's compile contract under this engine, recorded before
        it is captured (past the budget `_variant_budget` it raises
        `ContractViolation`). With the cost registry on, the runner's
        first eager run (the capture's first warm-up run, or an
        uncaptured runner's first round) is counted under the JAX
        engine's name and key of that program."""
        cost = (_COST_NAMES[step], (static.get("horizon", static.get(
            "width")), static["all_greedy"]))
        record_variant(*cost, owner=self, budget=self._variant_budget(
            cost[0]))
        fn = functools.partial(step, self.model, self._dec_params,
                               self._pools, self._last_logits,
                               vocab_size=self.vocab_size, **static)
        probe = None
        if self.costs is not None:
            args = sum(np.asarray(v).nbytes for v in null_args.values())
            probe = functools.partial(self._costed, *cost,
                                      arg_bytes=self._bound_bytes() + args)
        # graft-contract: engine.decode_scan
        # graft-contract: engine.mixed_step
        # graft-contract: engine.spec_verify
        runner = CapturedFn(fn, null_args, device=self.device,
                            pool=self._graph_pool, stream=self._graph_stream,
                            capture=not self._eager, probe=probe)
        if probe is not None and runner.captured:
            self.costs.note_temp(*cost, self._graph_pool_bytes())
        return runner

    def _variant_budget(self, name: str) -> int:
        """The runners a round kind may mint on this engine (JAX
        :1869-1882, :2422): both greedy specialisations of every bucket
        its configuration can ask for."""
        if name == "engine.decode_scan":
            return 2 * len(horizon_buckets(self.step_horizon))
        if name == "engine.mixed_step":
            return 2 * len(mixed_width_buckets(self.prefill_chunk_tokens))
        return 2

    def _costed(self, name: str, key, run, arg_bytes=None):
        """`run()`, counted into the cost registry under (name, key) the
        first time that key runs (JAX `_capture_cost`, :1336-1349); just
        `run()` otherwise."""
        if self.costs is None or self.costs.has(name, key):
            return run()
        return self.costs.capture(name, key, run, arg_bytes=arg_bytes)

    def _bound_bytes(self) -> int:
        """Bytes every round binds: the decode tree, the pools and the
        carried logits."""
        return sum(x.numel() * x.element_size() for x in (
            *_leaves(self._dec_params), *(t for g in self._pools for t in g),
            self._last_logits))

    def _graph_pool_bytes(self) -> Optional[int]:
        """The reserved bytes of this engine's graph pool (the cost
        records' temp bytes): the allocator's segments of that pool."""
        if self._graph_pool is None:
            return None
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

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
        inside `start()`. At tp > 1 every rank runs the same idle rounds,
        uncaptured."""
        self._dispatch("warmup")

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
            # this thread's stream, not the device: another replica's
            # serve thread may be capturing on the same card
            torch.cuda.current_stream(self.device).synchronize()

    # -- the choke point of every device call (tp serving) -------------------

    def mesh_scope(self):
        """This engine's tp context, installed for the calling thread
        (JAX :1362-1382): the model's collectives read it. A null scope
        at tp = 1."""
        if self._ctx is None:
            return contextlib.nullcontext()
        return use_mesh(self._ctx)

    def _dispatch(self, kind: str, key: tuple = (), args=None):
        """Run one device call of the engine: a round runner ("step",
        "mixed", "spec" with its bucket key), the whole-prompt "prefill",
        the prefix cache's page "copy", the KV hand-off's page "export"
        and "import" (tp = 1 only), the "warmup" or a "noop". At
        tp > 1 the leader first sends the call's descriptor (kind, key
        and host arrays) to the followers, which make the same call on
        their shards."""
        args = {} if args is None else args
        if self._ctx is not None:
            if self.tp_rank != 0:
                raise RuntimeError("a tp follower runs what the leader "
                                   "sends (follow()), nothing of its own")
            if self._released:
                raise RuntimeError(f"engine is stopped: its tp followers "
                                   f"were released ({self._broken})")
            broadcast_object((kind, key, args), self._ctx)
            self._last_dispatch = time.monotonic()
        return self._run(kind, key, args)

    def _run(self, kind: str, key: tuple, args: dict):
        with torch.inference_mode(), self.mesh_scope():
            if kind in _ROUNDS:
                runner = {"step": self._step_fn, "mixed": self._mixed_fn,
                          "spec": self._spec_fn}[kind](*key)
                out = runner(**args)
                if self._ctx is not None:
                    self._round_tokens.append(out[0].cpu().numpy().copy())
                return out
            if kind == "prefill":
                (si,) = key
                tokens = self._dev(args["tokens"], np.int64)
                pt_row = self._dev(args["pt_row"])
                # a bucket's cost is counted at its first run
                row_logits, plp = self._costed(
                    "engine.prefill_bucket", tokens.shape[1],
                    lambda: _prefill(self.model, self._dec_params,
                                     self._pools, tokens, pt_row,
                                     self.page_size))
                self._last_logits[si] = row_logits.float()
                return plp.cpu().tolist()
            if kind == "export":
                ids = self._dev(args["ids"], np.int64)
                return tuple(tuple(b.cpu() for b in group)
                             for group in _page_export(self._pools, ids))
            if kind == "import":
                ids = self._dev(args["ids"], np.int64)
                rows = tuple(tuple(b.to(self.device) for b in group)
                             for group in args["rows"])
                _page_import(self._pools, ids, rows)
                if self.device.type == "cuda":
                    # the pages are in place before the next round reads
                    # them and before the caller hears of it
                    torch.cuda.current_stream(self.device).synchronize()
            elif kind == "copy":
                _page_copy(self._pools, *key)
            elif kind == "warmup":
                self._warmup_scoped()
            elif kind != "noop":
                raise ValueError(f"unknown engine call {kind!r}")
            return None

    def follow(self):
        """A follower's loop (tp rank > 0): receive each descriptor the
        leader sends and make the same call on this rank's shards, until
        the stop descriptor. A failing call raises here (and the leader's
        next collective with this rank fails its serve loop)."""
        if self._ctx is None or self.tp_rank == 0:
            raise RuntimeError("follow() is a tp follower's loop (serving_tp "
                               "> 1, tp rank > 0)")
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        try:
            while True:
                kind, key, args = broadcast_object(None, self._ctx)
                if kind == "stop":
                    return
                self._run(kind, key, args)
        finally:
            self._close()

    def _release(self):
        """The leader's stop descriptor to the followers, sent once; a
        failure to send (a follower already gone) is logged, never
        raised, so the serve loop's death always completes."""
        if self._ctx is None or self.tp_rank != 0 or self._released:
            return
        self._released = True
        try:
            broadcast_object(("stop", (), {}), self._ctx)
        except Exception:  # noqa: BLE001: a dead follower cannot be told
            _logger.exception("could not send the tp followers their stop")
        self._close()

    def _close(self):
        if self._ctx is not None and self._ctx.groups:
            release_context(self._ctx)

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
        chosen, chosen_lp = self._dispatch("step", (hor, all_greedy), dict(
            page_table=self._pt, lengths=self._lengths, active=active,
            forced=forced, use_forced=use_forced,
            **self._sampling_arrays(live)))
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
        t1 = time.perf_counter()
        dt_ms = (t1 - t0) * 1e3
        with self._lock:
            self._round_log.append({
                "prefill_tokens": prefill_tokens, "decode_steps": hor,
                "decode_slots": len(live), "ms": dt_ms})
            self._decode_ms.append(dt_ms / hor)
        self._hists["serve_decode_round_ms"].observe(dt_ms / hor)
        self._note_dispatch("engine.decode_scan", (hor, all_greedy), dt_ms)
        self._sentinel_observe(dt_ms / hor)
        self.tracer.complete("round.decode_scan", t0, t1,
                             round=self._rounds, horizon=hor,
                             decode_slots=len(live),
                             prefill_tokens=prefill_tokens)
        self.recorder.record("round.decode_scan", round=self._rounds,
                             horizon=hor, decode_slots=len(live),
                             prefill_tokens=prefill_tokens,
                             ms=round(dt_ms, 3))
        return True

    def _mixed_round(self):
        """One mixed round: the oldest admitting slot (by rid) contributes
        a prompt chunk at its saved offset, every fully prefilled live
        slot one decode token, other admitting slots sit idle. Returns
        (decode slots advanced, prefill tokens consumed, the chunk
        request's rid (the round's span key), the runner's key)."""
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
        first, first_lp, chunk_lps = self._dispatch(
            "mixed", (width, all_greedy), dict(
                page_table=self._pt, lengths=self._lengths,
                chunk_tokens=chunk_tokens, chunk_lens=chunk_lens,
                is_prefill=is_prefill, chunk_idx=np.asarray([ci], np.int64),
                **self._sampling_arrays(dec)))
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
        s_c.prefilled += ln
        self._lengths[ci] += ln
        self._register_prefix(ci)

        now = time.perf_counter()
        for i in dec:
            r = self._slots[i].req
            self._lengths[i] += 1
            if r.return_log_probs:
                r.log_probs.append(float(first_lp[i]))
            self._book_token(i, int(first[i]), now)
        return len(dec), ln, s_c.req.rid, (width, all_greedy)

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
        first, first_lp, gt, gt_lp, acc = self._dispatch(
            "spec", (width, all_greedy), dict(
                page_table=self._pt, lengths=self._lengths,
                chunk_tokens=chunk_tokens, chunk_lens=chunk_lens,
                is_spec=is_spec, **self._sampling_arrays(live)))
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
            for j, (tok, lp) in enumerate(emit):
                self._lengths[i] += 1
                if r.return_log_probs:
                    r.log_probs.append(lp)
                if j > 0:
                    # before _book_token, which may retire the slot
                    s.spec_accepted += 1
                booked += 1
                if self._book_token(i, tok, now):
                    break  # eod or budget: the chunk's tail is not booked
            emitted_total += booked
            # acceptance counts only the draft tokens actually booked
            self._spec_accepted += booked - 1

        t1 = time.perf_counter()
        dt_ms = (t1 - t0) * 1e3
        per_advance = dt_ms * len(live) / max(emitted_total, 1)
        with self._lock:  # counters() reads these windows concurrently
            self._round_log.append({
                "prefill_tokens": prefill_tokens, "decode_steps": 1,
                "decode_slots": len(live), "ms": dt_ms,
                "spec_emitted": emitted_total})
            # per decode-token advance: emitted / live tokens a slot
            self._decode_ms.append(per_advance)
        self._hists["serve_decode_round_ms"].observe(per_advance)
        self._note_dispatch("engine.spec_verify", (width, all_greedy),
                            dt_ms)
        # not fed to the sentinel: its ms per advance moves with the
        # accept rate, which is not a regression of the card
        self.tracer.complete("round.spec_verify", t0, t1,
                             round=self._rounds, decode_slots=len(live),
                             emitted=emitted_total, drafted=len(drafts))
        self.recorder.record("round.spec_verify", round=self._rounds,
                             decode_slots=len(live), emitted=emitted_total,
                             drafted=len(drafts), ms=round(dt_ms, 3))

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

    # -- the KV page hand-off between replicas (JAX :2664-2887) -------------
    # A prefill replica exports the full-page prefix of a prompt it has
    # prefilled as a host payload; a decode replica imports it into free
    # pages and registers the chain in its prefix cache, so the next
    # submit() of that prompt admits as a prefix hit and prefills nothing
    # it received. Both run through the inbox `_xfers` on the serve thread
    # (the prefix cache and the pools are the serve thread's), or inline
    # when no serve thread runs.

    def _check_handoff(self, what: str) -> None:
        if self._prefix is None:
            raise ValueError(
                f"{what} needs prefix_cache=True: " + (
                    "the transfer ships the cache's registered pages"
                    if what == "export_prefix" else
                    "transferred pages land as cache entries"))
        if self.serving_tp > 1:
            raise ValueError(
                f"{what} at serving_tp={self.serving_tp} is not ported: "
                f"the hand-off of group-sharded pools is queued "
                f"(ROADMAP.md A5)")

    def export_prefix(self, prompt: List[int]):
        """The cached full-page prefix of `prompt` as a host payload dict
        (JAX :2676-2691): its tokens, page count, page size, pool dtype
        and per layer the (pages, page_size, g, d) K and V blocks and,
        for int8 pools, the scale blocks, as CPU tensors. None when this
        engine's prefix cache holds no full page of it. The donor's
        pages stay registered and unreferenced (an export is a read)."""
        self._check_handoff("export_prefix")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("export_prefix: empty prompt")
        return self._run_transfer({"kind": "export", "prompt": prompt})

    def import_prefix(self, payload):
        """Write an exported payload into free pages of this engine's
        pools (evicting idle cache entries if short) and register the
        chain in its prefix cache (JAX :2693-2708). Returns {'pages':
        shipped, 'registered': retained}, or False when the pool stays
        short after eviction (the caller prefills locally). A payload of
        another geometry or dtype raises ValueError."""
        self._check_handoff("import_prefix")
        self._check_payload(payload)
        return self._run_transfer({"kind": "import", "payload": payload})

    def _check_payload(self, payload) -> None:
        """The receiver's compatibility gate, on the caller's thread, so
        a bad payload fails fast instead of poisoning the serve loop
        (JAX :2710-2751)."""
        if not isinstance(payload, dict):
            raise ValueError("import_prefix: payload must be the dict "
                             "export_prefix produced")
        n = int(payload.get("pages", 0))
        ps = int(payload.get("page_size", 0))
        toks = payload.get("tokens") or []
        if n < 1 or n > self.max_pages_per_slot:
            raise ValueError(
                f"import_prefix: {n} pages outside [1, "
                f"{self.max_pages_per_slot}] for this engine")
        if ps != self.page_size:
            raise ValueError(
                f"import_prefix: payload page_size {ps} != engine "
                f"page_size {self.page_size}")
        if len(toks) != n * ps:
            raise ValueError(
                f"import_prefix: {len(toks)} prefix tokens for {n} "
                f"pages of {ps}")
        if str(payload.get("dtype")) != self.kv_pool_dtype():
            raise ValueError(
                f"import_prefix: payload kv dtype "
                f"{payload.get('dtype')} != pool "
                f"{self.kv_pool_dtype()} — a cross-dtype splice would "
                f"decode garbage")
        for name, pools in zip(("k", "v", "ks", "vs"), self._pools):
            rows = payload.get(name) or []
            if len(rows) != len(pools):
                raise ValueError(
                    f"import_prefix: {len(rows)} '{name}' layer blocks "
                    f"vs {len(pools)} pools (int8 (data, scale) pairs "
                    f"must travel together)")
            for i, (r, pool) in enumerate(zip(rows, pools)):
                if tuple(r.shape[1:]) != tuple(pool.shape[1:]):
                    raise ValueError(
                        f"import_prefix: '{name}' layer {i} page shape "
                        f"{tuple(r.shape[1:])} != pool "
                        f"{tuple(pool.shape[1:])}")

    def _run_transfer(self, op: dict):
        """Apply `op` on the serve thread (inbox, wake, wait) or inline
        when no serve loop runs. The waiter watches the loop's liveness,
        so a poisoned loop fails the hand-off instead of hanging it."""
        op["done"] = threading.Event()
        op["result"] = None
        op["error"] = None
        with self._lock:
            alive = (self._thread is not None and self._running
                     and self._broken is None)
            if alive:
                self._xfers.append(op)
                self._work.notify()
        if not alive:
            with torch.inference_mode():
                self._apply_transfer(op)
        else:
            while not op["done"].wait(timeout=0.05):
                if self._broken is not None or self._thread is None \
                        or not self._thread.is_alive():
                    if not op["done"].is_set():
                        state = (f"broken: {self._broken}" if self._broken
                                 else "stopped")
                        raise RuntimeError(
                            f"page transfer failed: engine {state}")
        if op["error"] is not None:
            raise op["error"]
        return op["result"]

    def _apply_transfers(self) -> bool:
        """The serve thread's inbox drain, at the top of every round."""
        did = False
        while True:
            with self._lock:
                if not self._xfers:
                    return did
                op = self._xfers.popleft()
            self._apply_transfer(op)
            did = True

    def _fail_transfers(self, msg: str) -> None:
        while True:
            with self._lock:
                if not self._xfers:
                    return
                op = self._xfers.popleft()
            op["error"] = RuntimeError(msg)
            op["done"].set()

    def _apply_transfer(self, op: dict) -> None:
        try:
            if op["kind"] == "export":
                op["result"] = self._do_export(op["prompt"])
            else:
                op["result"] = self._do_import(op["payload"])
        except Exception as e:  # noqa: BLE001: the waiter re-raises; a
            # failed transfer never poisons the serve loop
            op["error"] = e
        op["done"].set()

    def _do_export(self, prompt: List[int]):
        match = self._prefix.lookup(prompt)
        n = match.full_pages
        if n <= 0:
            return None
        # pinned against eviction across the gather
        self._prefix.acquire(match)
        try:
            rows_k, rows_v, rows_ks, rows_vs = self._dispatch(
                "export", (), {"ids": np.asarray(match.pages[:n],
                                                 np.int64)})
            payload = {
                "tokens": list(prompt[: n * self.page_size]),
                "pages": n,
                "page_size": self.page_size,
                "dtype": self.kv_pool_dtype(),
                "k": list(rows_k), "v": list(rows_v),
                "ks": list(rows_ks), "vs": list(rows_vs),
            }
        finally:
            self._prefix.unacquire(match)
        self._transfers_out += 1
        self._transfer_pages_out += n
        self.recorder.record("xfer.export", pages=n,
                             tokens=len(payload["tokens"]))
        return payload

    def _do_import(self, payload):
        n = int(payload["pages"])
        if n > len(self._free_pages):
            self._free_pages.extend(
                self._prefix.evict(n - len(self._free_pages)))
        if n > len(self._free_pages):
            return False  # the pool is full of live pages: prefill locally
        pages = [self._free_pages.pop() for _ in range(n)]
        rows = tuple(tuple(r if isinstance(r, torch.Tensor)
                           else torch.from_numpy(np.array(r))
                           for r in payload[name])
                     for name in ("k", "v", "ks", "vs"))
        self._dispatch("import", (), {"ids": np.asarray(pages, np.int64),
                                      "rows": rows})
        rejected = self._prefix.insert_chain(
            [int(t) for t in payload["tokens"]], pages)
        self._free_pages.extend(rejected)
        registered = n - len(rejected)
        self._transfers_in += 1
        self._transfer_pages_in += registered
        self.recorder.record("xfer.import", pages=n, registered=registered)
        return {"pages": n, "registered": registered}

    # -- modeled backlog and admission (JAX :2889-2949) ----------------------

    def modeled_request_flops(self, prompt_tokens: int,
                              gen_tokens: int, start: int = 0):
        """Modeled FLOPs to finish one request from cache length `start`:
        the per-request cost record's integral. None when the cost
        registry is off."""
        if self.costs is None:
            return None
        final = prompt_tokens + gen_tokens
        start = min(max(int(start), 0), final)
        return (self._cost_fpt_linear * (final - start)
                + 0.5 * self._cost_attn_coeff
                * (float(final) ** 2 - float(start) ** 2))

    def modeled_backlog_flops(self):
        """Modeled FLOPs queued on this engine: each queued request from
        zero, each live slot from its cache length. The router's
        placement signal; None when the cost registry is off."""
        if self.costs is None:
            return None
        total = 0.0
        with self._lock:
            work = [(len(r.prompt), r.tokens_to_generate, 0)
                    for r in self._queue]
            for i, s in enumerate(self._slots):
                r = s.req
                if r is not None:
                    work.append((len(r.prompt), r.tokens_to_generate,
                                 int(self._lengths[i])))
        for plen, gen, start in work:
            total += self.modeled_request_flops(plen, gen, start)
        return total

    def modeled_backlog_seconds(self):
        """Modeled seconds to drain the backlog at the card's peak:
        backlog FLOPs / (peak x serving_tp). None without a cost registry
        and a chip spec."""
        fl = self.modeled_backlog_flops()
        if fl is None or self.chip is None:
            return None
        dtype = "int8" if self.quantize_weights else "bf16"
        rate = self.chip.peak_flops_for(dtype) * max(self.serving_tp, 1)
        return fl / max(rate, 1.0)

    def retry_after_s(self) -> float:
        """The Retry-After of a 503: the modeled drain time clamped to
        [1, 60] s; 1 s without a cost registry."""
        s = self.modeled_backlog_seconds()
        if s is None:
            return 1.0
        return float(min(max(s, 1.0), 60.0))

    # -- the profiler hook (POST /profile; JAX :2006-2071) -------------------

    def request_profile(self, rounds: int,
                        trace_dir: Optional[str] = None) -> dict:
        """Arm a `torch.profiler` trace of the next `rounds` rounds that
        do work: started before the next round the serve loop runs,
        stopped once `rounds` have completed, written as a Chrome trace
        (`profile_<tag>_<pid>.json`) into `trace_dir` (default the
        engine's, else ./profile). On a CUDA engine the trace holds the
        card's kernels and copies (CUDA activity), on the CPU the host's
        ops. Failures to start or stop are logged no-ops recorded in the
        flight ring; a second request while one is armed or running is
        refused."""
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        d = trace_dir or self.trace_dir or "./profile"
        with self._lock:
            if self._profile_active or self._profile_pending is not None:
                return {"ok": False,
                        "error": "a profiler capture is already in "
                                 "progress"}
            self._profile_pending = (int(rounds), d)
            self._work.notify()
        self.recorder.record("profile_armed", rounds=int(rounds), dir=d)
        return {"ok": True, "rounds": int(rounds), "trace_dir": d}

    def _start_profile(self) -> None:
        with self._lock:
            pending, self._profile_pending = self._profile_pending, None
            if pending is not None:
                rounds, d = pending
                self._profile_active = True
                self._profile_left = rounds
                self._profile_dir = d
        if pending is None:
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            act = (ProfilerActivity.CUDA if self.device.type == "cuda"
                   else ProfilerActivity.CPU)
            self._profiler = profile(activities=[act])
            self._profiler.start()
        except Exception as e:  # noqa: BLE001: a diagnostic, never a crash
            self._profiler = None
            with self._lock:
                self._profile_active = False
            _logger.warning("torch.profiler capture unavailable (%r): the "
                            "/profile request is a no-op", e)
            self.recorder.record("profile_unsupported", error=repr(e))
            return
        self.recorder.record("profile_start", rounds=rounds, dir=d)

    def _tick_profile(self, did: bool) -> None:
        if did:
            self._profile_left -= 1
        if self._profile_left <= 0:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if not self._profile_active:
            return
        path = None
        try:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self._profiler.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            path = os.path.join(
                self._profile_dir,
                f"profile_{self._name('engine')}_{os.getpid()}.json")
            # the raw kineto events: the parsed event list of a window of
            # many thousand kernels takes the host minutes
            self._profiler.profiler.kineto_results.save(path)
        except Exception as e:  # noqa: BLE001
            _logger.warning("torch.profiler stop failed: %r", e)
            path = None
        self._profiler = None
        self._profile_path = path
        with self._lock:
            self._profile_active = False
        self.recorder.record("profile_done", dir=self._profile_dir,
                             path=path)
        _logger.info("profiler capture complete: %s", path)

    # -- serve thread --------------------------------------------------------

    def _fail_all(self, msg: str):
        """Fail every queued and in-flight request, so no waiter hangs on
        a dead engine."""
        self._fail_transfers(msg)
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
        _logger.info("%s", self.describe())

        def loop():
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while self._running:
                try:
                    did = self.step()
                    if (not did and self._ctx is not None
                            and time.monotonic() - self._last_dispatch
                            > HEARTBEAT_S):
                        self._dispatch("noop")
                except Exception as e:  # noqa: BLE001: fail loudly, never hang
                    self._broken = f"engine step failed: {e!r}"
                    _logger.exception("serve loop died; failing all "
                                      "in-flight requests")
                    # the postmortem before _fail_all clears the slots:
                    # what the engine was doing when it died, by rid
                    self.recorder.record(
                        "poison", error=repr(e), round=self._rounds,
                        queue_depth=len(self._queue),
                        live_rids=[s.req.rid for s in self._slots
                                   if s.req is not None])
                    self.recorder.note_counters(self.counters())
                    self.recorder.dump(
                        self.record_dir, self._name("engine-poison"),
                        extra={"costs": self.costs.snapshot()}
                        if self.costs is not None else None)
                    self._stop_profile()
                    self._fail_all(self._broken)
                    self._release()
                    self._running = False
                    return
                if not did:
                    with self._work:
                        if self._running:
                            self._work.wait(timeout=0.05)
            # a capture still running ends on the thread that started it
            self._stop_profile()

        self._thread = threading.Thread(
            target=loop, daemon=True, name=self._name("decode-engine"))
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the serve thread; drain=True finishes every admitted and
        queued request first, drain=False fails them. A tp leader then
        sends its followers the stop descriptor (also when it drained
        without the serve thread)."""
        if self._thread is None:
            self._release()
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
        # a transfer queued after the loop's last drain would hang its
        # waiter: sweep the inbox now the loop is gone
        self._fail_transfers("engine stopped")
        if self.trace_dir:
            path = self.tracer.export(os.path.join(
                self.trace_dir,
                f"trace_{self._name('engine')}_{os.getpid()}.json"))
            if path:
                _logger.info("engine span trace exported to %s "
                             "(Perfetto / chrome://tracing)", path)
        if not drain:
            self._fail_all("engine stopped")
        self._release()

    # -- observability -------------------------------------------------------

    def kv_pool_dtype(self) -> str:
        """The pools' storage dtype as the JAX engine names it
        ('bfloat16', 'float32', 'int8')."""
        return str(self._pools[0][0].dtype).replace("torch.", "")

    def _name(self, base: str) -> str:
        """`base` tagged with the replica id when one is set (JAX
        :1354-1360)."""
        if self.replica_id is None:
            return base
        return f"{base}-r{self.replica_id}"

    def describe(self) -> str:
        """The start line (JAX :3145-3165): slots, pool pages and the
        pool's bytes on this rank (its g / tp groups at tp > 1), and at
        tp > 1 that rounds run uncaptured."""
        return (
            "decode engine%s: %d slots, paged KV pool kv_dtype=%s%s — "
            "%d pages x %d tokens = %d KV positions, %.1f MiB/chip pool "
            "(%d bytes/token/chip)%s" % (
                "" if self.replica_id is None
                else f" [replica {self.replica_id}]",
                self.slots, self.kv_pool_dtype(),
                "" if self.serving_tp == 1
                else f" tp={self.serving_tp} (group-sharded, "
                     f"{self._ctx.backend}, rounds uncaptured)",
                self.num_pages - 1, self.page_size,
                (self.num_pages - 1) * self.page_size,
                self.kv_pool_bytes() / 2**20, self.kv_bytes_per_token(),
                ", weight-only int8 decode matmuls"
                if self.quantize_weights else ""))

    def kv_pool_bytes(self) -> int:
        """Device bytes the paged KV pools hold on this rank, data and
        (int8) scale pools, summed over layers: at tp > 1 the rank's
        g / tp groups, 1 / tp of one card's bytes (JAX :3267-3282)."""
        return sum(x.numel() * x.element_size()
                   for group in self._pools for x in group)

    def kv_bytes_per_token(self) -> int:
        """KV bytes one cached token costs across all layers (K and V
        data and any scales)."""
        return round(self.kv_pool_bytes()
                     / (self.num_pages * self.page_size))

    def round_summary(self) -> dict:
        """The logged rounds' wall times: ms per decode-token advance
        over the decode rounds, and the median mixed round, with their
        counts and the paged forwards they ran."""
        with self._lock:
            rounds = list(self._round_log)
        dec = [r for r in rounds
               if not r["prefill_tokens"] and "spec_emitted" not in r]
        mixed = sorted(r["ms"] for r in rounds if r["prefill_tokens"])
        return {
            "rounds": len(rounds),
            "paged_forwards": sum(r["decode_steps"] for r in rounds),
            "decode_rounds": len(dec),
            "decode_ms_per_advance": sum(r["ms"] for r in dec)
            / max(sum(r["decode_steps"] for r in dec), 1),
            "mixed_rounds": len(mixed),
            "mixed_round_ms_p50": mixed[len(mixed) // 2] if mixed else 0.0}

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
        out = {}
        if self.replica_id is not None:
            # first, and absent on untagged engines (JAX :3333-3338)
            out["serve_replica_id"] = self.replica_id
        out |= {
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
        if self.costs is not None:
            # present only with the registry on (the JAX schema's gate)
            out["serve_modeled_gflops"] = round(self._modeled_gflops, 3)
            out["serve_page_rounds"] = self._page_rounds
            out["serve_cost_records"] = self.costs.captures
            if self.chip is not None:
                out["serve_chip_spec"] = self.chip.label()
            if self._modeled_device_ms > 0 and self._measured_round_ms > 0:
                out["serve_dispatch_overhead_pct"] = round(
                    (self._measured_round_ms - self._modeled_device_ms)
                    / self._measured_round_ms * 100, 2)
        if self._sentinel is not None:
            out["serve_perf_regressions"] = self._sentinel.trips
            out["serve_perf_bad_rounds"] = self._sentinel.bad_total
        if self._transfers_out or self._transfers_in:
            # present once this engine has shipped or received pages
            out["serve_transfers_out"] = self._transfers_out
            out["serve_transfer_pages_out"] = self._transfer_pages_out
            out["serve_transfers_in"] = self._transfers_in
            out["serve_transfer_pages_in"] = self._transfer_pages_in
        if self.serving_tp > 1:
            # the port's: tp rounds are uncaptured (gloo collectives
            # cannot be captured), never a silent switch
            out["serve_captured"] = False
        return out

    def export_gauges(self, timers=None):
        """Every counter as a gauge of `timers` (default the engine's)."""
        timers = timers if timers is not None else self.timers
        if timers is None:
            return
        for name, value in self.counters().items():
            timers.gauge(name, value)

    def histograms(self):
        """The latency histograms: TTFT, ms per decode advance a round,
        queue wait."""
        return list(self._hists.values())

    def prometheus_metrics(self) -> str:
        """The Prometheus text exposition of GET /metrics under content
        negotiation: every numeric counter a gauge, string facts one info
        metric, the histograms, and with the cost registry on its labeled
        cost samples. The JSON path (counters()) is untouched."""
        text = render_prometheus(self.counters(), self.histograms())
        if self.costs is not None:
            lines = self.costs.prometheus_lines()
            if lines:
                text += "\n".join(lines) + "\n"
        return text

    def flight_record(self) -> dict:
        """The flight recorder's snapshot with live counters (GET
        /flight_record), and the cost table with the registry on."""
        self.recorder.note_counters(self.counters())
        return self.recorder.snapshot(
            reason="on-demand",
            extra={"costs": self.costs.snapshot()}
            if self.costs is not None else None)
