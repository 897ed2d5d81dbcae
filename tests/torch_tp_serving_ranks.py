"""Rank programs of the port's tensor-parallel serving tests
(tests/test_torch_tp_serving.py).

Each function here runs in every rank of a gloo CPU process group that
`megatron_llm_tpu_torch.utils.virtual_mesh.spawn_cpu_group` starts, so
this module imports torch and the port only: a rank never imports JAX.
Inputs and results are numpy arrays and plain Python values.

Run as a script under torchrun it is the launcher's test:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_tp_serving_ranks.py <dir>

runs `run_text_generation_server.main` with the argv of <dir>/spec.pkl
on the CPU in fp32; tp rank 0 sends the spec's HTTP requests to its own
server, writes the answers, the banner and the engine's counters to
<dir>/rank0.pkl and stops the server, which releases the other ranks.
"""

import contextlib
import io
import json
import os
import pickle
import sys
import time
from http.client import HTTPConnection

import numpy as np
import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.convert.from_jax import (
    params_from_jax,
    rank_params_from_jax,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    initialize_parallel,
)

# tests/torch_parity.py's tiny GQA Llama (2 layers, 2 KV groups of 2
# query heads, d 128), fp32
TINY = dict(hidden_size=512, num_attention_heads=4, num_attention_heads_kv=2,
            kv_channels=128, ffn_hidden_size=256)


def tiny_cfg(window=None, max_pos=128):
    return tiny_config(**TINY, compute_dtype=torch.float32,
                       attention_window_size=window, seq_length=max_pos,
                       max_position_embeddings=max_pos)


def _np_pools(eng):
    return [[x.numpy().copy() for x in group] for group in eng._pools]


def _traffic(eng, traffic):
    reqs = [eng.submit(list(p), g, top_k=1, return_log_probs=lp)
            for p, g, lp in traffic]
    eng.drain()
    return [r.result(timeout=60) for r in reqs]


# ---------------------------------------------------------------------------
# the engine at serving_tp 2
# ---------------------------------------------------------------------------

def engine_runs(cases, params_by_model):
    """For each (name, model key (window, max_pos), engine kwargs,
    traffic): a tp 2 engine built on every rank from the whole tree;
    rank 0 submits the traffic and drains it, then stops (releasing the
    follower), the follower runs `follow()`. Each rank returns its pools,
    gauges and chosen tokens a round; rank 0 also the streams, counters
    and free pages."""
    out = []
    rank = dist.get_rank()
    for name, key, kw, traffic in cases:
        cfg = tiny_cfg(*key)
        model = LlamaModel(cfg, device="cpu")
        params = params_from_jax(params_by_model[key], cfg, device="cpu")
        eng = DecodeEngine(model, params, serving_tp=2, **kw)
        res = {"name": name, "tp_rank": eng.tp_rank,
               "kv_pool_bytes": eng.kv_pool_bytes(),
               "kv_bytes_per_token": eng.kv_bytes_per_token()}
        if rank == 0:
            res["streams"] = _traffic(eng, traffic)
            res["counters"] = eng.counters()
            res["free_pages"] = sorted(eng._free_pages)
            res["num_pages"] = eng.num_pages
            res["spec"] = (eng._spec_rounds, eng._spec_proposed,
                           eng._spec_accepted)
            res["describe"] = eng.describe()
            eng.stop()
        else:
            eng.follow()
        res["pools"] = _np_pools(eng)
        res["rounds"] = [x.copy() for x in eng._round_tokens]
        out.append(res)
    return out


def leader_death(params_np):
    """The leader's serve loop dies between rounds (its admission raises)
    while a follower waits for the next round: the loop fails the
    request, sends the stop, and the follower's `follow()` returns.
    Each rank returns what it saw and its seconds."""
    cfg = tiny_cfg()
    model = LlamaModel(cfg, device="cpu")
    params = params_from_jax(params_np, cfg, device="cpu")
    eng = DecodeEngine(model, params, serving_tp=2, slots=2, page_size=16,
                       max_context=64, prefill_chunk_tokens=8,
                       vocab_size=256)
    t0 = time.monotonic()
    if eng.tp_rank > 0:
        eng.follow()
        return {"follower_returned": True, "s": time.monotonic() - t0,
                "rounds": len(eng._round_tokens)}
    eng.start()
    first = eng.submit([5, 6, 7, 8, 9], 6, top_k=1)
    first.result(timeout=60)

    def broken():
        raise RuntimeError("injected admission fault")

    eng._admit = broken
    second = eng.submit([10, 11, 12], 4, top_k=1)
    try:
        second.result(timeout=60)
        error = None
    except RuntimeError as e:
        error = str(e)
    eng._thread.join(timeout=60)
    health = eng.health()
    eng.stop()
    return {"error": error, "health": health, "released": eng._released,
            "s": time.monotonic() - t0, "rounds": len(eng._round_tokens)}


def follower_death(params_np):
    """A follower's round raises (its third call): it leaves the group,
    and the leader's serve loop fails at its next collective with it,
    so its health turns broken (GET /health: 503). Each rank returns
    what it saw."""
    cfg = tiny_cfg()
    model = LlamaModel(cfg, device="cpu")
    params = params_from_jax(params_np, cfg, device="cpu")
    eng = DecodeEngine(model, params, serving_tp=2, slots=2, page_size=16,
                       max_context=64, prefill_chunk_tokens=8,
                       vocab_size=256)
    if eng.tp_rank > 0:
        run, calls = eng._run, []

        def failing(kind, key, args):
            calls.append(kind)
            if len(calls) == 3:
                raise RuntimeError("injected follower fault")
            return run(kind, key, args)

        eng._run = failing
        try:
            eng.follow()
            return {"error": None}
        except RuntimeError as e:
            return {"error": str(e), "calls": calls}
    eng.start()
    req = eng.submit(list(range(5, 25)), 8, top_k=1)
    try:
        req.result(timeout=60)
        error = None
    except RuntimeError as e:
        error = str(e)
    eng._thread.join(timeout=60)
    health = eng.health()
    eng.stop()
    return {"error": error, "health": health}


# ---------------------------------------------------------------------------
# the whole-batch route and the pp x tp stage ring
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """Integer pass-through text ("12 7 3"), eod 255."""

    vocab_size = 256
    eod = 255

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(int(t)) for t in ids)


def api_requests(params_np, prompts, max_pos=128):
    """The API under a tp 2 context, every rank the same requests: a
    score, a greedy request with log-probs, a sampled one (seed 7) and a
    beam request, on each rank's tp slices. Each answer as numpy."""
    from megatron_llm_tpu_torch.inference import api

    cfg = tiny_cfg(max_pos=max_pos)
    ctx = initialize_parallel(tp=2, device="cpu")
    tok = ByteTokenizer()
    try:
        model = LlamaModel(cfg, device="cpu")
        local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
        out = {}
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
            texts, _, lp, toks = call()
            out[name] = (texts, None if lp is None else np.asarray(lp),
                         np.asarray(toks))
        return out
    finally:
        destroy_parallel()


def ring_decode(cfg_kw, params_np, tokens, lengths, prefill, pp=2, tp=2):
    """The stage ring at pp x tp (`make_pipelined_decode_fn`): its
    (tokens, generated lengths, log-probs) on every rank."""
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_decode_fn,
    )

    cfg = tiny_config(**cfg_kw)
    ctx = initialize_parallel(dp=dist.get_world_size() // (pp * tp), pp=pp,
                              tp=tp, device="cpu")
    try:
        model = LlamaModel(cfg, device="cpu")
        local = rank_params_from_jax(params_np, cfg, ctx, device="cpu")
        dec = make_pipelined_decode_fn(
            model, None, ctx, prefill_len=prefill, max_len=tokens.shape[1],
            return_log_probs=True)
        toks, lens, lps = dec(local, tokens, lengths)
        return toks.numpy(), lens.numpy(), lps.numpy()
    finally:
        destroy_parallel()


def suite(jobs):
    """Run `jobs`, a list of (function name, args) of this module, in
    order in the same ranks; their results in order."""
    torch.set_num_threads(1)
    return [globals()[name](*args) for name, args in jobs]


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------

def http_put(port, payload, timeout=120):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, json.loads(data)


def launch(argv, payloads, device="cpu"):
    """`run_text_generation_server.main(argv)` in fp32 on this rank; on
    tp rank 0 the answers to `payloads` (PUT /api, in order), the
    engine's counters and the lines the launcher printed."""
    from megatron_llm_tpu_torch.tools import run_text_generation_server \
        as rtgs

    inner = rtgs.llama_config
    rtgs.llama_config = lambda *a, **kw: inner(
        *a, compute_dtype=torch.float32, **kw)
    got = {}

    def ready(launched):
        try:
            got["answers"] = [http_put(launched.port, p) for p in payloads]
            eng = launched.server.engine
            got["counters"] = eng.counters() if eng is not None else None
        finally:
            launched.stop()

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rtgs.main(argv, device=device, ready=ready)
    finally:
        rtgs.llama_config = inner
    got["lines"] = buf.getvalue().splitlines()
    return got


if __name__ == "__main__":
    d = sys.argv[1]
    with open(os.path.join(d, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    rank = os.environ["RANK"]
    res = launch(spec["argv"], spec["payloads"])
    res["jax_modules"] = sorted(m for m in sys.modules if m == "jax" or
                                m.startswith(("jax.", "megatron_llm_tpu.")))
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
