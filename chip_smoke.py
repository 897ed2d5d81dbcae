#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one output line each (a failure raises and exits non-zero):

1. device: the card's name and power limit from nvidia-smi;
2. build: the hand-written kernels built from this checkout's sources
   (nvcc for the CUDA C++ decode attention, Triton's compiler for the
   RMSNorm), timed;
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16, max-abs 2e-2: the decode
   kernel rounds p to bf16 before normalising, the plain version after),
   and each kernel's time beside its plain version's, one library call's
   and the least time the card could take;
4. serving: Llama-2-7B at full width and depth, random bf16 weights from
   a fixed seed on the card, behind the port's HTTP server
   (`MegatronServer`, whole-batch route): a greedy batch of 4 prompts, a
   sampled, a score-only and a beam request. The launch counters are set
   to 0 before the requests and read after; the decode kernel must have
   run 32 times per decode step;
5. path check: the greedy output teacher-forced back through the same
   cached decode path with the kernels off (plain RMSNorm, plain decode
   attention) on the card; log-probs within 5e-2 max-abs. Greedy tokens
   are not required to match (a random-init 7B has near-flat logits, so
   argmax flips on bf16 rounding): their match fraction is printed;
6. throughput of the greedy batch: prefill ms, decode ms per step beside
   the weight-streaming floor, tokens/s.

Then one JSON line of the kernels, the nvidia-smi line, and the last
line `{"ok": true, "device": {...}}`. Without a CUDA card it exits 2 and
prints no result.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from http.client import HTTPConnection

import numpy as np
import torch

from megatron_llm_tpu_torch.config import llama_config
from megatron_llm_tpu_torch.inference.generation import (
    bucket_prefill_len,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.inference.tokenization import tokenize_prompts
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.ops import _build
from megatron_llm_tpu_torch.ops import decode_attention as dec
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_TOL = 2e-2
PATH_LP_TOL = 5e-2
SEED = 0
# Random weights at the config's init std (0.02) make a 7B whose log-probs
# move by ~0.2 under any one-ulp bf16 change (measured on the H100: the
# kernels-off no-cache forward differs from the kernels-off cached path
# by 0.23), which hides the kernels' own error. At 0.005 that noise floor
# is ~0.016 and the 5e-2 path check measures the kernels. `--init-std`
# sets it.
INIT_STD = 0.005


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase, **kw):
    print(f"{phase}: " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=100, warmup=5) -> float:
    """Mean ms per call on CUDA events, after a warm-up, launched from
    the host one call at a time (a short kernel then measures the host's
    launch rate, not the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, per_graph=50, replays=10) -> float:
    """Mean ms per call on the card: `per_graph` calls captured in one
    CUDA graph, replayed and timed on CUDA events, so the host's launch
    cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * per_graph)


def rotating(make, n):
    """A call that cycles through n independent input sets, so repeated
    launches find the inputs out of L2 as the serving path does (each
    layer reads its own cache)."""
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]
    return pick


# ---------------------------------------------------------------------------
# phases 2-3: build and kernel checks
# ---------------------------------------------------------------------------


def build_kernels():
    t0 = time.perf_counter()
    proc, lib = _build.start_build("decode_attention.cu")  # nvcc, async
    x = torch.randn(4, 4096, device="cuda", dtype=torch.bfloat16)
    rms.fused_rms_norm(x, torch.ones(4096, device="cuda",
                                     dtype=torch.bfloat16))  # Triton JIT
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    _build.finish_build(proc, lib)
    dec._library()
    say("build", decode_attention_cu_s=round(time.perf_counter() - t0, 2),
        rmsnorm_triton_s=round(t_triton, 2), library=lib.name)


def check_decode_kernel():
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for label, (b, g, qpk, d) in (("llama2_7b", (4, 32, 1, 128)),
                                  ("llama2_70b_attn", (4, 8, 8, 128))):
        T = 320
        q = torch.randn(b, 1, g, qpk, d, generator=gen, device="cuda").to(bf)
        k = torch.randn(b, g, T, d, generator=gen, device="cuda").to(bf)
        v = torch.randn(b, g, T, d, generator=gen, device="cuda").to(bf)
        for length in (1, 63, 64, 65, 320):
            got = dec.decode_attention(q, k, v, length)
            ref = dec._xla_decode(q, k, v, length)
            torch.cuda.synchronize()
            check(torch.isfinite(got.float()).all(), f"K1 {label} finite")
            err = (got.float() - ref.float()).abs().max().item()
            errs[f"{label}_len{length}"] = err
            check(err <= BF16_TOL, f"K1 {label} length {length}: {err}")
    say("kernel_check_decode_attention", max_abs_err=errs, tol=BF16_TOL)

    # time at the 7B decode shape at the longest cache the greedy batch
    # reaches, over 8 input sets (168 MB > the 50 MB L2)
    b, g, qpk, d, T = 4, 32, 1, 128, 320

    def make(i):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(bf)
                     for shape in ((b, 1, g, qpk, d), (b, g, T, d),
                                   (b, g, T, d)))
    pick = rotating(make, 8)
    eager_ms = time_ms(lambda: dec.decode_attention(*pick(), T))
    kernel_ms = device_ms(lambda: dec.decode_attention(*pick(), T))
    plain_ms = device_ms(lambda: dec._xla_decode(*pick(), T))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        q, k, v = pick()
        return sdpa(q.reshape(b, g * qpk, 1, d), k, v)
    library_ms = device_ms(library)
    nbytes = 2 * b * g * T * d * 2 + 2 * b * g * qpk * d * 2
    flops = 4 * b * g * qpk * T * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "megatron_llm_tpu_torch/csrc/decode_attention.cu",
        "replaces": "megatron_llm_tpu/ops/decode_attention.py:115",
        "max_abs_err": max(errs.values()), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "eager_launch_ms": eager_ms,
        "shape": f"b{b} g{g} qpk{qpk} d{d} length{T} bf16",
    }


def check_rmsnorm_kernel():
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    h = 4096
    scale = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
    errs = {}
    for n in (4, 4 * 64):
        x = torch.randn(n, h, generator=gen, device="cuda").to(bf)
        got = rms.fused_rms_norm(x, scale, 1e-5)
        ref = rms.rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        errs[f"n{n}"] = (got.float() - ref.float()).abs().max().item()
        check(errs[f"n{n}"] <= BF16_TOL, f"K2 n={n}: {errs[f'n{n}']}")
    say("kernel_check_rmsnorm", max_abs_err=errs, tol=BF16_TOL)

    n = 4  # a decode step's rows at b = 4
    pick = rotating(lambda i: torch.randn(n, h, generator=gen,
                                          device="cuda").to(bf), 64)
    eager_ms = time_ms(lambda: rms.fused_rms_norm(pick(), scale, 1e-5))
    kernel_ms = device_ms(lambda: rms.fused_rms_norm(pick(), scale, 1e-5))
    plain_ms = device_ms(lambda: rms.rms_norm(pick(), scale, 1e-5))
    lib = getattr(torch.nn.functional, "rms_norm", None)
    library_ms = None if lib is None else device_ms(
        lambda: lib(pick(), (h,), scale, 1e-5))
    nbytes = 2 * n * h * 2 + h * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
        4 * n * h / FP32_FLOPS * 1e3
    return {
        "name": "rmsnorm_fwd", "route": "triton",
        "source": "megatron_llm_tpu_torch/ops/rmsnorm.py",
        "replaces": "megatron_llm_tpu/ops/rmsnorm.py:50",
        "max_abs_err": max(errs.values()), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "eager_launch_ms": eager_ms,
        "shape": f"n{n} h{h} bf16",
    }


# ---------------------------------------------------------------------------
# phases 4-6: serving Llama-2-7B
# ---------------------------------------------------------------------------


class ForwardClock:
    """Wraps model.forward: counts single-token forwards and times each
    forward on the host clock between synchronisations."""

    def __init__(self, model):
        self.inner = model.forward
        self.calls = []  # (s, start, end)
        model.forward = self

    def __call__(self, params, tokens, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner(params, tokens, *args, **kw)
        torch.cuda.synchronize()
        self.calls.append((tokens.shape[1], t0, time.perf_counter()))
        return out


def put(port, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    check(resp.status == 200, f"PUT {list(payload)} -> {resp.status} {body}")
    return body


def serve_7b(kernels, init_std):
    t0 = time.perf_counter()
    cfg = llama_config(7, params_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16, use_fused_rmsnorm=True,
                       init_method_std=init_std)
    model = LlamaModel(cfg)
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    say("model", config="llama2-7b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
        ffn=cfg.ffn_hidden_size, vocab=cfg.padded_vocab_size,
        init_std=init_std, weight_bytes=weight_bytes,
        init_s=round(time.perf_counter() - t0, 2))

    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    server = MegatronServer(model, params, tok, engine=None)
    server.run("127.0.0.1", 0, block=False)
    port = server._httpd.server_address[1]
    clock = ForwardClock(model)
    rs = np.random.RandomState(SEED)
    lens = [20, 75, 130, 200]
    prompts = [" ".join(map(str, rs.randint(0, 31999, n))) for n in lens]
    try:
        dec.decode_attention.launches = 0
        rms.fused_rms_norm.launches = 0

        # greedy batch
        clock.calls.clear()
        t_req = time.perf_counter()
        greedy = put(port, {"prompts": prompts, "tokens_to_generate": 64,
                            "logprobs": True, "top_k": 1})
        t_req = time.perf_counter() - t_req
        steps = sum(1 for s, _, _ in clock.calls if s == 1)
        k1_greedy = dec.decode_attention.launches
        check(k1_greedy == cfg.num_layers * steps,
              f"K1 launches {k1_greedy} != {cfg.num_layers} x {steps} steps")
        out_ids = [list(map(int, t.split())) for t in greedy["text"]]
        for ids, n, p in zip(out_ids, lens, prompts):
            check(ids[:n] == list(map(int, p.split())), "prompt echoed")
            check(n < len(ids) <= n + 64, f"greedy length {len(ids)}")
            check(len(ids) == n + 64 or ids[-1] == tok.eod,
                  "row ended short without eod")
        lp = np.asarray(greedy["logprobs"], np.float64)
        check(lp.shape == (4, 319) and np.isfinite(lp).all(),
              f"greedy logprobs {lp.shape}")

        sampled = put(port, {"prompts": prompts[:2], "tokens_to_generate": 32,
                             "top_p": 0.9, "random_seed": 1234})
        for t, n in zip(sampled["text"], lens):
            check(n < len(t.split()) <= n + 32, "sampled length")
        scored = put(port, {"prompts": prompts, "tokens_to_generate": 0,
                            "logprobs": True})
        check(np.isfinite(np.asarray(scored["logprobs"])).all(), "scores")
        check([len(t.split()) for t in scored["text"]] == lens, "score echo")
        beam = put(port, {"prompts": prompts[:1], "tokens_to_generate": 16,
                          "beam_width": 2})
        check(len(beam["text"]) == 2 and len(beam["scores"]) == 2
              and all(lens[0] < len(t.split()) <= lens[0] + 16
                      for t in beam["text"]), "beam answer")
        launches = {"decode_attention": dec.decode_attention.launches,
                    "rmsnorm_fwd": rms.fused_rms_norm.launches}
        check(all(v > 0 for v in launches.values()), f"launches {launches}")
        say("serving", requests=["greedy", "sampled", "score", "beam"],
            greedy_decode_steps=steps, decode_attention_launches_greedy=k1_greedy,
            launches=launches, greedy_request_s=round(t_req, 3))
    finally:
        server.stop()
    kernels[0]["launches"] = launches["decode_attention"]
    kernels[1]["launches"] = launches["rmsnorm_fwd"]

    # phase 5: the greedy output teacher-forced back through the same
    # cached decode path (same prefill bucket, same GEMM shapes) with both
    # kernels off, so that the kernels are the only difference
    model.forward = clock.inner
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    n_out = [len(ids) for ids in out_ids]
    buf = np.full((4, lp.shape[1] + 1), tok.eod, np.int64)
    for i, ids in enumerate(out_ids):
        buf[i, :len(ids)] = ids
    kw = dict(prefill_len=bucket_prefill_len(min(lens)), top_k=1,
              vocab_size=tok.vocab_size, termination_id=tok.eod)
    forced = generate_tokens(plain, params, buf, np.asarray(n_out),
                             return_log_probs=True, **kw)
    forced = forced.log_probs.cpu().numpy()
    err = max(np.abs(forced[i, :n - 1] - lp[i, :n - 1]).max()
              for i, n in enumerate(n_out))
    # greedy tokens of the kernels-off path from the same prompts
    toks0, lens0 = tokenize_prompts(tok, prompts, 64)
    off = generate_tokens(plain, params, toks0, lens0, **kw).tokens
    off = off.cpu().numpy()
    match = sum(int((off[i, n:m] == buf[i, n:m]).sum())
                for i, (n, m) in enumerate(zip(lens, n_out)))
    # for information: the no-cache full forward (other GEMM shapes, so
    # other bf16 rounding) against the served log-probs
    full = score_tokens(plain, params, buf[:, :max(n_out)]).cpu().numpy()
    full_err = max(np.abs(full[i, :n - 1] - lp[i, :n - 1]).max()
                   for i, n in enumerate(n_out))
    say("path_check", max_abs_logprob_err=float(err), tol=PATH_LP_TOL,
        greedy_token_match_fraction=match / sum(m - n for n, m in
                                                zip(lens, n_out)),
        full_forward_max_abs_logprob_err=float(full_err))
    check(err <= PATH_LP_TOL, f"re-scored logprobs {err}")

    # phase 6: throughput of the greedy batch, run again outside the
    # server with the kernels on, warm (cuBLAS and Triton have seen these
    # shapes): once on the wall clock, once with every forward timed
    t0 = time.perf_counter()
    generate_tokens(model, params, toks0, lens0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clock = ForwardClock(model)
    generate_tokens(model, params, toks0, lens0, **kw)
    model.forward = clock.inner
    prefill = [e - s0 for s, s0, e in clock.calls if s > 1]
    steps = [(s0, e) for s, s0, e in clock.calls if s == 1]
    decode_s = steps[-1][1] - steps[0][0]
    # the card's own time for one decode step: a single-token 7B forward
    # (kernels on, cache length 300 of 320) captured in a CUDA graph
    with torch.inference_mode():
        dp = model.prepare_decode_params(params)
        caches = dict(model.init_kv_caches(4, toks0.shape[1]), offset=299)
        tok1 = torch.from_numpy(toks0[:, 299:300]).long().to(model.device)
        step_device_ms = device_ms(
            lambda: model.forward(dp, tok1, kv_caches=caches),
            per_graph=4, replays=5)
    say("throughput", batch=4, prefill_tokens=kw["prefill_len"],
        decode_steps=len(steps), prefill_ms=prefill[0] * 1e3,
        decode_ms_per_step=decode_s / len(steps) * 1e3,
        decode_step_device_ms=step_device_ms,
        device_idle_share=1 - step_device_ms / (decode_s / len(steps) * 1e3),
        weight_stream_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        generate_s=wall, requested_tokens_per_s=4 * 64 / wall,
        decoded_tokens_per_s=4 * len(steps) / decode_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-std", type=float, default=INIT_STD,
                    help="std of the random 7B weights (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    kernels = [check_decode_kernel(), check_rmsnorm_kernel()]
    serve_7b(kernels, args.init_std)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
