#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one output line each (a failure raises and exits non-zero):

1. device: the card's name and power limit from nvidia-smi;
2. build: the hand-written kernels built from this checkout's sources
   (one nvcc per CUDA C++ source, started together; Triton's compiler for
   the RMSNorm), each timed; then ptxas's report of decode_attention.cu,
   flash_attention.cu and paged_attention_tc.cu (`-Xptxas -v`:
   registers, stack and spills of each kernel instance) beside K4's, K5's,
   K6's and K7-tc's dynamic shared memory, the latter with bf16 and with
   int8 pools (ptxas_decode, ptxas_flash, ptxas_paged_tc);
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the shapes of the paths that run it (bf16, max-abs 2e-2: the
   attention kernels round p to bf16 before normalising, the plain
   versions after; flash gradients within 2e-2 of their reference's
   max-abs), and each kernel's time beside its plain version's, one
   library call's and the least time the card could take; K1 at four
   shapes (Llama-2-7B's decode batch, one 4096-position request,
   Llama-2-70B's and Falcon-7B's attention widths) in both cache layouts
   and with a length on the card, both of its designs timed; K7 in both of
   its designs (tc, on the tensor cores, for bf16 q with bf16 or int8
   pools, and present, for fp32 pools) where each takes the shape, at
   Llama-2-7B's,
   Llama-2-70B's and Falcon-7B's (qpk 71, tc only) attention shapes, both
   designs' times in the same call; K7
   also with int8 pools (the tc design's output elements that round
   otherwise than the exact float64 answer, summed over draws, held to
   twice the present design's on the same inputs, and two controls with
   a bf16 or hi/lo p * v_scale operand shown to fail that check), a
   window of 1024 (binding, and covering:
   bitwise the fp launch), both, and three packed documents over one
   slot's pages (kernel_check_paged_variants, kernel_time_paged_variants,
   both designs timed for every variant, and int8 pools at Llama-2-70B's
   widths too), with NaN below every chunk's floor kept out of the
   output;
4. model: Llama-2-7B at full width and depth, random bf16 weights from a
   fixed seed on the card, built once for every route;
5. serving (whole-batch route, `MegatronServer(engine=None)`): a greedy
   batch of 4 prompts, a sampled, a score-only and a beam request. The
   launch counters are set to 0 before the requests and read after; the
   decode kernel must have run 32 times per decode step, the flash
   forward 32 times (the score-only request's no-cache forward);
6. path check: the greedy output teacher-forced back through the same
   cached decode path with the kernels off (plain RMSNorm, plain decode
   attention) on the card; log-probs within 5e-2 max-abs. Greedy tokens
   are not required to match (a random-init 7B has near-flat logits, so
   argmax flips on bf16 rounding): their match fraction is printed;
7. throughput of the greedy batch: prefill ms, decode ms per step beside
   the weight-streaming floor, tokens/s;
8. serving_engine (the continuous-batching route, `MegatronServer(
   engine=DecodeEngine(...))` at the launcher's defaults: 8 slots, page
   64, max_context 2048, horizon 8, chunks of 256, prefix cache on): 16
   requests from concurrent client threads, more than the slots, with
   prompts of 20 to 1500 ids, two sharing a 700-token prefix, one
   sampled and one streamed over SSE. The counters are set to 0 before
   the traffic: the paged kernel must have run 32 times per paged
   forward (every launch its tc design), the RMSNorm kernel too, the
   decode kernel not at all; the
   prefix cache must show a hit and a copy-on-write copy, and every page
   must be free or cached at the end;
9. path_check_engine: the engine's greedy outputs that asked for
   log-probs, re-scored teacher-forced with the kernels off on the card;
   log-probs within 5e-2 max-abs, greedy-token match fraction printed;
10. throughput_engine: wall time and generated tokens/s over the whole
   traffic, ms per decode-token advance and per mixed round, TTFT p50,
   the device ms of one 8-slot paged decode step beside the weight floor
   and the idle share, the device ms of one mixed round's paged forward
   and K7's part of it (torch.profiler), peak memory;
11. serving_engine_int8: the same traffic through the same server with
   int8 pools and int8 weights (`kv_dtype="int8"`,
   `quantize_weights=True`); every K7 launch the int8 variant on the tc
   design; the outputs re-scored teacher-forced on a kernels-off int8
   engine within 5e-2; printed: drift against the bf16 engine, pool bytes
   per token, tokens/s, ms per decode advance, the device ms of a decode
   step and of a mixed round's forward (and K7's part), with K7's tc
   design and, in the same call, with every launch forced to the present
   design;
12. serving_engine_window: a model with `attention_window_size=1024`,
   max_context 4096, 12 requests (8 reaching 1564-3128 positions) queued
   and drained in a pool of 8 x 21 pages that their reach overflows: the
   streams bitwise those of the mask-only engine, pages reclaimed, no
   slot above 21 pages, every page back, a kernels-off windowed re-score
   within 5e-2, every K7 launch the window variant;
13. serving_engine_spec_whole_prompt: 8 requests (4 with repeating
   prompts) over HTTP through the chunked engine, with `spec_decode_k=4`
   and with whole-prompt admission: acceptance, tokens/s and TTFT of
   each, and log-probs within 5e-2 of the chunked engine's over each
   request's common prefix;
14. packed_docs_prefill: three documents packed into one slot's pages,
   prefilled by one paged `LlamaModel.forward` with "doc_starts" floors:
   K7 once per layer, the doc variant each time; log-probs within 5e-2 of
   the kernels-off forward and of each document's own forward;
14b. serving_engine_fp32: Llama-2-7B widths at 2 of 32 layers in fp32
   (weights, compute, pools) behind the same server, 4 requests: every K7
   launch the present design (fp32 pools); log-probs re-scored on a
   kernels-off fp32 engine within 1e-3;
15. train (the serving model and pools freed first): Llama-2-7B widths at
   8 of its 32 layers, seq 4096, flash attention and the fused RMSNorm,
   full recompute, bf16 compute on fp32 params and AdamW state, trained
   for 8 steps of 4 microbatches through `Trainer.setup()` / `train()` on
   one fixed batch of seeded tokens. The counters are set to 0 before
   `train()`: K2-K6 must have run exactly the launches the code implies;
   every loss finite, no step skipped, the last loss below the first;
16. path_check_train (run between setup and training): one microbatch's
   loss and gradients at the initial weights with the kernels on and off
   (grouped attention, plain RMSNorm): loss within 2e-2, global gradient
   norm within 5e-2 relative, every leaf's gradient cosine >= 0.98;
17. throughput_train: median ms per step, tokens/s, model TFLOP/s (6 N
   per token) and its share of 989, peak memory, and a torch.profiler
   trace of one step: the top 10 CUDA kernels by device time, the share
   of the step the card was busy, and the device ms of K4, K5 and K6 in
   the step with their share of it.

Then one JSON line of the kernels, the nvidia-smi line, and the last
line `{"ok": true, "device": {...}}`. Without a CUDA card it exits 2 and
prints no result.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    llama_config,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
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
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.ops.quantization import quantize_rows
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.training.trainer import Trainer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
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


def profiled_ms(fn, iters=20, warmup=3) -> float:
    """Mean device ms per call: the CUDA kernels' time in a torch.profiler
    trace of `iters` calls. For a call that launches several kernels
    through autograd (a library backward), which a CUDA graph does not
    capture here and which CUDA events around the calls would time at the
    host's launch rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


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


CUDA_SOURCES = ("decode_attention.cu", "paged_attention.cu",
                "paged_attention_tc.cu", "flash_attention.cu")


def build_kernels():
    """One nvcc per CUDA C++ source, all started together, while Triton
    compiles the RMSNorm kernel; each build's seconds from the common
    start to its end."""
    t0 = time.perf_counter()
    builds = {src: _build.start_build(src) for src in CUDA_SOURCES}
    x = torch.randn(4, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    rms.fused_rms_norm(x, w)  # Triton JIT of K2
    torch.cuda.synchronize()
    seconds = {"rmsnorm_triton_s": round(time.perf_counter() - t0, 2)}
    t1 = time.perf_counter()
    _, rstd = rms.rms_norm_fwd(x, w, 1e-5, with_rstd=True)
    rms.rms_norm_bwd(x, w, rstd, x)  # K2 with rstd and K3, at first launch
    torch.cuda.synchronize()
    seconds["rmsnorm_bwd_triton_s"] = round(time.perf_counter() - t1, 2)
    pending = dict(builds)
    while pending:
        for src, (proc, lib) in list(pending.items()):
            if proc is None or proc.poll() is not None:
                _build.finish_build(proc, lib)
                key = src.replace(".", "_") + "_s"
                seconds[key] = round(time.perf_counter() - t0, 2)
                del pending[src]
        time.sleep(0.05)
    dec._library()
    pa._library()
    pa._library("tc")
    fa._library("fwd")
    say("build", **seconds,
        libraries=[lib.name for _, lib in builds.values()])
    say("ptxas_decode", **ptxas_of("decode_attention.cu", 0))
    say("ptxas_flash", **ptxas_flash())
    say("ptxas_paged_tc", **ptxas_paged_tc())


def ptxas_report(log):
    """{kernel instance: its registers, stack, spills (and static shared
    memory)} from `nvcc -Xptxas -v` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"((?:flash|paged|decode)_[a-z_]+_kernel)I"
                          r"((?:f|13__nv_bfloat16|L[ib]\d+E)+)E", m.group(1))
            args = re.findall(r"(f|__nv_bfloat16|L[ib]\d+E)",
                              k.group(2)) if k else ()
            args = [{"f": "float", "__nv_bfloat16": "bf16"}.get(
                a, a[2:-1]) for a in args]
            name = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def ptxas_of(source, dyn):
    """ptxas's report of one source's kernels beside their dynamic shared
    memory `dyn`, and the spilled bytes of all of them together."""
    log = _build.build_log(source)
    if log is None:
        return {"report": "not built in this run (library cached)"}
    report = ptxas_report(log)
    spills = sum(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
                 for r in report.values())
    return {"kernels": report, "dynamic_smem_bytes": dyn,
            "spill_bytes": spills}


def ptxas_flash():
    """flash_attention.cu: K4's, K6's and K5's registers, spills and
    dynamic shared memory by head size."""
    smem = fa._library("smem")
    return ptxas_of("flash_attention.cu", {
        f"{label} d{d}": smem(kernel, d)
        for kernel, label in ((0, "flash_fwd"), (1, "flash_bwd_dkv"),
                              (2, "flash_bwd_dq"))
        for d in (64, 128, 256)})


def ptxas_paged_tc():
    """paged_attention_tc.cu: K7's tensor-core design, by head size, with
    bf16 pools (<DP,0>) and int8 pools (<DP,1>)."""
    smem = pa._library("smem")
    return ptxas_of("paged_attention_tc.cu",
                    {f"paged_attn_tc {pools} d{d}": smem(d, int8)
                     for int8, pools in ((0, "bf16"), (1, "int8"))
                     for d in (64, 128, 256)})


# (label, (b, g, qpk, d, T)) of K1's shapes, each timed at length T:
# Llama-2-7B's decode batch at the longest cache the greedy batch reaches
# (the whole-batch route's shape), one long request, Llama-2-70B's and
# Falcon-7B's attention widths (Falcon itself is not served: correctness
# and time only)
DECODE_DESIGNS = ("tensor_cores", "cuda_cores")
DECODE_SHAPES = (("llama2_7b_b4", (4, 32, 1, 128, 320)),
                 ("llama2_7b_b1_long", (1, 32, 1, 128, 4096)),
                 ("llama2_70b_attn", (4, 8, 8, 128, 2048)),
                 ("falcon_7b_attn", (4, 1, 71, 64, 2048)))


def decode_bound_ms(b, g, qpk, d, length, elt=2):
    """K1's least time: K/V of `length` positions, q and out, over 3.35
    TB/s, or 4 flops per (head, position, element) over the peak of the
    units the bf16 launch's design runs its products on (the bf16 tensor
    cores for "tensor_cores", fp32 CUDA cores for "cuda_cores"), whichever
    is larger."""
    nbytes = (2 * b * g * length * d + 2 * b * g * qpk * d) * elt
    flops = 4 * b * g * qpk * length * d
    peak = (BF16_FLOPS if dec.decode_design(torch.bfloat16, qpk)
            == "tensor_cores" else FP32_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_decode_kernel():
    """K1 against its plain version at each shape, in both cache layouts
    (tgd: one layer's slice of a stacked (2, b, T, g, d) cache, read in
    place), at lengths around its split size, with a device-side length
    too, NaN past the length kept out; then each shape's time in both
    designs beside the plain version, SDPA and the bound, in this one
    call."""
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs, plans = {}, {}
    for label, (b, g, qpk, d, T) in DECODE_SHAPES:
        plans[label] = {"design": dec.decode_design(bf, qpk)}
        for design in DECODE_DESIGNS:
            nsplit, S = dec.split_plan(b, g, qpk, d, T, bf, design)
            plans[label][design] = {"nsplit": nsplit, "split": S}
        q = torch.randn(b, 1, g, qpk, d, generator=gen, device="cuda").to(bf)
        stacked = [torch.randn(2, b, T, g, d, generator=gen,
                               device="cuda").to(bf) for _ in range(2)]
        caches = {"tgd": (stacked[0][1], stacked[1][1]),
                  "gtd": (stacked[0][1].transpose(1, 2).contiguous(),
                          stacked[1][1].transpose(1, 2).contiguous())}
        lengths = {1, 63, 64, 65, T}
        for design in DECODE_DESIGNS:
            S = plans[label][design]["split"]
            lengths |= {S - 1, S + 1}
        lengths = sorted(lengths & set(range(1, T + 1)))
        for layout, (k, v) in caches.items():
            for length in lengths:
                ref = dec._xla_decode(q, k, v, length, layout)
                dev_len = torch.tensor(length, dtype=torch.int32,
                                       device="cuda")
                for design in DECODE_DESIGNS:
                    kw = dict(layout=layout, design=design)
                    got = dec.decode_attention(q, k, v, length, **kw)
                    on_card = dec.decode_attention(q, k, v, dev_len, **kw)
                    torch.cuda.synchronize()
                    check(torch.isfinite(got.float()).all(),
                          f"K1 {label} finite")
                    check(torch.equal(got, on_card),
                          f"K1 {label} {design} device length {length}")
                    err = (got.float() - ref.float()).abs().max().item()
                    key = f"{label}_{layout}_{design}"
                    errs[key] = max(errs.get(key, 0.0), err)
                    check(err <= BF16_TOL,
                          f"K1 {label} {layout} {design} length {length}: "
                          f"{err}")
        k, v = caches["gtd"]
        cut = max(1, T // 2 - 3)
        clean = [dec.decode_attention(q, k, v, cut, design=dn)
                 for dn in DECODE_DESIGNS]
        k[:, :, cut:] = float("nan")
        v[:, :, cut:] = float("nan")
        for dn, c in zip(DECODE_DESIGNS, clean):
            dirty = dec.decode_attention(q, k, v, cut, design=dn)
            torch.cuda.synchronize()
            check(torch.equal(c, dirty),
                  f"K1 {label} {dn}: NaN past the length reached the output")
        del q, stacked, caches, k, v
    say("kernel_check_decode_attention", max_abs_err=errs, tol=BF16_TOL,
        splits=plans, nan_past_length="ok")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for label, (b, g, qpk, d, T) in DECODE_SHAPES:
        set_bytes = 2 * b * g * T * d * 2
        n_sets = min(64, max(2, -(-100_000_000 // set_bytes)))  # > 2x L2

        def make(i):
            return tuple(torch.randn(shape, generator=gen,
                                     device="cuda").to(bf)
                         for shape in ((b, 1, g, qpk, d), (b, g, T, d),
                                       (b, g, T, d)))
        pick = rotating(make, n_sets)
        row = {"shape": f"b{b} g{g} qpk{qpk} d{d} length{T} bf16",
               "input_sets": n_sets, **plans[label]}
        row["design"] = plans[label]["design"]
        row["eager_launch_ms"] = time_ms(
            lambda: dec.decode_attention(*pick(), T))
        # both designs in turns
        for design in DECODE_DESIGNS + DECODE_DESIGNS[::-1]:
            row.setdefault(f"{design}_ms", []).append(device_ms(
                lambda: dec.decode_attention(*pick(), T, design=design)))
        row["ms"] = min(row[f"{row['design']}_ms"])
        row["plain_ms"] = device_ms(lambda: dec._xla_decode(*pick(), T),
                                    per_graph=10, replays=5)

        def library():
            q, k, v = pick()
            # the group's qpk heads as qpk query rows over the group's
            # cache: every head sees every position, no mask
            return sdpa(q.reshape(b, g, qpk, d), k, v)
        row["library_ms"] = device_ms(library)
        row["bound_ms"], row["bound_by"] = decode_bound_ms(b, g, qpk, d, T)
        times[label] = row
        del pick
        torch.cuda.empty_cache()
    say("kernel_time_decode_attention", **times)
    main = times["llama2_7b_b4"]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "megatron_llm_tpu_torch/csrc/decode_attention.cu",
        "replaces": "megatron_llm_tpu/ops/decode_attention.py:115",
        "design": "split-cache, merge in the last block; tensor_cores "
                  "(mma.sync) from qpk 4 on, cuda_cores below",
        "max_abs_err": max(errs.values()), "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "eager_launch_ms": main["eager_launch_ms"], "shape": main["shape"],
        "shapes": times,
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


# the engine's pool shape at the smoke's configuration: page 64, 32 pages
# (2048 positions) a slot, 8 slots. (start, chunk_len) per slot.
PAGE, SLOT_PAGES = 64, 32
PAGED_BATCHES = {
    # a decode round: caches ending on both sides of page boundaries,
    # an idle slot, the longest slot
    "decode": (1, [(0, 1), (62, 1), (63, 1), (64, 1), (699, 1),
                   (2046, 1), (0, 0), (1499, 1)]),
    # a mixed round: a first 256-token chunk, a 100-token chunk starting
    # mid-page, six decode rows padded to the chunk width
    "mixed": (256, [(0, 256), (700, 100), (1, 1), (64, 1), (130, 1),
                    (1000, 1), (2046, 1), (511, 1)]),
}


def paged_inputs(batch, g, qpk, d, gen):
    """bf16 inputs of one paged launch with the chunks' K/V already
    scattered; table entries past each slot's reach are the null page."""
    C, spans = PAGED_BATCHES[batch]
    nc = len(spans)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    P = 1 + nc * SLOT_PAGES
    k_pages, v_pages = rnd(P, PAGE, g, d), rnd(P, PAGE, g, d)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(nc, SLOT_PAGES, dtype=torch.int32, device="cuda")
    for c, (start, ln) in enumerate(spans):
        owned = -(-max(start + ln, 1) // PAGE)
        pt[c, :owned] = perm[c * SLOT_PAGES:c * SLOT_PAGES + owned].int()
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32,
                        device="cuda")
    q = rnd(nc, C, g, qpk, d)
    pa.scatter_chunk_kv(rnd(nc, C, g, d), rnd(nc, C, g, d), k_pages,
                        v_pages, pt, starts, lens)
    return q, k_pages, v_pages, pt, starts, lens


def plant_nans(batch, k_pages, v_pages, pt):
    """NaN into the null page, every page no slot owns, and every owned
    position at or past each chunk's end."""
    owned = torch.zeros(k_pages.shape[0], dtype=torch.bool, device="cuda")
    owned[pt.long().flatten()] = True
    owned[0] = False
    k_pages[~owned] = float("nan")
    v_pages[~owned] = float("nan")
    table = pt.cpu().numpy()
    for c, (start, ln) in enumerate(PAGED_BATCHES[batch][1]):
        end = start + ln
        for j in range(end // PAGE, SLOT_PAGES):
            pg = int(table[c, j])
            if pg:
                lo = end - j * PAGE if j == end // PAGE else 0
                k_pages[pg, lo:] = float("nan")
                v_pages[pg, lo:] = float("nan")


def paged_bound_ms(batch, g, qpk, d):
    """The least time for one launch: the larger of the bytes it must
    move (each needed K/V position of each chunk, the valid q rows, the
    whole output) over 3.35 TB/s and its operations (4 per q row, key
    and head dimension over the causal span) over the bf16 peak."""
    C, spans = PAGED_BATCHES[batch]
    kv_pos = sum(start + ln for start, ln in spans if ln)
    q_rows = sum(ln for _, ln in spans)
    nbytes = 2 * (2 * kv_pos * g * d + q_rows * g * qpk * d
                  + len(spans) * C * g * qpk * d)
    flops = 4 * sum(start + t + 1 for start, ln in spans
                    for t in range(ln)) * qpk * g * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# (g, qpk, d) of the attention shapes K7 is held to: Llama-2-7B, Llama-2-70B
# (GQA, qpk 8) and Falcon-7B (multi-query, qpk 71: the tc design only)
PAGED_SHAPES = (("llama2_7b", (32, 1, 128)), ("llama2_70b_attn", (8, 8, 128)),
                ("falcon_7b_attn", (1, 71, 64)))


def paged_designs(qpk):
    return ("tc", "present") if qpk <= 16 else ("tc",)


def check_paged_kernel():
    """K7 in each design that takes the shape against its plain version
    on a decode and a mixed round, pad rows zeros, NaN outside the
    chunks' reach kept out; then both designs' times at the 7B shape in
    one call, beside the plain version, SDPA and the bound. Returns the
    rows of the present design and of the tc design."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {}
    for label, (g, qpk, d) in PAGED_SHAPES:
        for batch in PAGED_BATCHES:
            q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
            ref = pa._xla_paged_reference(q, kp, vp, pt, starts, lens)
            C = q.shape[1]
            pad = torch.arange(C, device="cuda")[None, :] >= lens[:, None]
            got = {}
            for design in paged_designs(qpk):
                got[design] = pa.paged_attention(q, kp, vp, pt, starts, lens,
                                                 design=design)
                torch.cuda.synchronize()
                err = (got[design].float() - ref.float()).abs().max().item()
                errs[f"{label}_{batch}_{design}"] = err
                check(err <= BF16_TOL, f"K7 {design} {label} {batch}: {err}")
                check(bool((got[design][pad] == 0).all()),
                      f"K7 {design} {label} {batch} pad rows")
            del ref
            plant_nans(batch, kp, vp, pt)
            for design in got:
                dirty = pa.paged_attention(q, kp, vp, pt, starts, lens,
                                           design=design)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dirty.float()).all())
                      and torch.equal(dirty, got[design]),
                      f"K7 {design} {label} {batch}: NaN outside the "
                      f"chunks' reach reached the output")
            del q, kp, vp, got
            torch.cuda.empty_cache()
    say("kernel_check_paged_attention", max_abs_err=errs, tol=BF16_TOL,
        nan_guard="ok")

    # time at the 7B shape, rotating over 4 input sets (the needed K/V
    # of one decode set is 73 MB, above the 50 MB L2); both designs in
    # this one call
    g, qpk, d = 32, 1, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for batch in PAGED_BATCHES:
        sets = [paged_inputs(batch, g, qpk, d, gen) for _ in range(4)]
        pick = rotating(lambda i: sets[i], 4)
        design = pa.paged_design(torch.bfloat16, torch.bfloat16, PAGE)
        eager_ms = time_ms(lambda: pa.paged_attention(*pick()))
        by_design = {
            f"{dn}_ms": device_ms(lambda: pa.paged_attention(*pick(),
                                                             design=dn))
            for dn in ("tc", "present")}
        plain_ms = device_ms(lambda: pa._xla_paged_reference(*pick()),
                             per_graph=10, replays=5)
        del sets

        # library yardstick: SDPA on K/V already gathered to the dense
        # (nc, g, T, d) view; the gather itself is left out of its time
        def dense(i):
            q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
            nc, C, gq, hq, dq = q.shape
            T = SLOT_PAGES * PAGE
            k = kp[pt.long()].reshape(nc, T, gq, dq).transpose(1, 2)
            v = vp[pt.long()].reshape(nc, T, gq, dq).transpose(1, 2)
            rows = torch.arange(C, device="cuda")
            mask = (torch.arange(T, device="cuda")[None, None, :]
                    <= (starts[:, None] + rows[None, :])[:, :, None])
            mask |= (rows[None, :, None] >= lens[:, None, None]) \
                & (torch.arange(T, device="cuda") == 0)  # pad rows: col 0
            return (q.reshape(nc, C, gq * hq, dq).transpose(1, 2),
                    k.contiguous(), v.contiguous(), mask[:, None])
        lib = rotating(dense, 4)
        library_ms = device_ms(lambda: _sdpa(sdpa, lib()))
        bound, bound_by = paged_bound_ms(batch, g, qpk, d)
        times[batch] = {"design": design, "ms": by_design[f"{design}_ms"],
                        **by_design, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library_ms,
                        "eager_launch_ms": eager_ms}
        del lib
        torch.cuda.empty_cache()
    say("kernel_time_paged_attention", **times)
    shapes = {"decode": "decode round: 8 slots C1 g32 qpk1 d128 page64 bf16 "
                        "(attended lengths 1,63,64,65,700,2047,idle,1500)",
              "mixed": "mixed round: C256, chunks 256@0 and 100@700, 6 "
                       "decode rows"}
    rows = []
    for design, name, src, main, other in (
            ("present", "ragged_paged_attention", "paged_attention.cu",
             "decode", "mixed"),
            ("tc", "ragged_paged_attention_tc", "paged_attention_tc.cu",
             "mixed", "decode")):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"megatron_llm_tpu_torch/csrc/{src}",
            "replaces": "megatron_llm_tpu/ops/prefill_attention.py:135",
            "max_abs_err": max(v for k, v in errs.items()
                               if k.endswith(design)),
            **times[main], "design": design,
            "ms": times[main][f"{design}_ms"],
            "shape": shapes[main],
            other: dict(times[other], ms=times[other][f"{design}_ms"],
                        shape=shapes[other]),
            "launches_by_path": {}, "launches": 0})
    return rows


def _sdpa(sdpa, args):
    q, k, v, mask = args
    return sdpa(q, k, v, attn_mask=mask)


# K7's variants beside fp pools: (int8 pools, window, document floors).
# The window binds on the longer slots of both batches; "window_covering"
# reaches past every slot and must launch bitwise the fp kernel.
WINDOW = 1024
K7_VARIANTS = {"int8": (True, None, False), "window": (False, WINDOW, False),
               "window_covering": (False, 4096, False),
               "int8_window": (True, WINDOW, False),
               "doc": (False, None, True)}
# three packed documents over slot 0's pages: [0, 700), [700, 1500),
# [1500, 2048); per batch (chunk width, [(start, chunk_len, doc floor)])
PACKED_DOCS = {
    "decode": (1, [(699, 1, 0), (1499, 1, 700), (2047, 1, 1500)]),
    "mixed": (256, [(444, 256, 0), (1244, 256, 700), (1500, 256, 1500)]),
}


def variant_inputs(batch, variant, g, qpk, d, gen):
    """(args, kw) of one K7 launch of `variant` on `batch`: the fp inputs
    of `paged_inputs` with their pools quantized for int8 (the chunks'
    K/V scattered again through the quantizing scatter), or for "doc"
    the three packed documents over one slot's pages."""
    int8, window, doc = K7_VARIANTS[variant]
    if doc:
        C, spans = PACKED_DOCS[batch]
        nc = len(spans)
        P = 1 + nc * SLOT_PAGES  # room for `plant_nans_below` to unshare

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        k_pages, v_pages = rnd(P, PAGE, g, d), rnd(P, PAGE, g, d)
        pt = (torch.randperm(SLOT_PAGES, generator=gen, device="cuda")
              + 1).int()[None].repeat(nc, 1).contiguous()
        starts, lens, floors = (torch.tensor(
            [x[i] for x in spans], dtype=torch.int32, device="cuda")
            for i in range(3))
        q = rnd(nc, C, g, qpk, d)
        pa.scatter_chunk_kv(rnd(nc, C, g, d), rnd(nc, C, g, d), k_pages,
                            v_pages, pt, starts, lens)
        return (q, k_pages, v_pages, pt, starts, lens), dict(
            k_scales=None, v_scales=None, window=window, doc_starts=floors)
    q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = quantize_rows(kp), quantize_rows(vp)
        C = q.shape[1]
        pa.scatter_chunk_kv(*(torch.randn(len(starts), C, g, d,
                                          generator=gen, device="cuda")
                              .to(torch.bfloat16) for _ in range(2)),
                            kp, vp, pt, starts, lens, ks, vs)
    return (q, kp, vp, pt, starts, lens), dict(
        k_scales=ks, v_scales=vs, window=window, doc_starts=None)


def paged_exact(q, k_pages, v_pages, page_table, starts, chunk_lens,
                k_scales=None, v_scales=None, window=None, doc_starts=None,
                pv_terms=None):
    """K7's function in float64 (pools dequantized exactly, the softmax
    and both products in float64): the answer both designs and the plain
    version round, to hold their errors against. With int8 pools and
    `pv_terms`, the PV product instead takes p * v_scale (p before its
    normalisation) as the sum of `pv_terms` bf16 terms, each the bf16
    rounding of what the terms before it left, times the raw integer V,
    as the tc design's wgmmas do: 3 terms keep fp32's 24 significant
    bits, 1 is a single bf16 operand (the control that the error check
    must catch)."""
    nc, C, g, qpk, d = q.shape
    P = k_pages.shape[1]
    T = page_table.shape[1] * P
    pt = page_table.long()
    k, v = k_pages[pt].double(), v_pages[pt].double()
    if k_scales is not None:
        k = k * k_scales[pt].double()[..., None]
        vs = v_scales[pt].double().reshape(nc, T, g).transpose(1, 2)
        if pv_terms is None:
            v = v * v_scales[pt].double()[..., None]
    k = k.reshape(nc, T, g, d).transpose(1, 2)
    v = v.reshape(nc, T, g, d).transpose(1, 2)
    tok = torch.arange(C * qpk, device=q.device) // qpk
    pos = starts.long()[:, None] + tok[None, :]
    cols = torch.arange(T, device=q.device)[None, None, :]
    mask = cols > pos[:, :, None]
    lo = pa._row_floors(starts, C, qpk, window, doc_starts)
    if lo is not None:
        mask = mask | (cols < lo[:, :, None])
    qb = q.double().permute(0, 2, 1, 3, 4).reshape(nc, g, C * qpk, d)
    s = (qb @ k.transpose(-1, -2)) / d ** 0.5
    s = s.masked_fill(mask[:, None], float("-inf"))
    if pv_terms is None:
        # rows that see nothing (pad rows) come out zero
        out = torch.softmax(s, -1).nan_to_num(0.0) @ v
    else:
        p = (s - s.amax(-1, keepdim=True)).exp().nan_to_num(0.0)
        left, pv = p * vs[:, :, None, :].nan_to_num(0.0), 0.0
        for _ in range(pv_terms):
            term = left.to(torch.bfloat16).double()
            pv, left = pv + term, left - term
        out = (pv @ v) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = out.masked_fill(~(tok[None, :] < chunk_lens[:, None])[:, None, :,
                                                                  None], 0)
    return out.reshape(nc, g, C, qpk, d).permute(0, 2, 1, 3, 4)


def nearest_bf16(x):
    """float64 `x` rounded to the nearest bf16 (torch converts through
    fp32, rounding twice): the better of the converted value and its two
    bf16 neighbours."""
    best = x.to(torch.bfloat16)
    bits = best.view(torch.int16)
    for step in (-1, 1):
        c = (bits + step).view(torch.bfloat16)
        closer = (torch.isfinite(c) & (x != 0)
                  & ((c.double() - x).abs() < (best.double() - x).abs()))
        best = torch.where(closer, c, best)
    return best


def misrounded(x, exact_bf16):
    """Elements of a bf16 output that differ from the correctly rounded
    exact answer: a count that falls to the few whose exact value lies
    within the design's own error of a rounding boundary, so it grows
    with any precision the design loses before the output's rounding
    (a max-abs error is set by the largest output's rounding instead)."""
    return int((x != exact_bf16).sum().item())


def chunk_floors(args, kw):
    """Each chunk's lowest attendable position (its first row's floor)."""
    starts = args[4].tolist()
    lo = [0] * len(starts)
    if kw["window"]:
        lo = [max(0, s - kw["window"] + 1) for s in starts]
    if kw["doc_starts"] is not None:
        lo = [max(a, b) for a, b in zip(lo, kw["doc_starts"].tolist())]
    return lo


def plant_nans_below(args, kw):
    """NaN at every position below each chunk's floor (in the scale pools
    of int8 pools), table entries of pages wholly below it reclaimed to
    the null page, and NaN in the null page. Packed documents first get
    private copies of their shared pages (same values, so the clean
    output stands), since one document's floor lies above another's
    positions."""
    q, kp, vp, pt, starts, lens = args
    targets = (kw["k_scales"], kw["v_scales"]) if kw["k_scales"] \
        is not None else (kp, vp)
    if kw["doc_starts"] is not None:
        for c in range(1, pt.shape[0]):
            own = torch.arange(1 + c * SLOT_PAGES, 1 + (c + 1) * SLOT_PAGES,
                               dtype=torch.int32, device="cuda")
            for x in (kp, vp):
                x[own.long()] = x[pt[c].long()]
            pt[c] = own
    table = pt.cpu().numpy()
    for c, lo in enumerate(chunk_floors(args, kw)):
        for j in range(-(-lo // PAGE)):
            pg = int(table[c, j])
            for x in targets:
                x[pg, :min(PAGE, lo - j * PAGE)] = float("nan")
        pt[c, :lo // PAGE] = 0
    for x in targets:
        x[0] = float("nan")


def variant_bound_ms(args, kw):
    """Least time of one variant launch: the bytes of each chunk's needed
    K/V positions ([floor, start + len), with the scales for int8: (d +
    4) / (2 d) of the bf16 bytes), its valid q rows and the whole output
    over 3.35 TB/s, or its operations over the bf16 peak, whichever is
    larger."""
    q, kp = args[0], args[1]
    nc, C, g, qpk, d = q.shape
    starts, lens = args[4].tolist(), args[5].tolist()
    per_pos = 2 * g * ((d + 4) if kw["k_scales"] is not None else 2 * d)
    nbytes, flops = 0, 0
    for lo, s, n in zip(chunk_floors(args, kw), starts, lens):
        if not n:
            continue
        nbytes += per_pos * (s + n - lo) + 2 * n * g * qpk * d
        for t in range(n):
            row_lo = lo if not kw["window"] else max(lo, s + t
                                                     - kw["window"] + 1)
            flops += 4 * (s + t + 1 - row_lo) * qpk * g * d
    nbytes += 2 * nc * C * g * qpk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def banded_sdpa_inputs(args, kw):
    """The library yardstick of a variant with floors: SDPA on K/V
    gathered to the dense (nc, g, T, d) view with the band (window or
    document) mask; pad rows keep column 0 so no row is empty."""
    q, kp, vp, pt, starts, lens = args
    nc, C, g, qpk, d = q.shape
    T = pt.shape[1] * PAGE
    k = kp[pt.long()].reshape(nc, T, g, d).transpose(1, 2).contiguous()
    v = vp[pt.long()].reshape(nc, T, g, d).transpose(1, 2).contiguous()
    rows = torch.arange(C, device="cuda")
    pos = (starts[:, None] + rows[None, :])[:, :, None]
    cols = torch.arange(T, device="cuda")[None, None, :]
    lo = torch.zeros_like(pos)
    if kw["window"]:
        lo = pos - kw["window"] + 1
    if kw["doc_starts"] is not None:
        lo = torch.maximum(lo, kw["doc_starts"][:, None, None])
    mask = (cols <= pos) & (cols >= lo)
    mask |= (rows[None, :, None] >= lens[:, None, None]) & (cols == 0)
    return (q.reshape(nc, C, g * qpk, d).transpose(1, 2), k, v,
            mask[:, None])


# input draws whose misrounded elements an int8 row's check sums: a decode
# round holds 32768 output elements, about ten of them misrounded by a
# design that keeps p in fp32 (H100), too few for a ratio to mean much
INT8_ERROR_DRAWS = {"decode": 8, "mixed": 1}


def int8_errors(draws):
    """The int8 tc design's error beside the present design's on the same
    inputs, summed over `draws` ((args, kw, tc output, plain output) of
    one int8 row): the elements each output rounds otherwise than the
    exact (float64) answer correctly rounded (`misrounded`), for tc,
    present, the plain version and two controls computed in float64 with
    p * v_scale cut to one bf16 term (a bf16 p operand: the precision the
    tc design must not lose) and to two (a hi/lo pair); and each design's
    largest max-abs error against the plain version, which the output's
    rounding at its largest elements sets."""
    names = ("tc", "present", "plain", "control_bf16_p_vs", "control_hi_lo")
    count = dict.fromkeys(names, 0)
    vs_plain = {"tc": 0.0, "present": 0.0}
    for args, kw, got, ref in draws:
        exact = nearest_bf16(paged_exact(*args, **kw))
        outs = {"tc": got, "plain": ref,
                "present": pa.paged_attention(*args, **kw, design="present")}
        for name, terms in (("control_bf16_p_vs", 1), ("control_hi_lo", 2)):
            outs[name] = paged_exact(*args, **kw, pv_terms=terms).to(
                torch.bfloat16)
        for name, x in outs.items():
            count[name] += misrounded(x, exact)
        for name in vs_plain:
            vs_plain[name] = max(vs_plain[name], (
                outs[name].float() - ref.float()).abs().max().item())
        del exact, outs
    return {"draws": len(draws), "elements": sum(d[2].numel()
                                                 for d in draws),
            "misrounded": count, "max_abs_vs_plain": vs_plain,
            "max_abs_within_twice_present": vs_plain["tc"]
            <= 2 * vs_plain["present"]}


def check_paged_variants(k7_row):
    """K7's int8 epilogue and lower bounds at the engine's pool shape (8
    slots, g 32, d 128, page 64, 2048 positions a slot), on a decode and a
    mixed batch: int8 pools, a binding window of 1024, a covering window
    (bitwise the fp launch), int8 with the window, and three packed
    documents over one slot's pages, each against its plain version
    (bf16 output, fp32 accumulation, max-abs 2e-2 as for K4) in the
    design `paged_design` picks (bf16 pools: tc for the mixed rounds);
    int8 rows also by `int8_errors`: tc's misrounded elements at most
    twice the present design's, and each control's above that bar.
    NaN below each chunk's floor must not reach the output. Then each
    variant's time beside its bound, plain version and library call, and
    for bf16 pools both designs' times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    g, qpk, d = 32, 1, 128
    errs, int8_errs = {}, {}
    for variant in K7_VARIANTS:
        for batch in PAGED_BATCHES:
            args, kw = variant_inputs(batch, variant, g, qpk, d, gen)
            got = pa.paged_attention(*args, **kw)
            ref = pa._xla_paged_reference(*args, **kw)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"K7 {variant} output dtype")
            err = (got.float() - ref.float()).abs().max().item()
            errs[f"{variant}_{batch}"] = err
            check(err <= BF16_TOL, f"K7 {variant} {batch}: {err}")
            if K7_VARIANTS[variant][0]:
                check(pa.paged_design(args[0].dtype, args[1].dtype, PAGE)
                      == "tc", f"K7 {variant}: int8 pools not on tc")
                draws = [(args, kw, got, ref)]
                for _ in range(INT8_ERROR_DRAWS[batch] - 1):
                    a, k = variant_inputs(batch, variant, g, qpk, d, gen)
                    draws.append((a, k, pa.paged_attention(*a, **k),
                                  pa._xla_paged_reference(*a, **k)))
                e = int8_errors(draws)
                del draws
                int8_errs[f"{variant}_{batch}"] = e
                n = e["misrounded"]
                check(n["tc"] <= 2 * n["present"],
                      f"K7 {variant} {batch}: tc misrounds {n['tc']} "
                      f"elements, more than twice the present design's "
                      f"{n['present']}")
                for control in ("control_bf16_p_vs", "control_hi_lo"):
                    check(n[control] > 2 * n["present"],
                          f"K7 {variant} {batch}: the {control} control "
                          f"passes the error check ({n}): it is blind")
            if variant == "window_covering":
                plain_fp = pa.paged_attention(*args)
                check(torch.equal(got, plain_fp),
                      f"K7 covering window {batch} is not bitwise no window")
            if kw["window"] or kw["doc_starts"] is not None:
                plant_nans_below(args, kw)
                dirty = pa.paged_attention(*args, **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dirty.float()).all())
                      and torch.equal(dirty, got),
                      f"K7 {variant} {batch}: NaN below the floor reached "
                      f"the output")
    say("kernel_check_paged_variants", max_abs_err=errs, tol=BF16_TOL,
        int8_tc_vs_present=int8_errs, nan_below_floor="ok",
        covering_window_bitwise=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    # (row, variant, (g, qpk, d)): the engine's widths, and int8 pools at
    # Llama-2-70B's attention widths (qpk 8)
    timed = [(v, v, (g, qpk, d)) for v in ("int8", "window", "int8_window",
                                           "doc")]
    timed.append(("int8_llama2_70b_attn", "int8", (8, 8, 128)))
    for row_name, variant, (tg, tq, td) in timed:
        times = {}
        for batch in PAGED_BATCHES:
            sets = [variant_inputs(batch, variant, tg, tq, td, gen)
                    for _ in range(4)]
            pick = rotating(lambda i: sets[i], 4)
            kernel_ms = device_ms(lambda: _launch(pa.paged_attention, pick()))
            # both designs in turns: tc, present, present, tc
            by_design = {}
            for dn in ("tc", "present", "present", "tc"):
                by_design.setdefault(f"{dn}_ms", []).append(device_ms(
                    lambda: _launch(pa.paged_attention, pick(), design=dn)))
            by_design = {k: min(v) for k, v in by_design.items()}
            plain_ms = device_ms(
                lambda: _launch(pa._xla_paged_reference, pick()),
                per_graph=10, replays=5)
            library_ms = None  # int8: no one library call reads int8 K/V
            if not K7_VARIANTS[variant][0]:
                lib = rotating(lambda i: banded_sdpa_inputs(*sets[i]), 4)
                library_ms = device_ms(lambda: _sdpa(sdpa, lib()))
                del lib
            bound, bound_by = variant_bound_ms(*sets[0])
            q0, kp0 = sets[0][0][:2]
            times[batch] = {"ms": kernel_ms, **by_design,
                            "design": pa.paged_design(q0.dtype, kp0.dtype,
                                                      PAGE),
                            "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": bound_by,
                            "library_ms": library_ms}
            del sets
            torch.cuda.empty_cache()
        rows[row_name] = dict(
            times["decode"], mixed=times["mixed"],
            shape=f"g{tg} qpk{tq} d{td}",
            max_abs_err=max(errs[f"{variant}_{b}"] for b in PAGED_BATCHES))
    say("kernel_time_paged_variants", **rows)
    k7_row["variants"] = rows
    k7_row["variant_shape"] = (
        "as the K7 row; int8 pools with (P, 64, 32) fp32 scale pools; "
        f"window {WINDOW}; doc: three packed documents over one slot's "
        "pages, decode rows at 699/1499/2047 and 256-token chunks")


def _launch(fn, inputs, **extra):
    args, kw = inputs
    return fn(*args, **kw, **extra)


# ---------------------------------------------------------------------------
# phases 4-7: Llama-2-7B on the whole-batch route
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


def build_model(init_std):
    """Llama-2-7B at full width and depth, bf16 weights drawn on the card
    from SEED; built once and served by both routes."""
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
    return cfg, model, params, weight_bytes


def serve_whole_batch(kernels, cfg, model, params, weight_bytes):
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    server = MegatronServer(model, params, tok, engine=None)
    server.run("127.0.0.1", 0, block=False)
    port = server._httpd.server_address[1]
    clock = ForwardClock(model)
    rs = np.random.RandomState(SEED)
    lens = [20, 75, 130, 200]
    prompts = [" ".join(map(str, rs.randint(0, 31999, n))) for n in lens]
    try:
        zero_counts()

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
                    "rmsnorm_fwd": rms.fused_rms_norm.launches,
                    "flash_fwd": fa.flash_fwd.launches}
        check(all(v > 0 for v in launches.values()), f"launches {launches}")
        # the score-only request's no-cache forward is the only one: one
        # flash forward per layer, no backward
        check(launches["flash_fwd"] == cfg.num_layers
              and fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == 0,
              f"flash launches {launches}")
        say("serving", requests=["greedy", "sampled", "score", "beam"],
            greedy_decode_steps=steps, decode_attention_launches_greedy=k1_greedy,
            launches=launches, greedy_request_s=round(t_req, 3))
    finally:
        server.stop()
    kernels[0]["launches"] = launches["decode_attention"]
    kernels[1]["launches_by_path"] = {"whole_batch": launches["rmsnorm_fwd"]}
    for row in kernels:
        if row["name"] == "flash_fwd":
            row["launches_by_path"] = {"whole_batch": launches["flash_fwd"]}

    # phase 6: the greedy output teacher-forced back through the same
    # cached decode path (same prefill bucket, same GEMM shapes) with both
    # kernels off, so that the kernels are the only difference
    model.forward = clock.inner
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
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

    # phase 7: throughput of the greedy batch, run again outside the
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


# ---------------------------------------------------------------------------
# phases 8-10: Llama-2-7B on the continuous-batching route
# ---------------------------------------------------------------------------


class PagedForwards:
    """Wraps model.forward and counts the paged forwards (the engine's
    rounds run one per decode step or mixed round), without syncing."""

    def __init__(self, model):
        self.inner = model.forward
        self.paged = 0
        model.forward = self

    def __call__(self, params, tokens, *args, **kw):
        kv = kw.get("kv_caches")
        if kv is not None and "k_pages_layers" in kv:
            self.paged += 1
        return self.inner(params, tokens, *args, **kw)


def put_raw(port, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    if payload.get("stream"):
        return resp.status, [json.loads(line[6:]) for line in
                             data.splitlines() if line.startswith("data: ")]
    return resp.status, json.loads(data)


def get_json(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    check(resp.status == 200, f"GET {path} -> {resp.status}")
    return body


def engine_traffic():
    """(name, prompt ids, payload) of the 16 engine requests: 12 greedy
    with log-probs (prompts 20-1500 ids, 64-128 new tokens), two that
    share a 700-token prefix (the second is sent once the first is
    answered, so its pages are registered), one sampled, one streamed."""
    rs = np.random.RandomState(SEED + 7)

    def ids(n):
        return [int(x) for x in rs.randint(0, 31999, n)]

    def text(x):
        return " ".join(map(str, x))

    out = []
    for i, (n, gen) in enumerate(zip(
            (20, 1500, 300, 75, 900, 130, 1200, 450, 40, 640, 1000, 210),
            (128, 64, 96, 80, 72, 112, 64, 100, 120, 88, 76, 104))):
        p = ids(n)
        out.append((f"greedy{i}", p, {"prompts": [text(p)], "top_k": 1,
                                      "tokens_to_generate": gen,
                                      "logprobs": True}))
    prefix = ids(700)
    for name, tail in (("shared_a", 40), ("shared_b", 20)):
        p = prefix + ids(tail)
        out.append((name, p, {"prompts": [text(p)], "top_k": 1,
                              "tokens_to_generate": 64}))
    out[-2][2]["then"] = "shared_b"  # sent once shared_a is answered
    p = ids(180)
    out.append(("sampled", p, {"prompts": [text(p)], "top_p": 0.9,
                               "random_seed": 1234,
                               "tokens_to_generate": 64}))
    p = ids(250)
    out.append(("stream", p, {"prompts": [text(p)], "top_k": 1,
                              "tokens_to_generate": 96, "stream": True}))
    return out


def engine_kwargs(tok, **over):
    """The launcher's defaults: 8 slots, page 64, max_context 2048,
    horizon 8, chunks of 256, prefix cache."""
    kw = dict(slots=8, page_size=64, max_context=2048, step_horizon=8,
              prefill_chunk_tokens=256, prefix_cache=True,
              termination_id=tok.eod, vocab_size=tok.vocab_size)
    kw.update(over)
    return kw


def drive_engine(eng, model, tok, params, traffic):
    """The traffic from concurrent client threads through
    `MegatronServer(engine=eng)` (a "then" request is sent once the one
    before it is answered), with every launch count set to 0 just before
    and read just after. Returns the run's record."""
    server = MegatronServer(model, params, tok, engine=eng)
    server.run("127.0.0.1", 0, block=False)
    port = server._httpd.server_address[1]
    results = {}
    then = {name: payload["then"] for name, _, payload in traffic
            if "then" in payload}
    by_name = {name: payload for name, _, payload in traffic}

    def client(name):
        payload = {k: v for k, v in by_name[name].items() if k != "then"}
        results[name] = put_raw(port, payload)
        if name in then:
            client(then[name])

    counter = PagedForwards(model)
    try:
        zero_counts()
        threads = [threading.Thread(target=client, args=(name,))
                   for name, _, _ in traffic if name not in then.values()]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_start
        launches = kernel_counts()
        variants = dict(pa.ragged_paged_attention.variant_launches)
        check(all(not th.is_alive() for th in threads), "engine clients hung")
        metrics = get_json(port, "/metrics")
    finally:
        model.forward = counter.inner
        server.stop()
    return {"results": results, "launches": launches, "variants": variants,
            "metrics": metrics, "wall": wall, "paged": counter.paged,
            "rounds": list(eng._round_log)}


def check_outputs(traffic, run, tok):
    """Every answer echoes its prompt and stops at its budget or eod;
    returns (generated tokens, [(name, prompt, out, log-probs)] of the
    requests that asked for log-probs)."""
    generated, scored = 0, []
    for name, prompt, payload in traffic:
        status, body = run["results"][name]
        check(status == 200, f"engine {name} -> {status} {body}")
        gen = payload["tokens_to_generate"]
        if payload.get("stream"):
            toks = [e["token"] for e in body[:-1]]
            final = body[-1]
            check(final.get("done") and final["tokens"] == toks
                  and final["text"] == " ".join(map(str, prompt + toks)),
                  "SSE tokens equal the final text")
            out = prompt + toks
        else:
            out = list(map(int, body["text"][0].split()))
        check(out[:len(prompt)] == prompt, f"{name}: prompt echoed")
        check(len(prompt) < len(out) <= len(prompt) + gen
              and (len(out) == len(prompt) + gen or out[-1] == tok.eod),
              f"{name}: length {len(out)}")
        generated += len(out) - len(prompt)
        if payload.get("logprobs"):
            lp = body["logprobs"][0]
            check(len(lp) == len(out) - 1 and np.isfinite(lp).all(),
                  f"{name}: logprobs")
            scored.append((name, prompt, out, lp))
    return generated, scored


@contextlib.contextmanager
def forced_paged_design(design):
    """Every K7 launch inside runs `design`: a measurement of the other
    design on the same path in the same call, made after the path's own
    run and launch check, never in them."""
    rule = pa.paged_design
    pa.paged_design = lambda *shape: design
    try:
        yield
    finally:
        pa.paged_design = rule


def check_paged_launches(cfg, run, label, variant=None, tc=True):
    """K7 ran once per layer per paged forward (under `variant` every
    time, when given), every launch in the tc design when `tc` (bf16 q
    with bf16 or int8 pools of page 64) and in the present design
    otherwise (fp32 pools); K2 ran, K1 and K4 did not."""
    k7 = run["launches"]["ragged_paged_attention"]
    check(k7 == cfg.num_layers * run["paged"] and k7 > 0,
          f"{label}: K7 launches {k7} != {cfg.num_layers} x {run['paged']} "
          f"paged forwards")
    if variant is not None:
        check(run["variants"][variant] == k7,
              f"{label}: K7 {variant} launches {run['variants']}")
    v = run["variants"]
    check(v["tc" if tc else "present"] == k7, f"{label}: K7 designs {v}")
    check(run["launches"]["rmsnorm_fwd"] > 0, f"{label}: K2 did not run")
    check(run["launches"]["decode_attention"] == 0, f"{label}: K1 ran")
    check(run["launches"]["flash_fwd"] == 0, f"{label}: K4 ran")


K7_ROWS = {"ragged_paged_attention": "present",
           "ragged_paged_attention_tc": "tc"}


def note_launches(kernels, path, run):
    """Add one engine path's launches to the K2 row and to K7's two rows,
    each design's launches to its own row, and the path's launches by
    variant and design to the present design's row."""
    for row in kernels:
        if row["name"] == "rmsnorm_fwd":
            row["launches_by_path"][path] = run["launches"]["rmsnorm_fwd"]
            row["launches"] = sum(row["launches_by_path"].values())
        design = K7_ROWS.get(row["name"])
        if design is not None:
            row["launches_by_path"][path] = run["variants"][design]
            row["launches"] = sum(row["launches_by_path"].values())
        if design == "present":
            row.setdefault("variant_launches_by_path", {})[path] = {
                k: v for k, v in run["variants"].items() if v}


def free_cuda():
    """Return the memory of what the caller dropped (engines hold
    reference cycles, so collect first)."""
    gc.collect()
    torch.cuda.empty_cache()


def rescore(eng, scored):
    """Each (prompt, out) teacher-forced through `eng` as one prompt
    (chunked prefill, one token generated): the log-probs of out[1:]."""
    reqs = [eng.submit(out, 1, top_k=1, return_log_probs=True,
                       use_eod_for_early_termination=False)
            for _, _, out, _ in scored]
    eng.drain()
    return [r.result(60)[1][:len(out) - 1]
            for r, (_, _, out, _) in zip(reqs, scored)]


def compare_streams(ref, other):
    """Greedy agreement of two runs of the same requests: the share of
    generated positions with equal tokens, and the largest |log-prob
    difference| over each pair's common prefix (where the contexts are
    still equal)."""
    agree, total, err = 0, 0, 0.0
    for (_, prompt, a, la), (_, _, b, lb) in zip(ref, other):
        n = min(len(a), len(b))
        agree += sum(x == y for x, y in zip(a[len(prompt):n],
                                            b[len(prompt):n]))
        total += len(a) - len(prompt)
        k = next((i for i in range(n) if a[i] != b[i]), n)
        if k > 1:
            err = max(err, float(np.abs(np.asarray(la[:k - 1])
                                        - np.asarray(lb[:k - 1])).max()))
    return agree / max(total, 1), err


def decode_step_device_ms(model, eng):
    """The card's own time for one 8-slot paged decode step (slots at
    length 1000) on the engine's pools and decode tree, captured in a
    CUDA graph (the engine is stopped)."""
    with torch.inference_mode():
        pt = torch.zeros(eng.slots, eng.max_pages_per_slot,
                         dtype=torch.int32, device="cuda")
        for i in range(eng.slots):
            pt[i, :16] = torch.arange(1 + 16 * i, 17 + 16 * i)
        lens = torch.full((eng.slots,), 1000, dtype=torch.int32,
                          device="cuda")
        pools_k, pools_v, pools_ks, pools_vs = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens,
                  "chunk_lens": torch.ones_like(lens)}
        if pools_ks:
            caches["k_scales_layers"] = pools_ks
            caches["v_scales_layers"] = pools_vs
        tok1 = torch.zeros(eng.slots, 1, dtype=torch.long, device="cuda")
        return device_ms(
            lambda: model.forward(eng._dec_params, tok1, kv_caches=caches,
                                  position_ids=lens.long()[:, None]),
            per_graph=4, replays=5)


def mixed_round_device_ms(model, eng, calls=3):
    """The card's own time for one mixed round's paged forward on the
    engine's pools and decode tree (the engine is stopped): the kernel
    check's mixed batch (chunks 256@0 and 100@700, six decode rows, width
    256), the CUDA kernels' time in a torch.profiler trace, in all and
    K7's part, per forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    C, spans = PAGED_BATCHES["mixed"]
    dev = eng._pools[0][0].device
    n = eng.max_pages_per_slot
    with torch.inference_mode():
        pt = (1 + torch.arange(eng.slots * n, dtype=torch.int32,
                               device=dev)).view(eng.slots, n)
        lens = torch.tensor([s for s, _ in spans], dtype=torch.int32,
                            device=dev)
        clen = torch.tensor([k for _, k in spans], dtype=torch.int32,
                            device=dev)
        pools_k, pools_v, pools_ks, pools_vs = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens, "chunk_lens": clen}
        if pools_ks:
            caches["k_scales_layers"] = pools_ks
            caches["v_scales_layers"] = pools_vs
        toks = torch.zeros(eng.slots, C, dtype=torch.long, device=dev)
        pos = lens.long()[:, None] + torch.arange(C, device=dev)[None, :]

        def forward():
            model.forward(eng._dec_params, toks, kv_caches=dict(caches),
                          position_ids=pos)
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                forward()
            torch.cuda.synchronize()
    total = k7 = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            total += us
            k7 += us if "paged_attn" in e.name else 0.0
    return total / calls / 1e3, k7 / calls / 1e3


def ms_per_advance(rounds):
    dec = [r for r in rounds if not r["prefill_tokens"]]
    steps = sum(r["decode_steps"] for r in dec
                if "spec_emitted" not in r)
    spec = [r for r in dec if "spec_emitted" in r]
    emitted = sum(r["spec_emitted"] / max(r["decode_slots"], 1)
                  for r in spec)
    return sum(r["ms"] for r in dec) / max(steps + emitted, 1)


def serve_engine(kernels, cfg, model, params, weight_bytes):
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, **engine_kwargs(tok))
    setup_s = time.perf_counter() - t0
    traffic = engine_traffic()
    run = drive_engine(eng, model, tok, params, traffic)
    generated, greedy = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine", "fp")
    metrics = run["metrics"]
    check(metrics["serve_prefix_hits"] >= 1
          and metrics["serve_prefix_cow_copies"] >= 1,
          f"prefix hit and COW copy: {metrics}")
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"pages after the traffic: {metrics}")
    rounds = run["rounds"]
    note_launches(kernels, "engine", run)
    kernels[2]["launches_per_engine_round"] = \
        run["launches"]["ragged_paged_attention"] / len(rounds)
    say("serving_engine", requests=len(traffic), slots=eng.slots,
        paged_forwards=run["paged"], rounds=len(rounds),
        mixed_rounds=sum(1 for r in rounds if r["prefill_tokens"]),
        launches=run["launches"], setup_s=round(setup_s, 2),
        prefix_hits=metrics["serve_prefix_hits"],
        prefix_hit_tokens=metrics["serve_prefix_hit_tokens"],
        prefix_cow_copies=metrics["serve_prefix_cow_copies"],
        pages_free=metrics["serve_pages_free"],
        prefix_cached_pages=metrics["serve_prefix_cached_pages"],
        num_pages=eng.num_pages)

    # phase 9: the greedy outputs teacher-forced through the same weights
    # on the no-cache forward with both kernels off (plain RMSNorm, plain
    # attention)
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
    err, match, total = 0.0, 0, 0
    with torch.inference_mode():
        for _, prompt, out, lp in greedy:
            seq = torch.tensor(out, device="cuda")[None]
            logits, _ = plain.forward(params, seq[:, :-1])
            lps = torch.log_softmax(logits[0].float(), -1)
            forced = lps.gather(1, seq[0, 1:, None])[:, 0].cpu().numpy()
            err = max(err, float(np.abs(forced - np.asarray(lp)).max()))
            am = lps.argmax(-1).cpu().numpy()[len(prompt) - 1:]
            match += int((am == np.asarray(out[len(prompt):])).sum())
            total += len(out) - len(prompt)
    say("path_check_engine", requests=len(greedy),
        max_abs_logprob_err=err, tol=PATH_LP_TOL,
        greedy_token_match_fraction=match / total)
    check(err <= PATH_LP_TOL, f"engine re-scored logprobs {err}")

    # phase 10: throughput of the traffic, and the card's own time for one
    # 8-slot paged decode step
    dec_rounds = [r for r in rounds if not r["prefill_tokens"]]
    mixed = [r for r in rounds if r["prefill_tokens"]]
    advance = ms_per_advance(rounds)
    step_ms = decode_step_device_ms(model, eng)
    mixed_ms, mixed_k7_ms = mixed_round_device_ms(model, eng)
    say("throughput_engine", wall_s=run["wall"], generated_tokens=generated,
        generated_tokens_per_s=generated / run["wall"],
        decode_rounds=len(dec_rounds), decode_ms_per_advance=advance,
        mixed_rounds=len(mixed),
        mixed_round_ms=sum(r["ms"] for r in mixed) / max(len(mixed), 1),
        mixed_forward_device_ms=mixed_ms or "not measured",
        mixed_forward_k7_device_ms=mixed_k7_ms or "not measured",
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        ttft_p95_ms=metrics["serve_ttft_p95_ms"],
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        device_idle_share=1 - step_ms / advance,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {"greedy": greedy, "bytes_per_token": eng.kv_bytes_per_token(),
            "tokens_per_s": generated / run["wall"],
            "decode_ms_per_advance": advance, "decode_step_device_ms": step_ms}


def serve_engine_int8(kernels, cfg, model, params, bf16):
    """Llama-2-7B with int8 pools and int8 weights at the launcher's
    defaults, the same 16 requests over HTTP. Path check: the served
    outputs re-scored teacher-forced on a kernels-off int8 engine (plain
    paged attention and RMSNorm, the same quantized tree) within 5e-2.
    Printed, not gated: drift against the bf16 engine's prompt
    log-probs and greedy tokens, pool bytes per token, tokens/s."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, **engine_kwargs(
        tok, kv_dtype="int8", quantize_weights=True))
    setup_s = time.perf_counter() - t0
    traffic = engine_traffic()
    run = drive_engine(eng, model, tok, params, traffic)
    generated, scored = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine_int8", "int8")
    metrics = run["metrics"]
    check(metrics["serve_kv_dtype"] == "int8", f"kv dtype {metrics}")
    check(metrics["serve_prefix_hits"] >= 1
          and metrics["serve_prefix_cow_copies"] >= 1,
          f"int8 prefix hit and COW copy: {metrics}")
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"int8 pages after the traffic: {metrics}")
    note_launches(kernels, "engine_int8", run)
    advance = ms_per_advance(run["rounds"])
    # device ms of a decode step and of a mixed round's forward with K7's
    # tc design (the one the path ran), then, in this call, with every
    # launch forced to the present design, then tc again
    device = {}
    for design in ("tc", "present", "tc"):
        with forced_paged_design(design):
            step = decode_step_device_ms(model, eng)
            mixed, mixed_k7 = mixed_round_device_ms(model, eng)
        for key, x in (("decode_step_device_ms", step),
                       ("mixed_forward_device_ms", mixed),
                       ("mixed_forward_k7_device_ms", mixed_k7)):
            device.setdefault(design, {}).setdefault(key, []).append(x)
    step_ms = min(device["tc"]["decode_step_device_ms"])
    bytes_per_token = eng.kv_bytes_per_token()
    eng = None
    free_cuda()

    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    off = DecodeEngine(plain, params, **engine_kwargs(
        tok, kv_dtype="int8", quantize_weights=True, prefix_cache=False))
    forced = rescore(off, scored)
    off = None
    free_cuda()
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    prompt_drift = max(
        float(np.abs(np.asarray(lp[:len(p) - 1])
                     - np.asarray(ref[:len(p) - 1])).max())
        for (_, p, _, lp), (_, _, _, ref) in zip(scored, bf16["greedy"]))
    agree, common_err = compare_streams(bf16["greedy"], scored)
    say("serving_engine_int8", requests=len(traffic),
        paged_forwards=run["paged"], launches=run["launches"],
        k7_variant_launches=run["variants"], setup_s=round(setup_s, 2),
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        drift_vs_bf16_prompt_logprob_max_abs=prompt_drift,
        drift_vs_bf16_common_prefix_logprob_max_abs=common_err,
        greedy_token_agreement_vs_bf16=agree,
        kv_bytes_per_token=bytes_per_token,
        kv_bytes_per_token_bf16=bf16["bytes_per_token"],
        generated_tokens=generated, wall_s=run["wall"],
        generated_tokens_per_s=generated / run["wall"],
        generated_tokens_per_s_bf16=bf16["tokens_per_s"],
        decode_ms_per_advance=advance,
        decode_ms_per_advance_bf16=bf16["decode_ms_per_advance"],
        decode_step_device_ms=step_ms,
        decode_step_device_ms_bf16=bf16["decode_step_device_ms"],
        k7_design_device_ms=device,
        present_design_decode_step_device_ms_earlier="29.8-30.0 (PERF.md)",
        ttft_p50_ms=run["metrics"]["serve_ttft_p50_ms"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(err <= PATH_LP_TOL, f"int8 re-scored logprobs {err}")


WINDOW_SERVE = 1024


def window_traffic():
    """8 requests whose prompt and generation pass the window (prompts
    1500-3000 ids, 64-128 new tokens) and 4 short ones, all greedy with
    log-probs."""
    rs = np.random.RandomState(SEED + 9)
    out = []
    for i, (n, gen) in enumerate(zip(
            (1500, 3000, 2100, 1800, 2600, 1650, 2900, 2300, 40, 200, 90, 350),
            (128, 64, 96, 112, 80, 128, 72, 100, 64, 48, 96, 32))):
        out.append((f"w{i}", [int(x) for x in rs.randint(0, 31999, n)], gen))
    return out


def serve_engine_window(kernels, cfg, model, params):
    """Llama-2-7B with a window of 1024, max_context 4096, page_budget 8 x
    the window's slot bound (168 pages): the traffic is queued on the
    engine and drained (a fixed schedule, so the two runs below compare
    bitwise). Gates: reclamation ON gives the streams of the mask-only
    OFF engine (full budget) bit for bit; pages were reclaimed; no slot
    held more than the bound; every page is back at the end; a
    teacher-forced re-score on a kernels-off windowed engine agrees
    within 5e-2."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    wcfg = dataclasses.replace(cfg, attention_window_size=WINDOW_SERVE)
    wmodel = LlamaModel(wcfg)
    bound = -(-(WINDOW_SERVE + 256) // 64) + 1
    kw = engine_kwargs(tok, max_context=4096, prefix_cache=False)
    traffic = window_traffic()
    reach = sum(-(-(len(p) + g) // 64) for _, p, g in traffic)

    def run(reclaim, budget):
        eng = DecodeEngine(wmodel, params, window_reclaim=reclaim,
                           page_budget=budget, **kw)
        reqs = [eng.submit(p, g, top_k=1, return_log_probs=True)
                for _, p, g in traffic]
        peak = [0]
        inner = eng._step_inner

        def step():
            did = inner()
            peak[0] = max([peak[0]] + [s.mapped - s.reclaimed
                                       for s in eng._slots])
            return did
        eng._step_inner = step
        counter = PagedForwards(wmodel)
        zero_counts()
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wmodel.forward = counter.inner
        outs = [r.result(60) for r in reqs]
        rec = {"outs": [(list(t), list(lp)) for t, lp in outs],
               "launches": kernel_counts(),
               "variants": dict(pa.ragged_paged_attention.variant_launches),
               "paged": counter.paged, "rounds": list(eng._round_log),
               "wall": wall, "peak": peak[0], "counters": eng.counters(),
               "bound": eng._window_slot_pages(), "num_pages": eng.num_pages}
        return rec

    on = run(True, 8 * bound * 64)
    free_cuda()
    off = run(False, None)
    free_cuda()
    check(on["bound"] == bound, f"window slot bound {on['bound']} != {bound}")
    check(reach > on["num_pages"] - 1,
          f"the traffic's reach ({reach} pages) fits the budget")
    check(on["outs"] == off["outs"],
          "window: reclamation ON is not bitwise the mask-only engine")
    c = on["counters"]
    check(c["serve_window_reclaimed_pages"] > 0, "no page was reclaimed")
    check(on["peak"] <= bound, f"a slot held {on['peak']} > {bound} pages")
    check(c["serve_pages_in_use"] == 0
          and c["serve_pages_free"] == on["num_pages"] - 1,
          f"window pages after the traffic: {c}")
    check_paged_launches(cfg, on, "engine_window", "window")
    note_launches(kernels, "engine_window", on)

    plain = LlamaModel(dataclasses.replace(wcfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    eng = DecodeEngine(plain, params, page_budget=8 * bound * 64, **kw)
    scored = [(name, p, list(t), lp) for (name, p, _), (t, lp) in
              zip(traffic, on["outs"])]
    forced = rescore(eng, scored)
    eng = None
    free_cuda()
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    generated = sum(len(t) - len(p) for (_, p, _), (t, _) in
                    zip(traffic, on["outs"]))
    say("serving_engine_window", window=WINDOW_SERVE, requests=len(traffic),
        max_context=4096, budget_pages=on["num_pages"] - 1,
        slot_bound_pages=bound, traffic_reach_pages=reach,
        peak_pages_per_slot=on["peak"],
        reclaimed_pages=c["serve_window_reclaimed_pages"],
        on_equals_off_bitwise=True, paged_forwards=on["paged"],
        launches=on["launches"], k7_variant_launches=on["variants"],
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        generated_tokens=generated, wall_s_on=on["wall"],
        wall_s_off=off["wall"],
        generated_tokens_per_s_on=generated / on["wall"],
        generated_tokens_per_s_off=generated / off["wall"],
        decode_ms_per_advance_on=ms_per_advance(on["rounds"]),
        decode_ms_per_advance_off=ms_per_advance(off["rounds"]),
        ttft_p50_ms_on=c["serve_ttft_p50_ms"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(err <= PATH_LP_TOL, f"window re-scored logprobs {err}")


def spec_traffic():
    """8 greedy requests with log-probs: 4 whose prompts repeat a block
    (the traffic prompt-lookup drafting is for) and 4 of random ids."""
    rs = np.random.RandomState(SEED + 13)

    def text(x):
        return " ".join(map(str, x))

    out = []
    for i, (n, gen) in enumerate(zip((600, 900, 1200, 300, 150, 700, 1400,
                                      400),
                                     (128, 96, 64, 112, 128, 80, 64, 100))):
        if i < 4:
            block = [int(x) for x in rs.randint(0, 31999, 24 + 8 * i)]
            p = (block * (n // len(block) + 1))[:n]
        else:
            p = [int(x) for x in rs.randint(0, 31999, n)]
        out.append((f"s{i}", p, {"prompts": [text(p)], "top_k": 1,
                                 "tokens_to_generate": gen,
                                 "logprobs": True}))
    return out


def serve_engine_spec_and_whole_prompt(kernels, cfg, model, params):
    """The same 8 requests over HTTP through the chunked engine without
    speculation, with `spec_decode_k=4`, and with whole-prompt admission
    (`prefill_chunk_tokens=0`): acceptance rate, tokens/s and TTFT of
    each; greedy agreement with the chunked engine and log-probs within
    5e-2 over each request's common prefix (other chunk widths are
    other GEMM shapes, so the card does not promise bitwise equality)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    traffic = spec_traffic()
    runs = {}
    for mode, over in (("chunked", {}), ("spec", {"spec_decode_k": 4}),
                       ("whole_prompt", {"prefill_chunk_tokens": 0,
                                         "prefix_cache": False})):
        eng = DecodeEngine(model, params, **engine_kwargs(tok, **over))
        run = drive_engine(eng, model, tok, params, traffic)
        run["generated"], run["scored"] = check_outputs(traffic, run, tok)
        check(run["metrics"]["serve_pages_in_use"]
              - run["metrics"].get("serve_prefix_cached_pages", 0) == 0,
              f"{mode}: pages after the traffic {run['metrics']}")
        if mode != "chunked":
            check_paged_launches(cfg, run, f"engine_{mode}", "fp")
            note_launches(kernels, f"engine_{mode}", run)
        runs[mode] = run
        eng = None
        free_cuda()
    spec = runs["spec"]["metrics"]
    check(spec["serve_spec_rounds"] > 0, f"no spec round ran: {spec}")
    report = {}
    for mode in ("chunked", "spec", "whole_prompt"):
        r = runs[mode]
        agree, err = compare_streams(runs["chunked"]["scored"], r["scored"])
        report[mode] = {
            "generated_tokens_per_s": r["generated"] / r["wall"],
            "wall_s": r["wall"], "ttft_p50_ms": r["metrics"]["serve_ttft_p50_ms"],
            "ttft_p95_ms": r["metrics"]["serve_ttft_p95_ms"],
            "decode_ms_per_advance": ms_per_advance(r["rounds"]),
            "paged_forwards": r["paged"], "rounds": len(r["rounds"]),
            "greedy_token_agreement_vs_chunked": agree,
            "common_prefix_logprob_max_abs_vs_chunked": err}
    report["spec"].update(
        accept_rate=spec["serve_spec_accept_rate"],
        spec_rounds=spec["serve_spec_rounds"],
        proposed=spec["serve_spec_proposed"],
        accepted=spec["serve_spec_accepted"])
    say("serving_engine_spec_whole_prompt", requests=len(traffic),
        tol=PATH_LP_TOL, **report)
    for mode in ("spec", "whole_prompt"):
        err = report[mode]["common_prefix_logprob_max_abs_vs_chunked"]
        check(err <= PATH_LP_TOL, f"{mode} log-probs vs chunked {err}")


def packed_docs_prefill(kernels, cfg, model, params):
    """Three documents packed into one slot's pages and prefilled by one
    paged `LlamaModel.forward` as three chunks with "doc_starts" floors
    (the packed-document path of K7). Counts zeroed just before, read
    just after: K7 once per layer, every launch the doc variant. Each
    document's log-probs within 5e-2 of the kernels-off forward of the
    same packed batch and of that document's own no-cache forward (no
    attention crosses a document; RoPE scores depend on relative
    positions only)."""
    lens, C, page = (256, 200, 300), 300, 64
    starts = (0, 256, 456)
    pages = -(-sum(lens) // page)
    rs = np.random.RandomState(SEED + 17)
    docs = [rs.randint(0, 31999, n) for n in lens]
    toks = np.zeros((3, C), np.int64)
    for i, d in enumerate(docs):
        toks[i, :len(d)] = d
    toks = torch.from_numpy(toks).cuda()
    dev = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
           for k, v in (("lengths", starts), ("chunk_lens", lens),
                        ("doc_starts", starts))}
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
    dp = model.prepare_decode_params(params)
    outs = []
    with torch.inference_mode():
        for m in (model, plain):
            caches = m.init_paged_kv_caches(3, 1 + pages, page, pages)
            caches["page_table"] = torch.arange(
                1, 1 + pages, dtype=torch.int32, device="cuda").repeat(3, 1)
            zero_counts()
            logits, _ = m.forward(dp, toks, kv_caches=dict(caches, **dev))
            torch.cuda.synchronize()
            if m is model:
                launches = kernel_counts()
                variants = dict(pa.ragged_paged_attention.variant_launches)
            outs.append(torch.log_softmax(logits.float(), -1))
        alone = [torch.log_softmax(plain.forward(params, torch.from_numpy(
            d[None]).cuda())[0][0].float(), -1) for d in docs]
    err_off = max((outs[0][i, :n] - outs[1][i, :n]).abs().max().item()
                  for i, n in enumerate(lens))
    err_alone = max((outs[0][i, :n] - alone[i]).abs().max().item()
                    for i, n in enumerate(lens))
    k7 = launches["ragged_paged_attention"]
    say("packed_docs_prefill", documents=list(lens), launches=launches,
        k7_variant_launches=variants,
        max_abs_logprob_err_vs_kernels_off=err_off,
        max_abs_logprob_err_vs_each_document_alone=err_alone,
        tol=PATH_LP_TOL)
    check(k7 == cfg.num_layers and variants["doc"] == k7
          and variants["tc"] == k7,
          f"packed docs: K7 launches {launches} {variants}")
    check(err_off <= PATH_LP_TOL and err_alone <= PATH_LP_TOL,
          f"packed docs log-probs {err_off} {err_alone}")
    note_launches(kernels, "packed_docs_prefill",
                  {"launches": launches, "variants": variants})


FP32_LAYERS = 2
FP32_REQUESTS = ("greedy0", "greedy2", "greedy3", "greedy5")
FP32_LP_TOL = 1e-3


def serve_engine_fp32(kernels, init_std):
    """Llama-2-7B widths at 2 of its 32 layers with fp32 weights, compute
    and pools (the pools of an fp32 model), served by the engine at the
    launcher's defaults over HTTP: the fp32-pool path of K7, which runs
    its present design. Counts zeroed before the traffic, read after: K7
    once per layer per paged forward, every launch present. The outputs
    re-scored teacher-forced on a kernels-off fp32 engine on the same
    weights: log-probs within 1e-3."""
    cfg = llama_config(7, num_layers=FP32_LAYERS, params_dtype=torch.float32,
                       compute_dtype=torch.float32, use_fused_rmsnorm=True,
                       init_method_std=init_std)
    model = LlamaModel(cfg)
    params = model.init(seed=SEED + 23)
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    eng = DecodeEngine(model, params, **engine_kwargs(tok))
    traffic = [x for x in engine_traffic() if x[0] in FP32_REQUESTS]
    run = drive_engine(eng, model, tok, params, traffic)
    generated, scored = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine_fp32", "fp", tc=False)
    metrics = run["metrics"]
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"fp32 pages after the traffic: {metrics}")
    note_launches(kernels, "engine_fp32", run)
    eng = None
    free_cuda()
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    off = DecodeEngine(plain, params, **engine_kwargs(tok,
                                                      prefix_cache=False))
    forced = rescore(off, scored)
    off = None
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    say("serving_engine_fp32", layers=FP32_LAYERS, requests=len(traffic),
        paged_forwards=run["paged"], launches=run["launches"],
        k7_variant_launches=run["variants"], generated_tokens=generated,
        wall_s=run["wall"], path_check_max_abs_logprob_err=err,
        tol=FP32_LP_TOL)
    check(err <= FP32_LP_TOL, f"fp32 re-scored logprobs {err}")
    del model, plain, params
    free_cuda()


# ---------------------------------------------------------------------------
# phase 3 (training kernels): K2 with rstd, K3, and flash K4-K6
# ---------------------------------------------------------------------------


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_rmsnorm_bwd_kernel(k2_row):
    """K2 writing rstd and K3 against `_plain_fwd` / `_plain_bwd` at a
    training microbatch's rows (n = seq 4096, h 4096): bf16 activations
    and gradients, the fp32 scale parameter. Adds the rstd variant's
    numbers to K2's row and returns K3's row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n, h, eps = 4096, 4096, 1e-5
    bf = torch.bfloat16

    def make(i):
        x = torch.randn(n, h, generator=gen, device="cuda").to(bf)
        g = torch.randn(n, h, generator=gen, device="cuda").to(bf)
        return x, g
    scale = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    x, g = make(0)
    out, rstd = rms.rms_norm_fwd(x, scale, eps, with_rstd=True)
    ref_out, ref_rstd = rms._plain_fwd(x, scale, eps)
    dx, ds = rms.rms_norm_bwd(x, scale, rstd, g)
    ref_dx, ref_ds = rms._plain_bwd(x, scale, ref_rstd, g)
    torch.cuda.synchronize()
    errs = {"out": max_err(out, ref_out), "rstd": max_err(rstd, ref_rstd),
            "dx": max_err(dx, ref_dx), "dscale": max_err(ds, ref_ds)}
    # against max(1, the reference's max-abs): normalised rows times the
    # scale reach |out| ~ 5, where one bf16 ulp is 0.03
    rel = {k: errs[k] / max(1.0, ref.abs().max().item())
           for k, ref in (("out", ref_out), ("rstd", ref_rstd),
                          ("dx", ref_dx), ("dscale", ref_ds))}
    say("kernel_check_rmsnorm_bwd", max_abs_err=errs, rel_err=rel,
        tol=BF16_TOL)
    for k, v in rel.items():
        check(v <= BF16_TOL, f"K2-rstd/K3 {k}: {v}")

    # four input sets of 64 MB: out of the 50 MB L2
    pick = rotating(make, 4)
    lib = torch.nn.functional.rms_norm
    scale_bf = scale.to(bf)
    fwd = {
        "ms": device_ms(lambda: rms.rms_norm_fwd(pick()[0], scale, eps,
                                                 with_rstd=True)),
        "plain_ms": device_ms(lambda: rms._plain_fwd(pick()[0], scale, eps),
                              per_graph=10, replays=5),
        "library_ms": device_ms(lambda: lib(pick()[0], (h,), scale_bf,
                                            eps)),
    }
    sets = [(xi, gi, rms.rms_norm_fwd(xi, scale, eps, True)[1])
            for xi, gi in (make(i) for i in range(4))]
    bpick = rotating(lambda i: sets[i], 4)
    bwd = {
        "ms": device_ms(lambda: _k3(bpick, scale)),
        "plain_ms": device_ms(lambda: _k3(bpick, scale, plain=True),
                              per_graph=10, replays=5),
    }
    # library: F.rms_norm's backward alone, on a retained graph
    xl = sets[0][0].clone().requires_grad_(True)
    wl = scale_bf.clone().requires_grad_(True)
    yl = lib(xl, (h,), wl, eps)
    bwd["library_ms"] = profiled_ms(lambda: torch.autograd.grad(
        yl, (xl, wl), sets[0][1], retain_graph=True))
    del sets, xl, wl, yl
    # bounds: each input read once, each output written once, at 3.35 TB/s;
    # operations (~4 and ~10 a element) at the fp32 rate
    for row, nbytes, flops in (
            (fwd, 2 * n * h * 2 + 4 * h + 4 * n, 4 * n * h),
            (bwd, 3 * n * h * 2 + 4 * n + 2 * 4 * h, 10 * n * h)):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        row.update(bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations")
    k2_row["rstd_variant"] = dict(fwd, shape=f"n{n} h{h} bf16, fp32 scale",
                                  max_abs_err=errs["out"])
    return dict({
        "name": "rmsnorm_bwd", "route": "triton",
        "source": "megatron_llm_tpu_torch/ops/rmsnorm.py",
        "replaces": "megatron_llm_tpu/ops/rmsnorm.py:59",
        "max_abs_err": errs["dx"], "shape": f"n{n} h{h} bf16, fp32 scale",
    }, **bwd)


def _k3(pick, scale, plain=False):
    x, g, rstd = pick()
    if plain:
        return rms._plain_bwd(x, scale, rstd, g)
    return rms.rms_norm_bwd(x, scale, rstd, g)


FLASH_CASES = (
    # label, (b, s, t, g, qpk, d, causal)
    ("llama2_7b_train", (1, 4096, 4096, 32, 1, 128, True)),
    ("llama2_70b_attn", (1, 2048, 2048, 8, 8, 128, True)),
    ("full_attention", (2, 1000, 1536, 8, 1, 128, False)),
    ("ragged_s1000", (1, 1000, 1000, 32, 1, 128, True)),
)


def flash_inputs(shape, gen):
    b, s, t, g, qpk, d, _ = shape

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda").to(
            torch.bfloat16)
    return rnd(b, s, g, qpk, d), rnd(b, t, g, d), rnd(b, t, g, d), \
        rnd(b, s, g, qpk, d)


def flash_errors(q, k, v, do, causal, dlse=None):
    """K4 (o, lse) against `_xla_reference_with_lse`; K5 and K6 against
    `_plain_bwd` from the plain forward's o and lse: max-abs errors, the
    gradients' relative to their reference's max-abs."""
    b, s, g, qpk, _ = q.shape
    o, lse = fa._fwd(q, k, v, causal)
    o_ref, lse_ref = fa._xla_reference_with_lse(q, k, v, causal)
    rows = fa._lse_bsgq_to_rows(lse_ref, b, s, g, qpk)
    dl = None if dlse is None else fa._lse_bsgq_to_rows(dlse, b, s, g, qpk)
    grads = fa._bwd(q, k, v, o, lse, do, causal, dl)
    refs = fa._plain_bwd(q, k, v, o_ref, rows, do, causal, dl)
    torch.cuda.synchronize()
    errs = {"o": max_err(o, o_ref), "lse": max_err(lse, rows)}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        errs[name] = max_err(got, ref)
        errs[name + "_rel"] = errs[name] / ref.float().abs().max().item()
    return errs


def causal_pairs(s, t, causal):
    """(query position, key) pairs a head attends: sum of min(t, p + 1)."""
    if not causal:
        return s * t
    full = min(s, t)
    return full * (full + 1) // 2 + max(s - t, 0) * t


def flash_bounds(shape):
    """Least time of K4, K5 and K6 at `shape`: the larger of their bf16
    tensor-core operations over 989 TFLOP/s (4, 6 and 8 flops a head, a
    pair and a d column: QK^T + PV; QK^T + dO V^T + dS K; QK^T + V dO^T +
    P^T dO + dS^T Q) and the bytes each must move over 3.35 TB/s."""
    b, s, t, g, qpk, d, causal = shape
    pairs = causal_pairs(s, t, causal) * b * g * qpk
    qb = 2 * b * s * g * qpk * d
    kvb = 2 * b * t * g * d
    rowb = 4 * b * s * g * qpk
    out = {}
    for name, f, nbytes in (("fwd", 4, 2 * qb + 2 * kvb + rowb),
                            ("dq", 6, 3 * qb + 2 * kvb + 2 * rowb),
                            ("dkv", 8, 2 * qb + 4 * kvb + 2 * rowb)):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = f * pairs * d / BF16_FLOPS * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations",
                     f * pairs * d)
    return out


def check_flash_kernels():
    """K4, K5 and K6 against their plain versions at the training shape
    (Llama-2-7B heads, s 4096, causal), Llama-2-70B's attention (g 8,
    qpk 8), full attention with t != s, a ragged s, and once with a
    nonzero lse cotangent; two backward runs bitwise equal; times at the
    training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {}
    for label, shape in FLASH_CASES:
        q, k, v, do = flash_inputs(shape, gen)
        errs[label] = flash_errors(q, k, v, do, shape[-1])
        del q, k, v, do
        torch.cuda.empty_cache()
    shape = (2, 512, 512, 8, 4, 128, True)
    q, k, v, do = flash_inputs(shape, gen)
    dlse = torch.randn(2, 512, 8, 4, generator=gen, device="cuda")
    errs["with_dlse"] = flash_errors(q, k, v, do, True, dlse)
    for label, e in errs.items():
        check(e["o"] <= BF16_TOL and e["lse"] <= 1e-3,
              f"K4 {label}: {e}")
        for name in ("dq", "dk", "dv"):
            check(e[name + "_rel"] <= BF16_TOL, f"K5/K6 {label} {name}: {e}")

    main = FLASH_CASES[0][1]
    b, s, t, g, qpk, d, causal = main
    q, k, v, do = flash_inputs(main, gen)
    o, lse = fa._fwd(q, k, v, causal)
    first = fa._bwd(q, k, v, o, lse, do, causal)
    second = fa._bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "flash backward is not deterministic")
    del first, second
    say("kernel_check_flash", max_abs_err=errs, tol=BF16_TOL,
        grad_tol="2e-2 of the reference's max-abs", deterministic=True)

    # times at the training shape (one input set is 134 MB: out of L2)
    qf, kf, vf, dof = fa._fold_q(q), fa._fold_kv(k), fa._fold_kv(v), \
        fa._fold_q(do)
    delta = fa._delta_rows(o, do).contiguous()
    ms = {
        "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, qpk, causal),
                         per_graph=5, replays=4),
        "dq": device_ms(lambda: fa.flash_bwd_dq(qf, kf, vf, dof, lse, delta,
                                                qpk, causal),
                        per_graph=5, replays=4),
        "dkv": device_ms(lambda: fa.flash_bwd_dkv(qf, kf, vf, dof, lse,
                                                  delta, qpk, causal),
                         per_graph=5, replays=4),
    }
    # the wrappers' layout copies around the kernels: q, k, v folded (and
    # o unfolded by the caller's reshape) in the forward; q, k, v, dO
    # folded and delta in the backward
    copies = {
        "fwd": device_ms(lambda: (fa._fold_q(q), fa._fold_kv(k),
                                  fa._fold_kv(v),
                                  o.reshape(b, s, -1).contiguous()),
                         per_graph=5, replays=4),
        "bwd": device_ms(lambda: (fa._fold_q(q), fa._fold_kv(k),
                                  fa._fold_kv(v), fa._fold_q(do),
                                  fa._delta_rows(o, do).contiguous()),
                         per_graph=5, replays=4),
    }
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3),
    }
    torch.cuda.empty_cache()
    # library yardstick: SDPA on (b, heads, s, d), forward, and the
    # backward alone on a retained graph; our forward + backward through
    # autograd on the same (profiler) clock
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, g * qpk, d).transpose(1, 2).detach() \
        .requires_grad_(True)
    ks = k.transpose(1, 2).detach().requires_grad_(True)
    vs = v.transpose(1, 2).detach().requires_grad_(True)
    dos = do.reshape(b, s, g * qpk, d).transpose(1, 2)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True),
                            per_graph=5, replays=4)
    ys = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
    lib_bwd = profiled_ms(lambda: torch.autograd.grad(
        ys, (qs, ks, vs), dos, retain_graph=True), iters=10)
    lib_fwd_bwd = profiled_ms(lambda: torch.autograd.grad(
        sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True), (qs, ks, vs),
        dos), iters=10)
    qa, ka, va = (x.detach().requires_grad_(True) for x in (q, k, v))
    ours_fwd_bwd = profiled_ms(lambda: torch.autograd.grad(
        fa.flash_attention(qa, ka, va, causal), (qa, ka, va), do),
        iters=10)
    del ys, qs, ks, vs, qa, ka, va
    torch.cuda.empty_cache()
    bounds = flash_bounds(main)
    tflops = {n: bounds[n][2] / (ms[n] * 1e-3) / 1e12 for n in ms}
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal bf16"
    say("kernel_time_flash", ms=ms, plain_ms=plain, layout_copy_ms=copies,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        library_fwd_bwd_ms=lib_fwd_bwd, ours_fwd_bwd_ms=ours_fwd_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, achieved_tflops=tflops,
        shape=label)
    rows = []
    for name, which, line, err, plain_ms, lib in (
            ("flash_fwd", "fwd", 262, max(e["o"] for e in errs.values()),
             plain["fwd"], lib_fwd),
            ("flash_bwd_dq", "dq", 388, max(e["dq"] for e in errs.values()),
             plain["bwd"], lib_bwd),
            ("flash_bwd_dkv", "dkv", 448,
             max(max(e["dk"], e["dv"]) for e in errs.values()), plain["bwd"],
             lib_bwd)):
        row = {
            "name": name, "route": "cuda",
            "source": "megatron_llm_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"megatron_llm_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[which], "plain_ms": plain_ms,
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            "library_ms": lib, "achieved_tflops": tflops[which],
            "shape": label, "design": "wgmma+tma",
        }
        if which != "fwd":
            row["plain_and_library_cover"] = "the whole backward (dq, dk, dv)"
        rows.append(row)
    rows[0].update(layout_copy_ms=copies["fwd"], fwd_bwd_ms=ours_fwd_bwd,
                   library_fwd_bwd_ms=lib_fwd_bwd)
    rows[1]["layout_copy_ms"] = copies["bwd"]
    return rows


# ---------------------------------------------------------------------------
# phases 11-13: training at Llama-2-7B width
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_MICRO, TRAIN_STEPS = 8, 4, 8


def train_config():
    """Llama-2-7B widths at 8 of its 32 layers, seq 4096, the kernels on,
    full recompute (examples/pretrain_gpt.sh passes
    --recompute_granularity full), bf16 compute on fp32 params."""
    return llama_config(7, num_layers=TRAIN_LAYERS,
                        params_dtype=torch.float32,
                        compute_dtype=torch.bfloat16,
                        use_flash_attn=True, use_fused_rmsnorm=True,
                        remat_policy="full")


def kernel_counts():
    return {"rmsnorm_fwd": rms.fused_rms_norm.launches,
            "rmsnorm_bwd": rms.rms_norm_bwd.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "decode_attention": dec.decode_attention.launches,
            "ragged_paged_attention": pa.ragged_paged_attention.launches}


def zero_counts():
    for fn in (rms.fused_rms_norm, rms.rms_norm_bwd, fa.flash_fwd,
               fa.flash_bwd_dq, fa.flash_bwd_dkv, dec.decode_attention,
               pa.ragged_paged_attention):
        fn.launches = 0
    pa.ragged_paged_attention.variant_launches = dict.fromkeys(
        pa.ragged_paged_attention.variant_launches, 0)


def train_slice(kernels):
    """8 steps of 4 microbatches through Trainer.setup()/train() on one
    fixed global batch (memorisation): AdamW as in the Llama 2 paper
    (beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0), lr 3e-4 held
    constant over the short run."""
    cfg = train_config()
    model = LlamaModel(cfg)
    tcfg = TrainConfig(micro_batch_size=1, global_batch_size=TRAIN_MICRO,
                       train_iters=TRAIN_STEPS, lr=3e-4,
                       lr_decay_style="constant", adam_beta2=0.95,
                       adam_eps=1e-5, weight_decay=0.1, clip_grad=1.0,
                       log_interval=1, eval_interval=0, seed=SEED)
    text = np.random.RandomState(SEED + 11).randint(
        0, cfg.padded_vocab_size,
        (TRAIN_MICRO, 1, cfg.seq_length + 1)).astype(np.int32)
    trainer = Trainer(model, tcfg,
                      ParallelConfig(num_microbatches=TRAIN_MICRO),
                      train_data_iterator=(text for _ in range(TRAIN_STEPS)))
    t0 = time.perf_counter()
    state = trainer.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats_log = []
    inner = trainer.train_step

    def step(st, txt, *a):
        out = inner(st, txt, *a)
        stats_log.append({k: out[k] for k in ("skipped", "grad_norm")})
        return out
    trainer.train_step = step
    # phase 12 at the initial weights, where the gradients are large
    path_check_train(cfg, model, state, text)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel_counts()
    trainer.train_step = inner
    L, M, S = TRAIN_LAYERS, TRAIN_MICRO, TRAIN_STEPS
    # per step: the flash forward and every layer norm run twice per layer
    # (forward and recompute), the final norm once; the backward kernels
    # once per layer (the final norm's backward too)
    expected = {"flash_fwd": 2 * L * M * S, "flash_bwd_dq": L * M * S,
                "flash_bwd_dkv": L * M * S,
                "rmsnorm_fwd": (2 * L + 1 + 2 * L) * M * S,
                "rmsnorm_bwd": (2 * L + 1) * M * S,
                "decode_attention": 0, "ragged_paged_attention": 0}
    losses = [r["loss"] for r in trainer.step_log]
    skipped = [int(x["skipped"]) for x in stats_log]
    gnorms = [float(x["grad_norm"]) for x in stats_log]
    say("train", config="llama2-7b widths", layers=L,
        hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
        ffn=cfg.ffn_hidden_size, vocab=cfg.padded_vocab_size,
        seq=cfg.seq_length, micro_batches=M, steps=S,
        params=trainer._n_params, remat=cfg.resolved_remat_policy,
        losses=losses, grad_norms=gnorms, skipped=skipped,
        launches=launches, expected_launches=expected,
        setup_s=round(setup_s, 2), train_s=round(train_s, 2),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(state.iteration == S and len(losses) == S, "train steps")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(not any(skipped), f"skipped steps {skipped}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == expected, f"launches {launches} != {expected}")
    for row in kernels:
        if row["name"] == "rmsnorm_fwd":
            row["launches_by_path"]["train"] = launches["rmsnorm_fwd"]
            row["launches"] = sum(row["launches_by_path"].values())
        elif row["name"] in ("rmsnorm_bwd", "flash_fwd", "flash_bwd_dq",
                             "flash_bwd_dkv"):
            paths = row.setdefault("launches_by_path", {})
            paths["train"] = launches[row["name"]]
            row["launches"] = sum(paths.values())
            row["launches_per_train_step"] = launches[row["name"]] / S
    return cfg, model, trainer, state, text


def path_check_train(cfg, model, state, text):
    """One microbatch's loss and gradients at the same (initial) weights
    with the kernels on and off (grouped attention and plain RMSNorm)."""
    from megatron_llm_tpu_torch.training.trainer import get_batch

    plain = LlamaModel(dataclasses.replace(cfg, use_flash_attn=False,
                                           use_fused_rmsnorm=False))
    micro = {k: v[0] for k, v in get_batch(text[:1],
                                            device=model.device).items()}
    leaves = tree_leaves(state.params)
    out = []
    for m in (model, plain):
        loss = m.loss(state.params, **micro)
        grads = torch.autograd.grad(loss, leaves)
        out.append((loss.item(), grads))
        del loss
    (l_on, g_on), (l_off, g_off) = out
    n_on = torch.sqrt(sum(g.double().square().sum() for g in g_on)).item()
    n_off = torch.sqrt(sum(g.double().square().sum() for g in g_off)).item()
    cos = [torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()
        for a, b in zip(g_on, g_off)]
    del out, g_on, g_off
    torch.cuda.empty_cache()
    say("path_check_train", loss_on=l_on, loss_off=l_off,
        loss_abs_diff=abs(l_on - l_off), loss_tol=2e-2,
        grad_norm_on=n_on, grad_norm_off=n_off,
        grad_norm_rel_diff=abs(n_on - n_off) / n_off, grad_norm_tol=5e-2,
        min_leaf_cosine=min(cos), cosine_tol=0.98, leaves=len(cos))
    check(abs(l_on - l_off) <= 2e-2, f"train loss on/off {l_on} {l_off}")
    check(abs(n_on - n_off) / n_off <= 5e-2,
          f"grad norm on/off {n_on} {n_off}")
    check(min(cos) >= 0.98, f"leaf gradient cosine {min(cos)}")


def throughput_train(trainer, state, text):
    """Step time over steps 2-8 (the first pays Triton's and cuBLAS's
    first calls), tokens/s, model TFLOP/s (6 N a token, the trainer's own
    formula) against 989, peak memory; then one more step under
    torch.profiler for the kernels' device time and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = [r["ms"] for r in trainer.step_log[1:]]
    med = float(np.median(ms))
    tokens = TRAIN_MICRO * trainer.cfg.seq_length
    tok_s, tflops = trainer.throughput(TRAIN_MICRO, med / 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_step(state, text)
        float(stats["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            r = e.time_range
            spans.append((r.start, r.end))
            kernels[e.name] = kernels.get(e.name, 0.0) + (r.end - r.start)
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    device_us = sum(kernels.values())
    flash = {k: sum(us for n, us in kernels.items()
                    if f"flash_{k}_kernel" in n) / 1e3
             for k in ("fwd", "bwd_dq", "bwd_dkv")}
    flash_ms = sum(flash.values())
    say("throughput_train", steps_timed=len(ms), step_ms_median=med,
        step_ms=ms, tokens_per_step=tokens, tokens_per_s=tok_s,
        model_tflops=tflops, model_tflops_share_of_989=tflops / 989.0,
        peak_memory_gb_train=peak,
        profiled_step_wall_ms=wall_us / 1e3,
        profiled_device_busy_ms=busy / 1e3 if spans else "not measured",
        device_busy_share=busy / wall_us if spans else "not measured",
        device_kernel_ms_total=device_us / 1e3,
        flash_kernels_ms=flash, flash_ms=flash_ms,
        flash_share_of_step_wall=flash_ms * 1e3 / wall_us,
        flash_share_of_device_ms=(flash_ms * 1e3 / device_us
                                  if device_us else "not measured"),
        top10_kernels_ms=[[n[:120], round(us / 1e3, 3)] for n, us in top])


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
    kernels = [check_decode_kernel(), check_rmsnorm_kernel(),
               *check_paged_kernel()]
    check_paged_variants(kernels[2])
    kernels.append(check_rmsnorm_bwd_kernel(kernels[1]))
    kernels += check_flash_kernels()
    torch.cuda.empty_cache()
    model = build_model(args.init_std)
    serve_whole_batch(kernels, *model)
    bf16 = serve_engine(kernels, *model)
    free_cuda()
    cfg, llama, params, _ = model
    serve_engine_int8(kernels, cfg, llama, params, bf16)
    free_cuda()
    serve_engine_window(kernels, cfg, llama, params)
    free_cuda()
    serve_engine_spec_and_whole_prompt(kernels, cfg, llama, params)
    packed_docs_prefill(kernels, cfg, llama, params)
    serve_engine_fp32(kernels, args.init_std)
    # the 13.5 GB serving model and its engines' pools go before training
    del model, llama, params
    free_cuda()
    say("memory_before_train",
        allocated_gb=torch.cuda.memory_allocated() / 1e9)
    throughput_train(*train_slice(kernels)[2:])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
