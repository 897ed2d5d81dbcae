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
   output; K2 with rstd and K3 also in fp16 (within 5e-3 of max(1, the
   reference's max-abs)); K4, K5 and K6 also in their fp16
   instantiations at the training shape, Llama-2-70B's GQA and full
   attention (within 5e-3, about 5 fp16 ulps at 1), timed beside the
   plain fp16 versions, SDPA in fp16 and the bound
   (kernel_check_flash_fp16, kernel_time_flash_fp16);
4. model: Llama-2-7B at full width and depth, random bf16 weights from a
   fixed seed on the card, built once for every route;
5. serving (whole-batch route, `MegatronServer(engine=None)`): a greedy
   batch of 4 prompts, a sampled, a score-only and a beam request; each
   decode step of the first two replays one captured CUDA graph. The
   launch counters (which replays move as launches do) are set to 0
   before the requests and read after; the decode kernel must have run
   32 times per replayed decode step, the flash forward 32 times (the
   score-only request's no-cache forward);
6. path check: the greedy output teacher-forced back through the same
   cached decode path with the kernels off (plain RMSNorm, plain decode
   attention) on the card; log-probs within 5e-2 max-abs. Greedy tokens
   are not required to match (a random-init 7B has near-flat logits, so
   argmax flips on bf16 rounding): their match fraction is printed;
7. throughput of the greedy batch: prefill ms, the call's capture
   seconds, decode ms per step, the card's ms per decode forward beside
   the weight-streaming floor, tokens/s, and, from the same call run
   again under torch.profiler (CUDA activity only), the card's busy ms
   in that call and its idle share 1 - busy/wall;
8. serving_engine (the continuous-batching route, `MegatronServer(
   engine=DecodeEngine(...))` at the launcher's defaults: 8 slots, page
   64, max_context 2048, horizon 8, chunks of 256, prefix cache on): 16
   requests from concurrent client threads, more than the slots, with
   prompts of 20 to 1500 ids, two sharing a 700-token prefix, one
   sampled and one streamed over SSE. Every engine of phases 8-14b
   captures each round bucket at `start()` (`warmup_compile=True`; the
   window phase, drained without a serve thread, calls `warmup()`) and
   replays a CUDA graph for every round. The counters are set to 0
   before the traffic: the paged kernel must have run 32 times per paged
   forward of the engine's round log (every launch its tc design), the
   RMSNorm kernel too, the decode kernel not at all; the
   prefix cache must show a hit and a copy-on-write copy, and every page
   must be free or cached at the end;
9. path_check_engine: the engine's greedy outputs that asked for
   log-probs, re-scored teacher-forced with the kernels off on the card;
   log-probs within 5e-2 max-abs, greedy-token match fraction printed;
10. throughput_engine: wall time and generated tokens/s over the whole
   traffic, ms per decode-token advance and per mixed round, TTFT p50,
   the device ms of one 8-slot paged decode step beside the weight
   floor, the device ms of one mixed round's paged forward and K7's part
   of it (torch.profiler), peak memory;
10b. graph_capture: 8 of the engine's greedy requests queued and drained
   by the bf16 engine with every round a replayed graph, and the same
   queue's first rounds (every mixed round and 4 decode rounds) with
   every round called eagerly (the private `_eager`), and phase 5's
   greedy batch decoded eagerly (`_eager=True`) and captured, in this one
   call: after those rounds, captured streams equal to eager token for
   token, equal page and prefix-cache accounting; ms per decode advance
   (and per mixed round) of each, the card's busy ms over the run
   window (torch.profiler, CUDA activity only, the rounds themselves
   traced) and the idle share 1 - busy/wall of that window (the
   whole-batch call likewise), the
   card's ms of one 8-slot decode round of 8 steps at 1000 positions
   (eager: its kernels in a torch.profiler trace; captured: replays on
   CUDA events) with its top kernels, the graphs, capture seconds and
   the reserved memory warmup added; one captured round
   replayed under `torch.cuda.set_sync_debug_mode("error")`; a captured
   decode advance must be faster than an eager one on both routes;
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
14c. launcher_llama (the serving entry path, after the 7B of phase 4 is
   written out and freed): its first 8 of 32 layers
   (LLAMA_LAUNCH_LAYERS) written as an HF Llama directory
   (config.json, bf16 safetensors in 2 GB shards with an index) by the
   port's converter and writer, converted by `python -m
   megatron_llm_tpu_torch.tools.convert_weights --direction hf2native
   --dtype bfloat16` into a release whose every leaf equals the smoke's
   bit for bit; then the launcher's `main([--load <release>
   --warmup_compile ...])` in a thread, at its engine defaults, serving
   over HTTP from concurrent clients the first 8 greedy requests of
   phase 8, the streamed one, and one after the other a beam-2 and a
   score-only request. Counters set to 0 before the traffic: K7 once a
   layer per paged forward (tc), K1 once a layer per beam decode step, K4
   once a layer (the score request), K2 never; the greedy streams
   teacher-forced through the kernels-off forward within 5e-2. Then two
   greedy requests, one at a
   time, answered equally by the launcher started as a subprocess
   (`python -m ...run_text_generation_server`). Printed: the seconds of
   the HF write, the conversion, the load, the warmup capture and the
   subprocess's start to its banner; bytes written, tokens/s, TTFT p50,
   ms per decode advance (wall, device), GPU memory after the start;
14d. launcher_falcon: Falcon-7B at full width, 16 of its 32 layers
   (FALCON_LAYERS), random bf16
   weights from a seed written as a release by `save_checkpoint(
   release=True)`; native2hf then hf2native through the CLI at full
   width and 2 layers, bit-exact; the launcher (`--model falcon`) in a
   thread: 8 engine requests, a beam-2 and a score-only request, K7 (tc,
   qpk 71) and K1 (tensor_cores, qpk 71) counted as in 14c, K4 never
   (Falcon runs no flash); the greedy streams teacher-forced through the
   kernels-off forward within 5e-2; tokens/s, TTFT p50, ms per decode
   advance (wall, device) beside the weight floor, an eager decode
   step's top kernels, and K7's and K1's device ms a launch at these
   shapes (torch.profiler). The files live
   under build/launcher_smoke/ (about 27 GB at the peak) and are deleted
   after their checks;
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
   the step with their share of it;
18. finetune_data and finetune (the training entry path, after the
   train phase's model is freed): two JSONL corpora of seeded token ids
   (about 1.5 M tokens each, documents of 64-8192) through the port's
   `preprocess_data` (NullTokenizer, 2 workers), then
   `finetune.main(argv)` three times at Llama-2-7B widths with 2 of 32
   layers (FT_ENTRY_LAYERS), seq 4096, 4 microbatches, bf16 on fp32
   AdamW, full recompute, blend 0.7/0.3, eval every 3 steps: R trains 6
   steps with an async save at 3 and the final save at 6
   (keep_latest_n 1); K is
   R with --exit_signal_handler and a SIGTERM after step 3, so it makes
   its emergency save at 3 and returns; C loads K and trains steps 4-6.
   The counters are set to 0 before each run and read after it: K4, K5
   and K6 run exactly the launches the code implies (eval forwards
   included), K1, K2, K3 and K7 never. C resumes at iteration 3 with 12
   samples consumed, its losses equal R's bit for bit and its final
   checkpoint R's leaf by leaf; the g++ sample indices equal their
   numpy version and the first batches are the samples the sampler
   names. Printed with the card's name and power limit: ms per step
   (median of R's steps 2-6) beside the train phase's, model TFLOP/s,
   the loader's host ms a step, preprocess s, each save's blocked ms
   and commit s, bytes on disk and the load's s. The checkpoints live
   under build/finetune_smoke/ and are deleted after their checks;
17b. train_remat (between 17 and 18): phase 15's trainer from its initial
   weights and batch, 3 steps under each recompute policy ("full",
   "selective", "save_dots", "offload", and "full" on the first 4 layers
   by `recompute_method` block): ms a step, peak memory, GEMM and flash
   device ms of a profiled step, launches a step checked against the
   policy (K4 2 L M under full, L M under the named-save-point policies,
   (L + 4) M under block), step 1's loss and gradient norm equal across
   policies;
19. finetune_modes (on phase 18's corpora, no --save): `finetune.main`
   at 4 of 32 layers in (a) the fine-tuning recipe's training flags
   (flash, selective recompute, bf16), and the same in a process of
   its own with the recipe's parallel flags (`--tensor_model_parallel_size
   1 --sequence_parallel --use_distributed_optimizer`) under `torchrun
   --nproc_per_node 1`, an NCCL group of world size 1: launches equal,
   losses and grad norms within 2e-2 / 5e-2 (bit for bit printed), ms a
   step within 3%; (b) fp16 with the dynamic scaler
   from 2^32 for 16 steps (the scale and skip sequence follows the
   scaler's rule, at least 3 steps taken, K4-K6 in fp16 only), (c)
   hidden, attention and LIMA dropout under full recompute (no flash
   launch: the grouped path) beside one step without recompute at the
   same seed (step 1's loss and gradient norm equal);
20. finetune_parallel: `torchrun --nproc_per_node 4` runs `finetune.main`
   in four ranks (this script's rank mode, `--finetune-rank`) at tp 2 x
   dp 2 with sequence parallelism and ZeRO-1 over gloo, every rank on
   cuda:0 and every collective staged through host memory, on the
   recipe's flags and phase 18's corpora: 3 steps and a save, then the
   same ranks resume it for step 4, and world size 1 resumes it too.
   Losses and grad norms within 2e-2 / 5e-2 of (a)'s world-size-1 run
   (the same weights and global batches); every rank reports the same;
   K4-K6 8 launches a rank a step; the checkpoint cut into each rank's
   pieces equal to what the rank held (a positional checksum of every
   leaf's bits); step 4 after either resume within 2e-2 of (a)'s.
   Printed: per-rank peak memory and their sum, the backend and the
   staging, ms a step labelled as gloo through the host on one shared
   card. Also, after the kernel checks, kernel_time_flash_tp2: K4-K6 at
   a tp 2 rank's attention shape (g 16) beside SDPA and their plain
   versions, within 2e-2;
21. pipeline: `torchrun --nproc_per_node 2` runs `finetune.main` at pp 2
   (`--pipeline_model_parallel_size 2 --pipeline_remat tick`, the
   recipe's flags, 4 of 32 layers, 2 a stage) over gloo, both stages on
   cuda:0: 3 steps and a save with the optimizer state, then the same
   ranks resume it (optimizer state included) for step 4 and serve it
   through the API (a pipelined score, four greedy requests through the
   stage ring), and world size 1 runs the same 4 steps, resumes the
   save for step 4 and serves it whole-batch. Losses and grad norms
   within 2e-2 / 5e-2 of world size 1, step 4 at pp 2 and pp 1 within
   1e-4, every leaf of the checkpoint (Adam moments included) cut into
   each stage's pieces equal to what the stage held, the scorer's
   log-probs within 5e-2 of the whole-batch route's and the ring's over
   each common prefix within 5e-2 of the one-rank route run on the
   ring's row groups (the same GEMM rows; the drift of the 4-row route
   from the 2-row one is printed beside it); per rank K4 16, K5 8, K6 8
   a step, the scorer's K4 once a stage layer, the ring's K1 in "tgd"
   once a stage layer a decode tick. Also, after the kernel checks,
   kernel_time_decode_ring: K1 on one layer's "tgd" slice of the ring's
   stacked cache against its plain version, beside SDPA and the bound.

Then a line of each phase's seconds, a line of the processes the run
still had to stop, one JSON line of the kernels, the nvidia-smi line,
and the last line `{"ok": true, "device": {...}}`.

Every process the run starts ends with it: the script is its
descendants' child subreaper, so a process orphaned by a parent that
exited (torchrun starts each rank in a session of its own) comes back
to it; before the result, and in `finally` when a phase fails, it stops
the multiprocessing resource tracker that preprocess_data's pool
started, then terminates, kills and reaps every descendant left.
Without a CUDA card it exits 2 and prints no result.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    falcon_config,
    llama_config,
)
from megatron_llm_tpu_torch.convert import hf as hf_conv
from megatron_llm_tpu_torch.convert import safetensors_io
from megatron_llm_tpu_torch.inference.engine import (
    DecodeEngine,
    horizon_buckets,
    mixed_width_buckets,
)
from megatron_llm_tpu_torch.inference.generation import (
    bucket_prefill_len,
    decode_log,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.inference.tokenization import tokenize_prompts
from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
from megatron_llm_tpu_torch.ops import _build
from megatron_llm_tpu_torch.ops import decode_attention as dec
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.ops.quantization import quantize_rows
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs
from megatron_llm_tpu_torch.training import checkpointing as ckpt
from megatron_llm_tpu_torch.training.trainer import Trainer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
BF16_TOL = 2e-2
# fp16 kernels against their plain fp16 versions: about 5 fp16 ulps at 1
# (bf16's 2e-2 is about 2.5 of its ulps); both round at the same places
FP16_TOL = 5e-3
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


PR_SET_CHILD_SUBREAPER = 36  # prctl(2)


def become_subreaper():
    """Orphaned descendants are reparented to this process, not init."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
          f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")


def descendants(root: int) -> list:
    """[(pid, command line)] of every live process below `root`, from
    /proc (zombies included: they still need reaping)."""
    kids = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:  # it exited while the table was read
            continue
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        kids.setdefault(ppid, []).append(int(entry))
    out, todo = [], list(kids.get(root, []))
    while todo:
        pid = todo.pop()
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = ""
        out.append((pid, cmd.strip()))
        todo += kids.get(pid, [])
    return out


def stop_tree(root: int, grace_s: float = 5.0) -> list:
    """SIGTERM every descendant of `root`, SIGKILL what is left after
    `grace_s`, and reap those that are this process's children: the
    command lines found."""
    found = descendants(root)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in descendants(root):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            for pid, _ in descendants(os.getpid()):
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
            if not descendants(root):
                return [cmd for _, cmd in found]
            time.sleep(0.05)
    check(not descendants(root), f"processes left below {root}: "
          f"{descendants(root)}")
    return [cmd for _, cmd in found]


def stop_children() -> list:
    """The resource tracker stopped (it ignores SIGTERM and would
    outlive this process until it reads EOF), then every other
    descendant: the command lines found."""
    import multiprocessing.resource_tracker as rt

    tracker = rt._resource_tracker
    stopped = []
    if tracker._pid is not None:
        stopped.append("multiprocessing resource tracker "
                       f"(pid {tracker._pid})")
        tracker._stop()
    return stopped + stop_tree(os.getpid())


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
    # on the warm-up stream: its arrival counters are sized already
    with torch.cuda.graph(graph, stream=side):
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
    for _ in range(warmup - 1):
        fn()
    return top_kernels(fn, calls=iters)[0] or 0.0


def cuda_trace(fn):
    """`fn()` under torch.profiler with CUDA activity only: (its result,
    wall s, [(name, start ns, end ns)] of the card's kernels and copies).
    The raw events, not the parsed event list, which takes the host
    seconds to minutes for a window of many thousand kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return out, wall, events


def kernel_totals(events):
    """{kernel name: device ms} summed over `events`."""
    out = {}
    for name, a, b in events:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def busy_ms(events):
    """The union of the events' intervals, in ms: the card's busy time."""
    busy, end = 0, 0
    for a, b in sorted((a, b) for _, a, b in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def top_kernels(fn, calls=3, n=10):
    """(device ms per call, [[kernel, ms per call]] of the n largest) in a
    torch.profiler trace of `calls` calls after one warm-up; (None, [])
    when the trace shows no device time (a graph replay whose kernels
    the profiler does not see)."""
    fn()
    _, _, events = cuda_trace(lambda: [fn() for _ in range(calls)])
    kernels = kernel_totals(events)
    if not kernels:
        return None, []
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:n]
    return (sum(kernels.values()) / calls,
            [[k[:100], round(ms / calls, 4)] for k, ms in top])


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


def busy_window(fn):
    """`fn()` under torch.profiler with CUDA activity only (the host's
    launches pay no per-op recording): (its result, wall s, the card's
    busy s in that window: the union of its kernels' and copies'
    intervals; None when the trace shows no device activity)."""
    out, wall, events = cuda_trace(fn)
    return out, wall, (busy_ms(events) / 1e3 if events else None)


def replay_ms(fn, n=20):
    """Mean ms per call of `fn` (a graph replay) on CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def whole_batch_timing(model, params, toks, lens, kw, eager=False):
    """A warm `generate_tokens` call (captured, or `_eager`), timed: wall
    ms, the prefill forward's ms alone, the call's capture seconds (its
    warm-up steps included; 0 eager), decode steps and ms per step (wall
    less prefill and capture); then the same call again under
    torch.profiler: its wall, the card's busy ms in it, the idle share
    1 - busy/wall of that traced window and, beside it, over the timed
    call's wall (the trace slows the host's side: the lower bound).
    Returns (record, output)."""
    def call():
        return generate_tokens(model, params, toks, lens, _eager=eager,
                               **kw)
    if not eager:  # an eager call has nothing to warm: phase 5 ran it
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = decode_log[-1]
    _, p_wall, busy = busy_window(call)
    with torch.inference_mode():
        dp = model.prepare_decode_params(params)
        caches = model.init_kv_caches(*toks.shape)
        prefix = torch.from_numpy(toks[:, :kw["prefill_len"]]).long().cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(dp, prefix, kv_caches=caches)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
    capture = rec["capture_s"]
    return {"wall_ms": wall * 1e3, "prefill_ms": prefill * 1e3,
            "capture_ms": capture * 1e3,
            "static_cache_bytes": rec["cache_bytes"],
            "decode_steps": rec["steps"],
            "decode_ms_per_step": (wall - prefill - capture)
            / rec["steps"] * 1e3,
            "profiled_wall_ms": p_wall * 1e3,
            "device_busy_ms": busy * 1e3 if busy else "not measured",
            "device_idle_share_traced": 1 - busy / p_wall if busy
            else "not measured",
            "device_idle_share_untraced_wall": 1 - busy / wall if busy
            else "not measured",
            "captured": rec["captured"]}, out


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
    rs = np.random.RandomState(SEED)
    lens = [20, 75, 130, 200]
    prompts = [" ".join(map(str, rs.randint(0, 31999, n))) for n in lens]
    try:
        zero_counts()

        # greedy batch: each decode step one replay of a captured graph
        decode_log.clear()
        t_req = time.perf_counter()
        greedy = put(port, {"prompts": prompts, "tokens_to_generate": 64,
                            "logprobs": True, "top_k": 1})
        t_req = time.perf_counter() - t_req
        calls = list(decode_log)
        steps = sum(r["steps"] for r in calls)
        warm = sum(r["warmup_steps"] for r in calls)
        k1_greedy = dec.decode_attention.launches
        check(len(calls) == 1 and calls[0]["captured"] and steps > 0,
              f"the whole-batch decode did not replay a captured step: "
              f"{calls}")
        check(k1_greedy == cfg.num_layers * (steps + warm),
              f"K1 launches {k1_greedy} != {cfg.num_layers} x ({steps} "
              f"replayed + {warm} warm-up steps)")
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
            greedy_decode_steps=steps, greedy_warmup_steps=warm,
        decode_attention_launches_greedy=k1_greedy,
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
    # shapes, the step is captured)
    rec, _ = whole_batch_timing(model, params, toks0, lens0, kw)
    # the card's own time for one decode forward alone: a single-token 7B
    # forward (kernels on, cache length 300 of 320) captured in a graph
    with torch.inference_mode():
        dp = model.prepare_decode_params(params)
        caches = dict(model.init_kv_caches(4, toks0.shape[1]), offset=299)
        tok1 = torch.from_numpy(toks0[:, 299:300]).long().to(model.device)
        forward_device_ms = device_ms(
            lambda: model.forward(dp, tok1, kv_caches=caches),
            per_graph=4, replays=5)
    wall = rec["wall_ms"] / 1e3
    say("throughput", batch=4, prefill_tokens=kw["prefill_len"],
        decode_steps=rec["decode_steps"], prefill_ms=rec["prefill_ms"],
        capture_ms=rec["capture_ms"],
        decode_ms_per_step=rec["decode_ms_per_step"],
        decode_forward_device_ms=forward_device_ms,
        profiled_call_wall_ms=rec["profiled_wall_ms"],
        profiled_call_device_busy_ms=rec["device_busy_ms"],
        profiled_call_device_idle_share=rec["device_idle_share_traced"],
        device_idle_share_untraced_wall=rec[
            "device_idle_share_untraced_wall"],
        weight_stream_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        generate_s=wall, requested_tokens_per_s=4 * 64 / wall,
        decoded_tokens_per_s=4 * rec["decode_steps"] / (
            wall - rec["prefill_ms"] / 1e3 - rec["capture_ms"] / 1e3),
        static_cache_bytes=rec["static_cache_bytes"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return toks0, lens0, kw


# ---------------------------------------------------------------------------
# phases 8-10: Llama-2-7B on the continuous-batching route
# ---------------------------------------------------------------------------


def paged_forwards(rounds):
    """The paged forwards an engine's rounds ran (a decode round one a
    step of its horizon, a mixed or verify round one), from its round
    log: replayed graphs call no Python forward to count."""
    return sum(r["decode_steps"] for r in rounds)


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
    horizon 8, chunks of 256, prefix cache; every round bucket captured
    at `start()` (`warmup_compile`)."""
    kw = dict(slots=8, page_size=64, max_context=2048, step_horizon=8,
              prefill_chunk_tokens=256, prefix_cache=True,
              termination_id=tok.eod, vocab_size=tok.vocab_size,
              warmup_compile=True)
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
        server.stop()
    rounds = list(eng._round_log)
    return {"results": results, "launches": launches, "variants": variants,
            "metrics": metrics, "wall": wall,
            "paged": paged_forwards(rounds), "rounds": rounds,
            "graphs": eng.graph_stats()}


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
        _, _, events = cuda_trace(lambda: [forward() for _ in range(calls)])
    kernels = kernel_totals(events)
    total = sum(kernels.values())
    k7 = sum(ms for name, ms in kernels.items() if "paged_attn" in name)
    return total / calls, k7 / calls


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
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {"greedy": greedy, "bytes_per_token": eng.kv_bytes_per_token(),
            "tokens_per_s": generated / run["wall"],
            "decode_ms_per_advance": advance, "decode_step_device_ms": step_ms}


# ---------------------------------------------------------------------------
# phase 10b: the same traffic eagerly and captured, in one call
# ---------------------------------------------------------------------------

CAPTURE_REQUESTS = 8


def _engine_device_ms(eng, horizon=8, length=1000):
    """The card's ms for one decode round of `horizon` steps with every
    slot live at `length` (pages 1.. of the drained engine's pool): on
    an `_eager` engine the round's kernels in a torch.profiler trace;
    else the captured round's replay on CUDA events, and its kernels'
    profile. Returns (ms, top kernels, the round's host arrays, its
    runner)."""
    n, per = eng.slots, -(-(length + horizon) // eng.page_size)
    pt = np.zeros_like(eng._pt)
    for i in range(n):
        pt[i, :per] = 1 + i * per + np.arange(per)
    host = {**eng._null_scan_args(horizon), "page_table": pt,
            "lengths": np.full(n, length, np.int32),
            "active": np.ones(n, bool)}
    with torch.inference_mode():
        runner = eng._step_fn(horizon, True)
        ms, top = top_kernels(lambda: runner(**host))
        if runner.captured:
            ms = replay_ms(lambda: runner(**host), n=10)
        return ms, top, host, runner


EAGER_DECODE_ROUNDS = 4


def eager_prefix(eng):
    """Step the engine until it has run EAGER_DECODE_ROUNDS decode rounds
    (every prompt admitted by then): the eager side's share of the
    traffic. Returns the rounds run."""
    while sum(not r["prefill_tokens"] for r in eng._round_log) \
            < EAGER_DECODE_ROUNDS:
        check(eng.step(), "the engine drained before the eager prefix")
    return len(eng._round_log)


def _traced_drain(model, params, tok, traffic, eager, rounds=None):
    """The same traffic again, on a fresh engine (warmed up unless
    `eager`), drained (or stepped `rounds` rounds) under `busy_window`:
    (rounds, wall s, busy s)."""
    eng = DecodeEngine(model, params, **engine_kwargs(
        tok, warmup_compile=False))
    eng._eager = eager
    if not eager:
        eng.warmup()
    for p, g in traffic:
        eng.submit(p, g, top_k=1, return_log_probs=True)
    run = eng.drain if rounds is None else \
        (lambda: [eng.step() for _ in range(rounds)])
    _, wall, busy = busy_window(run)
    return len(eng._round_log), wall, busy


def graph_capture_phase(kernels, cfg, model, params, whole_batch):
    """Llama-2-7B at full width and depth: the first 8 greedy requests of
    the engine traffic queued and drained (a fixed schedule) by the bf16
    engine with every round a replayed CUDA graph, and the same queue's
    first rounds (every mixed round and EAGER_DECODE_ROUNDS decode rounds:
    the eager prefix) with every round called eagerly (the private
    `_eager`); and the whole-batch greedy batch decoded eagerly and
    captured. Gates: after the eager prefix's rounds the captured
    engine's streams equal the eager ones token for token (log-probs
    too), with equal page and prefix-cache accounting; every paged
    forward's K7 launches counted through replays; ms per decode advance
    lower captured than eager on both routes; one captured decode round
    replays under `torch.cuda.set_sync_debug_mode("error")` (its
    read-back left out). The device's busy time comes from the same
    rounds run again under torch.profiler (their count is checked): idle
    is 1 - busy/wall over that traced window, and, beside it, over the
    untraced run's wall (the trace slows the host's side of a round: the
    untraced figure is the lower bound)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    traffic = [(p, pl["tokens_to_generate"]) for name, p, pl
               in engine_traffic() if name.startswith("greedy")]
    traffic = traffic[:CAPTURE_REQUESTS]
    runs = {}
    prefix = None  # the eager prefix's rounds
    for mode in ("eager", "captured"):
        eng = DecodeEngine(model, params, **engine_kwargs(
            tok, warmup_compile=False))
        eng._eager = mode == "eager"
        free_cuda()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        if mode == "captured":
            eng.warmup()
        warmup_s = time.perf_counter() - t0
        graph_bytes = torch.cuda.memory_reserved() - reserved
        reqs = [eng.submit(p, g, top_k=1, return_log_probs=True)
                for p, g in traffic]
        zero_counts()
        t0 = time.perf_counter()
        if mode == "eager":
            prefix = eager_prefix(eng)
        else:
            for _ in range(prefix):
                eng.step()
        c = eng.counters()
        # the streams and the accounting after the eager prefix's rounds
        at_prefix = ([(list(r.tokens), list(r.log_probs or []))
                      for r in reqs],
                     ({k: c[k] for k in c if k.startswith(
                         ("serve_pages", "serve_prefix", "serve_steps",
                          "serve_prefill", "serve_admitted",
                          "serve_retired"))}, sorted(eng._free_pages)))
        if mode == "captured":
            eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = list(eng._round_log)
        mixed = [r["ms"] for r in rounds if r["prefill_tokens"]]
        run = {"at_prefix": at_prefix,
               "launches": kernel_counts(),
               "variants": dict(pa.ragged_paged_attention.variant_launches),
               "paged": paged_forwards(rounds), "wall_s": wall,
               "decode_ms_per_advance": ms_per_advance(rounds),
               "mixed_round_ms": sum(mixed) / max(len(mixed), 1),
               "rounds": len(rounds), "mixed_rounds": len(mixed)}
        if mode == "captured":
            run["outs"] = [r.result(60) for r in reqs]
            run["pages_free"] = eng.counters()["serve_pages_free"]
        check_paged_launches(cfg, run, f"graph_capture_{mode}", "fp")
        if mode == "captured":
            stats = eng.graph_stats()
            flags = (True, False)
            check(set(eng._step_fns) == {(h, f) for f in flags for h in
                                         horizon_buckets(eng.step_horizon)}
                  and set(eng._mixed_fns) == {
                      (w, f) for f in flags for w in
                      mixed_width_buckets(eng.prefill_chunk_tokens)}
                  and stats["graphs"] == len(eng._step_fns)
                  + len(eng._mixed_fns), f"graphs {stats}")
            run.update(graphs=stats["graphs"], warmup_s=warmup_s,
                       capture_s=stats["capture_s"],
                       graph_memory_reserved_bytes=graph_bytes)
        (run["decode_round_device_ms"], run["decode_round_top_kernels_ms"],
         host, runner) = _engine_device_ms(eng)
        if run["decode_round_device_ms"] is None:  # no device time traced
            run["decode_round_device_ms"] = "not measured"
        if mode == "captured":
            # the round's replay (its input copies included) under the
            # sync check; the read-back after it is the one intended sync
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.inference_mode():
                    chosen, _ = runner(**host)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(bool((chosen >= 0).all()), "sync-checked round output")
            run["sync_debug_replay"] = "ok"
        eng = runner = None
        free_cuda()
        n_rounds, t_wall, busy = _traced_drain(
            model, params, tok, traffic, mode == "eager",
            prefix if mode == "eager" else None)
        check(n_rounds == len(rounds),
              f"traced drain: {n_rounds} rounds, untraced {len(rounds)}")
        run.update(traced_wall_s=t_wall,
                   device_busy_s=busy or "not measured",
                   device_idle_share_traced=1 - busy / t_wall if busy
                   else "not measured",
                   device_idle_share_untraced_wall=1 - busy / wall if busy
                   else "not measured")
        runs[mode] = run
        free_cuda()
    e, g = runs["eager"], runs["captured"]
    (e_out, e_acc), (g_out, g_acc) = e["at_prefix"], g["at_prefix"]
    check([t for t, _ in g_out] == [t for t, _ in e_out],
          "engine: captured greedy streams differ from eager")
    lp_diff = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for (_, a), (_, b) in zip(g_out, e_out) if a), default=0.0)
    check(g_acc == e_acc, f"engine accounting {g_acc} != {e_acc}")

    toks, lens, kw = whole_batch
    wb = {}
    for mode in ("eager", "captured"):
        wb[mode], out = whole_batch_timing(model, params, toks, lens, kw,
                                           eager=mode == "eager")
        wb[mode]["out"] = out
    we, wg = wb["eager"]["out"], wb["captured"]["out"]
    check(torch.equal(we.tokens, wg.tokens)
          and torch.equal(we.lengths, wg.lengths),
          "whole batch: captured tokens differ from eager")
    for rec in wb.values():
        del rec["out"]
    summary = {m: {k: v for k, v in r.items()
                   if k not in ("outs", "at_prefix")}
               for m, r in runs.items()}
    say("graph_capture", requests=len(traffic),
        engine=summary, engine_streams_equal_through_round=prefix,
        engine_accounting_equal=True,
        engine_pages_free=g["pages_free"],
        engine_logprob_max_abs_diff=lp_diff,
        whole_batch=wb, whole_batch_tokens_equal=True,
        nvidia_smi=nvidia_smi())
    check(g["decode_ms_per_advance"] < e["decode_ms_per_advance"],
          "engine: a captured decode advance is not faster than eager")
    check(wb["captured"]["decode_ms_per_step"]
          < wb["eager"]["decode_ms_per_step"],
          "whole batch: a captured step is not faster than eager")


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
        eng.warmup()  # drained without start(): capture first
        zero_counts()
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [r.result(60) for r in reqs]
        rec = {"outs": [(list(t), list(lp)) for t, lp in outs],
               "launches": kernel_counts(),
               "variants": dict(pa.ragged_paged_attention.variant_launches),
               "paged": paged_forwards(eng._round_log),
               "rounds": list(eng._round_log),
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
# phases 14c-14d: the serving entry path (converter CLI -> release ->
# launcher -> HTTP) for Llama-2-7B and Falcon-7B
# ---------------------------------------------------------------------------

REPO_DIR = Path(__file__).resolve().parent
LAUNCH_DIR = REPO_DIR / "build" / "launcher_smoke"
LLAMA_DISK_GB, FALCON_DISK_GB = 30, 20
LAUNCHER_REQUESTS = 8  # the first greedy requests of engine_traffic()
BEAM_GEN = 16
LAUNCH_TIMEOUT_S = 900


def need_disk(gb):
    """Free GB where the phase writes; raises, with the numbers, unless
    its files fit."""
    LAUNCH_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(LAUNCH_DIR).free / 1e9
    check(free >= gb, f"{LAUNCH_DIR}: {free:.1f} GB free, the phase writes "
                      f"about {gb} GB")
    return free


def convert(*argv):
    """`python -m megatron_llm_tpu_torch.tools.convert_weights argv` from
    the checkout's root, as a user runs it (a fresh process: no CUDA
    context of this one reaches it); returns its seconds."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "megatron_llm_tpu_torch.tools.convert_weights",
         *map(str, argv)], cwd=REPO_DIR, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    check(out.returncode == 0, f"convert_weights {argv}: rc "
                               f"{out.returncode}\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-4000:]}")
    return time.perf_counter() - t0


def release_leaves_equal(ckpt_dir, params):
    """Every leaf of the release in `ckpt_dir` equals `params`' (on the
    card) bit for bit; returns the number of leaves."""
    flat = torch.load(Path(ckpt_dir) / "release" / "model",
                      map_location="cpu", mmap=True, weights_only=True)
    ref = ckpt.flatten(params)
    check(sorted(flat) == sorted(ref), f"release leaves {sorted(flat)}")
    for k, v in ref.items():
        check(flat[k].dtype == v.dtype and flat[k].shape == v.shape
              and torch.equal(flat[k].to(v.device), v),
              f"release leaf {k} differs from the smoke's weights")
    return len(ref)


def tree_bytes(tree):
    """Bytes of a parameter tree (the decode tree's layers are a tuple)."""
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tree_bytes(x) for x in tree.values())
    return tree.numel() * tree.element_size()


class InThreadLauncher:
    """The launcher's `main(argv)` on the card in a thread of this
    process, started and stopped as a caller of `ready` does."""

    def __init__(self, argv):
        box, ready = {}, threading.Event()

        def run():
            try:
                rtgs.main(argv, ready=lambda launch: (
                    box.update(launch=launch), ready.set()))
            except BaseException as e:  # noqa: BLE001 - raised below
                box["error"] = e
                ready.set()

        self.box = box
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        ready.wait(LAUNCH_TIMEOUT_S)
        if "error" in box:
            raise box["error"]
        check("launch" in box, "the launcher did not start")
        launch = box["launch"]
        self.port, self.load_s, self.setup_s = (launch.port, launch.load_s,
                                                launch.setup_s)
        self.server = launch.server

    def stop(self):
        """main stops the engine, frees the model and returns."""
        self.box.pop("launch").stop()
        self.server = None
        self.thread.join(timeout=300)
        check(not self.thread.is_alive(), "the launcher did not return")
        if "error" in self.box:
            raise self.box["error"]
        free_cuda()


def launcher_traffic(stream=True):
    """The first 8 greedy requests of the engine traffic (prompts 20-1500,
    64-128 new tokens) and, with `stream`, the streamed one; and the
    whole-batch pair, a beam-2 request and a score-only request."""
    traffic = engine_traffic()
    out = traffic[:LAUNCHER_REQUESTS]
    if stream:
        out += [x for x in traffic if x[0] == "stream"]
    p, q = traffic[2][1][:200], traffic[4][1][:300]

    def text(x):
        return " ".join(map(str, x))

    whole = [("beam", p, {"prompts": [text(p)], "beam_width": 2,
                          "tokens_to_generate": BEAM_GEN}),
             ("score", [p, q], {"prompts": [text(p), text(q)],
                                "tokens_to_generate": 0, "logprobs": True})]
    return out, whole


def drive_launcher(port, eng, traffic, whole):
    """The engine traffic from concurrent client threads and, from one
    more, the beam and score requests one after the other (the
    whole-batch route takes one request at a time); every launch count
    set to 0 just before, read just after."""
    results = {}

    def client(name, payload):
        results[name] = put_raw(port, payload)

    def serial():
        for name, _, payload in whole:
            results[name] = put_raw(port, payload)

    threads = [threading.Thread(target=client, args=(name, payload))
               for name, _, payload in traffic]
    threads.append(threading.Thread(target=serial))
    n0 = len(eng._round_log)
    zero_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    variants = dict(pa.ragged_paged_attention.variant_launches)
    check(all(not th.is_alive() for th in threads), "launcher clients hung")
    rounds = list(eng._round_log)[n0:]
    return {"results": results, "launches": launches, "variants": variants,
            "wall": wall, "rounds": rounds, "paged": paged_forwards(rounds)}


def check_launcher_run(cfg, run, whole, flash):
    """The beam answer (2 texts, finite scores) and the score-only answer
    (the prompts echoed, finite log-probs); K7 ran once per layer per
    paged forward, every launch tc; K1 once per layer per beam decode
    step; K4 once per layer (the score request's no-cache forward) where
    the config runs flash, else never; K2, K3, K5, K6 never. Returns the
    beam's decode steps."""
    (_, p, _), (_, pq, _) = whole
    status, beam = run["results"]["beam"]
    check(status == 200 and len(beam["text"]) == 2
          and len(beam["scores"]) == 2 and np.isfinite(beam["scores"]).all()
          and all(len(p) < len(t.split()) <= len(p) + BEAM_GEN
                  for t in beam["text"]), f"beam answer {status} {beam}")
    status, score = run["results"]["score"]
    check(status == 200 and [len(t.split()) for t in score["text"]]
          == [len(x) for x in pq], f"score answer {status}")
    for lp, x in zip(score["logprobs"], pq):
        check(np.isfinite(lp[:len(x) - 1]).all(), "score logprobs")
    n, L = run["launches"], cfg.num_layers
    k1, k7 = n["decode_attention"], n["ragged_paged_attention"]
    steps = k1 // L
    check(k1 == L * steps and 1 <= steps <= BEAM_GEN,
          f"K1 launches {k1}: not {L} x the beam's decode steps")
    check(k7 == L * run["paged"] and k7 > 0 and run["variants"]["tc"] == k7,
          f"K7 launches {k7} (designs {run['variants']}) != {L} x "
          f"{run['paged']} paged forwards, all tc")
    check(n["flash_fwd"] == (L if flash else 0)
          and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 0,
          f"flash launches {n}")
    check(n["rmsnorm_fwd"] == n["rmsnorm_bwd"] == 0, f"K2/K3 ran: {n}")
    return steps


def note_launcher_launches(kernels, path, run):
    """The path's launches on the K1, K4 and K7 rows (and K2's, 0)."""
    note_launches(kernels, path, run)
    for row in kernels:
        if row["name"] in ("decode_attention", "flash_fwd"):
            if "launches_by_path" not in row:  # K1: the whole-batch count
                row["launches_by_path"] = {"whole_batch": row["launches"]}
            by = row["launches_by_path"]
            by[path] = run["launches"][row["name"]]
            row["launches"] = sum(by.values())


def sequential_greedy(port, payloads):
    """The payloads one at a time: each answer's token ids."""
    out = []
    for payload in payloads:
        status, body = put_raw(port, payload)
        check(status == 200, f"sequential greedy -> {status} {body}")
        out.append(list(map(int, body["text"][0].split())))
    return out


def sequential_payloads():
    rs = np.random.RandomState(SEED + 41)
    return [{"prompts": [" ".join(map(str, rs.randint(0, 31999, n)))],
             "tokens_to_generate": 32, "top_k": 1} for n in (300, 60)]


def launcher_subprocess(argv, payloads):
    """The launcher started as a user starts it, `python -m ...`: seconds
    to its banner line, its answers to `payloads` sent one at a time, and
    the banner. SIGINT stops it (main drains and returns); it is killed
    if it does not exit."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_llm_tpu_torch.tools.run_text_generation_server", *argv],
        cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, banner = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                banner.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        banner.wait(LAUNCH_TIMEOUT_S)
        banner_s = time.perf_counter() - t0
        check(banner.is_set(), "the launcher subprocess printed no "
                               "banner:\n" + "".join(lines)[-3000:])
        line = next(x for x in lines if x.startswith("serving "))
        port = int(re.search(r"http://[^:/]+:(\d+)/api", line).group(1))
        answers = sequential_greedy(port, payloads)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    check(proc.returncode == 0, f"launcher subprocess rc {proc.returncode}:"
                                "\n" + "".join(lines)[-3000:])
    return banner_s, answers, line.strip()


# the serving entry path's depth: Llama-2-7B's width at 8 of its 32
# layers (the conversion's disk traffic is a quarter), to keep the whole
# smoke within 950 s beside the pipeline phase's optimizer-state save
LLAMA_LAUNCH_LAYERS = 8


def first_layers(cfg, params, n):
    """The config and weights of the first n layers (copies: the whole
    model can be freed)."""
    layers = ckpt.unflatten({k: v[:n].clone() for k, v in
                             ckpt.flatten(params["layers"]).items()})
    return dataclasses.replace(cfg, num_layers=n), dict(params,
                                                        layers=layers)


def convert_llama(cfg, params):
    """The smoke's Llama-2-7B weights (phase 4) at LLAMA_LAUNCH_LAYERS of
    its 32 layers written as an HF Llama directory (config.json, sharded
    bf16 safetensors with an index) through the port's converter and
    writer, then converted by the CLI's hf2native into a bf16 release,
    whose every leaf must equal the smoke's bit for bit. Runs while the
    weights are on the card; returns the conversion's facts and the
    weights it converted."""
    cfg, params = first_layers(cfg, params, LLAMA_LAUNCH_LAYERS)
    free_gb = need_disk(LLAMA_DISK_GB)
    hf_dir, rel_dir = LAUNCH_DIR / "hf_llama", LAUNCH_DIR / "llama"
    for d in (hf_dir, rel_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    sd = hf_conv.native_to_hf_llama(params, cfg, dtype=torch.bfloat16)
    safetensors_io.write_hf_config(str(hf_dir), safetensors_io.llama_hf_config(
        cfg, cfg.padded_vocab_size, torch.bfloat16))
    # 2 GB shards: the 3.77 GB of 8 layers still take the sharded layout
    hf_bytes = safetensors_io.save_sharded(sd, str(hf_dir),
                                           max_shard_bytes=2 * 10**9)
    del sd
    free_cuda()
    hf_write_s = time.perf_counter() - t0
    shards = len(list(hf_dir.glob("*.safetensors")))
    convert_s = convert("--model", "llama", "--direction", "hf2native",
                        "--dtype", "bfloat16", "--input", hf_dir,
                        "--output", rel_dir)
    leaves = release_leaves_equal(rel_dir, params)
    shutil.rmtree(hf_dir)
    return {"disk_free_gb": free_gb, "hf_write_s": hf_write_s,
            "hf_bytes": hf_bytes, "hf_shards": shards,
            "convert_s": convert_s, "release_leaves_equal": leaves,
            "release_bytes": dir_bytes(rel_dir / "release"),
            "release": rel_dir}, (cfg, params)


def teacher_forced(model, params, greedy):
    """The greedy outputs teacher-forced through `model`'s no-cache
    forward: the largest |log-prob difference| and the share of
    generated positions where its argmax is the stream's token."""
    err, match, total = 0.0, 0, 0
    with torch.inference_mode():
        for _, prompt, out, lp in greedy:
            seq = torch.tensor(out, device=model.device)[None]
            logits, _ = model.forward(params, seq[:, :-1])
            lps = torch.log_softmax(logits[0].float(), -1)
            forced = lps.gather(1, seq[0, 1:, None])[:, 0].cpu().numpy()
            err = max(err, float(np.abs(forced - np.asarray(lp)).max()))
            am = lps.argmax(-1).cpu().numpy()[len(prompt) - 1:]
            match += int((am == np.asarray(out[len(prompt):])).sum())
            total += len(out) - len(prompt)
    return err, match / max(total, 1)


def launcher_llama(kernels, conv, weights):
    """Llama-2-7B widths at LLAMA_LAUNCH_LAYERS layers from the converted
    release through the launcher, in a thread (`--warmup_compile`, the
    engine defaults: 8 slots, page 64, max_context 2048, chunks of 256,
    prefix cache), then as a subprocess. The greedy streams teacher-forced
    through the kernels-off forward on the converted weights within
    5e-2; the subprocess answers two greedy requests, one at a time, as
    the in-thread launcher did."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    argv = ["--load", str(conv.pop("release")), "--model", "llama",
            "--tokenizer_type", "NullTokenizer", "--null_vocab_size",
            "31999", "--host", "127.0.0.1", "--port", "0"]
    torch.cuda.reset_peak_memory_stats()
    srv = InThreadLauncher(argv + ["--warmup_compile"])
    eng, model = srv.server.engine, srv.server.generator.model
    cfg = model.cfg
    mem = {"memory_after_start_gb": torch.cuda.memory_allocated() / 1e9,
           "params_fp32_gb": tree_bytes(srv.server.generator.params) / 1e9,
           "decode_copy_gb": tree_bytes(eng._dec_params) / 1e9,
           "kv_pool_gb": eng.kv_pool_bytes() / 1e9}
    decode_bytes = tree_bytes(eng._dec_params)
    graphs = eng.graph_stats()
    traffic, whole = launcher_traffic()
    run = drive_launcher(srv.port, eng, traffic, whole)
    generated, greedy = check_outputs(traffic, run, tok)
    beam_steps = check_launcher_run(cfg, run, whole, flash=True)
    seq = sequential_greedy(srv.port, sequential_payloads())
    metrics = get_json(srv.port, "/metrics")
    eng.stop()  # its serve thread: the card is timed alone
    step_ms = decode_step_device_ms(model, eng)
    note_launcher_launches(kernels, "launcher_llama", run)
    del eng, model
    srv.stop()
    banner_s, sub, banner = launcher_subprocess(argv, sequential_payloads())
    check(sub == seq, "the subprocess launcher's answers differ from the "
                      "in-thread launcher's")
    shutil.rmtree(argv[1])
    wcfg, wparams = weights
    plain = LlamaModel(dataclasses.replace(
        wcfg, use_decode_attn=False, use_flash_attn=False,
        use_fused_rmsnorm=False))
    err, agree = teacher_forced(plain, wparams, greedy)
    del plain, wparams, weights
    free_cuda()
    check(err <= PATH_LP_TOL, f"launcher streams teacher-forced through "
                              f"the kernels-off forward: log-probs {err}")
    say("launcher_llama", card=nvidia_smi(), config="llama2-7b",
        layers=cfg.num_layers, **conv, load_s=srv.load_s,
        engine_setup_s=srv.setup_s, warmup_capture_s=graphs["capture_s"],
        graphs=graphs["graphs"], subprocess_banner_s=banner_s,
        subprocess_banner=banner, subprocess_answers_equal=True,
        requests=len(traffic) + len(whole), paged_forwards=run["paged"],
        launches=run["launches"], k7_variant_launches=run["variants"],
        beam_decode_steps=beam_steps, generated_tokens=generated,
        wall_s=run["wall"], generated_tokens_per_s=generated / run["wall"],
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        decode_ms_per_advance=ms_per_advance(run["rounds"]),
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
        greedy_token_match_fraction_kernels_off=agree,
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL, **mem,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def kernel_ms(top, names):
    """Ms per call of the kernels in `top` (`top_kernels`' list) whose
    names hold any of `names`."""
    return sum(ms for name, ms in top if any(s in name for s in names))


def falcon_kernel_ms(model, eng):
    """On the launcher's decode tree and pools (the engine stopped), from
    torch.profiler traces of eager calls: an 8-slot paged decode step at
    1000 positions (its device ms, its top kernels and K7's ms a
    launch), a mixed round's forward (K7's ms a launch), and a
    beam-shaped dense decode step, 2 rows at 216 positions (K1's ms a
    launch)."""
    L = model.cfg.num_layers
    with torch.inference_mode():
        pt = torch.zeros(eng.slots, eng.max_pages_per_slot,
                         dtype=torch.int32, device="cuda")
        for i in range(eng.slots):
            pt[i, :16] = torch.arange(1 + 16 * i, 17 + 16 * i)
        lens = torch.full((eng.slots,), 1000, dtype=torch.int32,
                          device="cuda")
        pools_k, pools_v, _, _ = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens,
                  "chunk_lens": torch.ones_like(lens)}
        tok1 = torch.zeros(eng.slots, 1, dtype=torch.long, device="cuda")
        step_ms, top = top_kernels(lambda: model.forward(
            eng._dec_params, tok1, kv_caches=caches,
            position_ids=lens.long()[:, None]), n=100)
        dense = dict(model.init_kv_caches(2, 256), offset=216)
        beam_tok = torch.zeros(2, 1, dtype=torch.long, device="cuda")
        _, beam_top = top_kernels(lambda: model.forward(
            eng._dec_params, beam_tok, kv_caches=dense), n=100)
    _, k7_mixed = mixed_round_device_ms(model, eng)
    return {"eager_decode_step_device_ms": step_ms,
            "eager_decode_step_top_kernels": top[:8],
            "k7_tc_decode_ms_per_launch": kernel_ms(top, ("paged_attn",)) / L,
            "k7_tc_mixed_ms_per_launch": k7_mixed / L,
            "k1_tensor_cores_ms_per_launch": kernel_ms(
                beam_top, ("decode_mma_kernel", "decode_split_kernel")) / L}


# Falcon-7B's launcher phase runs half its depth: the whole smoke must fit
# its time limit beside the parallel phase, and a cut of depth
# leaves every width, kernel shape and route as it was
FALCON_LAYERS = 16


def launcher_falcon(kernels, init_std):
    """Falcon-7B at full width and FALCON_LAYERS of its 32 layers (hidden
    4544, 71 query heads on 1 KV head, d 64, ffn 18176, vocab 65024),
    random bf16
    weights from a seed written as a release by `save_checkpoint(
    release=True)` (the layout hf2native writes); the converters checked
    at full width and 2 layers (native2hf then hf2native through the
    CLI, bit-exact); then the launcher (`--model falcon`) in a thread: 8
    engine requests, a beam-2 and a score-only request. K7 (tc, qpk 71)
    and K1 (tensor_cores, qpk 71) on the path; the greedy streams
    teacher-forced through the kernels-off forward within 5e-2."""
    free_gb = need_disk(FALCON_DISK_GB)
    rel_dir, small, hf2, back = (LAUNCH_DIR / n for n in (
        "falcon", "falcon_2l", "hf_falcon_2l", "falcon_2l_back"))
    for d in (rel_dir, small, hf2, back):
        shutil.rmtree(d, ignore_errors=True)
    cfg = falcon_config(7, num_layers=FALCON_LAYERS,
                        params_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16,
                        init_method_std=init_std)
    check(dec.decode_design(torch.bfloat16, cfg.q_per_kv) == "tensor_cores",
          "K1's design at qpk 71")
    model = FalconModel(cfg)
    params = model.init(seed=SEED + 43)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(str(rel_dir), 0, params, model_cfg=cfg, release=True)
    release_write_s = time.perf_counter() - t0
    release_bytes = dir_bytes(rel_dir / "release")

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = dict(params, layers=ckpt.unflatten(
        {k: v[:2] for k, v in ckpt.flatten(params["layers"]).items()}))
    ckpt.save_checkpoint(str(small), 0, params2, model_cfg=cfg2,
                         release=True)
    trip_s = convert("--model", "falcon", "--direction", "native2hf",
                     "--input", small, "--output", hf2)
    trip_s += convert("--model", "falcon", "--direction", "hf2native",
                      "--dtype", "bfloat16", "--input", hf2, "--output", back)
    trip_leaves = release_leaves_equal(back, params2)
    for d in (small, hf2, back):
        shutil.rmtree(d)
    del params2

    tok = build_tokenizer("NullTokenizer", null_vocab_size=65023)
    srv = InThreadLauncher([
        "--load", str(rel_dir), "--model", "falcon", "--tokenizer_type",
        "NullTokenizer", "--null_vocab_size", "65023", "--host",
        "127.0.0.1", "--port", "0", "--warmup_compile"])
    eng, served = srv.server.engine, srv.server.generator.model
    mem_gb = torch.cuda.memory_allocated() / 1e9
    decode_bytes = tree_bytes(eng._dec_params)
    graphs = eng.graph_stats()
    traffic, whole = launcher_traffic(stream=False)
    run = drive_launcher(srv.port, eng, traffic, whole)
    generated, greedy = check_outputs(traffic, run, tok)
    beam_steps = check_launcher_run(served.cfg, run, whole, flash=False)
    metrics = get_json(srv.port, "/metrics")
    eng.stop()  # its serve thread: the card is timed alone
    step_ms = decode_step_device_ms(served, eng)
    kernel_times = falcon_kernel_ms(served, eng)
    note_launcher_launches(kernels, "launcher_falcon", run)
    del eng, served
    srv.stop()

    # the greedy outputs teacher-forced through the no-cache forward with
    # the kernels off, on the smoke's own weights (the release's values)
    plain = FalconModel(dataclasses.replace(cfg, use_decode_attn=False))
    err, match_fraction = teacher_forced(plain, params, greedy)
    shutil.rmtree(rel_dir)
    del model, plain, params
    free_cuda()
    say("launcher_falcon", card=nvidia_smi(), config="falcon-7b",
        layers=cfg.num_layers, hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads, kv_heads=cfg.num_query_groups,
        head_dim=cfg.head_dim, ffn=cfg.ffn_hidden_size,
        vocab=cfg.padded_vocab_size, init_std=init_std,
        disk_free_gb=free_gb, release_write_s=release_write_s,
        release_bytes=release_bytes, two_layer_round_trip_s=trip_s,
        two_layer_round_trip_leaves_equal=trip_leaves, load_s=srv.load_s,
        engine_setup_s=srv.setup_s, warmup_capture_s=graphs["capture_s"],
        graphs=graphs["graphs"], memory_after_start_gb=mem_gb,
        requests=len(traffic) + len(whole), paged_forwards=run["paged"],
        launches=run["launches"], k7_variant_launches=run["variants"],
        beam_decode_steps=beam_steps, generated_tokens=generated,
        wall_s=run["wall"], generated_tokens_per_s=generated / run["wall"],
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        decode_ms_per_advance=ms_per_advance(run["rounds"]),
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
        **kernel_times, path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        greedy_token_match_fraction=match_fraction)
    check(err <= PATH_LP_TOL, f"falcon re-scored logprobs {err}")


# ---------------------------------------------------------------------------
# phase 3 (training kernels): K2 with rstd, K3, and flash K4-K6
# ---------------------------------------------------------------------------


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rmsnorm_train_numbers(dtype, tol, gen):
    """K2 writing rstd and K3 against `_plain_fwd` / `_plain_bwd` at a
    training microbatch's rows (n = seq 4096, h 4096) in `dtype` with the
    fp32 scale parameter: (errors, errors relative to max(1, the
    reference's max-abs), the forward's and the backward's numbers)."""
    n, h, eps = 4096, 4096, 1e-5

    def make(i):
        x = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
        g = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
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
    for k, v in rel.items():
        check(v <= tol, f"K2-rstd/K3 {dtype} {k}: {v}")

    # four input sets of 64 MB: out of the 50 MB L2
    pick = rotating(make, 4)
    lib = torch.nn.functional.rms_norm
    scale_lib = scale.to(dtype)
    fwd = {
        "ms": device_ms(lambda: rms.rms_norm_fwd(pick()[0], scale, eps,
                                                 with_rstd=True)),
        "plain_ms": device_ms(lambda: rms._plain_fwd(pick()[0], scale, eps),
                              per_graph=10, replays=5),
        "library_ms": device_ms(lambda: lib(pick()[0], (h,), scale_lib,
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
    wl = scale_lib.clone().requires_grad_(True)
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
    name = str(dtype).replace("torch.", "")
    shape = f"n{n} h{h} {name}, fp32 scale"
    return errs, rel, dict(fwd, shape=shape), dict(bwd, shape=shape)


def check_rmsnorm_bwd_kernel(k2_row):
    """K2 writing rstd and K3 at a training microbatch's rows, in bf16
    (the training path's) and in fp16 (`--fp16`'s): errors within 2e-2
    (bf16) and 5e-3 (fp16: about 5 of its ulps at 1) of max(1, the
    reference's max-abs), times beside the plain versions, F.rms_norm and
    the bound. Adds the rstd variant's and the fp16 numbers to K2's row
    and returns K3's row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs, rel, fwd, bwd = _rmsnorm_train_numbers(torch.bfloat16, BF16_TOL,
                                                 gen)
    errs16, rel16, fwd16, bwd16 = _rmsnorm_train_numbers(torch.float16,
                                                         FP16_TOL, gen)
    say("kernel_check_rmsnorm_bwd", max_abs_err=errs, rel_err=rel,
        tol=BF16_TOL, fp16_max_abs_err=errs16, fp16_rel_err=rel16,
        fp16_tol=FP16_TOL)
    k2_row["rstd_variant"] = dict(fwd, max_abs_err=errs["out"])
    k2_row["fp16_variant"] = dict(fwd16, max_abs_err=errs16["out"],
                                  rel_err=rel16["out"])
    return dict({
        "name": "rmsnorm_bwd", "route": "triton",
        "source": "megatron_llm_tpu_torch/ops/rmsnorm.py",
        "replaces": "megatron_llm_tpu/ops/rmsnorm.py:59",
        "max_abs_err": errs["dx"],
        "fp16_variant": dict(bwd16, max_abs_err=errs16["dx"],
                             rel_err=rel16["dx"]),
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


def flash_inputs(shape, gen, dtype=torch.bfloat16):
    b, s, t, g, qpk, d, _ = shape

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda").to(dtype)
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
    errs["o_rel"] = errs["o"] / max(1.0, o_ref.float().abs().max().item())
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


FLASH_FP16_CASES = (FLASH_CASES[0], FLASH_CASES[1], FLASH_CASES[2])


def check_flash_fp16():
    """The fp16 instantiations of K4, K5 and K6 (`--fp16` training)
    against their plain versions in fp16: o within FP16_TOL of max(1, its
    reference's max-abs), lse within 1e-3, each gradient within FP16_TOL
    of its reference's max-abs, at the training shape, Llama-2-70B's GQA
    and full attention; then the times at the training shape beside the
    plain versions, SDPA in fp16 and the bound (the bf16 count of
    operations: the tensor cores' fp16 rate is bf16's 989 TFLOP/s).
    Returns the three rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    h = torch.float16
    errs = {}
    for label, shape in FLASH_FP16_CASES:
        q, k, v, do = flash_inputs(shape, gen, h)
        errs[label] = e = flash_errors(q, k, v, do, shape[-1])
        check(e["o_rel"] <= FP16_TOL and e["lse"] <= 1e-3,
              f"K4 fp16 {label}: {e}")
        for name in ("dq", "dk", "dv"):
            check(e[name + "_rel"] <= FP16_TOL,
                  f"K5/K6 fp16 {label} {name}: {e}")
        del q, k, v, do
        torch.cuda.empty_cache()
    say("kernel_check_flash_fp16", max_abs_err=errs, tol=FP16_TOL,
        grad_tol=f"{FP16_TOL} of the reference's max-abs",
        card=nvidia_smi())

    main = FLASH_CASES[0][1]
    b, s, t, g, qpk, d, causal = main
    q, k, v, do = flash_inputs(main, gen, h)
    o, lse = fa._fwd(q, k, v, causal)
    b4 = fa._rows4(lse.contiguous(), b * g, s * qpk)
    qf, kf, vf, dof = fa._fold_q(q), fa._fold_kv(k), fa._fold_kv(v), \
        fa._fold_q(do)
    delta = fa._rows4(fa._delta_rows(o, do).contiguous(), b * g, s * qpk)
    ms = {
        "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, qpk, causal),
                         per_graph=5, replays=4),
        "dq": device_ms(lambda: fa.flash_bwd_dq(qf, kf, vf, dof, b4, delta,
                                                qpk, causal),
                        per_graph=5, replays=4),
        "dkv": device_ms(lambda: fa.flash_bwd_dkv(qf, kf, vf, dof, b4,
                                                  delta, qpk, causal),
                         per_graph=5, replays=4),
    }
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3),
    }
    torch.cuda.empty_cache()
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
    del ys, qs, ks, vs
    torch.cuda.empty_cache()
    bounds = flash_bounds(main)
    tflops = {n: bounds[n][2] / (ms[n] * 1e-3) / 1e12 for n in ms}
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal fp16"
    say("kernel_time_flash_fp16", ms=ms, plain_ms=plain,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, achieved_tflops=tflops,
        shape=label, card=nvidia_smi())
    rows = []
    for name, which, line, err, plain_ms, lib in (
            ("flash_fwd_fp16", "fwd", 262,
             max(e["o"] for e in errs.values()), plain["fwd"], lib_fwd),
            ("flash_bwd_dq_fp16", "dq", 388,
             max(e["dq"] for e in errs.values()), plain["bwd"], lib_bwd),
            ("flash_bwd_dkv_fp16", "dkv", 448,
             max(max(e["dk"], e["dv"]) for e in errs.values()),
             plain["bwd"], lib_bwd)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "megatron_llm_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"megatron_llm_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[which], "plain_ms": plain_ms,
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            "library_ms": lib, "achieved_tflops": tflops[which],
            "shape": label, "design": "wgmma+tma, fp16 instantiation",
            "launches": 0, "launches_by_path": {},
        })
        if which != "fwd":
            rows[-1]["plain_and_library_cover"] = \
                "the whole backward (dq, dk, dv)"
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


def train_tcfg(steps, log_interval=1):
    return TrainConfig(micro_batch_size=1, global_batch_size=TRAIN_MICRO,
                       train_iters=steps, lr=3e-4, lr_decay_style="constant",
                       adam_beta2=0.95, adam_eps=1e-5, weight_decay=0.1,
                       clip_grad=1.0, log_interval=log_interval,
                       eval_interval=0, seed=SEED)


def kernel_counts():
    return {"rmsnorm_fwd": rms.fused_rms_norm.launches,
            "rmsnorm_bwd": rms.rms_norm_bwd.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "decode_attention": dec.decode_attention.launches,
            "ragged_paged_attention": pa.ragged_paged_attention.launches}


FLASH_WRAPPERS = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                  "flash_bwd_dkv": fa.flash_bwd_dkv}


def fp16_counts():
    """The flash kernels' fp16 launches (part of kernel_counts())."""
    return {name: fn.launches_by_dtype["float16"]
            for name, fn in FLASH_WRAPPERS.items()}


def zero_counts():
    for fn in (rms.fused_rms_norm, rms.rms_norm_bwd, fa.flash_fwd,
               fa.flash_bwd_dq, fa.flash_bwd_dkv, dec.decode_attention,
               pa.ragged_paged_attention):
        fn.launches = 0
    dec.decode_attention.launches_by_layout = dict.fromkeys(
        dec.decode_attention.launches_by_layout, 0)
    for fn in FLASH_WRAPPERS.values():
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
    pa.ragged_paged_attention.variant_launches = dict.fromkeys(
        pa.ragged_paged_attention.variant_launches, 0)


def train_slice(kernels):
    """8 steps of 4 microbatches through Trainer.setup()/train() on one
    fixed global batch (memorisation): AdamW as in the Llama 2 paper
    (beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0), lr 3e-4 held
    constant over the short run."""
    cfg = train_config()
    model = LlamaModel(cfg)
    tcfg = train_tcfg(TRAIN_STEPS)
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


# cuBLAS's GEMM kernels by name on the H100 (cuBLAS 12: nvjet and
# sm90_xmma kernels; CUTLASS-built ones)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def step_profile(trainer, state, text):
    """One more training step under torch.profiler (CUDA activity only):
    its wall ms, the card's busy ms, the kernels' ms in all, by flash
    kernel and for cuBLAS's GEMMs, and the ten largest kernels."""
    def step():
        stats = trainer.train_step(state, text)
        float(stats["loss"])
    _, wall, events = cuda_trace(step)
    kernels = kernel_totals(events)
    flash = {k: sum(ms for n, ms in kernels.items()
                    if f"flash_{k}_kernel" in n)
             for k in ("fwd", "bwd_dq", "bwd_dkv")}
    gemm = sum(ms for n, ms in kernels.items()
               if any(g in n.lower() for g in GEMM_NAMES)
               and "flash" not in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3,
            "busy_ms": busy_ms(events) if events else "not measured",
            "device_ms": sum(kernels.values()), "flash_ms": flash,
            "gemm_ms": gemm,
            "top10_kernels_ms": [[n[:120], round(ms, 3)] for n, ms in top]}


def throughput_train(trainer, state, text):
    """Step time over steps 2-8 (the first pays Triton's and cuBLAS's
    first calls), tokens/s, model TFLOP/s (6 N a token, the trainer's own
    formula) against 989, peak memory; then one more step under
    torch.profiler for the kernels' device time and the busy share."""
    ms = [r["ms"] for r in trainer.step_log[1:]]
    med = float(np.median(ms))
    tokens = TRAIN_MICRO * trainer.cfg.seq_length
    tok_s, tflops = trainer.throughput(TRAIN_MICRO, med / 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = step_profile(trainer, state, text)
    wall, busy, device = prof["wall_ms"], prof["busy_ms"], prof["device_ms"]
    flash_ms = sum(prof["flash_ms"].values())
    say("throughput_train", steps_timed=len(ms), step_ms_median=med,
        step_ms=ms, tokens_per_step=tokens, tokens_per_s=tok_s,
        model_tflops=tflops, model_tflops_share_of_989=tflops / 989.0,
        peak_memory_gb_train=peak, profiled_step_wall_ms=wall,
        profiled_device_busy_ms=busy,
        device_busy_share=(busy / wall if isinstance(busy, float)
                           else "not measured"),
        device_kernel_ms_total=device, gemm_ms=prof["gemm_ms"],
        flash_kernels_ms=prof["flash_ms"], flash_ms=flash_ms,
        flash_share_of_step_wall=flash_ms / wall,
        flash_share_of_device_ms=(flash_ms / device if device
                                  else "not measured"),
        top10_kernels_ms=prof["top10_kernels_ms"], card=nvidia_smi())
    return med


def add_launches(kernels, path, launches, fp16=None):
    """Adds a path's launches to the kernels' rows: the flash kernels'
    fp16 launches (`fp16`, by kernel) to their fp16 rows, the rest to
    each kernel's row."""
    fp16 = fp16 or {}
    for row in kernels:
        name = row["name"]
        base = name[:-5] if name.endswith("_fp16") else name
        n = fp16.get(base, 0) if name.endswith("_fp16") \
            else launches.get(name, 0) - fp16.get(name, 0)
        if base not in launches or not n:
            continue
        paths = row.setdefault("launches_by_path", {})
        paths[path] = paths.get(path, 0) + n
        row["launches"] = sum(paths.values())


REMAT_STEPS = 3


def activation_gb(model, params, text):
    """One microbatch's memory above what is resident before it (params,
    optimizer state and the gradients, already allocated), in GB: what
    its forward leaves for the backward (the tensors the policy keeps,
    the layers' inputs), the forward's peak, and the forward and
    backward's peak (set at the backward's end, where every layer's fp32
    weight gradient is live before the stacked leaves' gradients are
    assembled, whatever the policy)."""
    from megatron_llm_tpu_torch.training.trainer import get_batch

    micro = {k: v[0] for k, v in get_batch(text[:1],
                                            device=model.device).items()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = model.loss(params, **micro)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    fwd_peak = torch.cuda.max_memory_allocated() - base
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for p in leaves:
        p.grad = None
    return {"forward_held_gb": held / 1e9, "forward_peak_gb": fwd_peak / 1e9,
            "forward_backward_peak_gb": peak / 1e9}


# (label, policy, overrides): the trainer of phase 15 under each policy
REMAT_RUNS = (
    ("full", "full", {}),
    ("selective", "selective", {}),
    ("save_dots", "save_dots", {}),
    ("offload", "offload", {}),
    ("full_block4", "full", dict(recompute_method="block",
                                 recompute_num_layers=4)),
)


def train_remat(kernels, cfg, text):
    """Phase 15's trainer (Llama-2-7B widths, 8 layers, seq 4096, 4
    microbatches, the same initial weights from the same seed and the
    same batch) under each recompute policy for REMAT_STEPS steps:
    ms a step (median of steps 2 on), the step's peak memory (the
    optimizer's, the same for all) and one microbatch's activation memory
    (`activation_gb`: what the forward leaves for the backward, the
    forward's peak, the forward and backward's peak), and from one more
    profiled step the GEMMs' and the flash kernels' device ms; the
    launches of each kernel a step, checked against the policy: K4
    twice a remat'd layer and microbatch under "full" and once under the
    named-save-point policies (their kept o and lse answer the
    recompute), K5 and K6 once, K2 twice a layer plus the final norm in
    the forward and again in each recompute. Step 1's loss and gradient
    norm must be equal across policies (bit for bit: the kept products
    and the recomputed ones are the same kernels on the same inputs)."""
    L, M, S = TRAIN_LAYERS, TRAIN_MICRO, REMAT_STEPS
    pcfg = ParallelConfig(num_microbatches=M)
    runs = {}
    for label, policy, over in REMAT_RUNS:
        rcfg = dataclasses.replace(cfg, remat_policy=policy, **over)
        trainer = Trainer(LlamaModel(rcfg), train_tcfg(S, log_interval=S),
                          pcfg, train_data_iterator=(text for _ in range(S)))
        state = trainer.setup()
        stats_log = []
        inner = trainer.train_step

        def step(st, txt, *a):
            out = inner(st, txt, *a)
            stats_log.append((float(out["loss"]), float(out["grad_norm"]),
                              int(out["skipped"])))
            return out
        trainer.train_step = step
        torch.cuda.synchronize()
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.train(state)
        torch.cuda.synchronize()
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        trainer.train_step = inner
        prof = step_profile(trainer, state, text)
        act = activation_gb(trainer.model, state.params, text)
        n_remat = L if rcfg.recompute_method == "uniform" \
            else rcfg.recompute_num_layers
        k4 = L + (n_remat if policy == "full" else 0)
        expected = {"flash_fwd": k4 * M * S, "flash_bwd_dq": L * M * S,
                    "flash_bwd_dkv": L * M * S,
                    "rmsnorm_fwd": (2 * L + 1 + 2 * n_remat) * M * S,
                    "rmsnorm_bwd": (2 * L + 1) * M * S,
                    "decode_attention": 0, "ragged_paged_attention": 0}
        check(launches == expected,
              f"train_remat {label}: launches {launches} != {expected}")
        check(not any(sk for _, _, sk in stats_log)
              and all(np.isfinite([lo for lo, _, _ in stats_log])),
              f"train_remat {label}: {stats_log}")
        add_launches(kernels, "train_remat", launches)
        runs[label] = {
            "policy": policy, "recompute_method": rcfg.recompute_method,
            "remat_layers": n_remat,
            "step_ms": [r["ms"] for r in trainer.step_log],
            "step_ms_median": float(np.median(
                [r["ms"] for r in trainer.step_log[1:]])),
            "peak_memory_gb": peak, **act,
            "step1_loss": stats_log[0][0],
            "step1_grad_norm": stats_log[0][1],
            "losses": [lo for lo, _, _ in stats_log],
            "launches_per_step": {k: v / S for k, v in launches.items()},
            "gemm_ms": prof["gemm_ms"], "flash_ms": prof["flash_ms"],
            "profiled_step": {k: prof[k] for k in ("wall_ms", "busy_ms",
                                                   "device_ms")},
            "top10_kernels_ms": prof["top10_kernels_ms"][:5]}
        del trainer, state, inner, step
        free_cuda()
    first = runs["full"]
    diffs = {label: {"loss": r["step1_loss"] - first["step1_loss"],
                     "grad_norm": r["step1_grad_norm"]
                     - first["step1_grad_norm"]}
             for label, r in runs.items()}
    say("train_remat", card=nvidia_smi(), config="llama2-7b widths",
        layers=L, seq=cfg.seq_length, micro_batches=M, steps=S,
        runs=runs, step1_diff_from_full=diffs,
        step1_bitwise_equal=all(d == {"loss": 0.0, "grad_norm": 0.0}
                                for d in diffs.values()))
    check(all(d["loss"] == 0.0 for d in diffs.values()),
          f"step-1 losses differ across policies: {diffs}")
    check(all(abs(d["grad_norm"]) <= 1e-6 * first["step1_grad_norm"]
              for d in diffs.values()),
          f"step-1 gradient norms differ across policies: {diffs}")


FT_LAYERS, FT_SEQ, FT_STEPS, FT_MICRO, FT_EVAL_INTERVAL = 4, 4096, 6, 4, 3
# the entry path's save-and-resume runs (phase 18): four 8.0 GB commits
# at 2 layers where 4 layers make them 12.86 GB each
FT_ENTRY_LAYERS = 2
FT_CORPUS_TOKENS = 1_500_000
FT_DIR = Path(__file__).resolve().parent / "build" / "finetune_smoke"


def write_corpus(path, seed):
    """JSONL documents of random token ids from `seed` (ids below 31999,
    NullTokenizer's eod), lengths 64-8192, about FT_CORPUS_TOKENS in
    all."""
    rs = np.random.RandomState(seed)
    n = 0
    with open(path, "w") as f:
        while n < FT_CORPUS_TOKENS:
            ids = rs.randint(0, 31999, rs.randint(64, 8193))
            f.write(json.dumps({"text": " ".join(map(str, ids))}) + "\n")
            n += len(ids)
    return n


def finetune_argv(data, save, *extra):
    """`python -m megatron_llm_tpu_torch.finetune`'s flags: Llama-2-7B
    widths at FT_ENTRY_LAYERS of 32 layers, seq 4096, 4 microbatches of
    1, bf16 on fp32 AdamW as in the train phase (lr 3e-4 held constant),
    full recompute; eval every 3 steps, an interval save every 3."""
    flags = (f"--model_name llama2 --model_size 7 --num_layers "
             f"{FT_ENTRY_LAYERS} "
             f"--seq_length {FT_SEQ} --micro_batch_size 1 "
             f"--global_batch_size {FT_MICRO} --bf16 "
             f"--recompute_granularity full --lr 3e-4 "
             f"--lr_decay_style constant --adam_beta2 0.95 --adam_eps 1e-5 "
             f"--weight_decay 0.1 --clip_grad 1.0 --tokenizer_type "
             f"NullTokenizer --null_vocab_size 31999 --split 98,2,0 "
             f"--train_iters {FT_STEPS} --eval_interval {FT_EVAL_INTERVAL} "
             f"--eval_iters 1 --log_interval 1 --seed {SEED} "
             f"--save_interval 3 --keep_latest_n 1").split()
    return flags + ["--data_path", "0.7", data[0], "0.3", data[1],
                    "--save", save, *extra]


@contextlib.contextmanager
def patched(obj, name, make):
    """`obj.name` replaced by make(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def finetune_run(argv, sigterm_after=None, on_state=None):
    """One `finetune.main(argv)` with the launch counters set to 0 just
    before it, and the host facts the checks need: per step its
    iteration, loss, ms, loader ms and batch; the datasets; each save's
    blocked ms and commit s; the load's s; the state setup resumed to;
    the parallel context's backend and whether it staged collectives
    through the host. `on_state(state)` sees the final state."""
    from megatron_llm_tpu_torch import data as ft_data
    from megatron_llm_tpu_torch import finetune
    from megatron_llm_tpu_torch.training import trainer as trainer_mod
    from megatron_llm_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )

    rec = {"steps": [], "saves": [], "commits": [], "loads": [],
           "stats": []}

    def train_step(inner):
        def step(self, state, text, *a):
            stats = inner(self, state, text, *a)
            rec["stats"].append({
                "loss": float(stats["loss"]),
                "grad_norm": float(stats["grad_norm"]),
                "skipped": int(stats["skipped"]),
                "loss_scale": float(stats["loss_scale"])
                if "loss_scale" in stats else None})
            rec.setdefault("first_batch", (state.iteration, np.array(text)))
            if sigterm_after is not None and state.iteration == \
                    sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return stats
        return step

    def train(inner):
        def run(self, state):
            out = inner(self, state)
            rec["steps"] = [dict(r) for r in self.step_log]
            rec["n_params"] = self._n_params
            return out
        return run

    def setup(inner):
        def run(self, *a):
            state = inner(self, *a)
            rec["resumed"] = (state.iteration, state.consumed_train_samples)
            return state
        return run

    def save(inner):
        def run(self, iteration, *a, **kw):
            out = inner(self, iteration, *a, **kw)
            rec["saves"].append((iteration, self.last_blocked_ms))
            return out
        return run

    def commit(inner):
        def run(self, path, iteration, *a):
            inner(self, path, iteration, *a)
            rec["commits"].append((iteration, self.last_commit_s))
        return run

    def load(inner):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            rec["loads"].append(time.perf_counter() - t0)
            return out
        return run

    def datasets(inner):
        def run(*a, **kw):
            rec["datasets"] = inner(*a, **kw)
            return rec["datasets"]
        return run

    def layout(inner):
        def run(*a, **kw):
            ctx = inner(*a, **kw)
            rec["parallel"] = {"backend": ctx.backend, "staged": ctx.staged,
                               "world": ctx.world_size, "dp": ctx.dp,
                               "pp": ctx.pp, "tp": ctx.tp, "rank": ctx.rank,
                               "sequence_parallel": ctx.sequence_parallel}
            return ctx
        return run

    def clock(key):
        def make(inner):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **kw)
                finally:
                    rec["clock_s"][key] = rec["clock_s"].get(key, 0.0) + (
                        time.perf_counter() - t0)
            return run
        return make

    rec["clock_s"] = {}
    prev = signal.getsignal(signal.SIGTERM)
    with contextlib.ExitStack() as stack:
        # where a run's seconds go: set-up, steps, saves and the wait
        # for their commit
        for obj, name, key in (
                (ft_data, "build_train_valid_test_datasets", "datasets"),
                (trainer_mod.Trainer, "setup", "setup"),
                (trainer_mod.Trainer, "train", "train"),
                (trainer_mod.Trainer, "train_step", "steps"),
                (trainer_mod.Trainer, "_save", "saves"),
                (trainer_mod.Trainer, "_wait_for_commit", "commit_wait")):
            stack.enter_context(patched(obj, name, clock(key)))
        for obj, name, make in (
                (finetune, "initialize_parallel", layout),
                (trainer_mod.Trainer, "train_step", train_step),
                (trainer_mod.Trainer, "train", train),
                (trainer_mod.Trainer, "setup", setup),
                (trainer_mod, "load_checkpoint", load),
                (CheckpointManager, "save", save),
                (CheckpointManager, "_commit", commit),
                (ft_data, "build_train_valid_test_datasets", datasets)):
            stack.enter_context(patched(obj, name, make))
        zero_counts()
        t0 = time.perf_counter()
        state = finetune.main(argv)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = kernel_counts()
        rec["fp16"] = fp16_counts()
    signal.signal(signal.SIGTERM, prev)
    rec["iteration"] = state.iteration
    rec["consumed"] = state.consumed_train_samples
    if on_state is not None:
        on_state(state)
    del state
    free_cuda()
    return rec


def expected_finetune_launches(steps, evals):
    """K4 runs twice a layer and microbatch (forward and the full
    recompute) and once a layer for each eval batch; K5 and K6 once a
    layer and microbatch; nothing else."""
    L, M = FT_ENTRY_LAYERS, FT_MICRO
    return {"flash_fwd": 2 * L * M * steps + L * evals,
            "flash_bwd_dq": L * M * steps, "flash_bwd_dkv": L * M * steps,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def checkpoint_leaves_equal(a_dir, b_dir):
    """Leaf by leaf, bit for bit, the model and optim files of two
    checkpoint directories (mmap'd, compared on the card)."""
    n = 0
    for name in ("model", "optim"):
        a = torch.load(os.path.join(a_dir, name), mmap=True,
                       weights_only=True)
        b = torch.load(os.path.join(b_dir, name), mmap=True,
                       weights_only=True)
        check(set(a) == set(b), f"{name} leaves differ")
        for k in a:
            check(torch.equal(a[k].cuda(), b[k].cuda()),
                  f"{name} leaf {k} differs between the runs")
            n += 1
    return n


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def check_finetune_data(rec):
    """The g++ helpers' sample indices against their numpy version, per
    corpus; the first global batch against the samples the sampler
    names (0-3 of the blend)."""
    from megatron_llm_tpu_torch.data import helpers

    train = rec["datasets"][0]
    n = 0
    for ds in train.datasets:
        sizes = ds.indexed_dataset.sizes
        tpe = int(np.sum(sizes[np.unique(ds.doc_idx)]))
        epochs = len(ds.doc_idx) // len(np.unique(ds.doc_idx))
        plain = helpers.build_sample_idx_np(sizes, ds.doc_idx, FT_SEQ,
                                            epochs, tpe)
        check(np.array_equal(plain, ds.sample_idx),
              "g++ sample index != numpy")
        n += len(plain)
    step, first = rec["first_batch"]
    want = np.stack([train[i]["text"] for i in range(FT_MICRO)])
    check(step == 1 and np.array_equal(first.reshape(FT_MICRO, -1), want),
          "first batch != the sampler's samples")
    return n


def finetune_phase(kernels, train_step_ms):
    """The training entry path: two seeded JSONL corpora through
    preprocess_data, then `finetune.main` three times: R uninterrupted
    (interval save at 3, final at 6), K the same with SIGTERM after step
    3 (emergency save at 3), C resuming K to 6. C's losses and final
    checkpoint must equal R's bit for bit."""
    from megatron_llm_tpu_torch.tools import preprocess_data

    shutil.rmtree(FT_DIR, ignore_errors=True)
    FT_DIR.mkdir(parents=True)
    data, tokens, t_pre = [], 0, 0.0
    for name, seed in (("A", SEED + 31), ("B", SEED + 37)):
        jsonl = FT_DIR / f"{name}.jsonl"
        tokens += write_corpus(jsonl, seed)
        t0 = time.perf_counter()
        preprocess_data.main([
            "--input", str(jsonl), "--output_prefix", str(FT_DIR / name),
            "--tokenizer_type", "NullTokenizer", "--null_vocab_size",
            "31999", "--append_eod", "--workers", "2"])
        t_pre += time.perf_counter() - t0
        data.append(str(FT_DIR / f"{name}_text_document"))
    free_gb = shutil.disk_usage(FT_DIR).free / 1e9
    say("finetune_data", card=nvidia_smi(), corpus_tokens=tokens,
        preprocess_s=t_pre,
        disk_free_gb_before_saves=free_gb)

    r_dir, k_dir = str(FT_DIR / "R"), str(FT_DIR / "K")
    runs = {"R": finetune_run(finetune_argv(data, r_dir))}
    runs["K"] = finetune_run(finetune_argv(data, k_dir,
                                           "--exit_signal_handler"),
                             sigterm_after=3)
    runs["C"] = finetune_run(finetune_argv(data, k_dir, "--load", k_dir))
    R, K, C = runs["R"], runs["K"], runs["C"]
    for name, (steps, evals) in {"R": (6, 2), "K": (3, 1),
                                 "C": (3, 1)}.items():
        want = expected_finetune_launches(steps, evals)
        check(runs[name]["launches"] == want,
              f"run {name} launches {runs[name]['launches']} != {want}")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in R["launches"]}

    r_losses = {s["step"]: s["loss"] for s in R["steps"]}
    c_losses = {s["step"]: s["loss"] for s in C["steps"]}
    check(sorted(r_losses) == list(range(1, 7)), f"R steps {r_losses}")
    check(all(np.isfinite(list(r_losses.values()))), "R losses")
    check([s["step"] for s in K["steps"]] == [1, 2, 3]
          and K["iteration"] == 3, "K did not stop at iteration 3")
    check(K["saves"][-1][0] == 3 and os.path.isfile(
        os.path.join(k_dir, "iter_0000003", "COMPLETE")),
        "K made no save at 3")
    check(C["resumed"] == (3, 12), f"C resumed at {C['resumed']}")
    check(sorted(c_losses) == [4, 5, 6], f"C steps {c_losses}")
    check(all(c_losses[s] == r_losses[s] for s in (4, 5, 6)),
          f"C losses {c_losses} != R's {r_losses}")
    check(C["consumed"] == R["consumed"] == 24, "consumed samples")
    step, first = C["first_batch"]
    want = np.stack([R["datasets"][0][i]["text"] for i in range(12, 16)])
    check(step == 4 and np.array_equal(first.reshape(FT_MICRO, -1), want),
          "C's first batch is not samples 12-15")
    samples = check_finetune_data(R)
    r_final = os.path.join(r_dir, "iter_0000006")
    c_final = os.path.join(k_dir, "iter_0000006")
    ckpt_bytes = dir_bytes(r_final)
    leaves = checkpoint_leaves_equal(r_final, c_final)
    check(not os.path.exists(os.path.join(r_dir, "iter_0000003")),
          "keep_latest_n 1 left iteration 3 in R")
    # the corpora stay for finetune_modes
    shutil.rmtree(r_dir)
    shutil.rmtree(k_dir)

    ms = [s["ms"] for s in R["steps"][1:]]
    med = float(np.median(ms))
    # the trainer's formula: 6 N FLOPs a token
    tok_s = FT_MICRO * FT_SEQ / (med / 1e3)
    tflops = tok_s * 6 * R["n_params"] / 1e12
    say("finetune", card=nvidia_smi(),
        config="llama2-7b widths via finetune.main",
        layers=FT_ENTRY_LAYERS, seq=FT_SEQ, micro_batches=FT_MICRO,
        params=R["n_params"], losses_R=[r_losses[s] for s in range(1, 7)],
        losses_C=[c_losses[s] for s in (4, 5, 6)],
        resumed_iteration=C["resumed"][0],
        resumed_consumed_samples=C["resumed"][1],
        step_ms_median_2_6=med, step_ms_R=[s["ms"] for s in R["steps"]],
        train_phase_step_ms_median=train_step_ms,
        tokens_per_s=tok_s, model_tflops=tflops,
        loader_ms_per_step=[s["data_ms"] for s in R["steps"]],
        loader_ms_median=float(np.median([s["data_ms"]
                                          for s in R["steps"]])),
        saves_blocked_ms={n: r["saves"] for n, r in runs.items()},
        commits_s={n: r["commits"] for n, r in runs.items()},
        load_s=C["loads"], checkpoint_bytes=ckpt_bytes,
        checkpoint_leaves_equal=leaves, sample_idx_rows_checked=samples,
        run_wall_s={n: r["wall_s"] for n, r in runs.items()},
        launches=launches, expected_launches={
            k: sum(expected_finetune_launches(*se)[k]
                   for se in ((6, 2), (3, 1), (3, 1)))
            for k in launches})
    for row in kernels:
        if row["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row["launches_by_path"]["finetune"] = launches[row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
    return data


def mode_argv(data, *extra):
    """`finetune.main`'s flags for finetune_modes: Llama-2-7B widths at
    FT_LAYERS of 32 layers, seq 4096, 4 microbatches of 1, the corpora
    of finetune_data, no evaluation and no --save (a commit costs 16-27
    s); the mode's flags in `extra`."""
    flags = (f"--model_name llama2 --model_size 7 --num_layers {FT_LAYERS} "
             f"--seq_length {FT_SEQ} --micro_batch_size 1 "
             f"--global_batch_size {FT_MICRO} --tokenizer_type "
             f"NullTokenizer --null_vocab_size 31999 --split 98,2,0 "
             f"--eval_interval 1000 --eval_iters 1 --log_interval 1 "
             f"--seed {SEED}").split()
    return flags + ["--data_path", "0.7", data[0], "0.3", data[1],
                    *extra]


# examples/finetune.sh's training flags, less what the port does not run
# on one card
RECIPE = ("--use_flash_attn --recompute_granularity selective --lr 3e-4 "
          "--min_lr 1e-6 --lr_decay_style cosine --lr_warmup_iters 1 "
          "--weight_decay 0.1 --clip_grad 1.0 --adam_beta1 0.9 "
          "--adam_beta2 0.95 --adam_eps 1e-5 --hidden_dropout 0.0 "
          "--attention_dropout 0.0 --position_embedding_type rotary "
          "--rope_scaling_factor 1.0").split()
# the recipe's parallel flags at one rank (examples/finetune.sh:12,57-62),
# run (a) again under torchrun
RECIPE_A4_FLAGS = ["--tensor_model_parallel_size", "1", "--sequence_parallel",
                   "--use_distributed_optimizer"]
RECIPE_LEFT_OUT = {
    "--tensor_model_parallel_size 8": "1 on one card; tp 2 in "
    "finetune_parallel",
    "--pipeline_model_parallel_size": "1 in (a); 2 in the pipeline "
    "phase",
    "--context_parallel_size": "the next A4 PR (context parallelism, "
    "ROADMAP.md A4 item 2)",
    "--tensorboard_dir, --log_timers_to_tensorboard":
        "the trainer's telemetry hooks, ROADMAP.md A3.8",
    "--save, --load, --use_checkpoint_args, --save_interval":
        "no saves here (phase 18 holds the checkpoints)",
    "--eval_interval 50 --eval_iters 10": "no evaluation in a short run",
    "--lr_warmup_iters 2000": "1: a warmup longer than the run is refused",
}
FP16_STEPS = 16


def scaler_rule(skipped, initial=2.0 ** 32, hysteresis=2, min_scale=1.0,
                window=1000):
    """The scale each step uses under the dynamic scaler's rule (JAX
    optimizer/grad_scaler.py:63-86), given which steps overflowed."""
    out, scale, hyst, growth = [], initial, hysteresis, 0
    for bad in skipped:
        out.append(scale)
        if bad:
            hyst, growth = hyst - 1, 0
            if hyst <= 0:
                scale = max(scale / 2, min_scale)
        else:
            growth += 1
            if growth == window:
                scale, growth, hyst = scale * 2, 0, hysteresis
    return out


def finetune_modes(kernels, data):
    """`finetune.main` at Llama-2-7B widths (4 of 32 layers, seq 4096) in
    the single-card training modes, the counters set to 0 before each
    run: (a) the fine-tuning recipe's training flags (flash, selective
    recompute, bf16, its AdamW): K4 once a layer and microbatch, and
    again under torchrun with the recipe's parallel flags at world size
    1 (its record is returned, for
    finetune_parallel); (b) the
    same in fp16 with the default dynamic scaler from 2^32: the scale and
    skip sequence follows the scaler's rule, the scale comes down and at
    least three steps are taken, K4-K6 run their fp16 instantiations;
    (c) hidden, attention and LIMA dropout under full recompute: no
    flash launch (attention dropout takes the grouped path), and step
    1's gradient norm equal to a run without recompute at the same seed
    (the recompute draws the same masks). Printed with the card's name
    and power limit: ms a step, losses, the sequences, launches."""
    out = {}
    recipe = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    # (a), and again under torchrun with the recipe's parallel flags: an
    # NCCL group of world size 1, where every mapping is the identity
    # and ZeRO-1 at dp 1 the replicated AdamW
    a = finetune_run(recipe)
    a_a4 = run_ranks([recipe + RECIPE_A4_FLAGS], nproc=1)[0][0][0]
    b = finetune_run(mode_argv(data, *RECIPE, "--fp16", "--train_iters",
                               str(FP16_STEPS)))
    drop = ["--hidden_dropout", "0.1", "--attention_dropout", "0.1",
            "--lima_dropout", "--use_flash_attn", "--bf16", "--lr", "3e-4",
            "--lr_decay_style", "constant", "--clip_grad", "1.0"]
    c = finetune_run(mode_argv(data, *drop, "--recompute_granularity",
                               "full", "--train_iters", "3"))
    c_none = finetune_run(mode_argv(data, *drop, "--train_iters", "1"))
    L, M = FT_LAYERS, FT_MICRO
    for name, run, steps in (("a", a, 4), ("b", b, FP16_STEPS),
                             ("a_a4", a_a4, 4)):
        want = {"flash_fwd": L * M * steps, "flash_bwd_dq": L * M * steps,
                "flash_bwd_dkv": L * M * steps, "rmsnorm_fwd": 0,
                "rmsnorm_bwd": 0, "decode_attention": 0,
                "ragged_paged_attention": 0}
        check(run["launches"] == want,
              f"finetune_modes ({name}) launches {run['launches']} != {want}")
    check(a["fp16"] == dict.fromkeys(FLASH_WRAPPERS, 0)
          and b["fp16"] == {k: b["launches"][k] for k in FLASH_WRAPPERS},
          "finetune_modes: the fp16 run must launch the fp16 kernels only")
    for name, run in (("c", c), ("c_none", c_none)):
        check(all(run["launches"][k] == 0 for k in FLASH_WRAPPERS),
              f"finetune_modes ({name}): flash ran under attention dropout")
    scales = [st["loss_scale"] for st in b["stats"]]
    skipped = [st["skipped"] for st in b["stats"]]
    check(scales == scaler_rule(skipped),
          f"loss scale sequence {scales} does not follow the rule for "
          f"skips {skipped}")
    check(min(scales) < 2.0 ** 32 and skipped.count(0) >= 3,
          f"fp16: scale {scales}, skips {skipped}")
    check(all(st["skipped"] == 0 for st in a["stats"] + c["stats"]),
          "finetune_modes: a bf16 step was skipped")
    check(a_a4["launches"] == a["launches"],
          f"finetune_modes (a) with the A4 flags launched "
          f"{a_a4['launches']} != {a['launches']}")
    check(a_a4["parallel"] == {"backend": "nccl", "staged": False,
                               "world": 1, "dp": 1, "pp": 1, "tp": 1,
                               "rank": 0, "sequence_parallel": False},
          f"finetune_modes (a) under torchrun: {a_a4.get('parallel')}")
    a4_equal = [x["loss"] == y["loss"] and x["grad_norm"] == y["grad_norm"]
                for x, y in zip(a["stats"], a_a4["stats"])]
    check(all(abs(x["loss"] - y["loss"]) <= BF16_TOL
              and abs(x["grad_norm"] - y["grad_norm"])
              <= PATH_LP_TOL * y["grad_norm"]
              for x, y in zip(a["stats"], a_a4["stats"])),
          f"finetune_modes (a): the A4 flags moved the run: "
          f"{a_a4['stats']} != {a['stats']}")
    g_full, g_none = c["stats"][0]["grad_norm"], c_none["stats"][0][
        "grad_norm"]
    check(c["stats"][0]["loss"] == c_none["stats"][0]["loss"]
          and abs(g_full - g_none) <= 1e-6 * g_none,
          f"dropout: full {c['stats'][0]} != none {c_none['stats'][0]}")
    for name, run in (("a_recipe", a), ("a_recipe_a4_flags", a_a4),
                      ("b_fp16", b), ("c_dropout_full", c),
                      ("c_dropout_none", c_none)):
        ms = [st["ms"] for st in run["steps"]]
        out[name] = {
            "step_ms": ms, "step_ms_median": float(np.median(ms[1:] or ms)),
            "losses": [st["loss"] for st in run["stats"]],
            "grad_norms": [st["grad_norm"] for st in run["stats"]],
            "launches": run["launches"], "fp16_launches": run["fp16"],
            "wall_s": run["wall_s"]}
    out["b_fp16"].update(loss_scales=scales, skipped=skipped,
                         clean_steps=skipped.count(0))
    ms_ratio = out["a_recipe_a4_flags"]["step_ms_median"] \
        / out["a_recipe"]["step_ms_median"]
    out["a_recipe_a4_flags"].update(
        argv_extra=" ".join(RECIPE_A4_FLAGS), launcher="torchrun "
        "--nproc_per_node 1 (NCCL, world size 1)",
        bitwise_equal_by_step=a4_equal,
        step_ms_ratio_to_a_recipe=ms_ratio)
    check(abs(ms_ratio - 1.0) <= 0.03,
          f"finetune_modes (a): the A4 flags cost {ms_ratio:.4f}x a step")
    say("finetune_modes", card=nvidia_smi(), layers=FT_LAYERS, seq=FT_SEQ,
        micro_batches=FT_MICRO, recipe_flags=" ".join(RECIPE),
        recipe_left_out=RECIPE_LEFT_OUT, runs=out,
        dropout_step1_grad_norm={"full": g_full, "none": g_none,
                                 "bitwise_equal": g_full == g_none})
    for path, run in (("finetune_modes", a), ("finetune_modes", b),
                      ("finetune_modes", a_a4)):
        add_launches(kernels, path, run["launches"], run["fp16"])
    return a


# ---------------------------------------------------------------------------
# ranks in processes of their own: finetune.main under torchrun
# ---------------------------------------------------------------------------

# tp 2 x dp 2 with the recipe's parallel flags, four ranks sharing the card
# through gloo (NCCL cannot put two ranks on one device)
PAR_FLAGS = ["--tensor_model_parallel_size", "2", "--sequence_parallel",
             "--use_distributed_optimizer", "--distributed_backend", "gloo"]
PAR_RANKS, PAR_TP, PAR_DP = 4, 2, 2
RANK_TIMEOUT_S = 600
# a positional checksum: any changed bit of a leaf changes it
_FP_CHUNK, _FP_MOD = 1 << 24, 65521


def fingerprint(x: torch.Tensor) -> int:
    """sum(bits[i] * (i % 65521 + 1)) mod 2^64 over the leaf's raw bits,
    in chunks on the card (the sum wraps, so its order does not
    matter)."""
    flat = x.detach().contiguous().view(-1)
    bits = flat.view(torch.int32 if flat.element_size() == 4
                     else torch.int16)
    total = 0
    for lo in range(0, bits.numel(), _FP_CHUNK):
        chunk = bits[lo:lo + _FP_CHUNK].to("cuda", torch.int64)
        w = (torch.arange(lo, lo + chunk.numel(), device="cuda")
             % _FP_MOD) + 1
        total += int((chunk * w).sum())
    return total % (1 << 64)


def state_fingerprints(state) -> dict:
    """Leaf name (the checkpoint files' names) -> fingerprint of this
    rank's piece."""
    out = {k: fingerprint(v) for k, v in ckpt.flatten(state.params).items()}
    for prefix, tree in (("m.", state.opt_state.m),
                         ("v.", state.opt_state.v)):
        out.update({prefix + k: fingerprint(v)
                    for k, v in ckpt.flatten(tree).items()})
    return out


def finetune_rank(out_dir, argvs_file):
    """Rank mode (`chip_smoke.py --finetune-rank OUT ARGVS`, one process
    per rank under torchrun, or alone): `finetune.main` for each argv of
    the JSON list in ARGVS, each with the counters set to 0 just before
    it; writes OUT/rank<RANK>.json with each run's step stats, host
    facts, launches, peak memory and the final state's fingerprints."""
    argvs = json.loads(Path(argvs_file).read_text())
    runs = []
    for argv in argvs:
        if isinstance(argv, dict):  # the pipeline phase's serving entry
            runs.append(pp_serve(**argv))
            continue
        fps = {}
        torch.cuda.reset_peak_memory_stats()
        rec = finetune_run(argv, on_state=lambda st: fps.update(
            state_fingerprints(st)))
        keep = ("stats", "steps", "launches", "fp16", "wall_s", "saves",
                "commits", "loads", "iteration", "consumed", "resumed",
                "parallel", "n_params", "clock_s")
        out = {k: rec[k] for k in keep if k in rec}
        out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   fingerprints={k: str(v) for k, v in fps.items()})
        runs.append(out)
        print(f"rank {os.environ.get('RANK', '0')}: run {len(runs)} "
              f"wall {rec['wall_s']:.1f} s, commits {rec['commits']}, "
              f"loads {rec['loads']}, peak {out['peak_gb']:.2f} GB",
              flush=True)
    rank = int(os.environ.get("RANK", "0"))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(runs))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def run_ranks(argvs, nproc=None, timeout_s=RANK_TIMEOUT_S):
    """`finetune.main` for each argv in turn in `nproc` ranks under
    torchrun (world size nproc), or in one plain process for None: the
    rank records in rank order and rank 0's log. Past `timeout_s` every
    process of the run is killed and the phase fails."""
    out = FT_DIR / f"ranks-{time.monotonic_ns()}"
    out.mkdir(parents=True)
    (out / "argv.json").write_text(json.dumps(argvs))
    mode = [str(Path(__file__).resolve()), "--finetune-rank", str(out),
            str(out / "argv.json")]
    cmd = [sys.executable, *mode] if nproc is None else [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(nproc), *mode]
    log = out / "log.txt"
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                # the ranks run in sessions of their own: stop them by
                # the process tree, then torchrun
                stop_tree(proc.pid)
                proc.kill()
                proc.wait()
    text = log.read_text()
    check(proc.returncode == 0, f"ranks exited {proc.returncode} "
          f"({' '.join(cmd[:6])} ...):\n{text[-6000:]}")
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nproc or 1)]
    shutil.rmtree(out)
    return recs, text


def parallel_expected_launches(steps):
    """K4 once a layer and local microbatch under selective recompute
    (the forward keeps its output), K5 and K6 once; no eval."""
    n = FT_LAYERS * FT_MICRO // PAR_DP * steps
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def check_parallel_checkpoint(ck_dir, rank_fps, ctxs=None, zero1=True,
                              bucket_mb=4.0):
    """Cut every leaf of the checkpoint the tracker names into each
    rank's piece (by default of tp2 x dp2; else of the layouts `ctxs`,
    one a rank), as a resume would, and hold its fingerprint to the piece
    the rank saved: (leaves checked, iteration). A checkpoint without
    optimizer state is held to the ranks' parameters. Each leaf is read
    once and cut on the card."""
    from types import SimpleNamespace

    from megatron_llm_tpu_torch.training.trainer import StateLayout

    path, meta = ckpt.tracked_checkpoint(ck_dir)
    model = torch.load(os.path.join(path, "model"), map_location="cpu",
                       mmap=True, weights_only=True)
    optim = torch.load(os.path.join(path, "optim"), map_location="cpu",
                       mmap=True, weights_only=True) \
        if os.path.exists(os.path.join(path, "optim")) else {}
    tmpl = ckpt.unflatten({k: torch.empty(v.shape, dtype=v.dtype,
                                          device="meta")
                           for k, v in model.items()})
    leaves = dict(model)
    leaves.update({k: v for k, v in optim.items()
                   if k.startswith(("m.", "v."))})
    if ctxs is None:
        ctxs = [SimpleNamespace(tp=PAR_TP, dp=PAR_DP, tp_rank=r % PAR_TP,
                                dp_rank=r // PAR_TP)
                for r in range(len(rank_fps))]
    layouts = []
    for r, (fps, ctx) in enumerate(zip(rank_fps, ctxs)):
        if not optim:
            fps = {k: v for k, v in fps.items()
                   if not k.startswith(("m.", "v."))}
            rank_fps[r] = fps
        check(set(leaves) == set(fps), f"rank {r}: checkpoint leaves "
              f"{sorted(set(leaves) ^ set(fps))[:4]} differ")
        layouts.append(StateLayout(ctx, None, tmpl, zero1=zero1,
                                   bucket_mb=bucket_mb))
    checked = 0
    for name, leaf in leaves.items():
        whole = leaf.to("cuda")
        for r, (lay, fps) in enumerate(zip(layouts, rank_fps)):
            got = str(fingerprint(lay.shard(name, whole)))
            check(got == fps[name], f"rank {r}: {name} in the checkpoint "
                  f"is not the rank's saved piece")
            checked += 1
        del whole
    del model, optim, leaves
    return checked, meta["iteration"]


def finetune_parallel(kernels, data, one):
    """`torchrun --nproc_per_node 4 ... finetune.main` at tp 2 x dp 2
    with sequence parallelism and ZeRO-1 over gloo, the four ranks on
    cuda:0, on the recipe's flags at Llama-2-7B widths (4 of 32 layers,
    seq 4096, selective recompute, bf16, global batch 4): 3 steps and a
    save, then the same ranks resume it for step 4; world size 1 resumes
    it too. Held to `one` (finetune_modes' run (a): world size 1, the
    same weights and batches): losses within 2e-2, grad norms within
    5e-2; the checkpoint cut back into each rank's pieces bit for bit;
    K4-K6 launches per rank as the layout implies; per-rank peak
    memory."""
    ck = FT_DIR / "parallel_ck"
    base = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    t0 = time.perf_counter()
    ranks, log = run_ranks(
        [base + PAR_FLAGS + ["--exit_interval", "3", "--save_interval", "3",
                             "--save", str(ck)],
         base + PAR_FLAGS + ["--load", str(ck)]], nproc=PAR_RANKS)
    ranks_s = time.perf_counter() - t0
    first = [r[0] for r in ranks]
    resumed = [r[1] for r in ranks]
    ref = one["stats"]
    for r, run in enumerate(first):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": 4, "dp": PAR_DP, "pp": 1,
                                  "tp": PAR_TP, "rank": r,
                                  "sequence_parallel": True},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == first[0]["stats"],
              f"rank {r} reports another global loss or grad norm")
        check(run["launches"] == parallel_expected_launches(3),
              f"rank {r} launches {run['launches']} != "
              f"{parallel_expected_launches(3)}")
        check(resumed[r]["resumed"] == [3, 12] and resumed[r]["launches"]
              == parallel_expected_launches(1),
              f"rank {r} resumed {resumed[r].get('resumed')} with "
              f"{resumed[r]['launches']}")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(first[0]["stats"], ref)]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(first[0]["stats"], ref)]
    check(len(loss_err) == 3 and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"tp2 x dp2 against world size 1: loss err {loss_err}, grad "
          f"norm rel err {gnorm_err}")
    leaves, iteration = check_parallel_checkpoint(
        ck, [run["fingerprints"] for run in first])
    check(iteration == 3, f"the save is at iteration {iteration}")
    t0 = time.perf_counter()
    ws1 = finetune_run(base + ["--load", str(ck)])
    ws1_s = time.perf_counter() - t0
    step4 = {"tp2_dp2_resumed": resumed[0]["stats"][0]["loss"],
             "world1_resumed": ws1["stats"][0]["loss"],
             "world1_uninterrupted": ref[3]["loss"]}
    check(ws1["resumed"] == (3, 12) and abs(
        step4["world1_resumed"] - step4["tp2_dp2_resumed"]) <= BF16_TOL
        and abs(step4["world1_resumed"] - step4["world1_uninterrupted"])
        <= BF16_TOL, f"step 4 after the resume: {step4}")
    ckpt_bytes = dir_bytes(os.path.join(ck, "iter_0000003"))
    shutil.rmtree(ck)
    ms = [s["ms"] for s in first[0]["steps"]]
    peak = [run["peak_gb"] for run in first]
    say("finetune_parallel", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PAR_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main in each rank)",
        flags=" ".join(PAR_FLAGS), layout="tp 2 x dp 2, sequence parallel, "
        "ZeRO-1, every rank on cuda:0", backend="gloo",
        collectives_staged_through_host=first[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        losses=[x["loss"] for x in first[0]["stats"]],
        losses_world1=[y["loss"] for y in ref[:3]],
        grad_norms=[x["grad_norm"] for x in first[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ref[:3]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL},
        step_ms=ms, step_ms_label="gloo through the host, one card shared "
        "by 4 ranks (not comparable with a one-rank step)",
        step_ms_world1=[s["ms"] for s in one["steps"]],
        peak_gb_per_rank=peak, peak_gb_sum=sum(peak),
        launches_per_rank=[run["launches"] for run in first],
        expected_launches_per_rank=parallel_expected_launches(3),
        checkpoint_leaves_checked=leaves, checkpoint_bytes=ckpt_bytes,
        saves_blocked_ms=first[0]["saves"], commits_s=first[0]["commits"],
        load_s_per_rank=[run["loads"] for run in resumed],
        load_s_world1=ws1["loads"], step4_losses=step4,
        ranks_wall_s=ranks_s, world1_resume_wall_s=ws1_s,
        rank0_run_wall_s=[first[0]["wall_s"], resumed[0]["wall_s"]],
        rank0_clock_s=[first[0]["clock_s"], resumed[0]["clock_s"]],
        quantized_grad_reduce="not run on the card (CPU tests only)",
        rank0_log_tail=log[-1500:])
    for row in kernels:
        name = row["name"]
        if name in FLASH_WRAPPERS:
            per = [run["launches"][name] + res["launches"][name]
                   for run, res in zip(first, resumed)]
            row["launches_by_path"]["finetune_parallel"] = sum(per)
            row.setdefault("launches_per_rank", {})[
                "finetune_parallel"] = per
            row["launches"] = sum(row["launches_by_path"].values())


def time_flash_tp2(kernels):
    """K4, K5 and K6 at a tp 2 rank's attention shape (Llama-2-7B's 32
    heads over 2 ranks: b 1, s 4096, g 16, qpk 1, d 128, causal), their
    errors against the plain versions, beside SDPA's forward and
    backward at the same shape."""
    shape = (1, 4096, 4096, 16, 1, 128, True)
    b, s, t, g, qpk, d, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    q, k, v, do = flash_inputs(shape, gen)
    errs = flash_errors(q, k, v, do, causal)
    check(errs["o"] <= BF16_TOL and all(
        errs[n + "_rel"] <= BF16_TOL for n in ("dq", "dk", "dv")),
        f"K4-K6 at the tp2 shape: {errs}")
    o, lse = fa._fwd(q, k, v, causal)
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
                         per_graph=5, replays=4)}
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, g * qpk, d).transpose(1, 2).detach() \
        .requires_grad_(True)
    ks = k.transpose(1, 2).detach().requires_grad_(True)
    vs = v.transpose(1, 2).detach().requires_grad_(True)
    dos = do.reshape(b, s, g * qpk, d).transpose(1, 2)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qs, ks, vs, is_causal=causal),
                            per_graph=5, replays=4)
    ys = sdpa(qs, ks, vs, is_causal=causal)
    lib_bwd = profiled_ms(lambda: torch.autograd.grad(
        ys, (qs, ks, vs), dos, retain_graph=True), iters=10)
    del ys, qs, ks, vs
    bounds = flash_bounds(shape)
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal bf16 (a tp 2 rank)"
    say("kernel_time_flash_tp2", card=nvidia_smi(), shape=label, ms=ms,
        plain_ms=plain, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, max_abs_err=errs)
    for row in kernels:
        which = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
                 "flash_bwd_dkv": "dkv"}.get(row["name"])
        if which is not None:
            row["tp2_rank_shape"] = {
                "shape": label, "ms": ms[which],
                "plain_ms": plain["fwd" if which == "fwd" else "bwd"],
                "library_ms": lib_fwd if which == "fwd" else lib_bwd,
                "bound_ms": bounds[which][0],
                "bound_by": bounds[which][1]}
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# pipeline parallelism: two stages sharing the card through gloo
# ---------------------------------------------------------------------------

# the recipe's pipeline flags at pp 2 (examples/finetune.sh:13,59) with
# the JAX package's --pipeline_remat, two ranks on cuda:0 through gloo
PP_FLAGS = ["--pipeline_model_parallel_size", "2", "--pipeline_remat",
            "tick", "--distributed_backend", "gloo"]
PP_RANKS = 2
PP_GEN = 32  # tokens each served request generates
PP_STEP4_TOL = 1e-4


def pp_prompts():
    """Four greedy requests (one ring group of two rows a stage)."""
    rs = np.random.RandomState(SEED + 51)
    return [" ".join(map(str, rs.randint(0, 31999, n)))
            for n in (130, 96, 150, 110)]


def pp_ring_plan(prompts, gen=PP_GEN):
    """The ring's shape for these requests: (rows, groups, max_len,
    prefill_len, decode steps)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    tokens, lengths = tokenize_prompts(tok, prompts, gen)
    b, max_len = tokens.shape
    prefill = bucket_prefill_len(int(lengths.min()))
    nm = PP_RANKS
    return {"rows": b // nm, "groups": nm, "max_len": max_len,
            "prefill_len": prefill, "steps": max_len - prefill - 1}


def pp_expected_launches(steps):
    """Per rank (a stage of FT_LAYERS / 2 layers): under "tick" each
    microbatch's stage runs forward once without a graph and again in
    the backward, where the recipe's selective recompute keeps K4's
    output: K4 twice a layer and microbatch, K5 and K6 once."""
    n = FT_LAYERS // PP_RANKS * FT_MICRO * steps
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def pp_serving_model(argv, ck, ctx):
    """`argv`'s model (finetune's flags) with the checkpoint's weights on
    this rank's card: whole, or under `ctx` this stage's layers."""
    from megatron_llm_tpu_torch import arguments, finetune
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_map
    from megatron_llm_tpu_torch.parallel.mesh import rank_device
    from megatron_llm_tpu_torch.parallel.sharding import shard_params

    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    args = arguments.build_base_parser().parse_args(argv)
    mcfg = arguments.args_to_configs(
        args, tok.vocab_size, world_size=1 if ctx is None else ctx.pp)[0]
    dev = rank_device("cuda")
    model = finetune.model_provider(args, mcfg, device=dev)
    params = ckpt.load_checkpoint(str(ck), model.abstract_params(),
                                  no_load_optim=True, device="cpu")[0]
    if ctx is not None:
        params = shard_params(params, ctx, mcfg)
    return tok, model, tree_map(lambda x: x.to(dev), params)


def pp_requests(model, params, tok, prompts, gen=PP_GEN):
    """A score of `prompts`, then their greedy decode (no early stop),
    through the API, the counters set to 0 before each: the log-probs,
    tokens, launches and seconds."""
    from megatron_llm_tpu_torch.inference import api

    out = {}
    for name, kw in (("score", {}), ("greedy", dict(
            return_output_log_probs=True, top_k_sampling=1,
            use_eod_token_for_early_termination=False))):
        zero_counts()
        t0 = time.perf_counter()
        _, _, lp, toks = api.generate_and_post_process(
            model, params, tok, prompts, 0 if name == "score" else gen, **kw)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "lp": np.asarray(lp, np.float64).tolist(),
                     "tokens": np.asarray(toks).tolist(),
                     "launches": kernel_counts(),
                     "k1_by_layout": dict(
                         dec.decode_attention.launches_by_layout)}
    return out


def pp_group_greedy(model, params, tok, prompts, gen=PP_GEN):
    """The one-rank greedy request of `pp_requests` on each ring group's
    prompts alone (b / PP_RANKS consecutive rows, the ring's GEMM rows;
    the same max_len and prefill here): tokens and log-probs in the
    batch's row order."""
    from megatron_llm_tpu_torch.inference import api

    n = len(prompts) // PP_RANKS
    out = {"tokens": [], "lp": []}
    for i in range(0, len(prompts), n):
        _, _, lp, toks = api.generate_and_post_process(
            model, params, tok, prompts[i:i + n], gen,
            return_output_log_probs=True, top_k_sampling=1,
            use_eod_token_for_early_termination=False)
        out["tokens"] += np.asarray(toks).tolist()
        out["lp"] += np.asarray(lp, np.float64).tolist()
    return out


def pp_serve(argv, ck, prompts):
    """Rank mode's serving entry: the checkpoint `ck` served at pp 2, this
    rank a stage, through the API (every rank the same requests)."""
    from megatron_llm_tpu_torch.parallel.mesh import (
        destroy_parallel,
        initialize_parallel,
    )

    ctx = initialize_parallel(pp=PP_RANKS, backend="gloo", device="cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        tok, model, params = pp_serving_model(argv, ck, ctx)
        out = pp_requests(model, params, tok, prompts)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stage"] = ctx.pp_rank
        del model, params
        free_cuda()
        return out
    finally:
        destroy_parallel()


def pp_stream_errs(prompts, ref, got, gen=PP_GEN):
    """Greedy streams `got` against `ref`: the share of generated
    positions with equal tokens, and the largest |log-prob difference|
    over each row's common prefix."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    _, lengths = tokenize_prompts(tok, prompts, gen)
    agree, total, err = 0, 0, 0.0
    for n, a, b, la, lb in zip(lengths, ref["tokens"], got["tokens"],
                               ref["lp"], got["lp"]):
        end = n + gen
        agree += sum(x == y for x, y in zip(a[n:end], b[n:end]))
        total += gen
        k = next((i for i in range(end) if a[i] != b[i]), end)
        err = max(err, float(np.abs(np.asarray(la[:k - 1])
                                    - np.asarray(lb[:k - 1])).max()))
    return agree / total, err


def pipeline_phase(kernels, data, one):
    """`torchrun --nproc_per_node 2 ... finetune.main` at pp 2 with the
    recipe's flags and `--pipeline_remat tick` over gloo, both stages on
    cuda:0, at Llama-2-7B widths (4 of 32 layers, 2 a stage, seq 4096,
    global batch 4: 4 microbatches of 1): 3 steps and a save with the
    optimizer state, then the same ranks resume it for step 4 and serve
    it through the API (a pipelined score and greedy requests through
    the stage ring), and world size 1 resumes it too and serves it
    whole-batch. Held to `one` (finetune_modes' run (a): world size 1,
    the same flags, weights and batches): losses within 2e-2, grad norms
    within 5e-2; step 4 at pp 2 and at pp 1 within 1e-4; every leaf of
    the checkpoint, Adam moments included, cut into each stage's pieces
    equal to what the stage held; the scorer's log-probs within 5e-2 of
    the whole-batch score; the ring's streams those of the one-rank
    greedy route run on each ring group's rows alone (the ring's GEMM
    rows) over each common prefix, log-probs within 5e-2, the 4-row
    route's drift from both printed beside; K4-K6 per rank as the
    schedule implies, K1 in "tgd" once a stage layer per ring decode
    tick."""
    from types import SimpleNamespace

    ck = FT_DIR / "pipeline_ck"
    base = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    pp = base + PP_FLAGS
    prompts = pp_prompts()
    t0 = time.perf_counter()
    ranks, log = run_ranks(
        [pp + ["--exit_interval", "3", "--save_interval", "3", "--save",
               str(ck)],
         pp + ["--load", str(ck)],
         {"argv": pp, "ck": str(ck), "prompts": prompts}], nproc=PP_RANKS)
    ranks_s = time.perf_counter() - t0
    first, resumed, served = ([r[i] for r in ranks] for i in range(3))
    ref = one["stats"]
    for r, run in enumerate(first):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": PP_RANKS, "dp": 1,
                                  "pp": PP_RANKS, "tp": 1, "rank": r,
                                  "sequence_parallel": False},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == first[0]["stats"]
              and resumed[r]["stats"] == resumed[0]["stats"],
              f"rank {r} reports another loss or grad norm")
        check(run["launches"] == pp_expected_launches(3),
              f"rank {r} launches {run['launches']} != "
              f"{pp_expected_launches(3)}")
        check(resumed[r]["resumed"] == [3, 12] and resumed[r]["launches"]
              == pp_expected_launches(1),
              f"rank {r} resumed {resumed[r].get('resumed')} with "
              f"{resumed[r]['launches']}")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(first[0]["stats"], ref)]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(first[0]["stats"], ref)]
    check(len(loss_err) == 3 and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"pp 2 against world size 1: loss err {loss_err}, grad norm "
          f"rel err {gnorm_err}")
    ctxs = [SimpleNamespace(tp=1, dp=1, pp=PP_RANKS, tp_rank=0, dp_rank=0,
                            pp_rank=r) for r in range(PP_RANKS)]
    leaves, iteration = check_parallel_checkpoint(
        ck, [run["fingerprints"] for run in first], ctxs, zero1=False)
    check(iteration == 3, f"the save is at iteration {iteration}")
    t0 = time.perf_counter()
    ws1 = finetune_run(base + ["--load", str(ck)])
    ws1_s = time.perf_counter() - t0
    step4 = {"pp2_resumed": resumed[0]["stats"][0]["loss"],
             "pp1_resumed": ws1["stats"][0]["loss"],
             "pp1_uninterrupted": ref[3]["loss"]}
    check(ws1["resumed"] == (3, 12)
          and abs(step4["pp2_resumed"] - step4["pp1_resumed"])
          <= PP_STEP4_TOL
          and abs(step4["pp1_resumed"] - step4["pp1_uninterrupted"])
          <= BF16_TOL, f"step 4 after the resume: {step4}")
    # the one-rank whole-batch answers of the same checkpoint
    t0 = time.perf_counter()
    tok, model, params = pp_serving_model(base, ck, None)
    whole = pp_requests(model, params, tok, prompts)
    grouped = pp_group_greedy(model, params, tok, prompts)
    del model, params
    free_cuda()
    whole_s = time.perf_counter() - t0
    plan = pp_ring_plan(prompts)
    L = FT_LAYERS // PP_RANKS
    ring_k1 = L * plan["steps"] * plan["groups"]
    score_err = 0.0
    _, lengths = tokenize_prompts(tok, prompts, 0)
    for rank in served:
        check(rank["greedy"]["tokens"] == served[0]["greedy"]["tokens"]
              and rank["score"]["lp"] == served[0]["score"]["lp"],
              "the stages returned different answers")
        check(rank["greedy"]["k1_by_layout"] == {"gtd": 0, "tgd": ring_k1}
              and rank["greedy"]["launches"]["decode_attention"] == ring_k1
              and rank["greedy"]["launches"]["flash_fwd"] == 0,
              f"ring launches {rank['greedy']['launches']} "
              f"{rank['greedy']['k1_by_layout']}: K1 in tgd {ring_k1}")
        check(rank["score"]["launches"]["flash_fwd"] == L,
              f"scorer launches {rank['score']['launches']}")
    for n, a, b in zip(lengths, whole["score"]["lp"],
                       served[0]["score"]["lp"]):
        score_err = max(score_err, float(np.abs(
            np.asarray(a[:n - 1]) - np.asarray(b[:n - 1])).max()))
    agree, ring_err = pp_stream_errs(prompts, grouped, served[0]["greedy"])
    # bf16 noise from the GEMMs' row count: the 4-row route against the
    # ring and against the same route on the ring's 2-row groups
    drift = {name: dict(zip(("token_agreement", "max_abs_logprob_err"),
                            pp_stream_errs(prompts, whole["greedy"], got)))
             for name, got in (("ring", served[0]["greedy"]),
                               ("route_on_ring_rows", grouped))}
    ckpt_bytes = dir_bytes(os.path.join(ck, "iter_0000003"))
    shutil.rmtree(ck)
    ms = [st["ms"] for st in first[0]["steps"]]
    peak = [run["peak_gb"] for run in first]
    say("pipeline", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PP_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main, then the API, in each rank)",
        flags=" ".join(PP_FLAGS), layout="pp 2 (2 layers a stage), every "
        "rank on cuda:0", backend="gloo",
        collectives_staged_through_host=first[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        microbatches=FT_MICRO,
        losses=[x["loss"] for x in first[0]["stats"]],
        losses_world1=[y["loss"] for y in ref[:3]],
        grad_norms=[x["grad_norm"] for x in first[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ref[:3]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL,
             "step4_pp2_vs_pp1": PP_STEP4_TOL, "serving": PATH_LP_TOL},
        step_ms=ms, step_ms_label="gloo through the host, one card shared "
        "by 2 stages (not comparable with a one-rank step)",
        step_ms_world1=[st["ms"] for st in one["steps"]],
        peak_gb_per_rank=peak, serve_peak_gb_per_rank=[
            rank["peak_gb"] for rank in served],
        launches_per_rank=[run["launches"] for run in first],
        expected_launches_per_rank=pp_expected_launches(3),
        checkpoint_leaves_checked=leaves, checkpoint_bytes=ckpt_bytes,
        saves_blocked_ms=first[0]["saves"], commits_s=first[0]["commits"],
        load_s_per_rank=[run["loads"] for run in resumed],
        load_s_world1=ws1["loads"], step4_losses=step4,
        ring=plan, ring_k1_tgd_launches_per_rank=ring_k1,
        score_max_abs_err=score_err, ring_max_abs_logprob_err=ring_err,
        ring_greedy_token_agreement=agree,
        ring_reference="the one-rank greedy route on each ring group's "
        f"{plan['rows']} rows alone", four_row_route_drift=drift,
        serve_s_per_rank=[{k: rank[k]["s"] for k in ("score", "greedy")}
                          for rank in served],
        serve_s_world1={k: whole[k]["s"] for k in ("score", "greedy")},
        ranks_wall_s=ranks_s, world1_resume_wall_s=ws1_s,
        world1_serve_wall_s=whole_s,
        rank0_run_wall_s=[first[0]["wall_s"], resumed[0]["wall_s"]],
        rank0_clock_s=[first[0]["clock_s"], resumed[0]["clock_s"]],
        rank0_log_tail=log[-1500:])
    check(score_err <= PATH_LP_TOL and ring_err <= PATH_LP_TOL,
          f"pp 2 serving against one rank: score {score_err}, ring "
          f"{ring_err}")
    for row in kernels:
        name = row["name"]
        if name in FLASH_WRAPPERS:
            per = [run["launches"][name] + res["launches"][name]
                   + sv["score"]["launches"][name] + sv["greedy"][
                       "launches"][name]
                   for run, res, sv in zip(first, resumed, served)]
            row["launches_by_path"]["pipeline"] = sum(per)
            row["launches_by_path"]["pipeline_world1"] = \
                ws1["launches"][name] + whole["score"]["launches"][name]
            row.setdefault("launches_per_rank", {})["pipeline"] = per
            row["launches"] = sum(row["launches_by_path"].values())
        if name == "decode_attention":
            per = [sv["greedy"]["k1_by_layout"]["tgd"] for sv in served]
            row["launches_by_path"]["pipeline_ring_tgd"] = sum(per)
            row.setdefault("launches_per_rank", {})[
                "pipeline_ring_tgd"] = per
            row["launches"] = sum(row["launches_by_path"].values())


def time_decode_ring(kernels):
    """K1 at the pipeline ring's shape: one layer's "tgd" slice of a
    stage's stacked cache (2 layers, 2 groups, 2 rows a group, max_len
    positions) at Llama-2-7B widths, read in place at the ring's last
    decode length; its error against the plain version, beside SDPA and
    the bound."""
    plan = pp_ring_plan(pp_prompts())
    b, nm, T = plan["rows"], plan["groups"], plan["max_len"]
    g, qpk, d = 32, 1, 128
    length = plan["max_len"] - 1
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    stacked = [torch.randn(FT_LAYERS // PP_RANKS, nm, b, T, g, d,
                           generator=gen, device="cuda").to(bf)
               for _ in range(2)]
    k, v = stacked[0][1, 1], stacked[1][1, 1]
    q = torch.randn(b, 1, g, qpk, d, generator=gen, device="cuda").to(bf)
    ref = dec._xla_decode(q, k, v, length, "tgd")
    got = dec.decode_attention(q, k, v, length, layout="tgd")
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(err <= BF16_TOL, f"K1 at the ring's shape: {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kt, vt = k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2)
    bound, by = decode_bound_ms(b, g, qpk, d, length)
    row = {"shape": f"b{b} g{g} qpk{qpk} d{d} length{length}, the tgd "
                    f"slice of a stacked ({FT_LAYERS // PP_RANKS}, {nm}, "
                    f"{b}, {T}, {g}, {d}) bf16 cache",
           "ms": device_ms(lambda: dec.decode_attention(q, k, v, length,
                                                        layout="tgd")),
           "plain_ms": device_ms(lambda: dec._xla_decode(q, k, v, length,
                                                         "tgd"),
                                 per_graph=10, replays=5),
           "library_ms": device_ms(lambda: sdpa(
               q.reshape(b, g, qpk, d), kt, vt)),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "design": dec.decode_design(bf, qpk)}
    say("kernel_time_decode_ring", card=nvidia_smi(), **row)
    for r in kernels:
        if r["name"] == "decode_attention":
            r["pipeline_ring_shape"] = row
    del stacked, k, v, q
    torch.cuda.empty_cache()


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
    ap.add_argument("--finetune-rank", nargs=2, metavar=("OUT", "ARGVS"),
                    help="rank mode: finetune.main for each argv of the "
                         "JSON list ARGVS, records to OUT (what the "
                         "smoke's torchrun phases start)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.finetune_rank:
        return finetune_rank(*args.finetune_rank)
    become_subreaper()
    try:
        return smoke(args)
    finally:
        # a failed phase's processes (none left after a whole run)
        stop_children()


def smoke(args) -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = nvidia_smi()
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed("build", build_kernels)
    t0 = time.perf_counter()
    kernels = [check_decode_kernel(), check_rmsnorm_kernel(),
               *check_paged_kernel()]
    check_paged_variants(kernels[2])
    kernels.append(check_rmsnorm_bwd_kernel(kernels[1]))
    kernels += check_flash_kernels()
    seconds["kernel_checks"] = round(time.perf_counter() - t0, 1)
    kernels += timed("kernel_checks_fp16", check_flash_fp16)
    timed("kernel_time_flash_tp2", time_flash_tp2, kernels)
    timed("kernel_time_decode_ring", time_decode_ring, kernels)
    torch.cuda.empty_cache()
    model = timed("model", build_model, args.init_std)
    whole_batch = timed("serving", serve_whole_batch, kernels, *model)
    bf16 = timed("serving_engine", serve_engine, kernels, *model)
    free_cuda()
    cfg, llama, params, _ = model
    timed("graph_capture", graph_capture_phase, kernels, cfg, llama, params,
          whole_batch)
    free_cuda()
    timed("serving_engine_int8", serve_engine_int8, kernels, cfg, llama,
          params, bf16)
    free_cuda()
    timed("serving_engine_window", serve_engine_window, kernels, cfg, llama,
          params)
    free_cuda()
    timed("serving_engine_spec_whole_prompt",
          serve_engine_spec_and_whole_prompt, kernels, cfg, llama, params)
    timed("packed_docs_prefill", packed_docs_prefill, kernels, cfg, llama,
          params)
    timed("serving_engine_fp32", serve_engine_fp32, kernels, args.init_std)
    converted, weights = timed("convert_llama", convert_llama, cfg, params)
    # the 13.5 GB serving model and its engines' pools go before the
    # launchers and training
    del model, llama, params
    free_cuda()
    timed("launcher_llama", launcher_llama, kernels, converted, weights)
    del weights
    timed("launcher_falcon", launcher_falcon, kernels, args.init_std)
    say("memory_before_train",
        allocated_gb=torch.cuda.memory_allocated() / 1e9)
    train_cfg, _, trainer, state, text = timed("train", train_slice,
                                               kernels)
    train_ms = timed("throughput_train", throughput_train, trainer, state,
                     text)
    del trainer, state
    free_cuda()
    timed("train_remat", train_remat, kernels, train_cfg, text)
    data = timed("finetune", finetune_phase, kernels, train_ms)
    one = timed("finetune_modes", finetune_modes, kernels, data)
    timed("finetune_parallel", finetune_parallel, kernels, data, one)
    timed("pipeline", pipeline_phase, kernels, data, one)
    shutil.rmtree(FT_DIR)
    say("phase_seconds", card=smi, **seconds,
        total_s=round(time.perf_counter() - t_start, 1))
    say("processes_stopped", left_running=stop_children())
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
