"""Start the REST text-generation server on a checkpoint (port of
tools/run_text_generation_server.py).

    python -m megatron_llm_tpu_torch.tools.run_text_generation_server \\
        --load native-ckpt --model llama \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merge_file merges.txt --port 5000

`--load` takes what the tracker there names: a converter's release
(tools/convert_weights.py) or a checkpoint `finetune` saved. The params
are restored in the config's params_dtype (fp32, as in the JAX package)
and the serving paths cast them once. It serves on the first CUDA card;
`main(argv, device="cpu")` serves on the CPU (the tests do). The flags
are the JAX launcher's; the tokenizer takes `--tokenizer_model` and
`--null_vocab_size` too, and gets the merges file under the name
`build_tokenizer` reads (the JAX launcher passes `merge_file=`, which
its `build_tokenizer` does not take).

`--router_replicas N` serves N engine replicas behind the prefix-affinity
router (inference/router.py; JAX :335-440): replica i runs on
`cuda:{i % device_count}` (on one card every replica shares it; the JAX
launcher gives replica i the devices [i tp, (i + 1) tp) and refuses too
few), `--prefill_replicas M` dedicates the first M to chunked prefill and
hands their KV pages to the decode replicas, `--chaos` arms fault
injection (inference/chaos.py), `--fleet_controller` replaces a dead or
regressed replica (inference/fleet.py) and `--recover_requests` resubmits
a dead replica's requests. The telemetry flags (`--trace_dir`,
`--record_dir`, `--flight_recorder_size`, `--cost_registry`,
`--chip_spec`, `--perf_sentinel_*`) reach every engine. Replicas at
`--serving_tp` > 1 raise (ROADMAP.md A5).

`--serving_tp N` serves one engine on N tensor-parallel ranks, one
process each, under torchrun (JAX :154-162, :335-354):

    torchrun --nproc_per_node 2 -m \
        megatron_llm_tpu_torch.tools.run_text_generation_server \
        --serving_tp 2 --distributed_backend gloo --load ... --port 5000

N must equal the world size. Every rank restores the checkpoint and
builds the engine on its slice (inference/engine.py, the module doc);
tp rank 0 serves HTTP and keeps the whole tree for the requests the
engine does not take (score, beam: JAX inference/server.py:255-257,
on rank 0 alone), the other ranks free it and follow the engine's
rounds until rank 0 stops (they ignore SIGINT: Ctrl-C reaches rank 0,
which drains and releases them). `--distributed_backend gloo` lets
ranks share one card (NCCL refuses two ranks on one device); the
rounds then run uncaptured, which the banner says.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.config import (
    falcon_config,
    gpt_config,
    llama_config,
)
from megatron_llm_tpu_torch.inference.chaos import ChaosPolicy
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.inference.fleet import FleetController
from megatron_llm_tpu_torch.inference.graph_capture import launch_counts
from megatron_llm_tpu_torch.inference.router import (
    EngineReplica,
    ReplicaRouter,
)
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.models import FalconModel, GPTModel, LlamaModel
from megatron_llm_tpu_torch.parallel.mesh import (
    maybe_initialize_distributed,
    rank_device,
)
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.training.checkpointing import (
    restore_params,
    tracked_checkpoint,
)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", required=True)
    p.add_argument("--model", choices=["llama", "falcon", "gpt"],
                   default="llama")
    p.add_argument("--tokenizer_type", default="SentencePieceTokenizer")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merge_file", default=None)
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--null_vocab_size", type=int, default=None,
                   help="NullTokenizer's vocabulary (ids 0..N-1; N is eod)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000,
                   help="0 picks a free port (the banner names it)")
    # the continuous-batching engine (inference/engine.py);
    # --serving_slots 0 serves every request on the whole-batch path
    p.add_argument("--serving_slots", type=int, default=8)
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--max_context", type=int, default=2048)
    p.add_argument("--page_budget", type=int, default=None,
                   help="total pooled KV positions; default "
                        "slots*max_context (full reservation)")
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--step_horizon", type=int, default=8,
                   help="decode steps per round")
    p.add_argument("--prefill_chunk_tokens", type=int, default=256,
                   help="per-round prompt-token budget of chunked "
                        "admission; 0 = whole-prompt prefill")
    p.add_argument("--warmup_compile", action="store_true",
                   help="capture every round bucket as a CUDA graph "
                        "before serving")
    p.add_argument("--request_deadline_s", type=float, default=None,
                   help="per-request wall-clock budget (default: none)")
    p.add_argument("--prefix_cache", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="share prompt-prefix KV pages across requests; "
                        "default: on whenever chunked admission is on")
    p.add_argument("--spec_decode_k", type=int, default=0,
                   help="prompt-lookup drafts of up to K tokens per "
                        "greedy slot; 0 disables")
    p.add_argument("--stream", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve SSE token streaming for {\"stream\": true}")
    p.add_argument("--kv_dtype", choices=["bf16", "int8"], default="bf16",
                   help="paged KV pool storage dtype")
    p.add_argument("--quantize_weights", action="store_true",
                   help="weight-only int8 decode matmuls")
    p.add_argument("--rope_theta", type=float, default=None,
                   help="override the checkpoint's rotary base")
    p.add_argument("--rope_scaling_factor", type=float, default=None,
                   help="linear RoPE position interpolation factor")
    p.add_argument("--attention_window_size", type=int, default=None,
                   help="sliding-window attention for serving (needs "
                        "--prefill_chunk_tokens > 0)")
    p.add_argument("--serving_tp", type=int, default=1,
                   help="tensor-parallel ranks of the engine, one process "
                        "each under torchrun --nproc_per_node N: the KV "
                        "page pools (and int8 scale pools) shard over the "
                        "group axis; must divide the model's "
                        "num_query_groups and equal the world size")
    p.add_argument("--distributed_backend", default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend at --serving_tp > 1 "
                        "(default: nccl for CUDA, gloo for the CPU); gloo "
                        "lets ranks share one card")
    # the engine's telemetry (inference/engine.py, telemetry/)
    p.add_argument("--trace_dir", type=str, default=None,
                   help="enable the engines' span tracer: Chrome trace "
                        "JSON written here at shutdown; POST /profile "
                        "traces default here")
    p.add_argument("--record_dir", type=str, default=".",
                   help="where the flight recorder dumps its ring when a "
                        "serve loop dies or the perf sentinel trips")
    p.add_argument("--flight_recorder_size", type=int, default=4096,
                   help="events the flight recorder's ring keeps")
    p.add_argument("--cost_registry", action="store_true",
                   help="count each round kind's FLOPs and bytes once per "
                        "bucket: per-request cost records, the modeled "
                        "backlog the router places by, cost_* samples on "
                        "the Prometheus /metrics")
    p.add_argument("--chip_spec", type=str, default=None,
                   choices=["h100"],
                   help="the card's spec for the roofline denominators "
                        "(telemetry/chipspec.py; default: detect)")
    p.add_argument("--perf_sentinel_ksigma", type=float, default=0.0,
                   help="arm the decode-round perf sentinel: patience "
                        "rounds above median + k * 1.4826 MAD trip it; 0 "
                        "disables")
    p.add_argument("--perf_sentinel_window", type=int, default=64,
                   help="the sentinel's baseline window (good rounds)")
    p.add_argument("--perf_sentinel_patience", type=int, default=8,
                   help="consecutive bad rounds that trip the sentinel")
    # the fleet (inference/{router,fleet,chaos}.py)
    p.add_argument("--router_replicas", type=int, default=1,
                   help="N engine replicas behind the prefix-affinity "
                        "router (replica i on cuda:{i %% device_count}); "
                        "1 = one engine, no router")
    p.add_argument("--affinity_routing",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="route by the page-aligned prefix index "
                        "(--no-affinity_routing: least queue depth)")
    p.add_argument("--prefill_replicas", type=int, default=0,
                   help="disaggregated serving: the first N of "
                        "--router_replicas prefill long prompts and hand "
                        "their KV pages to the decode replicas; 0 = a "
                        "symmetric fleet")
    p.add_argument("--ttft_slo_s", type=float, default=None,
                   help="refuse (503 with a modeled Retry-After) when every "
                        "replica's modeled backlog exceeds this many "
                        "seconds (needs --cost_registry)")
    p.add_argument("--chaos", type=str, default=None,
                   help="deterministic fault injection (inference/chaos.py"
                        " grammar), e.g. 'kill=1@8'; a test knob")
    p.add_argument("--fleet_controller", action="store_true",
                   help="replace dead or regressed replicas (drain, stop, "
                        "rebuild, warm, rotate in); needs "
                        "--router_replicas > 1")
    p.add_argument("--recover_requests",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="resubmit a dead replica's queued and unstreamed "
                        "requests elsewhere (default: with "
                        "--fleet_controller)")
    p.add_argument("--scale_up_backlog_s", type=float, default=None,
                   help="the controller grows the active set above this "
                        "modeled backlog a replica")
    p.add_argument("--scale_down_backlog_s", type=float, default=None,
                   help="and shrinks it below this one")
    p.add_argument("--scale_patience", type=int, default=3,
                   help="identical scale verdicts before the controller "
                        "acts")
    return p


def check_serving_tp(args) -> int:
    """The world size torchrun gives this process (1 without torchrun),
    which `--serving_tp` must equal: one process a tp rank."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    tp = max(args.serving_tp, 1)
    if tp != world:
        raise ValueError(
            f"--serving_tp {args.serving_tp} needs exactly {tp} processes, "
            f"one a tp rank (torchrun --nproc_per_node {tp}); this process "
            f"is one of {world} (ROADMAP.md A4, tp serving's torch form)")
    return world


def replica_device(device, i: int):
    """Replica i's device: `cuda:{i % device_count}` for "cuda" (every
    replica on cuda:0 on one card), the device itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", i % max(torch.cuda.device_count(), 1))


def build_serving(args, model, params, tokenizer):
    """What the server serves (JAX :364-440): one engine, or a
    `ReplicaRouter` over `--router_replicas` engines (disaggregated with
    `--prefill_replicas`), with its chaos policy and fleet controller;
    None with `--serving_slots 0`."""
    n_rep, tp = max(args.router_replicas, 1), max(args.serving_tp, 1)
    if args.serving_slots <= 0:
        if tp > 1:
            raise ValueError("--serving_tp > 1 serves the engine: pass "
                             "--serving_slots > 0")
        if n_rep > 1:
            raise ValueError("--router_replicas > 1 serves engines: pass "
                             "--serving_slots > 0")
        return None
    if n_rep > 1 and tp > 1:
        raise ValueError(
            f"--router_replicas {n_rep} with --serving_tp {tp} is not "
            f"ported: each replica needs a process group of its own under "
            f"torchrun (ROADMAP.md A5)")
    # the prefix cache's default (None) is on whenever chunked admission
    # is; an explicit --prefix_cache without chunks reaches the engine's
    # error
    prefix_cache = (args.prefix_cache if args.prefix_cache is not None
                    else args.prefill_chunk_tokens > 0)

    def build_engine(replica_id=None):
        devices = None
        if replica_id is not None and model.device.type == "cuda":
            devices = [replica_device(model.device, replica_id)]
        return DecodeEngine(
            model, params, slots=args.serving_slots,
            page_size=args.page_size, max_context=args.max_context,
            page_budget=args.page_budget, max_queue=args.max_queue,
            step_horizon=args.step_horizon,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            warmup_compile=args.warmup_compile, prefix_cache=prefix_cache,
            spec_decode_k=args.spec_decode_k, kv_dtype=args.kv_dtype,
            quantize_weights=args.quantize_weights,
            serving_tp=args.serving_tp, devices=devices,
            replica_id=replica_id,
            termination_id=tokenizer.eod, vocab_size=tokenizer.vocab_size,
            trace_dir=args.trace_dir, record_dir=args.record_dir,
            flight_recorder_size=args.flight_recorder_size,
            cost_registry=args.cost_registry, chip_spec=args.chip_spec,
            perf_sentinel_ksigma=args.perf_sentinel_ksigma,
            perf_sentinel_window=args.perf_sentinel_window,
            perf_sentinel_patience=args.perf_sentinel_patience)

    if n_rep <= 1:
        for flag, on in (("--chaos", args.chaos),
                         ("--fleet_controller", args.fleet_controller),
                         ("--prefill_replicas", args.prefill_replicas)):
            if on:
                raise ValueError(
                    f"{flag} needs --router_replicas > 1 (faults, "
                    f"replacements and the hand-off act on replicas)")
        return build_engine()
    chaos = ChaosPolicy.parse(args.chaos) if args.chaos else None
    recover = (args.recover_requests if args.recover_requests is not None
               else args.fleet_controller)
    replicas = [EngineReplica(build_engine(replica_id=i), chaos=chaos)
                for i in range(n_rep)]
    n_pre = args.prefill_replicas
    if n_pre:
        if not 0 < n_pre < n_rep:
            raise ValueError(
                f"--prefill_replicas {n_pre} must leave at least one "
                f"decode replica out of --router_replicas {n_rep}")
        router = ReplicaRouter(
            prefill_replicas=replicas[:n_pre],
            decode_replicas=replicas[n_pre:],
            affinity=args.affinity_routing, ttft_slo_s=args.ttft_slo_s)
    else:
        router = ReplicaRouter(replicas, affinity=args.affinity_routing,
                               ttft_slo_s=args.ttft_slo_s,
                               recover_requests=recover)
    if args.fleet_controller:
        # a replacement is rebuilt on the dead replica's device without
        # the chaos policy: an injected kill must not fire again
        def spawn_replica(old):
            return EngineReplica(build_engine(replica_id=old.replica_id))

        # it registers on the router (`router._controller`)
        FleetController(
            router, spawn_replica=spawn_replica,
            scale_up_backlog_s=args.scale_up_backlog_s,
            scale_down_backlog_s=args.scale_down_backlog_s,
            scale_patience=args.scale_patience).start()
    return router


def build_model(model_name: str, saved: dict, args, device):
    """The model the JAX launcher builds from a checkpoint's saved config
    keys and the serve-time RoPE and window overrides (JAX :283-310)."""
    common = {k: saved[k] for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "num_attention_heads_kv", "ffn_hidden_size", "seq_length",
        "max_position_embeddings", "padded_vocab_size", "rope_theta",
        "rope_scaling_factor", "layernorm_epsilon") if k in saved}
    # the rotary tables come from the config, not the checkpoint, so
    # theta and interpolation can be retargeted at load time
    if args.rope_theta is not None:
        common["rope_theta"] = args.rope_theta
    if args.rope_scaling_factor is not None:
        common["rope_scaling_factor"] = args.rope_scaling_factor
    if args.attention_window_size is not None:
        common["attention_window_size"] = args.attention_window_size
    vocab = saved["padded_vocab_size"]
    if model_name == "llama":
        return LlamaModel(llama_config(7, vocab_size=vocab, **common),
                          device=device)
    if model_name == "falcon":
        return FalconModel(falcon_config(
            7, vocab_size=vocab,
            parallel_layernorm=saved.get("parallel_layernorm", False),
            **common), device=device)
    return GPTModel(gpt_config(vocab_size=vocab, **common), device=device)


@dataclasses.dataclass
class Launch:
    """What a caller of `main(..., ready=...)` gets once the server
    listens: the server, its port, the load and engine set-up seconds,
    and `stop()`, after which `main` stops the engine, frees the model
    and returns."""

    server: MegatronServer
    port: int
    load_s: float
    setup_s: float
    stop: Callable[[], None]


def banner(args, path, port, engine) -> str:
    """The JAX launcher's start line (JAX :462-490), for what the port
    serves; at --serving_tp > 1 the pool's bytes are a rank's, and the
    line says that the rounds run uncaptured."""
    head = f"serving {args.model} from {path} on http://{args.host}:{port}/api"
    if engine is None:
        return head + " (whole-batch, no engine)"
    fleet = ""
    if isinstance(engine, ReplicaRouter):
        n = len(engine.replicas)
        split = (f"{args.prefill_replicas} prefill + "
                 f"{n - args.prefill_replicas} decode"
                 if args.prefill_replicas else f"{n} replicas")
        fleet = (f"{split} (prefix-affinity routing "
                 f"{'ON' if args.affinity_routing else 'OFF'}"
                 + (f", ttft_slo {args.ttft_slo_s}s"
                    if args.ttft_slo_s is not None else "")
                 + (", fleet controller" if args.fleet_controller else "")
                 + (f", CHAOS[{args.chaos}]" if args.chaos else "")
                 + "), ")
        # per-engine facts from replica 0 (a homogeneous fleet)
        engine = engine.replicas[0].engine
    chip = "/chip" if engine.serving_tp > 1 else ""
    parts = [
        f"{fleet}continuous batching: {args.serving_slots} slots",
        f"{engine.num_pages - 1} pages x {args.page_size}",
        f"kv_dtype={engine.kv_pool_dtype()} "
        f"({engine.kv_pool_bytes() / 2**20:.0f} MiB{chip} pool, "
        f"{engine.kv_bytes_per_token()} B/token{chip})",
    ]
    if engine.serving_tp > 1:
        parts[0] = (f"tp{engine.serving_tp} mesh ({engine._ctx.backend}, "
                    f"rounds uncaptured), {parts[0]}")
    if args.quantize_weights:
        parts.append("int8 decode weights")
    parts.append(f"chunked prefill {engine.prefill_chunk_tokens} tok/round"
                 if engine.prefill_chunk_tokens else "whole-prompt prefill")
    if engine._prefix is not None:
        parts.append("prefix cache")
    if engine.spec_decode_k:
        parts.append(f"spec decode k={engine.spec_decode_k}")
    if args.stream:
        parts.append("SSE streaming")
    if args.trace_dir:
        parts.append(f"span tracing -> {args.trace_dir}")
    if engine.costs is not None:
        parts.append("cost registry" + (f" ({engine.chip.label()})"
                                        if engine.chip else ""))
    if args.perf_sentinel_ksigma > 0:
        parts.append(f"perf sentinel k={args.perf_sentinel_ksigma}")
    parts.append("counters at /metrics (JSON + Prometheus), health at "
                 "/health, flight record at /flight_record, profiler at "
                 "POST /profile")
    return f"{head} ({', '.join(parts)})"


def main(argv=None, device="cuda",
         ready: Optional[Callable[[Launch], None]] = None):
    """Parse `argv` (sys.argv when None), restore the checkpoint, build
    the tokenizer and the engine, and serve until stopped: Ctrl-C, or
    the `stop` of the `Launch` handed to `ready` (a caller that runs
    `main` in a thread). Returns once the engine is stopped and the
    model and its caches are freed. At --serving_tp > 1 every rank of
    the torchrun group calls it: rank 0 serves as above, the others
    follow the engine's rounds and return once rank 0 stops."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_text_generation_server: no CUDA device "
                           "(call main(argv, device='cpu') to serve on "
                           "the CPU)")
    args = build_parser().parse_args(argv)
    own_group = False
    if check_serving_tp(args) > 1:
        own_group = not dist.is_initialized()
        maybe_initialize_distributed(args.distributed_backend, device)
        device = rank_device(device)
    try:
        return _serve(args, device, ready)
    finally:
        if own_group:
            dist.destroy_process_group()


def _rank_started(engine, device) -> None:
    """At --serving_tp > 1, one line a rank once it serves: its pid, its
    pool's bytes and, on a card, its memory."""
    line = (f"tp rank {engine.tp_rank} (pid {os.getpid()}): kv pool "
            f"{engine.kv_pool_bytes()} bytes")
    if torch.device(device).type == "cuda":
        line += (f", {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB "
                 f"allocated, {torch.cuda.memory_reserved(device) / 2**30:.3f}"
                 f" GiB reserved after the start")
    _print_line(line)


def _rank_stopped(engine) -> None:
    """At --serving_tp > 1, each rank's last line: its kernels' launch
    counts and, on tp rank 0, the wall times of the engine's rounds."""
    report = {"launches": launch_counts()}
    if engine.tp_rank == 0:
        report["rounds"] = engine.round_summary()
    _print_line(f"tp rank {engine.tp_rank} stopped: {json.dumps(report)}")


def _print_line(line: str) -> None:
    """One line in one write: the ranks of a torchrun group share its
    standard output, and print's two writes (text, newline) interleave."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _serve(args, device, ready):
    t0 = time.perf_counter()
    path, meta = tracked_checkpoint(args.load)
    model = build_model(args.model, meta["config"], args, device)
    params = restore_params(path, model.abstract_params(), model.device)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    load_s = time.perf_counter() - t0

    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merges_file=args.merge_file, tokenizer_model=args.tokenizer_model,
        null_vocab_size=args.null_vocab_size)
    t0 = time.perf_counter()
    engine = build_serving(args, model, params, tokenizer)
    if isinstance(engine, DecodeEngine) and engine.tp_rank > 0:
        # a follower: its decode and pool slices only; rank 0 stops it
        del params, model
        gc.collect()
        _rank_started(engine, device)
        main_thread = threading.current_thread() is threading.main_thread()
        if main_thread:
            previous = signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            engine.follow()
        finally:
            if main_thread:
                signal.signal(signal.SIGINT, previous)
            _rank_stopped(engine)
            del engine
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        return
    server = MegatronServer(model, params, tokenizer, engine=engine,
                            request_deadline_s=args.request_deadline_s,
                            stream_enabled=args.stream)
    stopped = threading.Event()
    try:
        # starts the engine's serve thread (and its warmup) first
        httpd = server.run(args.host, args.port, block=False)
        setup_s = time.perf_counter() - t0
        port = httpd.server_address[1]
        if isinstance(engine, DecodeEngine) and engine.serving_tp > 1:
            _rank_started(engine, device)
        print(banner(args, path, port, engine), flush=True)
        if ready is not None:
            ready(Launch(server, port, load_s, setup_s, stopped.set))
        try:
            stopped.wait()
        except KeyboardInterrupt:
            pass
    finally:
        controller = getattr(engine, "_controller", None)
        if controller is not None:
            controller.stop()
        server.stop()
        if isinstance(engine, DecodeEngine) and engine.serving_tp > 1:
            _rank_stopped(engine)
        del server, engine, params, model
        gc.collect()  # engines hold reference cycles
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
