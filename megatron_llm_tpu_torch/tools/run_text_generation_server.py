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
its `build_tokenizer` does not take). Flags of later slices raise
`ValueError` naming their ROADMAP.md item when set away from their
defaults: tp serving (A4), replica routing and the fleet (A5), the
engine's telemetry (A5).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import threading
import time
from typing import Callable, Optional

import torch

from megatron_llm_tpu_torch.config import (
    falcon_config,
    gpt_config,
    llama_config,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.models import FalconModel, GPTModel, LlamaModel
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.training.checkpointing import (
    restore_params,
    tracked_checkpoint,
)

_A4 = "tp serving (ROADMAP.md A4)"
_A5 = "replica routing and the fleet (ROADMAP.md A5)"
_A5_TELEMETRY = "the engine's telemetry (ROADMAP.md A5)"

# flags of later slices (parser dest -> the item): a value other than
# the parser's default raises
LATER_FLAGS = {
    "serving_tp": _A4,
    **dict.fromkeys((
        "router_replicas", "affinity_routing", "prefill_replicas",
        "ttft_slo_s", "chaos", "fleet_controller", "recover_requests",
        "scale_up_backlog_s", "scale_down_backlog_s", "scale_patience"),
        _A5),
    **dict.fromkeys((
        "trace_dir", "record_dir", "flight_recorder_size", "cost_registry",
        "chip_spec", "perf_sentinel_ksigma", "perf_sentinel_window",
        "perf_sentinel_patience"), _A5_TELEMETRY),
}


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
    # flags of later slices: each raises away from its default
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--record_dir", type=str, default=".")
    p.add_argument("--flight_recorder_size", type=int, default=4096)
    p.add_argument("--cost_registry", action="store_true")
    p.add_argument("--chip_spec", type=str, default=None,
                   choices=["v5e", "v5p", "v4"])
    p.add_argument("--perf_sentinel_ksigma", type=float, default=0.0)
    p.add_argument("--perf_sentinel_window", type=int, default=64)
    p.add_argument("--perf_sentinel_patience", type=int, default=8)
    p.add_argument("--serving_tp", type=int, default=1)
    p.add_argument("--router_replicas", type=int, default=1)
    p.add_argument("--affinity_routing",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--prefill_replicas", type=int, default=0)
    p.add_argument("--ttft_slo_s", type=float, default=None)
    p.add_argument("--chaos", type=str, default=None)
    p.add_argument("--fleet_controller", action="store_true")
    p.add_argument("--recover_requests",
                   action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--scale_up_backlog_s", type=float, default=None)
    p.add_argument("--scale_down_backlog_s", type=float, default=None)
    p.add_argument("--scale_patience", type=int, default=3)
    return p


def check_later_flags(args) -> None:
    defaults = build_parser()
    for dest, item in LATER_FLAGS.items():
        value = getattr(args, dest)
        if value != defaults.get_default(dest):
            raise ValueError(f"--{dest} {value!r} is not ported yet "
                             f"({item})")


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
    """The JAX launcher's start line (JAX :464-490), for what the port
    serves."""
    head = f"serving {args.model} from {path} on http://{args.host}:{port}/api"
    if engine is None:
        return head + " (whole-batch, no engine)"
    parts = [
        f"continuous batching: {args.serving_slots} slots",
        f"{engine.num_pages - 1} pages x {args.page_size}",
        f"kv_dtype={engine.kv_pool_dtype()} "
        f"({engine.kv_pool_bytes() / 2**20:.0f} MiB pool, "
        f"{engine.kv_bytes_per_token()} B/token)",
    ]
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
    parts.append("counters at /metrics (JSON), health at /health")
    return f"{head} ({', '.join(parts)})"


def main(argv=None, device="cuda",
         ready: Optional[Callable[[Launch], None]] = None):
    """Parse `argv` (sys.argv when None), restore the checkpoint, build
    the tokenizer and the engine, and serve until stopped: Ctrl-C, or
    the `stop` of the `Launch` handed to `ready` (a caller that runs
    `main` in a thread). Returns once the engine is stopped and the
    model and its caches are freed."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_text_generation_server: no CUDA device "
                           "(call main(argv, device='cpu') to serve on "
                           "the CPU)")
    args = build_parser().parse_args(argv)
    check_later_flags(args)

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
    engine = None
    if args.serving_slots > 0:
        # the prefix cache's default (None) is on whenever chunked
        # admission is; an explicit --prefix_cache without chunks reaches
        # the engine's error
        prefix_cache = (args.prefix_cache if args.prefix_cache is not None
                        else args.prefill_chunk_tokens > 0)
        engine = DecodeEngine(
            model, params, slots=args.serving_slots,
            page_size=args.page_size, max_context=args.max_context,
            page_budget=args.page_budget, max_queue=args.max_queue,
            step_horizon=args.step_horizon,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            warmup_compile=args.warmup_compile, prefix_cache=prefix_cache,
            spec_decode_k=args.spec_decode_k, kv_dtype=args.kv_dtype,
            quantize_weights=args.quantize_weights,
            termination_id=tokenizer.eod, vocab_size=tokenizer.vocab_size)
    server = MegatronServer(model, params, tokenizer, engine=engine,
                            request_deadline_s=args.request_deadline_s,
                            stream_enabled=args.stream)
    stopped = threading.Event()
    try:
        # starts the engine's serve thread (and its warmup) first
        httpd = server.run(args.host, args.port, block=False)
        setup_s = time.perf_counter() - t0
        port = httpd.server_address[1]
        print(banner(args, path, port, engine), flush=True)
        if ready is not None:
            ready(Launch(server, port, load_s, setup_s, stopped.set))
        try:
            stopped.wait()
        except KeyboardInterrupt:
            pass
    finally:
        server.stop()
        del server, engine, params, model
        gc.collect()  # engines hold reference cycles
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
