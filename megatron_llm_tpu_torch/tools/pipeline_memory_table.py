"""A stage's peak memory under each `--pipeline_remat` policy (port of
tools/pipeline_memory_table.py).

The JAX tool reads the compiled temp bytes of `grad(pipelined_loss)` on a
virtual CPU mesh. Here each rank is a stage on a card: for every policy
("tick", "selective", "save_dots", "offload", "none") and microbatch
count (4 and 8) it runs one pipelined forward and backward
(parallel/pipeline.py) and reads the card's peak allocation above what
the rank held before the step (`torch.cuda.max_memory_allocated`), of
which the fp32 gradients are a fixed part. Beside each, the JAX tool's
two analytic yardsticks for the same stage:

- the boundary stash: the (b, s, h) compute-dtype boundary of each of
  the stage's microbatches, kept from the forward to the backward;
- the 1F1B full stash: up to pp microbatches in flight, each keeping
  the stage's full per-layer activations with no recompute,
  (10 h + 3 ffn) values a token a layer in the compute dtype.

    torchrun --nproc_per_node 2 -m \\
        megatron_llm_tpu_torch.tools.pipeline_memory_table \\
        --distributed_backend gloo [--out table.json]

The model is Llama-2-7B's widths at LAYERS of its 32 layers, SEQ tokens
a row and MICRO_BATCH_SIZE rows a microbatch.

Every rank runs on the card (two ranks may share one through gloo);
`--device cpu` runs the same schedules on the CPU with no memory read.
Rank 0 prints a markdown table and, with --out, writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

POLICIES = ("tick", "selective", "save_dots", "offload", "none")
MICROBATCHES = (4, 8)
LAYERS, SEQ, MICRO_BATCH_SIZE = 4, 4096, 1


def yardsticks(cfg, pp: int, num_micro: int, b: int, s: int) -> dict:
    """The JAX tool's analytic bytes for one stage (compute dtype)."""
    elt = torch.tensor([], dtype=cfg.compute_dtype).element_size()
    h, ffn = cfg.hidden_size, cfg.ffn_hidden_size
    layers = cfg.num_layers // pp
    per_layer_per_token = (10 * h + 3 * ffn) * elt
    return {"boundary_stash_bytes": num_micro * b * s * h * elt,
            "full_stash_1f1b_bytes": min(pp, num_micro) * layers * b * s
            * per_layer_per_token}


def measure(model, params, ctx, policy: str, num_micro: int, b: int,
            s: int, device) -> dict:
    """One pipelined forward and backward of `num_micro` microbatches of
    (b, s) tokens under `policy`: the seconds, and on a card the peak
    bytes above the state before the step and the gradients' bytes."""
    from megatron_llm_tpu_torch.config import ParallelConfig
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
    from megatron_llm_tpu_torch.parallel.pipeline import (
        make_pipelined_loss_fn,
    )

    cfg = model.cfg
    gen = torch.Generator(device="cpu").manual_seed(num_micro)
    tokens = torch.randint(0, cfg.padded_vocab_size, (num_micro, b, s + 1),
                           generator=gen).to(device)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    pcfg = ParallelConfig(pipeline_parallel_size=ctx.pp,
                          num_microbatches=num_micro,
                          pipeline_remat=policy)
    loss_fn = make_pipelined_loss_fn(model, pcfg, ctx)
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = loss_fn(params, batch, backward=True)
    if on_card:
        torch.cuda.synchronize()
    row = {"policy": policy, "num_micro": num_micro,
           "s": time.perf_counter() - t0, "loss": float(loss)}
    if on_card:
        row["peak_above_state_bytes"] = \
            torch.cuda.max_memory_allocated() - base
        row["grad_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                                for p in leaves if p.grad is not None)
    for p in leaves:
        p.grad = None
    if on_card:
        torch.cuda.empty_cache()
    row.update(yardsticks(cfg, ctx.pp, num_micro, b, s))
    return row


def main(argv=None) -> list:
    """The rows (on every rank; rank 0 prints them)."""
    from megatron_llm_tpu_torch.config import llama_config
    from megatron_llm_tpu_torch.models import LlamaModel
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
    from megatron_llm_tpu_torch.parallel.mesh import (
        destroy_parallel,
        initialize_parallel,
        maybe_initialize_distributed,
        rank_device,
    )
    from megatron_llm_tpu_torch.parallel.sharding import shard_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--distributed_backend", default=None,
                    choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pipeline_memory_table: no CUDA device (pass "
                           "--device cpu to run on the CPU)")
    world = maybe_initialize_distributed(args.distributed_backend,
                                         args.device)
    device = rank_device(args.device)
    cfg = llama_config(
        7, num_layers=LAYERS, seq_length=SEQ,
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32, use_flash_attn=device.type == "cuda",
        recompute_granularity="selective")
    ctx = initialize_parallel(pp=world, backend=args.distributed_backend,
                              device=args.device)
    rows = []
    try:
        model = LlamaModel(cfg, device=device)
        params = shard_params(model.init(seed=0), ctx, cfg)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        for policy in POLICIES:
            for nm in MICROBATCHES:
                rows.append(measure(model, params, ctx, policy, nm,
                                    MICRO_BATCH_SIZE, SEQ, device))
        if ctx.rank == 0:
            _print(rows, cfg, ctx)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump({"config": {
                        "layers": cfg.num_layers, "pp": ctx.pp,
                        "hidden": cfg.hidden_size,
                        "ffn": cfg.ffn_hidden_size, "seq": SEQ,
                        "micro_batch_size": MICRO_BATCH_SIZE,
                        "device": torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"},
                        "rows": rows}, f, indent=1)
    finally:
        destroy_parallel()
    return rows


def _print(rows, cfg, ctx):
    gb = 1e9
    print(f"stage 0 of pp {ctx.pp}: {cfg.num_layers // ctx.pp} layers, h "
          f"{cfg.hidden_size}, ffn {cfg.ffn_hidden_size}, seq {SEQ}, "
          f"mbs {MICRO_BATCH_SIZE}")
    print("| policy | num_micro | peak above the state (GB) | of which "
          "fp32 grads (GB) | boundary stash (GB) | 1F1B full stash (GB) "
          "| s |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        peak = r.get("peak_above_state_bytes")
        grads = r.get("grad_bytes")
        print(f"| {r['policy']} | {r['num_micro']} | "
              f"{'not measured' if peak is None else f'{peak / gb:.3f}'} | "
              f"{'not measured' if grads is None else f'{grads / gb:.3f}'} "
              f"| {r['boundary_stash_bytes'] / gb:.3f} | "
              f"{r['full_stash_1f1b_bytes'] / gb:.3f} | {r['s']:.2f} |",
              flush=True)


if __name__ == "__main__":
    import torch.distributed as dist

    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
