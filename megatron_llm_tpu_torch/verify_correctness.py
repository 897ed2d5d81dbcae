"""Golden-logit correctness gate: the port's model against HuggingFace
side by side (port of the root verify_correctness.py).

    python -m megatron_llm_tpu_torch.verify_correctness --device cpu \\
        [--model llama|falcon] [--hf_dir DIR] [--num_kv_heads 1]

Both run on the same random batches; each iteration prints the max and
mean absolute logit error and the loss delta, then the mean of the max
errors is held to --tolerance (1e-3 in fp32) and the last line says OK
or FAIL, the exit code 0 or 1. With --hf_dir a real checkpoint is
verified; without, a randomly initialised small HF model (Llama, or
Falcon: --num_kv_heads 1 the 7B multi-query layout, more the 40B
grouped one) keeps the gate hermetic. The HF weights go through the
port's own converters (convert/hf.py, tools/convert_weights.py's
config), and everything runs in fp32 with TF32 off.

It needs the `transformers` package, imported when the gate runs, and
raises naming it where it is missing (the H100 machine has none, so the
gate runs on the CPU there is `transformers`); nothing falls back.
`--device` (default cuda) places the port's model; HF runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=["llama", "falcon"], default="llama")
    p.add_argument("--hf_dir", default=None,
                   help="HF checkpoint dir; omit for a random hermetic model")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seq_length", type=int, default=64)
    p.add_argument("--tolerance", type=float, default=1e-3)
    # hermetic-model architecture knobs
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--hidden_size", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_kv_heads", type=int, default=4)
    p.add_argument("--vocab_size", type=int, default=512)
    p.add_argument("--dump_layer_errors", action="store_true",
                   help="per-layer hidden-state max-abs error vs HF on the "
                        "first batch")
    p.add_argument("--device", default="cuda",
                   help="the port model's device (default %(default)s)")
    return p.parse_args(argv)


def import_transformers():
    """The `transformers` module, or an ImportError naming it."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "verify_correctness needs the `transformers` package to build "
            "or load the HF reference model; it is not installed here") \
            from e
    return transformers


def hf_model(args):
    """The HF reference in fp32, eval mode: --hf_dir's checkpoint, or the
    hermetic random model of the architecture flags (JAX :66-95)."""
    tr = import_transformers()
    if args.hf_dir:
        return tr.AutoModelForCausalLM.from_pretrained(
            args.hf_dir, torch_dtype=torch.float32).eval()
    if args.model == "llama":
        return tr.LlamaForCausalLM(tr.LlamaConfig(
            vocab_size=args.vocab_size, hidden_size=args.hidden_size,
            intermediate_size=int(args.hidden_size * 8 / 3 // 16 * 16),
            num_hidden_layers=args.num_layers,
            num_attention_heads=args.num_heads,
            num_key_value_heads=args.num_kv_heads,
            max_position_embeddings=max(2048, args.seq_length),
            tie_word_embeddings=False, attention_bias=False, mlp_bias=False,
        )).float().eval()
    # --num_kv_heads 1: the 7B multi-query layout; more: the 40B grouped
    # (new_decoder_architecture) one
    mqa = args.num_kv_heads == 1
    return tr.FalconForCausalLM(tr.FalconConfig(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads, num_kv_heads=args.num_kv_heads,
        multi_query=mqa, new_decoder_architecture=not mqa,
        parallel_attn=True, bias=False, alibi=False,
    )).float().eval()


def native_model(args, hf, device):
    """(cfg, model, params) of the port from `hf`'s weights, fp32
    compute, on `device`."""
    from megatron_llm_tpu_torch.convert.hf import (
        hf_falcon_to_native,
        hf_llama_to_native,
    )
    from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_map
    from megatron_llm_tpu_torch.tools.convert_weights import (
        _model_cfg_from_hf,
    )

    cfg = dataclasses.replace(
        _model_cfg_from_hf(args.model, hf.config, "float32"),
        compute_dtype=torch.float32)
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    convert = hf_llama_to_native if args.model == "llama" \
        else hf_falcon_to_native
    params = tree_map(lambda x: x.to(device), convert(sd, cfg))
    model = (LlamaModel if args.model == "llama" else FalconModel)(
        cfg, device=device)
    return cfg, model, params


@torch.no_grad()
def dump_layer_errors(hf, cfg, params, tokens, device):
    """Per-layer hidden-state drift against HF (the embedding, then each
    layer, the last with the final norm), the port's stack run layer by
    layer."""
    from megatron_llm_tpu_torch.models.language_model import embed_tokens
    from megatron_llm_tpu_torch.models.norms import apply_norm
    from megatron_llm_tpu_torch.models.rope import precompute_rope
    from megatron_llm_tpu_torch.models.transformer import (
        layer_slice,
        transformer_layer,
    )

    hf_states = hf(torch.as_tensor(tokens),
                   output_hidden_states=True).hidden_states
    rope = None
    if cfg.position_embedding_type == "rotary":
        rope = precompute_rope(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, cfg.rope_scaling_factor,
                               device)
    h = embed_tokens(params, cfg, torch.as_tensor(tokens, device=device))
    for i in range(cfg.num_layers + 1):
        if i > 0:
            h, _ = transformer_layer(layer_slice(params["layers"], i - 1),
                                     cfg, h, rope, None, None)
        # transformers' last hidden state is after the final norm
        h_cmp = apply_norm(h, params["final_norm"], cfg) \
            if i == cfg.num_layers else h
        err = float((h_cmp.float().cpu() - hf_states[i]).abs().max())
        name = "embedding" if i == 0 else f"layer {i - 1}"
        if i == cfg.num_layers:
            name += " (+final norm)"
        print(f"  {name:>22s}: max abs hidden error {err:.3e}", flush=True)


def main(argv=None) -> int:
    """Run the gate; returns the exit code (0 OK, 1 FAIL)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("verify_correctness: no CUDA device (pass "
                           "--device cpu to run on the CPU)")
    # the gate compares true fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hf = hf_model(args)
    cfg, model, params = native_model(args, hf, device)
    rs = np.random.RandomState(0)
    max_errs = []
    for it in range(args.iters):
        data = rs.randint(
            0, min(cfg.padded_vocab_size, hf.config.vocab_size),
            (args.batch_size, args.seq_length + 1))
        tokens, labels = data[:, :-1], data[:, 1:]
        with torch.no_grad():
            out = hf(torch.as_tensor(tokens)).logits
            ref_loss = torch.nn.functional.cross_entropy(
                out.reshape(-1, out.shape[-1]),
                torch.as_tensor(labels).reshape(-1)).item()
            t = torch.as_tensor(tokens, device=device)
            ours = model.forward(params, t)[0].float().cpu()[
                ..., : out.shape[-1]]
            our_loss = float(model.loss(
                params, t, torch.as_tensor(labels, device=device)))
        abs_err = (ours - out).abs()
        max_err, avg_err = float(abs_err.max()), float(abs_err.mean())
        max_errs.append(max_err)
        if args.dump_layer_errors and it == 0:
            dump_layer_errors(hf, cfg, params, tokens, device)
        print(f"iteration {it}: max abs logit error {max_err:.3e} | "
              f"avg abs logit error {avg_err:.3e} | "
              f"our loss {our_loss:.6f} | hf loss {ref_loss:.6f} | "
              f"loss delta {abs(our_loss - ref_loss):.3e}", flush=True)
    avg_max = float(np.mean(max_errs))
    ok = avg_max <= args.tolerance
    print(f"avg max-abs logit error over {args.iters} iters: {avg_max:.3e} "
          f"({'OK' if ok else 'FAIL'}, tolerance {args.tolerance})",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
