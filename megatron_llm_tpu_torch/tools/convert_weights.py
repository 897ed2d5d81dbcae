"""Convert weights between HuggingFace, reference-Megatron and native
checkpoints (port of tools/convert_weights.py).

    # HF Llama directory -> native "release" checkpoint
    python -m megatron_llm_tpu_torch.tools.convert_weights --model llama \\
        --direction hf2native --input hf-llama --output native-ckpt

    # native checkpoint (a release or a trained one) -> HF directory
    python -m megatron_llm_tpu_torch.tools.convert_weights --model llama \\
        --direction native2hf --input native-ckpt --output hf-out

The same flags as the JAX package's tool. Everything runs on the host
in torch: no GPU, and neither `safetensors` nor `transformers` (the
port reads and writes safetensors and config.json itself); only an HF
directory with `.bin` weights and no safetensors needs `transformers`.
hf2native reads one HF tensor at a time into preallocated stacked
leaves of `--dtype`. native2hf writes float32, as the JAX tool does, in
sharded safetensors with an index, beside the config.json transformers
reads.
"""

from __future__ import annotations

import argparse
import os

import torch

from megatron_llm_tpu_torch.config import (
    falcon_config,
    gpt_config,
    llama_config,
)
from megatron_llm_tpu_torch.convert import hf as hf_conv
from megatron_llm_tpu_torch.convert import megatron_torch as mt
from megatron_llm_tpu_torch.convert import safetensors_io as st
from megatron_llm_tpu_torch.training.checkpointing import (
    load_model_config_from_checkpoint,
    read_leaves,
    save_checkpoint,
    tracked_checkpoint,
    unflatten,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _model_cfg_from_hf(model: str, hf_cfg, dtype):
    """The native config of an HF config (JAX :32-78)."""
    dt = DTYPES[dtype]
    if model == "llama":
        return llama_config(
            7,  # the size key is irrelevant: every field is overridden
            num_layers=hf_cfg.num_hidden_layers,
            hidden_size=hf_cfg.hidden_size,
            num_attention_heads=hf_cfg.num_attention_heads,
            num_attention_heads_kv=getattr(hf_cfg, "num_key_value_heads",
                                           hf_cfg.num_attention_heads),
            ffn_hidden_size=hf_cfg.intermediate_size,
            seq_length=hf_cfg.max_position_embeddings,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            vocab_size=hf_cfg.vocab_size,
            padded_vocab_size=hf_cfg.vocab_size,
            rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
            layernorm_epsilon=hf_cfg.rms_norm_eps,
            params_dtype=dt,
        )
    if model == "falcon":
        n_kv = (hf_cfg.num_kv_heads
                if getattr(hf_cfg, "new_decoder_architecture", False)
                else (1 if getattr(hf_cfg, "multi_query", True)
                      else hf_cfg.num_attention_heads))
        return falcon_config(
            7,
            num_layers=hf_cfg.num_hidden_layers,
            hidden_size=hf_cfg.hidden_size,
            num_attention_heads=hf_cfg.num_attention_heads,
            num_attention_heads_kv=n_kv,
            ffn_hidden_size=4 * hf_cfg.hidden_size,
            seq_length=2048,
            vocab_size=hf_cfg.vocab_size,
            padded_vocab_size=hf_cfg.vocab_size,
            parallel_layernorm=getattr(hf_cfg, "new_decoder_architecture",
                                       False),
            params_dtype=dt,
        )
    raise ValueError(model)


def _bin_state_dict(hf_dir: str) -> dict:
    """An HF directory without safetensors: a full load through
    `transformers`, which the port does not otherwise need."""
    try:
        from transformers import AutoModelForCausalLM
    except ImportError as e:
        raise ImportError(
            f"{hf_dir} has no *.safetensors: reading its .bin weights "
            f"needs the transformers package, which is not installed "
            f"(convert the directory to safetensors first)") from e
    hf = AutoModelForCausalLM.from_pretrained(hf_dir,
                                              torch_dtype=torch.float32)
    return {k: v.detach() for k, v in hf.state_dict().items()}


def hf2native(args) -> str:
    hf_cfg = st.read_hf_config(args.input)
    cfg = _model_cfg_from_hf(args.model, hf_cfg, args.dtype)
    print(f"reading HF {args.model} safetensors from {args.input} ...",
          flush=True)
    try:
        sd = st.LazySafetensorsDict(args.input)
    except FileNotFoundError:
        sd = _bin_state_dict(args.input)
    convert = (hf_conv.hf_llama_to_native if args.model == "llama"
               else hf_conv.hf_falcon_to_native)
    params = convert(sd, cfg, dtype=DTYPES[args.dtype])
    path = save_checkpoint(args.output, 0, params, model_cfg=cfg,
                           release=True,
                           extra_meta={"source": f"hf:{args.input}"})
    print(f"wrote native release checkpoint to {path}", flush=True)
    return path


def _native_leaves(load_dir: str):
    """(nested params as saved, meta) of the checkpoint the tracker
    names, in their saved dtype: a whole-tensor file memory mapped, or
    per-rank pieces reassembled (training/checkpointing.py
    `read_leaves`)."""
    path, meta = tracked_checkpoint(load_dir)
    return unflatten(read_leaves(path, "model")), meta


def native2hf(args) -> str:
    params, meta = _native_leaves(args.input)
    saved = meta["config"]
    common = {k: saved[k] for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "num_attention_heads_kv", "ffn_hidden_size", "seq_length",
        "max_position_embeddings", "padded_vocab_size", "rope_theta",
        "layernorm_epsilon")}
    if args.model == "llama":
        cfg = llama_config(7, vocab_size=saved["padded_vocab_size"], **common)
    else:
        cfg = falcon_config(7, vocab_size=saved["padded_vocab_size"],
                            parallel_layernorm=saved["parallel_layernorm"],
                            **common)
    vocab = args.true_vocab_size or saved["padded_vocab_size"]
    if args.model == "llama":
        sd = hf_conv.native_to_hf_llama(params, cfg, vocab_size=vocab)
        fields = st.llama_hf_config(cfg, vocab, torch.float32)
    else:
        sd = hf_conv.native_to_hf_falcon(params, cfg, vocab_size=vocab)
        del sd["lm_head.weight"]  # tied: HF stores the embedding once
        fields = st.falcon_hf_config(cfg, vocab, torch.float32)
    st.write_hf_config(args.output, fields)
    n = st.save_sharded(sd, args.output)
    print(f"wrote HF checkpoint to {args.output} ({n} bytes)", flush=True)
    return args.output


def megatron2native(args) -> str:
    """Reference-Megatron checkpoint directory -> native release."""
    lm, ref_args, version = mt.load_reference_checkpoint(args.input)
    assert ref_args is not None, (
        "the reference checkpoint has no saved args; pass a "
        "weights2megatron- or training-written checkpoint")
    cfg = mt.config_from_reference_args(ref_args, language_model=lm)
    params = mt.reference_to_native(lm, cfg, dtype=DTYPES[args.dtype],
                                    checkpoint_version=version)
    path = save_checkpoint(args.output, 0, params, model_cfg=cfg,
                           release=True,
                           extra_meta={"source": f"megatron:{args.input}"})
    print(f"wrote native release checkpoint to {path}", flush=True)
    return path


def native2megatron(args) -> str:
    """Native checkpoint -> reference-Megatron layout."""
    params, meta = _native_leaves(args.input)
    cfg = load_model_config_from_checkpoint(args.input, gpt_config(
        num_layers=1, hidden_size=64, num_attention_heads=1, seq_length=64))
    lm = mt.native_to_reference(params, cfg)
    ref_args = mt.reference_args_for_cfg(cfg)
    # scalars that are not architecture (seq_length, ...) come from the
    # checkpoint's meta, not from the placeholder config
    saved = meta.get("config", {})
    for k in ref_args:
        if k in saved and isinstance(saved[k],
                                     (int, float, bool, str, type(None))):
            ref_args[k] = saved[k]
    out = mt.save_reference_checkpoint(args.output, lm, ref_args)
    print(f"wrote reference-megatron checkpoint to {out}", flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=["llama", "falcon", "gpt"],
                   required=True)
    p.add_argument("--direction", required=True,
                   choices=["hf2native", "native2hf", "megatron2native",
                            "native2megatron"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--true_vocab_size", type=int, default=None,
                   help="unpadded vocab for native2hf (ref: "
                        "checkpoint_util --true_vocab_size)")
    return p


def main(argv=None) -> str:
    """Run one conversion; returns the path written."""
    args = build_parser().parse_args(argv)
    args.input = os.path.abspath(args.input)
    args.output = os.path.abspath(args.output)
    if args.model == "gpt" and args.direction in ("hf2native", "native2hf"):
        raise SystemExit(
            "--model gpt: only the megatron2native/native2megatron "
            "directions exist (there is no canonical HF GPT layout for "
            "this architecture; use llama or falcon for HF interop)")
    return {"hf2native": hf2native, "native2hf": native2hf,
            "megatron2native": megatron2native,
            "native2megatron": native2megatron}[args.direction](args)


if __name__ == "__main__":
    main()
