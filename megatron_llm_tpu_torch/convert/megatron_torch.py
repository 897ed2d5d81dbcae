"""Reference-Megatron torch checkpoint <-> native converters (port of
megatron_llm_tpu/convert/megatron_torch.py).

The reference's layout: `latest_checkpointed_iteration.txt` and
`<release|iter_%07d>/mp_rank_00/model_optim_rng.pt` holding
{"model": {"language_model": {"embedding", "transformer"[, "lm_head"]}},
"checkpoint_version": 3.0, "args": Namespace, "iteration"}.

Layout facts:
- The reference's fused qkv rows are already the grouped layout
  [group g: q_g0..q_g{qpk-1}, k_g, v_g] x head_dim in the interleaved
  RoPE convention: native wqkv is its transpose.
- GLU dense_h_to_4h packs [up(ffn); gate(ffn)] along dim 0; native w1
  is (h, 2, ffn) with index 0 = gate, 1 = up.
- tp/pp-sharded reference checkpoints (several mp_rank_XX) must be
  merged with the reference's own tools/checkpoint_util.py first.

The functions take torch tensors or numpy arrays and return torch
tensors on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional, Tuple

import torch

from megatron_llm_tpu_torch.convert.hf import Stacked, as_tensor, fp32, pad_rows

# ---------------------------------------------------------------------------
# Pre-2.0 qkv row-order fixups
# ---------------------------------------------------------------------------


def fix_qkv_ordering(w, version: float, n_heads: int, n_kv: int,
                     head_dim: int) -> torch.Tensor:
    """Reorder a fused qkv weight (or bias) saved by checkpoint_version
    < 2.0 into the modern [np, 3, hn] row order. Multi-query checkpoints
    are never reordered."""
    w = as_tensor(w)
    if version >= 2.0 or n_kv != n_heads:
        return w
    rest = tuple(w.shape[1:])
    if version == 0:  # [3, np, hn] -> [np, 3, hn]
        t = w.reshape(3, n_heads, head_dim, *rest)
        return t.transpose(0, 1).reshape(w.shape)
    if version == 1.0:  # [np, hn, 3] -> [np, 3, hn]
        t = w.reshape(n_heads, head_dim, 3, *rest)
        return t.transpose(1, 2).reshape(w.shape)
    raise ValueError(f"invalid checkpoint version {version}")


# ---------------------------------------------------------------------------
# state dict <-> native tree
# ---------------------------------------------------------------------------


def _detect_naming(transformer_keys) -> Tuple[str, str]:
    """The fork writes ("transformer", "attention"); upstream Megatron
    writes ("encoder", "self_attention"). Returns (block key, attention
    key)."""
    for k in transformer_keys:
        if ".self_attention." in k:
            return "encoder", "self_attention"
    return "transformer", "attention"


def reference_to_native(language_model: Mapping, cfg, dtype=torch.float32,
                        checkpoint_version: float = 3.0) -> dict:
    """{"embedding", "transformer"|"encoder"[, "lm_head"]} with reference
    names -> native params, stacked layer by layer into `dtype`."""
    L, d = cfg.num_layers, cfg.head_dim
    n, n_kv = cfg.num_attention_heads, cfg.num_query_groups

    emb_sd = language_model["embedding"]
    trans = (language_model.get("transformer")
             or language_model.get("encoder"))
    _, attn = _detect_naming(trans.keys())

    def get(k):
        return fp32(trans[k])

    def fix(w):
        return fix_qkv_ordering(w, checkpoint_version, n, n_kv, d)

    st = Stacked(L, dtype)
    norms = {"input_norm": "input_layernorm",
             "post_attention_norm": "post_attention_layernorm",
             "mlp_norm": "mlp_layernorm"}
    for i in range(L):
        p = f"layers.{i}"
        st.put("wqkv", i, fix(get(f"{p}.{attn}.query_key_value.weight")).T)
        st.put("wo", i, get(f"{p}.{attn}.dense.weight").T)
        h4 = get(f"{p}.mlp.dense_h_to_4h.weight")  # (2 ffn | ffn, h)
        if cfg.glu_activation:
            up, gate = torch.chunk(h4, 2, dim=0)  # the reference packs [up; gate]
            st.put("w1", i, torch.stack([gate.T, up.T], dim=1))
        else:
            st.put("w1", i, h4.T)
        st.put("w2", i, get(f"{p}.mlp.dense_4h_to_h.weight").T)
        if f"{p}.{attn}.query_key_value.bias" in trans:
            st.put("bqkv", i, fix(get(f"{p}.{attn}.query_key_value.bias")))
            st.put("bo", i, get(f"{p}.{attn}.dense.bias"))
            b4 = get(f"{p}.mlp.dense_h_to_4h.bias")
            if cfg.glu_activation:
                up_b, gate_b = torch.chunk(b4, 2, dim=0)
                st.put("b1", i, torch.stack([gate_b, up_b], dim=0))
            else:
                st.put("b1", i, b4)
            st.put("b2", i, get(f"{p}.mlp.dense_4h_to_h.bias"))
        for group, ref_name in norms.items():
            for leaf, suffix in (("scale", "weight"), ("bias", "bias")):
                key = f"{p}.{ref_name}.{suffix}"
                if key in trans:
                    st.put(f"{group}.{leaf}", i, get(key))

    o = st.out
    attn_tree = {"wqkv": o["wqkv"], "wo": o["wo"]}
    mlp_tree = {"w1": o["w1"], "w2": o["w2"]}
    if "bqkv" in o:
        attn_tree.update(bqkv=o["bqkv"], bo=o["bo"])
        mlp_tree.update(b1=o["b1"], b2=o["b2"])
    layers = {"attention": attn_tree, "mlp": mlp_tree}
    for group in norms:
        for leaf in ("scale", "bias"):
            if f"{group}.{leaf}" in o:
                layers.setdefault(group, {})[leaf] = o[f"{group}.{leaf}"]

    final = {"scale": get("final_layernorm.weight").to(dtype)}
    if "final_layernorm.bias" in trans:
        final["bias"] = get("final_layernorm.bias").to(dtype)
    params = {
        "embedding": {"word_embeddings": pad_rows(
            fp32(emb_sd["word_embeddings.weight"]), cfg.padded_vocab_size,
            dtype)},
        "layers": layers,
        "final_norm": final,
    }
    if "position_embeddings.weight" in emb_sd:
        params["embedding"]["position_embeddings"] = fp32(
            emb_sd["position_embeddings.weight"]).to(dtype)
    if language_model.get("lm_head") is not None:
        params["lm_head"] = pad_rows(
            fp32(language_model["lm_head"]), cfg.padded_vocab_size,
            dtype).T.contiguous()
    return params


def native_to_reference(params: Mapping, cfg) -> dict:
    """native params -> {"embedding", "transformer"[, "lm_head"]} with
    reference names, fp32."""
    L = cfg.num_layers
    layers = params["layers"]
    embedding = {"word_embeddings.weight":
                 fp32(params["embedding"]["word_embeddings"])}
    if "position_embeddings" in params["embedding"]:
        embedding["position_embeddings.weight"] = fp32(
            params["embedding"]["position_embeddings"])
    transformer = {"final_layernorm.weight": fp32(params["final_norm"]["scale"])}
    if "bias" in params["final_norm"]:
        transformer["final_layernorm.bias"] = fp32(params["final_norm"]["bias"])

    def put_norm(group, layer_prefix, ref_name, i):
        if group not in layers:
            return
        transformer[f"{layer_prefix}.{ref_name}.weight"] = fp32(
            layers[group]["scale"][i])
        if "bias" in layers[group]:
            transformer[f"{layer_prefix}.{ref_name}.bias"] = fp32(
                layers[group]["bias"][i])

    for i in range(L):
        p = f"layers.{i}"
        transformer[f"{p}.attention.query_key_value.weight"] = fp32(
            layers["attention"]["wqkv"][i]).T
        transformer[f"{p}.attention.dense.weight"] = fp32(
            layers["attention"]["wo"][i]).T
        w1 = fp32(layers["mlp"]["w1"][i])
        if cfg.glu_activation:  # native (h, 2, ffn), 0=gate 1=up -> [up; gate]
            transformer[f"{p}.mlp.dense_h_to_4h.weight"] = torch.cat(
                [w1[:, 1].T, w1[:, 0].T], dim=0)
        else:
            transformer[f"{p}.mlp.dense_h_to_4h.weight"] = w1.T
        transformer[f"{p}.mlp.dense_4h_to_h.weight"] = fp32(
            layers["mlp"]["w2"][i]).T
        if "bqkv" in layers["attention"]:
            transformer[f"{p}.attention.query_key_value.bias"] = fp32(
                layers["attention"]["bqkv"][i])
            transformer[f"{p}.attention.dense.bias"] = fp32(
                layers["attention"]["bo"][i])
            b1 = fp32(layers["mlp"]["b1"][i])
            transformer[f"{p}.mlp.dense_h_to_4h.bias"] = torch.cat(
                [b1[1], b1[0]], dim=0) if cfg.glu_activation else b1
            transformer[f"{p}.mlp.dense_4h_to_h.bias"] = fp32(
                layers["mlp"]["b2"][i])
        put_norm("input_norm", p, "input_layernorm", i)
        put_norm("post_attention_norm", p, "post_attention_layernorm", i)
        put_norm("mlp_norm", p, "mlp_layernorm", i)

    out = {"embedding": embedding, "transformer": transformer}
    if "lm_head" in params:
        out["lm_head"] = fp32(params["lm_head"]).T
    return out


# ---------------------------------------------------------------------------
# args and the .pt container
# ---------------------------------------------------------------------------


def reference_args_for_cfg(cfg) -> dict:
    """The args Namespace fields the reference's weights2megatron
    records."""
    return {
        "num_layers": cfg.num_layers,
        "hidden_size": cfg.hidden_size,
        "num_attention_heads": cfg.num_attention_heads,
        "num_attention_heads_kv": cfg.num_query_groups,
        "ffn_hidden_size": cfg.ffn_hidden_size,
        "padded_vocab_size": cfg.padded_vocab_size,
        "glu_activation": cfg.glu_activation,
        "use_rms_norm": cfg.use_rms_norm,
        "tie_embed_logits": cfg.tie_embed_logits,
        "parallel_attn": cfg.parallel_attn,
        "parallel_layernorm": cfg.parallel_layernorm,
        "position_embedding_type": cfg.position_embedding_type,
        "max_position_embeddings": cfg.max_position_embeddings,
        "seq_length": cfg.seq_length,
        "layernorm_epsilon": cfg.layernorm_epsilon,
        "rope_theta": cfg.rope_theta,
        "tensor_model_parallel_size": 1,
        "pipeline_model_parallel_size": 1,
    }


def config_from_reference_args(args, language_model=None, **overrides):
    """A ModelConfig from the checkpoint's saved args Namespace. The
    reference's args do not record use_bias; with the state dict given,
    bias presence is read from it (Falcon has LayerNorm without linear
    biases, so `not use_rms_norm` alone would misread it)."""
    from megatron_llm_tpu_torch.config import ModelConfig

    def g(k, default=None):
        return getattr(args, k, default)

    if language_model is not None:
        trans = (language_model.get("transformer")
                 or language_model.get("encoder"))
        use_bias = any(k.endswith(".query_key_value.bias") for k in trans)
    else:
        use_bias = not bool(g("use_rms_norm", False))
    fields = dict(
        num_layers=g("num_layers"),
        hidden_size=g("hidden_size"),
        num_attention_heads=g("num_attention_heads"),
        num_attention_heads_kv=g("num_attention_heads_kv",
                                 g("num_attention_heads")),
        ffn_hidden_size=g("ffn_hidden_size") or 4 * g("hidden_size"),
        padded_vocab_size=g("padded_vocab_size"),
        glu_activation=g("glu_activation"),
        use_rms_norm=bool(g("use_rms_norm", False)),
        tie_embed_logits=bool(g("tie_embed_logits", True)),
        parallel_attn=bool(g("parallel_attn", False)),
        parallel_layernorm=bool(g("parallel_layernorm", False)),
        position_embedding_type=g("position_embedding_type", "rotary"),
        max_position_embeddings=g("max_position_embeddings", 2048),
        seq_length=g("seq_length", 2048),
        layernorm_epsilon=g("layernorm_epsilon", 1e-5),
        rope_theta=g("rope_theta", 10000.0),
        use_bias=use_bias,
    )
    fields.update(overrides)
    return ModelConfig(**fields)


def load_reference_checkpoint(load_dir: str):
    """Read a reference-layout checkpoint directory: (language_model with
    fp32 tensor leaves, args Namespace or None, checkpoint version)."""
    tracker = os.path.join(load_dir, "latest_checkpointed_iteration.txt")
    with open(tracker) as f:
        it = f.read().strip()
    sub = "release" if it == "release" else f"iter_{int(it):07d}"
    ranks = sorted(d for d in os.listdir(os.path.join(load_dir, sub))
                   if d.startswith("mp_rank_"))
    assert len(ranks) == 1, (
        f"tp/pp-sharded reference checkpoint ({len(ranks)} mp_rank dirs): "
        "merge it with the reference's tools/checkpoint_util.py first")
    # the args are an argparse.Namespace: not a weights-only pickle
    blob = torch.load(os.path.join(load_dir, sub, ranks[0],
                                   "model_optim_rng.pt"),
                      map_location="cpu", weights_only=False)
    out = {}
    for part, val in blob["model"]["language_model"].items():
        if isinstance(val, dict):
            out[part] = {k: fp32(v) for k, v in val.items()}
        elif val is not None:
            out[part] = fp32(val)
    return out, blob.get("args"), float(blob.get("checkpoint_version", 3.0))


def save_reference_checkpoint(save_dir: str, language_model: dict,
                              args: dict,
                              iteration: Optional[int] = None) -> str:
    """Write the reference's on-disk layout, fp32; `iteration` None is a
    release. Returns the .pt path."""
    it_name = "release" if iteration is None else f"iter_{iteration:07d}"
    rank_dir = os.path.join(save_dir, it_name, "mp_rank_00")
    os.makedirs(rank_dir, exist_ok=True)
    with open(os.path.join(save_dir,
                           "latest_checkpointed_iteration.txt"), "w") as f:
        f.write("release" if iteration is None else str(iteration))
    lm = {part: ({k: fp32(v).contiguous() for k, v in val.items()}
                 if isinstance(val, dict) else fp32(val).contiguous())
          for part, val in language_model.items()}
    blob = {
        "iteration": "release" if iteration is None else iteration,
        "model": {"language_model": lm},
        "checkpoint_version": 3.0,
        "args": argparse.Namespace(**args),
    }
    path = os.path.join(rank_dir, "model_optim_rng.pt")
    torch.save(blob, path)
    return path
