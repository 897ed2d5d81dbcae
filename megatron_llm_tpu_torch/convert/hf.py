"""HuggingFace <-> native weight converters, Llama/CodeLlama and Falcon
(port of megatron_llm_tpu/convert/hf.py).

The functions take torch tensors or numpy arrays and compute in torch on
the host (bf16 included, which numpy has no type for). The native tree
is the port's parameter tree: the leaf names and layouts of
`convert/from_jax.params_from_jax`.

Layout facts (models/attention.py, models/transformer.py):

- native fused wqkv is (h, qkv_size), input-major; its output columns
  are the grouped layout [group g: q_g0..q_g{qpk-1}, k_g, v_g], the
  transpose of a torch Linear weight of (qkv_size, h).
- native RoPE rotates interleaved pairs (Meta's convention); HF Llama
  and Falcon checkpoints use the half-split ("rotate_half") convention,
  so each q and k head's rows are permuted: HF [r0..r_{d/2-1},
  i0..i_{d/2-1}] <-> interleaved [r0, i0, r1, i1, ...]. v is never
  permuted.
- native GLU w1 is (h, 2, ffn) with index 0 = gate, 1 = up.
- vocabulary padding: a native table may be padded past the HF
  vocabulary (cfg.padded_vocab_size); the extra rows are zero-filled on
  import and sliced off on export.

Import streams: each HF tensor is read once (from a lazy mapping such as
`convert/safetensors_io.LazySafetensorsDict`), upcast to fp32, permuted
and written into its slot of a preallocated stacked leaf of `dtype`, so
host memory holds the output and at most one layer of fp32 scratch.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def as_tensor(x) -> torch.Tensor:
    """A torch view of a tensor or numpy array (a copy only for a
    read-only array)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def fp32(x) -> torch.Tensor:
    return as_tensor(x).to(torch.float32)


class Stacked:
    """Leaves of shape (L, ...) allocated at their first layer and filled
    layer by layer: `put(name, i, x)` casts x into `out[name][i]`."""

    def __init__(self, num_layers: int, dtype: torch.dtype):
        self.num_layers, self.dtype, self.out = num_layers, dtype, {}

    def put(self, name: str, i: int, x: torch.Tensor) -> None:
        if name not in self.out:
            self.out[name] = torch.empty((self.num_layers, *x.shape),
                                         dtype=self.dtype)
        self.out[name][i].copy_(x)


# ---------------------------------------------------------------------------
# Per-head RoPE-convention permutation
# ---------------------------------------------------------------------------


def permute_rope_rows(w, head_dim: int, revert: bool = False) -> torch.Tensor:
    """Permute the leading (n_heads * head_dim) rows of `w` between the HF
    half-split layout and the interleaved-pair layout, per head.

    revert=False: HF -> interleaved. revert=True: interleaved -> HF."""
    w = as_tensor(w)
    n = w.shape[0] // head_dim
    rest = tuple(w.shape[1:])
    if revert:  # [r0,i0,r1,i1,...] -> [r..., i...]
        out = w.reshape(n, head_dim // 2, 2, *rest).transpose(1, 2)
    else:  # [r..., i...] -> [r0,i0,...]
        out = w.reshape(n, 2, head_dim // 2, *rest).transpose(1, 2)
    return out.reshape(w.shape)


def build_grouped_qkv(wq, wk, wv, head_dim: int, n_heads: int, n_kv: int,
                      permute: bool = True) -> torch.Tensor:
    """Interleave per-group [q*qpk, k, v] along dim 0 (out-major),
    applying the RoPE permute to the q and k heads. Inputs are torch
    Linear weights (out, in)."""
    qpk = n_heads // n_kv
    wq, wk, wv = as_tensor(wq), as_tensor(wk), as_tensor(wv)
    if permute:
        wq = permute_rope_rows(wq, head_dim)
        wk = permute_rope_rows(wk, head_dim)
    q = wq.reshape(n_kv, qpk, head_dim, -1)
    k = wk.reshape(n_kv, 1, head_dim, -1)
    v = wv.reshape(n_kv, 1, head_dim, -1)
    grouped = torch.cat([q, k, v], dim=1)  # (n_kv, qpk + 2, d, in)
    return grouped.reshape(n_kv * (qpk + 2) * head_dim, -1)


def split_grouped_qkv(qkv, head_dim: int, n_heads: int, n_kv: int,
                      permute: bool = True):
    """Inverse of build_grouped_qkv: (wq, wk, wv)."""
    qpk = n_heads // n_kv
    grouped = as_tensor(qkv).reshape(n_kv, qpk + 2, head_dim, -1)
    wq = grouped[:, :qpk].reshape(n_heads * head_dim, -1)
    wk = grouped[:, qpk].reshape(n_kv * head_dim, -1)
    wv = grouped[:, qpk + 1].reshape(n_kv * head_dim, -1)
    if permute:
        wq = permute_rope_rows(wq, head_dim, revert=True)
        wk = permute_rope_rows(wk, head_dim, revert=True)
    return wq, wk, wv


def pad_rows(w, rows: int, dtype: torch.dtype) -> torch.Tensor:
    """`w` in `dtype` with zero rows appended up to `rows`."""
    w = as_tensor(w)
    assert w.shape[0] <= rows, (tuple(w.shape), rows)
    out = torch.zeros((rows, *w.shape[1:]), dtype=dtype)
    out[:w.shape[0]].copy_(w)
    return out


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------


def hf_llama_to_native(sd: Mapping, cfg, dtype=torch.float32) -> dict:
    """transformers LlamaForCausalLM state dict -> native params. `sd`
    maps HF names to tensors or arrays (out, in): a dict or a lazy
    mapping that loads each tensor on access."""
    L, d = cfg.num_layers, cfg.head_dim
    n, n_kv = cfg.num_attention_heads, cfg.num_query_groups

    def get(name):
        return fp32(sd[name])

    st = Stacked(L, dtype)
    for i in range(L):
        p = f"model.layers.{i}"
        qkv = build_grouped_qkv(get(f"{p}.self_attn.q_proj.weight"),
                                get(f"{p}.self_attn.k_proj.weight"),
                                get(f"{p}.self_attn.v_proj.weight"),
                                d, n, n_kv)
        st.put("wqkv", i, qkv.T)  # (h, qkv_size)
        st.put("wo", i, get(f"{p}.self_attn.o_proj.weight").T)
        gate = get(f"{p}.mlp.gate_proj.weight").T  # (h, ffn)
        up = get(f"{p}.mlp.up_proj.weight").T
        st.put("w1", i, torch.stack([gate, up], dim=1))  # (h, 2, ffn)
        st.put("w2", i, get(f"{p}.mlp.down_proj.weight").T)
        st.put("in_n", i, get(f"{p}.input_layernorm.weight"))
        st.put("post_n", i, get(f"{p}.post_attention_layernorm.weight"))
    o = st.out
    V = cfg.padded_vocab_size
    return {
        "embedding": {"word_embeddings": pad_rows(
            get("model.embed_tokens.weight"), V, dtype)},
        "layers": {
            "input_norm": {"scale": o["in_n"]},
            "attention": {"wqkv": o["wqkv"], "wo": o["wo"]},
            "mlp": {"w1": o["w1"], "w2": o["w2"]},
            "post_attention_norm": {"scale": o["post_n"]},
        },
        "final_norm": {"scale": get("model.norm.weight").to(dtype)},
        "lm_head": pad_rows(get("lm_head.weight"), V, dtype).T.contiguous(),
    }


def native_to_hf_llama(params: Mapping, cfg, vocab_size: int = None,
                       dtype=torch.float32) -> StateDict:
    """native params -> transformers LlamaForCausalLM state dict in
    `dtype` (the JAX package's is fp32), on the params' device."""
    L, d = cfg.num_layers, cfg.head_dim
    n, n_kv = cfg.num_attention_heads, cfg.num_query_groups
    V = vocab_size or cfg.padded_vocab_size

    def cast(x):
        return as_tensor(x).to(dtype)

    layers = params["layers"]
    sd: StateDict = {
        "model.embed_tokens.weight":
            cast(params["embedding"]["word_embeddings"])[:V],
        "model.norm.weight": cast(params["final_norm"]["scale"]),
        "lm_head.weight": cast(params["lm_head"]).T[:V],
    }
    for i in range(L):
        p = f"model.layers.{i}"
        wq, wk, wv = split_grouped_qkv(
            cast(layers["attention"]["wqkv"][i]).T, d, n, n_kv)
        sd[f"{p}.self_attn.q_proj.weight"] = wq
        sd[f"{p}.self_attn.k_proj.weight"] = wk
        sd[f"{p}.self_attn.v_proj.weight"] = wv
        sd[f"{p}.self_attn.o_proj.weight"] = \
            cast(layers["attention"]["wo"][i]).T
        w1 = cast(layers["mlp"]["w1"][i])  # (h, 2, ffn)
        sd[f"{p}.mlp.gate_proj.weight"] = w1[:, 0].T
        sd[f"{p}.mlp.up_proj.weight"] = w1[:, 1].T
        sd[f"{p}.mlp.down_proj.weight"] = cast(layers["mlp"]["w2"][i]).T
        sd[f"{p}.input_layernorm.weight"] = \
            cast(layers["input_norm"]["scale"][i])
        sd[f"{p}.post_attention_layernorm.weight"] = \
            cast(layers["post_attention_norm"]["scale"][i])
    return sd


# ---------------------------------------------------------------------------
# Falcon
# ---------------------------------------------------------------------------


def hf_falcon_to_native(sd: Mapping, cfg, dtype=torch.float32) -> dict:
    """transformers FalconForCausalLM state dict -> native params. HF
    Falcon already stores qkv fused in the grouped layout ([g: q*qpk, k,
    v] under new_decoder_architecture; [q..., k, v], one group, under
    multi_query): only the per-head RoPE permute is needed."""
    L = cfg.num_layers

    def get(name):
        return fp32(sd[name])

    st = Stacked(L, dtype)
    for i in range(L):
        p = f"transformer.h.{i}"
        qkv = _permute_falcon_qkv(
            get(f"{p}.self_attention.query_key_value.weight"), cfg)
        st.put("wqkv", i, qkv.T)
        st.put("wo", i, get(f"{p}.self_attention.dense.weight").T)
        st.put("w1", i, get(f"{p}.mlp.dense_h_to_4h.weight").T)
        st.put("w2", i, get(f"{p}.mlp.dense_4h_to_h.weight").T)
        # Falcon-40B: ln_attn and ln_mlp; 7B: one input_layernorm
        attn_ln = "ln_attn" if cfg.parallel_layernorm else "input_layernorm"
        st.put("in_w", i, get(f"{p}.{attn_ln}.weight"))
        st.put("in_b", i, get(f"{p}.{attn_ln}.bias"))
        if cfg.parallel_layernorm:
            st.put("mlp_w", i, get(f"{p}.ln_mlp.weight"))
            st.put("mlp_b", i, get(f"{p}.ln_mlp.bias"))
    o = st.out
    layers = {
        "input_norm": {"scale": o["in_w"], "bias": o["in_b"]},
        "attention": {"wqkv": o["wqkv"], "wo": o["wo"]},
        "mlp": {"w1": o["w1"], "w2": o["w2"]},
    }
    if cfg.parallel_layernorm:
        layers["mlp_norm"] = {"scale": o["mlp_w"], "bias": o["mlp_b"]}
    return {
        "embedding": {"word_embeddings": pad_rows(
            get("transformer.word_embeddings.weight"),
            cfg.padded_vocab_size, dtype)},
        "layers": layers,
        "final_norm": {"scale": get("transformer.ln_f.weight").to(dtype),
                       "bias": get("transformer.ln_f.bias").to(dtype)},
    }


def native_to_hf_falcon(params: Mapping, cfg, vocab_size: int = None,
                        dtype=torch.float32) -> StateDict:
    """native params -> transformers FalconForCausalLM state dict in
    `dtype`; "lm_head.weight" is the embedding (tied)."""
    L = cfg.num_layers
    V = vocab_size or cfg.padded_vocab_size

    def cast(x):
        return as_tensor(x).to(dtype)

    layers = params["layers"]
    emb = cast(params["embedding"]["word_embeddings"])[:V]
    sd: StateDict = {
        "transformer.word_embeddings.weight": emb,
        "lm_head.weight": emb,
        "transformer.ln_f.weight": cast(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": cast(params["final_norm"]["bias"]),
    }
    for i in range(L):
        p = f"transformer.h.{i}"
        qkv = cast(layers["attention"]["wqkv"][i]).T
        sd[f"{p}.self_attention.query_key_value.weight"] = \
            _permute_falcon_qkv(qkv, cfg, revert=True)
        sd[f"{p}.self_attention.dense.weight"] = \
            cast(layers["attention"]["wo"][i]).T
        sd[f"{p}.mlp.dense_h_to_4h.weight"] = cast(layers["mlp"]["w1"][i]).T
        sd[f"{p}.mlp.dense_4h_to_h.weight"] = cast(layers["mlp"]["w2"][i]).T
        attn_ln = "ln_attn" if cfg.parallel_layernorm else "input_layernorm"
        sd[f"{p}.{attn_ln}.weight"] = cast(layers["input_norm"]["scale"][i])
        sd[f"{p}.{attn_ln}.bias"] = cast(layers["input_norm"]["bias"][i])
        if cfg.parallel_layernorm:
            sd[f"{p}.ln_mlp.weight"] = cast(layers["mlp_norm"]["scale"][i])
            sd[f"{p}.ln_mlp.bias"] = cast(layers["mlp_norm"]["bias"][i])
    return sd


def _permute_falcon_qkv(qkv, cfg, revert: bool = False) -> torch.Tensor:
    """RoPE-permute each q and k head inside a fused grouped qkv weight,
    leaving v untouched."""
    d, qpk, n_kv = cfg.head_dim, cfg.q_per_kv, cfg.num_query_groups
    qkv = as_tensor(qkv)
    grouped = qkv.reshape(n_kv, qpk + 2, d, -1)
    qk = grouped[:, :qpk + 1].reshape(n_kv * (qpk + 1) * d, -1)
    qk = permute_rope_rows(qk, d, revert=revert).reshape(n_kv, qpk + 1, d, -1)
    out = torch.cat([qk, grouped[:, qpk + 1:]], dim=1)
    return out.reshape(qkv.shape)
