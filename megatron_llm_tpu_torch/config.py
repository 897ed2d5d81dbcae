"""Model configuration (port of megatron_llm_tpu/config.py).

Only the fields the serving paths (whole-batch and the continuous-batching
engine) read are carried over; the presets keep the JAX package's values.
Dtypes are torch dtypes.

Not carried over: dropout (serving is deterministic), `use_flash_attn`
(the port has no flash kernel yet; the no-cache forward takes the grouped
einsum path), `decode_attn_min_cache` (it gated the Pallas decode kernel
off below a cache length because of TPU launch overhead) and
`decode_attn_interpret` (it ran that kernel under the Pallas interpreter).
Here the decode kernel runs on every CUDA single-token step and its plain
version serves CPU tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (JAX: config.py ModelConfig)."""

    num_layers: int = 2
    hidden_size: int = 128
    ffn_hidden_size: Optional[int] = None
    num_attention_heads: int = 4
    num_attention_heads_kv: Optional[int] = None
    kv_channels: Optional[int] = None
    max_position_embeddings: int = 2048
    seq_length: int = 2048
    padded_vocab_size: int = 0
    make_vocab_size_divisible_by: int = 128

    layernorm_epsilon: float = 1e-5
    use_rms_norm: bool = False
    use_bias: bool = True
    glu_activation: Optional[str] = None
    hidden_act: str = "gelu"

    position_embedding_type: str = "absolute"
    rope_scaling_factor: float = 1.0
    rope_theta: float = 10000.0

    tie_embed_logits: bool = True

    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    init_method_std: float = 0.02
    use_scaled_init_method: bool = True

    # Hand-written RMSNorm forward (ops/rmsnorm.py). Off by default, as in
    # the JAX package.
    use_fused_rmsnorm: bool = False
    # Hand-written attention kernels on CUDA tensors: decode attention
    # (ops/decode_attention.py) on every single-token step of the dense
    # KV cache, ragged paged attention (ops/prefill_attention.py) on every
    # paged forward of the engine. Off, the plain versions run.
    use_decode_attn: bool = True

    def __post_init__(self):
        if self.kv_channels is None:
            object.__setattr__(
                self, "kv_channels", self.hidden_size // self.num_attention_heads)
        if self.num_attention_heads_kv is None:
            object.__setattr__(self, "num_attention_heads_kv",
                               self.num_attention_heads)
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        assert self.num_attention_heads % self.num_attention_heads_kv == 0

    @property
    def head_dim(self) -> int:
        return self.kv_channels

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads_kv

    @property
    def q_per_kv(self) -> int:
        return self.num_attention_heads // self.num_attention_heads_kv

    @property
    def qkv_projection_size(self) -> int:
        return self.kv_channels * (
            self.num_attention_heads + 2 * self.num_attention_heads_kv)

    def pad_vocab_size(self, vocab_size: int, tp: int = 1) -> int:
        multiple = self.make_vocab_size_divisible_by * tp
        return ((vocab_size + multiple - 1) // multiple) * multiple


_LLAMA_SIZES = {
    # size -> (layers, hidden, heads, n_kv, ffn)
    7: (32, 4096, 32, 32, 11008),
    13: (40, 5120, 40, 40, 13824),
    30: (60, 6656, 52, 52, 17920),
    34: (48, 8192, 64, 8, 22016),
    65: (80, 8192, 64, 64, 22016),
    70: (80, 8192, 64, 8, 28672),
}


def llama_config(size_b: int = 7, version: int = 2, seq_length: int = 4096,
                 vocab_size: int = 32000, tp: int = 1,
                 **overrides) -> ModelConfig:
    """Llama-1/2/CodeLlama preset (JAX: config.py llama_config)."""
    layers, hidden, heads, n_kv, ffn = _LLAMA_SIZES[size_b]
    if version == 1:
        seq_length = min(seq_length, 2048)
    cfg = dict(
        num_layers=layers,
        hidden_size=hidden,
        num_attention_heads=heads,
        num_attention_heads_kv=n_kv,
        ffn_hidden_size=ffn,
        seq_length=seq_length,
        max_position_embeddings=seq_length,
        position_embedding_type="rotary",
        glu_activation="swiglu",
        use_rms_norm=True,
        use_bias=False,
        tie_embed_logits=False,
        layernorm_epsilon=1e-6 if version == 1 else 1e-5,
        init_method_std=0.02,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


def tiny_config(**overrides) -> ModelConfig:
    """Small config for tests (JAX: config.py tiny_config)."""
    cfg = dict(
        num_layers=2,
        hidden_size=64,
        num_attention_heads=4,
        num_attention_heads_kv=2,
        ffn_hidden_size=128,
        seq_length=64,
        max_position_embeddings=64,
        padded_vocab_size=256,
        position_embedding_type="rotary",
        glu_activation="swiglu",
        use_rms_norm=True,
        use_bias=False,
        tie_embed_logits=False,
    )
    cfg.update(overrides)
    return ModelConfig(**cfg)
