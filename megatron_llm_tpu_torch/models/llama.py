"""Llama 1/2 + CodeLlama (port of models/llama.py)."""

from __future__ import annotations

from megatron_llm_tpu_torch.models.gpt import GPTModel


class LlamaModel(GPTModel):
    """Asserts the Llama architectural invariants."""

    def _check_config(self):
        cfg = self.cfg
        assert cfg.position_embedding_type == "rotary", "llama requires RoPE"
        assert cfg.glu_activation == "swiglu", "llama requires SwiGLU"
        assert cfg.use_rms_norm, "llama requires RMSNorm"
        assert not cfg.use_bias, "llama uses no bias"
        assert not cfg.tie_embed_logits, "llama has untied embeddings"
        assert not cfg.parallel_attn, "llama is sequential"
