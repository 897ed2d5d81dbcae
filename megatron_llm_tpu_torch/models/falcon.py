"""Falcon 7B/40B (port of models/falcon.py)."""

from __future__ import annotations

from megatron_llm_tpu_torch.models.gpt import GPTModel


class FalconModel(GPTModel):
    """Asserts the Falcon architectural invariants: rotary, MQA/GQA and
    parallel attention; `parallel_layernorm` distinguishes 40B from 7B.
    Post-LN layers belong to BERT (ROADMAP.md A6) and are not a config
    field of the port."""

    def _check_config(self):
        cfg = self.cfg
        assert cfg.position_embedding_type == "rotary", "falcon requires RoPE"
        assert cfg.parallel_attn, "falcon uses parallel attention"
        assert cfg.num_attention_heads_kv < cfg.num_attention_heads, (
            "falcon uses MQA/GQA")
