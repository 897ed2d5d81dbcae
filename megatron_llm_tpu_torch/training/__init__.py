"""The training runtime (port of megatron_llm_tpu/training)."""
