from megatron_llm_tpu_torch.models.gpt import GPTModel
from megatron_llm_tpu_torch.models.llama import LlamaModel

__all__ = ["GPTModel", "LlamaModel"]
