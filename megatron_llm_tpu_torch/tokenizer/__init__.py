from megatron_llm_tpu_torch.tokenizer.tokenizer import (
    AbstractTokenizer,
    build_tokenizer,
)

__all__ = ["AbstractTokenizer", "build_tokenizer"]
