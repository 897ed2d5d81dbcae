from megatron_llm_tpu_torch.models.bert import BertModel
from megatron_llm_tpu_torch.models.classification import (
    Classification,
    MultipleChoice,
)
from megatron_llm_tpu_torch.models.falcon import FalconModel
from megatron_llm_tpu_torch.models.gpt import GPTModel
from megatron_llm_tpu_torch.models.llama import LlamaModel
from megatron_llm_tpu_torch.models.t5 import T5Model

__all__ = ["BertModel", "Classification", "FalconModel", "GPTModel",
           "LlamaModel", "MultipleChoice", "T5Model"]
