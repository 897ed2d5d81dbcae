"""The GPT data pipeline (port of megatron_llm_tpu/data, its GPT side):
indexed token files, the GPT dataset with its cached index mappings,
weighted blends, and the pretraining samplers and loader."""

from megatron_llm_tpu_torch.data.blendable_dataset import BlendableDataset
from megatron_llm_tpu_torch.data.data_samplers import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
    build_pretraining_data_loader,
)
from megatron_llm_tpu_torch.data.gpt_dataset import (
    GPTDataset,
    build_train_valid_test_datasets,
)
from megatron_llm_tpu_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    make_dataset,
)

__all__ = [
    "BlendableDataset", "GPTDataset", "MMapIndexedDataset",
    "MMapIndexedDatasetBuilder", "MegatronPretrainingRandomSampler",
    "MegatronPretrainingSampler", "build_pretraining_data_loader",
    "build_train_valid_test_datasets", "make_dataset",
]
