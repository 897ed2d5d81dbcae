"""The GLUE dataset base (port of tasks/glue/data.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from megatron_llm_tpu_torch.tasks.data_utils import (
    build_sample,
    build_tokens_types_paddings_from_text,
)


class GLUEAbstractDataset(ABC):
    """Reads TSVs into {'text_a','text_b','label','uid'} rows; __getitem__
    assembles the padded classification sample."""

    def __init__(self, task_name, dataset_name, datapaths, tokenizer,
                 max_seq_length):
        self.task_name = task_name
        self.dataset_name = dataset_name
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        print(f" > building {task_name} dataset for {dataset_name}:",
              flush=True)
        self.samples = []
        for path in datapaths:
            self.samples.extend(self.process_samples_from_single_path(path))
        print(f"  >> total number of samples: {len(self.samples)}",
              flush=True)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        raw = self.samples[idx]
        ids, types, paddings = build_tokens_types_paddings_from_text(
            raw["text_a"], raw["text_b"], self.tokenizer,
            self.max_seq_length,
        )
        return build_sample(ids, types, paddings, raw["label"], raw["uid"])

    @abstractmethod
    def process_samples_from_single_path(self, datapath):
        """-> list of {'text_a': str, 'text_b': str, 'label': int,
        'uid': int}."""
