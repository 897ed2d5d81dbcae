"""RACE multiple choice (port of tasks/race/data.py).

Each question yields NUM_CHOICES samples of [CLS] article [SEP]
question + option [SEP]; the model scores each and the loss softmaxes
over the four (models/classification.MultipleChoice). The inputs are
RACE's .txt JSON files: {"article", "questions", "options",
"answers"}, one file or a directory searched recursively.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from megatron_llm_tpu_torch.tasks.data_utils import (
    build_tokens_types_paddings_from_text,
    clean_text,
)

NUM_CHOICES = 4


class RaceDataset:

    def __init__(self, dataset_name, datapaths, tokenizer, max_seq_length):
        self.dataset_name = dataset_name
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.samples = []
        for path in datapaths:
            self.samples.extend(self._process_path(path))
        print(f" > {dataset_name}: {len(self.samples)} RACE questions",
              flush=True)

    def _process_path(self, path):
        files = ([path] if os.path.isfile(path)
                 else sorted(glob.glob(os.path.join(path, "**", "*.txt"),
                                       recursive=True)))
        samples = []
        for fname in files:
            with open(fname) as f:
                data = json.load(f)
            article = clean_text(data["article"])
            for q, opts, ans in zip(data["questions"], data["options"],
                                    data["answers"]):
                label = ord(ans) - ord("A")
                if not 0 <= label < NUM_CHOICES \
                        or len(opts) != NUM_CHOICES:
                    raise ValueError(f"{fname}: a RACE question needs "
                                     f"{NUM_CHOICES} options and an answer "
                                     f"among them, got {ans!r}, "
                                     f"{len(opts)} options")
                samples.append({
                    "article": article,
                    "texts_b": [clean_text(f"{q} {o}") for o in opts],
                    "label": label,
                    "uid": len(samples),
                })
        return samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        raw = self.samples[idx]
        ids_c, types_c, pad_c = [], [], []
        for text_b in raw["texts_b"]:
            ids, types, paddings = build_tokens_types_paddings_from_text(
                raw["article"], text_b, self.tokenizer, self.max_seq_length
            )
            ids_c.append(ids)
            types_c.append(types)
            pad_c.append(paddings)
        return {
            "text": np.array(ids_c, np.int64),  # (4, s)
            "types": np.array(types_c, np.int64),
            "padding_mask": np.array(pad_c, np.int64),
            "label": int(raw["label"]),
            "uid": int(raw["uid"]),
        }
