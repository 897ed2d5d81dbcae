"""MNLI (port of tasks/glue/mnli.py)."""

from __future__ import annotations

from megatron_llm_tpu_torch.tasks.data_utils import clean_text
from megatron_llm_tpu_torch.tasks.glue.data import GLUEAbstractDataset

LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}


class MNLIDataset(GLUEAbstractDataset):

    def __init__(self, name, datapaths, tokenizer, max_seq_length,
                 test_label="contradiction"):
        self.test_label = test_label
        super().__init__("MNLI", name, datapaths, tokenizer, max_seq_length)

    def process_samples_from_single_path(self, filename):
        """TSV: col 0 = uid, 8 = premise, 9 = hypothesis, last = label;
        the 10-column dev-test form carries no label (ref mnli.py:21-76)."""
        samples = []
        first, is_test = True, False
        with open(filename) as f:
            for line in f:
                row = line.strip().split("\t")
                if first:
                    first = False
                    is_test = len(row) == 10
                    continue
                text_a = clean_text(row[8].strip())
                text_b = clean_text(row[9].strip())
                uid = int(row[0].strip())
                label = self.test_label if is_test else row[-1].strip()
                if not (text_a and text_b and label in LABELS
                        and uid >= 0):
                    raise ValueError(f"{filename}: malformed MNLI row "
                                     f"{row[0]!r}")
                samples.append({"text_a": text_a, "text_b": text_b,
                                "label": LABELS[label], "uid": uid})
        return samples
