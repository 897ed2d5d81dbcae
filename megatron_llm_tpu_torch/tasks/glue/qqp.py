"""QQP (port of tasks/glue/qqp.py)."""

from __future__ import annotations

from megatron_llm_tpu_torch.tasks.data_utils import clean_text
from megatron_llm_tpu_torch.tasks.glue.data import GLUEAbstractDataset

LABELS = [0, 1]


class QQPDataset(GLUEAbstractDataset):

    def __init__(self, name, datapaths, tokenizer, max_seq_length,
                 test_label=0):
        self.test_label = test_label
        super().__init__("QQP", name, datapaths, tokenizer, max_seq_length)

    def process_samples_from_single_path(self, filename):
        """TSV: train rows are (id, qid1, qid2, q1, q2, is_duplicate);
        test rows are (id, q1, q2) with no label (ref qqp.py:21-84)."""
        samples = []
        first, is_test = True, False
        drop = 0
        with open(filename) as f:
            for line in f:
                row = line.strip().split("\t")
                if first:
                    first = False
                    is_test = len(row) == 3
                    continue
                if is_test:
                    if len(row) != 3:
                        drop += 1
                        continue
                    uid, text_a, text_b = (int(row[0]), clean_text(row[1]),
                                           clean_text(row[2]))
                    label = self.test_label
                else:
                    if len(row) != 6:
                        drop += 1
                        continue
                    uid = int(row[0].strip())
                    text_a = clean_text(row[3].strip())
                    text_b = clean_text(row[4].strip())
                    label = int(row[-1].strip())
                if not text_a or not text_b or label not in LABELS:
                    drop += 1
                    continue
                samples.append({"text_a": text_a, "text_b": text_b,
                                "label": label, "uid": uid})
        if drop:
            print(f"  >> dropped {drop} malformed rows", flush=True)
        return samples
