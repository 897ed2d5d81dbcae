"""The open-retrieval evidence dataset (port of
data/orqa_wiki_dataset.py): the DPR-format evidence TSV (`id \\t text \\t
title`) as an indexable view whose rows stay text until an embedding
batch is formed (the biencoder's `embed_text` takes the ids the batch's
tokenizer call makes)."""

from __future__ import annotations

import csv
from typing import List, Tuple


class OpenRetrievalEvidenceDataset:
    """{"row_id", "text", "title"} a row of the evidence TSV (JAX
    :19-51)."""

    def __init__(self, datapath: str, name: str = "evidence"):
        self.name = name
        self.samples = self.process_samples_from_single_path(datapath)
        print(f" > loaded {len(self.samples)} evidence rows from "
              f"{datapath}", flush=True)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        row_id, text, title = self.samples[idx]
        return {"row_id": row_id, "text": text, "title": title}

    @staticmethod
    def process_samples_from_single_path(
        filename: str,
    ) -> List[Tuple[int, str, str]]:
        """(id, text, title) rows; the header row is skipped, the ids are
        the file's (1-based, the DPR convention)."""
        rows = []
        with open(filename, encoding="utf-8") as f:
            reader = csv.reader(f, delimiter="\t")
            for i, row in enumerate(reader):
                if i == 0 and row and row[0] in ("id", "﻿id"):
                    continue  # header
                if len(row) < 2:
                    continue
                title = row[2] if len(row) > 2 else ""
                rows.append((int(row[0]), row[1], title))
        return rows
