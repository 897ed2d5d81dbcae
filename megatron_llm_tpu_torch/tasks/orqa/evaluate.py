"""ORQA retriever evaluation (port of tasks/orqa/evaluate.py): embed the
evidence with the biencoder's context tower (or load a prebuilt store),
embed the questions with the query tower, exact MIPS on the model's
device (data/realm_index.MIPSIndex), and the top-k answer-containment
hit rates.

Texts are embedded a fixed batch shape at a time: the last batch is
padded with empty strings, as in the JAX package, so that every row
sees the same batch shape.

Under data parallelism (tasks/main.py under torchrun) each dp rank
embeds its contiguous share of the evidence, its tp rank 0 writes the
share to the store's per-rank shard (data/realm_index.py, the JAX
store's own layout), rank 0 merges the shards once all are written, and
every rank searches the merged store; the store's row ids are evidence
positions.
"""

from __future__ import annotations

import csv
import os
import shutil
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from megatron_llm_tpu_torch.tasks.orqa.nq import (
    read_nq_file,
    tokenize_queries,
)
from megatron_llm_tpu_torch.tasks.orqa.qa_utils import calculate_matches


def read_evidence_tsv(path: str) -> List[Tuple[object, str, str]]:
    """The DPR psgs_w100.tsv format: `id \\t text \\t title` with a header
    row; ids stay strings."""
    docs = []
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        for i, row in enumerate(reader):
            if i == 0 and row and row[0] == "id":
                continue
            if len(row) < 3:
                continue
            docs.append((row[0], row[1], row[2]))
    return docs


@torch.no_grad()
def embed_batch(model, tower_params, tokenizer, texts: List[str],
                seq_length: int, batch_size: int) -> np.ndarray:
    """(len(texts), d) fp32 embeddings of `texts` by one tower, `batch_size`
    rows a call (the tail padded with empty strings)."""
    out = []
    for i in range(0, len(texts), batch_size):
        chunk = texts[i:i + batch_size]
        toks, mask, _ = tokenize_queries(
            tokenizer, chunk + [""] * (batch_size - len(chunk)), seq_length)
        emb = model.embed_text(
            tower_params, torch.from_numpy(toks).to(model.device),
            torch.from_numpy(mask).to(model.device))
        out.append(emb.float().cpu().numpy()[: len(chunk)])
    return np.concatenate(out, axis=0)


class ORQAEvaluator:
    """Evidence index, retrieval and top-k accuracy (JAX :45-149)."""

    def __init__(self, model, params, tokenizer, seq_length: int = 64,
                 batch_size: int = 32):
        self.model = model  # BiEncoderModel
        self.params = params
        self.tokenizer = tokenizer
        self.seq_length = seq_length
        self.batch_size = batch_size
        self.evidence_ids: Optional[list] = None
        self.evidence_emb: Optional[np.ndarray] = None
        self.index = None
        self.all_docs: dict = {}

    def _tower(self, name):
        p = self.params
        return p["shared"] if "shared" in p else p[name]

    def _embed_texts(self, texts: List[str], tower: str) -> np.ndarray:
        return embed_batch(self.model, self._tower(tower), self.tokenizer,
                           texts, self.seq_length, self.batch_size)

    def _set_evidence(self, docs, emb: np.ndarray):
        from megatron_llm_tpu_torch.data.realm_index import MIPSIndex

        self.evidence_ids = [d[0] for d in docs]
        self.all_docs = {d[0]: (d[1], d[2]) for d in docs}
        self.evidence_emb = emb
        # index rows are evidence-list positions, mapped back to ids on
        # return; the matrix goes to the model's device once
        self.index = MIPSIndex(emb.shape[1], device=self.model.device)
        self.index.add_rows(np.arange(len(docs)), emb)
        return emb

    def build_index(self, docs: List[Tuple[object, str, str]]):
        """Embed the evidence texts with the CONTEXT tower; `docs` =
        [(doc_id, text, title)]. Under data parallelism each dp rank
        embeds its share into the store's shards (module doc)."""
        from megatron_llm_tpu_torch.parallel.mesh import get_context

        ctx = get_context()
        if ctx is None or ctx.dp == 1:
            return self._set_evidence(
                docs, self._embed_texts([d[1] for d in docs], "context"))
        return self._set_evidence(docs, self._sharded_embeddings(docs, ctx))

    def _sharded_embeddings(self, docs, ctx) -> np.ndarray:
        """Every doc's context embedding in `docs` order, each dp rank
        embedding rows [r n / dp, (r + 1) n / dp) into its store shard,
        merged by rank 0 in a directory rank 0 made."""
        import torch.distributed as dist

        from megatron_llm_tpu_torch.data.realm_index import (
            OpenRetrievalDataStore,
        )
        from megatron_llm_tpu_torch.parallel.mesh import barrier

        where = [tempfile.mkdtemp(prefix="evidence_store_")
                 if ctx.rank == 0 else None]
        dist.broadcast_object_list(where, src=0, group=ctx.world_group)
        path = os.path.join(where[0], "evidence")
        n, r = len(docs), ctx.dp_rank
        lo, hi = r * n // ctx.dp, (r + 1) * n // ctx.dp
        emb = self._embed_texts([d[1] for d in docs[lo:hi]], "context") \
            if hi > lo else None
        if ctx.tp_rank == 0 and emb is not None:
            store = OpenRetrievalDataStore(path, load_from_path=False,
                                           rank=r)
            store.add_block_data(np.arange(lo, hi), emb)
            store.save_shard()
        barrier(ctx)
        if ctx.rank == 0:
            OpenRetrievalDataStore(path, load_from_path=False,
                                   rank=0).merge_shards_and_save()
        barrier(ctx)
        merged = OpenRetrievalDataStore(path, rank=r).embed_data
        barrier(ctx)
        if ctx.rank == 0:
            shutil.rmtree(where[0])
        return np.stack([merged[i] for i in range(n)]).astype(np.float32)

    def load_index(self, docs: List[Tuple[object, str, str]],
                   embedding_path: str):
        """The evidence's embeddings from a prebuilt store
        (tools/build_retrieval_index.py) instead of embedding it."""
        from megatron_llm_tpu_torch.data.realm_index import (
            OpenRetrievalDataStore,
        )

        store = OpenRetrievalDataStore(embedding_path)
        if not store.embed_data:
            raise FileNotFoundError(
                f"no embedding store at {store.embedding_path}: build it "
                "with tools/build_retrieval_index.py")
        return self._set_evidence(docs, np.stack(
            [store.embed_data[int(d[0])] for d in docs]).astype(np.float32))

    def retrieve(self, questions: List[str], topk: int = 20):
        """[(evidence ids, scores)] a question: its top-k by inner product
        over the index."""
        if self.index is None:
            raise RuntimeError("call build_index or load_index first")
        q = self._embed_texts(questions, "query")
        scores, pos = self.index.search_mips_index(q, topk)
        return [
            ([self.evidence_ids[j] for j in pos[i]], list(scores[i]))
            for i in range(len(questions))
        ]

    def evaluate(self, qa_file: str, split: str = "DEV", topk: int = 20,
                 match_type: str = "string"):
        """Prints and returns the top-k hit rates, and the match stats."""
        data = read_nq_file(qa_file)
        questions = [q for q, _ in data]
        answers = [a for _, a in data]
        closest = self.retrieve(questions, topk)
        stats = calculate_matches(self.all_docs, answers, closest,
                                  match_type)
        n = len(questions)
        rates = [hits / n for hits in stats.top_k_hits]
        for k in (1, 5, 20, 100):
            if k <= len(rates):
                print(f"{split} top-{k} accuracy: {rates[k-1]:.4f}",
                      flush=True)
        return rates, stats
