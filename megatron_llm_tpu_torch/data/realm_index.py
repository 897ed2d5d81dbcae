"""The retrieval embedding store and exact MIPS index (port of
data/realm_index.py).

- `OpenRetrievalDataStore`: row id -> embedding, written as per-rank
  `.npz` shards (ids and an embedding matrix) and merged by
  concatenation into one `.npz` store: the JAX package's layout, so each
  package reads the other's store.
- `MIPSIndex`: exact maximum-inner-product search. The (N, d) matrix is
  copied to the index's device once; a search runs over it a chunk of
  rows at a time, each chunk `torch.matmul` plus `torch.topk`, with a
  running top-k merge, so the (Q, N) score matrix never materialises.
  TF32 stays off for the products, so that the ids follow the fp32
  scores.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Dict, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.analysis.contracts import (
    CompileContract,
    register_contract,
)

# JAX :32-38: the chunk scorer; here `torch.matmul` + `torch.topk`, no
# executable per shape, so nothing records into it. The search hands its
# top k to the host as numpy after the last chunk: the one host read the
# contract allows (the JAX scorer returns device arrays)
register_contract(CompileContract(
    "realm.chunk_topk", max_variants=4, collectives={"single": frozenset()},
    tmp_bytes_budget=1 << 20, allow_host_callbacks=True,
    notes="the exact MIPS search's chunk scorer"))


class OpenRetrievalDataStore:
    """row_id -> embedding store with rank-sharded writes (JAX :68-152)."""

    def __init__(self, embedding_path: str, load_from_path: bool = True,
                 rank: Optional[int] = None):
        # np.savez appends ".npz" to extension-less paths; normalize here
        # so save and load always agree on one file name
        if not embedding_path.endswith(".npz"):
            embedding_path += ".npz"
        self.embedding_path = os.path.abspath(embedding_path)
        if rank is None:
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
        self.rank = rank
        self.embed_data: Dict[int, np.ndarray] = {}
        if load_from_path and os.path.exists(self.embedding_path):
            self.load_from_file()

    def state(self) -> dict:
        return {"embed_data": self.embed_data}

    def clear(self):
        """Free the embedding data."""
        self.embed_data = {}

    def load_from_file(self):
        with np.load(self.embedding_path) as z:
            ids, embeds = z["ids"], z["embeds"]
        self.embed_data = {int(i): e for i, e in zip(ids, embeds)}
        print(f"> loaded {len(self.embed_data)} embeddings from "
              f"{self.embedding_path}", flush=True)

    def add_block_data(self, row_ids, block_embeds,
                       allow_overwrite: bool = False):
        """Add (n,) ids and their (n, d) embeddings."""
        row_ids = np.atleast_1d(np.asarray(row_ids))
        block_embeds = np.atleast_2d(np.asarray(block_embeds, np.float32))
        for rid, emb in zip(row_ids, block_embeds):
            rid = int(rid)
            if not allow_overwrite and rid in self.embed_data:
                raise ValueError(f"duplicate row id {rid}")
            self.embed_data[rid] = emb

    def _shard_path(self, rank: int) -> str:
        return f"{self.embedding_path}.shard{rank}.npz"

    def save_shard(self):
        """Write this process's shard."""
        os.makedirs(os.path.dirname(self.embedding_path) or ".",
                    exist_ok=True)
        ids = np.asarray(sorted(self.embed_data), np.int64)
        embeds = np.stack([self.embed_data[int(i)] for i in ids]) \
            if len(ids) else np.zeros((0, 0), np.float32)
        np.savez(self._shard_path(self.rank), ids=ids, embeds=embeds)

    def merge_shards_and_save(self):
        """Concatenate every shard into the final store and remove the
        shards. Call from one process after every shard is written."""
        ids_all, emb_all = [], []
        shards = sorted(glob.glob(f"{self.embedding_path}.shard*.npz"))
        for path in shards:
            with np.load(path) as z:
                if z["ids"].size:
                    ids_all.append(z["ids"])
                    emb_all.append(z["embeds"])
        ids = np.concatenate(ids_all) if ids_all else np.zeros(0, np.int64)
        if len(set(ids.tolist())) != len(ids):
            raise ValueError("duplicate row ids across shards")
        embeds = np.concatenate(emb_all) if emb_all else \
            np.zeros((0, 0), np.float32)
        np.savez(self.embedding_path, ids=ids, embeds=embeds)
        for path in shards:
            os.remove(path)
        print(f"> merged {len(shards)} shards -> {len(ids)} embeddings at "
              f"{self.embedding_path}", flush=True)


@contextlib.contextmanager
def fp32_products():
    """Matmuls of fp32 tensors in full fp32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MIPSIndex:
    """Exact maximum-inner-product search over an (N, d) fp32 matrix held
    on `device` (JAX :155-234)."""

    def __init__(self, embed_size: int, embed_data=None,
                 chunk_rows: int = 1 << 20, device="cuda"):
        self.embed_size = embed_size
        self.chunk_rows = chunk_rows
        self.device = torch.device(device)
        self.reset_index()
        if embed_data is not None:
            self.add_embed_data(embed_data)

    def reset_index(self):
        self.ids = np.zeros(0, np.int64)
        self.embeds = torch.zeros((0, self.embed_size), dtype=torch.float32,
                                  device=self.device)

    def add_embed_data(self, all_embed_data):
        """Add an OpenRetrievalDataStore, its state() dict, or a row_id ->
        embedding dict, in row id order."""
        if isinstance(all_embed_data, OpenRetrievalDataStore):
            data = all_embed_data.embed_data
        elif isinstance(all_embed_data, dict) and "embed_data" in all_embed_data:
            data = all_embed_data["embed_data"]
        else:
            data = all_embed_data
        if not data:
            return
        ids = np.asarray(sorted(data), np.int64)
        self.add_rows(ids, np.stack([np.asarray(data[int(i)], np.float32)
                                     for i in ids]))

    def add_rows(self, ids, embeds):
        """Add (n,) ids and their (n, d) fp32 embeddings (numpy or a
        tensor), copied to the index's device once."""
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        if embeds.shape[1] != self.embed_size:
            raise ValueError(f"embeddings of width {embeds.shape[1]}, the "
                             f"index's is {self.embed_size}")
        self.ids = np.concatenate([self.ids, np.asarray(ids, np.int64)])
        self.embeds = embeds if not len(self.embeds) else \
            torch.cat([self.embeds, embeds])

    def __len__(self):
        return len(self.ids)

    @torch.no_grad()
    def search_mips_index(self, query_embeds, top_k: int,
                          reconstruct: bool = False):
        """(Q, d) queries -> (scores (Q, k), ids (Q, k)) as numpy, or
        (scores, embeddings (Q, k, d)) when `reconstruct`. Each chunk's
        top min(k, chunk_rows) joins the running top k. A chunk of fewer
        rows than that is padded with -inf scores (ids clamped to the
        last row), so that a pad never outranks a real row, however
        negative its score."""
        q = torch.as_tensor(np.asarray(query_embeds, np.float32)).to(
            self.device)
        n = self.embeds.shape[0]
        k = min(top_k, n)
        kk = min(k, self.chunk_rows)
        best_s = torch.full((q.shape[0], 0), -torch.inf, device=self.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=self.device)
        with fp32_products():
            for lo in range(0, n, self.chunk_rows):
                s = q @ self.embeds[lo:lo + self.chunk_rows].T
                n_valid = s.shape[1]
                if n_valid < kk:  # the tail chunk
                    s = torch.cat([s, s.new_full((s.shape[0], kk - n_valid),
                                                 -torch.inf)], dim=1)
                s, i = torch.topk(s, kk, dim=1)
                i = torch.clamp(i + lo, max=n - 1)
                s = torch.cat([best_s, s], dim=1)
                best_s, order = torch.topk(s, min(k, s.shape[1]), dim=1)
                best_i = torch.gather(torch.cat([best_i, i], dim=1), 1,
                                      order)
        best_s = best_s.cpu().numpy()
        if reconstruct:
            return best_s, self.embeds[best_i].cpu().numpy()
        return best_s, self.ids[best_i.cpu().numpy()]
