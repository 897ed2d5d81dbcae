"""Supervised retriever finetuning on Natural Questions, RET-FINETUNE-NQ
(port of tasks/orqa/supervised.py): DPR-format json samples {question,
answers, positive_ctxs[, hard negatives]}; each batch trains the
biencoder with the in-batch softmax (every other sample's positive
context a negative, one hard negative a query appended when asked), and
validation reports the in-batch top-k retrieval accuracy.

The optimizer is the JAX package's `optax.adamw(lr)` at its defaults:
b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled weight
decay 1e-4 on every leaf (not the trainer's AdamW with its decay
masks); `adamw_step` computes that rule leaf by leaf in fp32.

Across ranks (tasks/main.py under torchrun) the batch size is the
global batch and must divide by dp: every rank reads the whole batch
(the hard negatives are drawn in read order) and computes its batch / dp
queries; each query's softmax runs over the global batch's positive and
hard-negative contexts (all-gathered over dp, `gather_from_data_
parallel`, as the JAX loss sees the whole batch), the loss is the
global batch's mean and the gradients are summed over dp once a step.
Under tensor (and sequence) parallelism the towers are BERT's parallel
encoder on this rank's slices; the AdamW rule is elementwise, so each
rank updates its slices.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves, tree_map
from megatron_llm_tpu_torch.parallel.cross_entropy import cross_entropy
from megatron_llm_tpu_torch.parallel.mappings import (
    gather_from_data_parallel,
)
from megatron_llm_tpu_torch.parallel.mesh import all_reduce, get_context

NEG_INF = -1e30
ADAMW_B1, ADAMW_B2, ADAMW_EPS, ADAMW_DECAY = 0.9, 0.999, 1e-8, 1e-4


def read_dpr_json(path: str) -> List[dict]:
    """DPR's retriever-train format, a json array or jsonl."""
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "[":
            return json.load(f)
        return [json.loads(ln) for ln in f if ln.strip()]


def _encode(tokenizer, text: str, title: Optional[str], max_len: int):
    ids = tokenizer.tokenize(text)
    if title is not None:
        ids = tokenizer.tokenize(title) + [tokenizer.sep] + ids
    ids = [tokenizer.cls] + ids[: max_len - 2] + [tokenizer.sep]
    out = np.full((max_len,), tokenizer.pad, np.int32)
    out[: len(ids)] = ids
    mask = np.zeros((max_len,), np.int32)
    mask[: len(ids)] = 1
    return out, mask


class OpenRetrievalDataset:
    """(query, positive context[, hard negative context]) token rows
    (JAX :52-100). A hard negative is drawn from the sample's list by the
    dataset's RandomState(seed), in the order the rows are read."""

    def __init__(self, path: str, tokenizer, max_seq_length: int = 128,
                 use_hard_negatives: bool = False, seed: int = 1234):
        self.samples = read_dpr_json(path)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.use_hard_negatives = use_hard_negatives
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx]
        q_ids, q_mask = _encode(self.tokenizer, s["question"], None,
                                self.max_seq_length)
        pos = s["positive_ctxs"][0]
        c_ids, c_mask = _encode(self.tokenizer, pos["text"],
                                pos.get("title"), self.max_seq_length)
        out = {"query": q_ids, "query_mask": q_mask,
               "context": c_ids, "context_mask": c_mask}
        if self.use_hard_negatives:
            negs = s.get("hard_negative_ctxs") or s.get("negative_ctxs") \
                or []
            if negs:
                neg = negs[int(self.rng.randint(len(negs)))]
                n_ids, n_mask = _encode(self.tokenizer, neg["text"],
                                        neg.get("title"),
                                        self.max_seq_length)
                out["neg_valid"] = np.int32(1)
            else:
                # no negatives for this sample: a PAD row the loss masks
                # out entirely (a duplicated positive would split its
                # softmax mass)
                n_ids = np.full((self.max_seq_length,), self.tokenizer.pad,
                                np.int32)
                n_mask = np.zeros((self.max_seq_length,), np.int32)
                n_mask[0] = 1  # keep one live token for the encoder
                out["neg_valid"] = np.int32(0)
            out["neg_context"] = n_ids
            out["neg_context_mask"] = n_mask
        return out


def host_batch(ds, idxs) -> dict:
    """The stacked numpy rows of `idxs`."""
    rows = [ds[int(i)] for i in idxs]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _embed(model, tower, params, tokens, mask):
    p = params["shared"] if "shared" in params else params[tower]
    return model.embed_text(p, tokens, mask)


def make_loss_fn(model, use_hard_negatives: bool):
    """loss_fn(params, batch of tensors) -> (mean in-batch retrieval CE,
    in-batch top-1), both 0-d fp32; hard negatives append B context
    columns, pad rows masked out by `neg_valid` (JAX :126-160). Under
    data parallelism `batch` holds this rank's queries, the contexts
    are the global batch's and the loss this rank's share of the global
    mean: its queries' sum over the global count (the ranks' losses sum
    to the mean, and so do their gradients)."""

    def loss_fn(params, batch):
        q = _embed(model, "query", params, batch["query"],
                   batch["query_mask"])
        c = gather_from_data_parallel(_embed(
            model, "context", params, batch["context"],
            batch["context_mask"]).float())
        total = c.shape[0]  # the global batch's queries
        ctx = get_context()
        row0 = ctx.dp_rank * q.shape[0] if ctx is not None else 0
        col_mask = None
        if use_hard_negatives and "neg_context" in batch:
            n = gather_from_data_parallel(_embed(
                model, "context", params, batch["neg_context"],
                batch["neg_context_mask"]).float())
            c = torch.cat([c, n], dim=0)  # (2B, d)
            col_mask = torch.cat([
                torch.ones((n.shape[0],), dtype=torch.float32,
                           device=q.device),
                gather_from_data_parallel(batch["neg_valid"].float())])
        scores = q.float() @ c.T
        if col_mask is not None:
            scores = torch.where(col_mask[None, :] > 0, scores,
                                 torch.full_like(scores, NEG_INF))
        targets = row0 + torch.arange(q.shape[0], device=q.device)
        losses = cross_entropy(scores, targets)
        top1 = (torch.argmax(scores, dim=-1) == targets).float().sum()
        return losses.sum() / total, top1 / total

    return loss_fn


def _rank_ctx():
    ctx = get_context()
    return ctx if ctx is not None and ctx.world_size > 1 else None


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


@torch.no_grad()
def in_batch_topk_accuracy(model, params, ds, batch_size: int,
                           ks=(1, 5)) -> dict:
    """The rank of each query's own positive among the batch's contexts
    by fp32 score; the share of queries ranked below each k (JAX
    :163-188)."""
    hits = {k: 0 for k in ks}
    total = 0
    for lo in range(0, len(ds) - batch_size + 1, batch_size):
        batch = to_device(host_batch(ds, range(lo, lo + batch_size)),
                          model.device)
        q = _embed(model, "query", params, batch["query"],
                   batch["query_mask"])
        c = _embed(model, "context", params, batch["context"],
                   batch["context_mask"])
        s = (q.float() @ c.float().T).cpu().numpy()
        order = np.argsort(-s, axis=-1)
        for i in range(s.shape[0]):
            rank = int(np.where(order[i] == i)[0][0])
            for k in ks:
                hits[k] += rank < k
        total += s.shape[0]
    return {k: hits[k] / max(total, 1) for k in ks}


@torch.no_grad()
def adamw_step(params: dict, state: dict, lr: float):
    """One step of optax.adamw(lr) at its defaults on each leaf's `.grad`,
    in place: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, the
    update mu_hat / (sqrt(nu_hat) + eps) + decay * p, scaled by -lr. A
    leaf with no gradient (the towers read no tokentypes) takes a zero
    gradient, as the JAX package's differentiation gives it."""
    state["count"] += 1
    t = np.float32(state["count"])
    bc1 = float(1 - np.float32(ADAMW_B1) ** t)
    bc2 = float(1 - np.float32(ADAMW_B2) ** t)
    for p, m, v in zip(tree_leaves(params), tree_leaves(state["mu"]),
                       tree_leaves(state["nu"])):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        m.mul_(ADAMW_B1).add_((1 - ADAMW_B1) * g)
        v.mul_(ADAMW_B2).add_((1 - ADAMW_B2) * (g * g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + ADAMW_EPS)
        p.add_(-lr * (update + ADAMW_DECAY * p))


def finetune_retriever(model, params, train_ds, valid_ds=None,
                       epochs: int = 2, batch_size: int = 8,
                       lr: float = 2e-5, use_hard_negatives: bool = False,
                       seed: int = 1234, log_interval: int = 10,
                       losses: Optional[list] = None):
    """The epoch loop (JAX :191-235): each epoch a RandomState(seed)
    permutation of the training samples, whole batches only, validation
    after each epoch. Returns the trained params (this rank's slices
    across ranks); `losses`, a list, receives each step's (loss,
    in-batch top-1), the global batch's."""
    from megatron_llm_tpu_torch.parallel.sharding import (
        model_axis,
        param_specs,
        spec_leaves,
    )
    from megatron_llm_tpu_torch.training.train_step import (
        sequence_parallel_grads,
    )

    ctx = _rank_ctx()
    dp, dp_rank = (ctx.dp, ctx.dp_rank) if ctx is not None else (1, 0)
    if batch_size % dp:
        raise ValueError(f"batch size {batch_size} must divide dp={dp}")
    rows = slice(dp_rank * batch_size // dp,
                 (dp_rank + 1) * batch_size // dp)
    loss_fn = make_loss_fn(model, use_hard_negatives)
    params = tree_map(lambda p: p.detach().clone().float()
                      .requires_grad_(True), params)
    tp_sharded = [model_axis(sp) is not None
                  for sp in spec_leaves(param_specs(model.cfg, params))]
    state = {"count": 0,
             "mu": tree_map(torch.zeros_like, params),
             "nu": tree_map(torch.zeros_like, params)}

    rng = np.random.RandomState(seed)
    it = 0
    for epoch in range(epochs):
        order = rng.permutation(len(train_ds))
        for lo in range(0, len(train_ds) - batch_size + 1, batch_size):
            # every rank reads the whole batch: the draws follow reads
            whole = host_batch(train_ds, order[lo:lo + batch_size])
            batch = to_device({k: v[rows] for k, v in whole.items()},
                              model.device)
            for p in tree_leaves(params):
                p.grad = None
            loss, top1 = loss_fn(params, batch)
            loss.backward()
            if ctx is not None:
                for p in tree_leaves(params):
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = sequence_parallel_grads(
                    [p.grad for p in tree_leaves(params)], tp_sharded, ctx)
                for g in grads:
                    all_reduce(g, ctx.dp_group, ctx=ctx)
                stats = all_reduce(torch.stack([loss.detach(),
                                                top1.detach()]),
                                   ctx.dp_group, ctx=ctx)
                loss, top1 = stats[0], stats[1]
            adamw_step(params, state, lr)
            it += 1
            loss, top1 = float(loss.detach()), float(top1)
            if losses is not None:
                losses.append((loss, top1))
            if it % log_interval == 0 and (ctx is None or ctx.rank == 0):
                print(f"epoch {epoch} iter {it}: loss {loss:.4f} in-batch "
                      f"top1 {top1:.3f}", flush=True)
        if valid_ds is not None:
            acc = in_batch_topk_accuracy(model, params, valid_ds,
                                         batch_size)
            print(f"epoch {epoch} validation in-batch accuracy: "
                  + ", ".join(f"top-{k} {v:.4f}" for k, v in acc.items()),
                  flush=True)
    return tree_map(lambda p: p.detach(), params)
