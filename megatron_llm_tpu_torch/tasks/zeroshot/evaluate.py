"""Zero-shot GPT evaluation, WikiText-103 perplexity and LAMBADA accuracy
(port of tasks/zeroshot/evaluate.py): the evaluation set is fixed-shape
arrays, and one step per batch computes the masked loss sum ("loss") or
the count of fully correct cloze samples ("accuracy"). The forward has
no attention mask, so under `--use_flash_attn` its attention is the flash
kernel (K4).

Across ranks (the layouts of the JAX entry's `initialize_parallel(dp,
pp, tp, cp, sequence_parallel)`, one process a rank) every rank runs the
same loop over the same global batches of `micro_batch_size` rows:

- dp: each dp rank takes its rows of the batch, padded with zero-mask
  rows to a multiple of dp, and the step's sum is all-reduced over the
  dp group;
- tp (with or without sequence parallelism): the logits stay
  vocab-parallel; the loss is `vocab_parallel_cross_entropy` over the tp
  group and LAMBADA's argmax a (max, index) reduction over it
  (`vocab_parallel_argmax`, the lowest index winning a tie);
- pp: the pipelined forward of `parallel/pipeline.make_pipelined_score_fn`,
  whose last stage maps its logits to the step's per-position values,
  broadcast from the last stage;
- cp: the sequence padded at its end to a multiple of cp (causal
  attention keeps the pads out of every real position), each cp rank its
  shard at global positions through the ring, the per-position values
  gathered over the cp group.

Every rank returns the same sum; only global rank 0 prints."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from megatron_llm_tpu_torch.models.language_model import (
    language_model_forward,
    lm_logits,
)
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_argmax,
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.parallel.mappings import tp_input
from megatron_llm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce,
    get_context,
)
from megatron_llm_tpu_torch.parallel.pipeline import make_pipelined_score_fn


def metric_for_task(task: str) -> str:
    if task == "LAMBADA":
        return "accuracy"
    if task == "WIKITEXT103":
        return "loss"
    raise NotImplementedError(f"{task} task is not implemented.")


def _layout():
    """The installed context, None at world size 1."""
    ctx = get_context()
    return None if ctx is None or ctx.world_size == 1 else ctx


def is_rank_0() -> bool:
    ctx = _layout()
    return ctx is None or ctx.rank == 0


def _head(eval_metric: str):
    """(vocab-parallel logits (b, s, V / tp), labels (b, s)) -> (b, s)
    fp32: each position's loss, or whether its argmax is its label."""
    if eval_metric == "loss":
        return vocab_parallel_cross_entropy
    if eval_metric == "accuracy":
        return lambda logits, labels: (
            vocab_parallel_argmax(logits) == labels).float()
    raise NotImplementedError(eval_metric)


def _pad_seq(x: torch.Tensor, cp: int) -> torch.Tensor:
    """(b, s) padded with zeros at the end to a multiple of cp."""
    pad = (-x.shape[1]) % cp
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _per_position(model, params, inp, labels, head, ctx) -> torch.Tensor:
    """head's (b, s) values of this rank's rows over the whole sequence,
    the same on every rank of the row's tp, cp and pp groups (`ctx` None
    at world size 1)."""
    s = inp.shape[1]
    cp, cp_rank = (1, 0) if ctx is None else (ctx.cp, ctx.cp_rank)
    x, t = _pad_seq(inp, cp), _pad_seq(labels, cp)
    if ctx is not None and ctx.pp > 1:
        return make_pipelined_score_fn(model, None, ctx, head=head)(
            params, x[None], t[None])[0][:, :s]
    n = x.shape[1] // cp
    sl = slice(cp_rank * n, (cp_rank + 1) * n)
    pos = None
    if cp > 1:
        pos = torch.arange(sl.start, sl.stop, device=x.device)[None].expand(
            x.shape[0], n)
    hidden, _ = language_model_forward(params, model.cfg, x[:, sl], pos,
                                       return_hidden=True)
    vals = head(lm_logits(params, model.cfg, tp_input(hidden)), t[:, sl])
    if cp > 1:
        vals = all_gather_rows(vals.float().T.contiguous(), ctx.cp_group,
                               ctx).T
    return vals[:, :s]


def make_eval_step(model, eval_metric: str):
    """step(params, tokens (b, s+1), pad_mask (b, s)) -> the batch's
    contribution, a float (JAX :33-56); across ranks `tokens` and
    `pad_mask` are this dp rank's rows and the contribution is summed
    over the dp group."""
    head = _head(eval_metric)

    @torch.no_grad()
    def step(params, tokens, pad_mask):
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        ctx = _layout()
        vals = _per_position(model, params, inp, labels, head, ctx)
        if eval_metric == "loss":
            out = torch.sum(vals * pad_mask)
        else:
            correct = (vals > 0.5) | (pad_mask == 0.0)
            # a sample counts only if every scored position is right
            sample_ok = torch.all(correct, dim=-1)
            # fully padded filler rows (the batch's pad) score 0
            real = torch.any(pad_mask > 0.0, dim=-1)
            out = torch.sum((sample_ok & real).float())
        if ctx is not None:
            out = all_reduce(out.reshape(1), ctx.dp_group, ctx=ctx)[0]
        return float(out)

    return step


def evaluate(model, params, data, eval_metric: str,
             micro_batch_size: int = 8, log_interval: int = 100) -> float:
    """The metric's sum over `data` (JAX :59-85): the sample count padded
    to a whole batch with zero-mask rows, so that every step has one
    shape; across ranks each batch padded further to a multiple of dp
    and cut into the dp ranks' rows."""
    step = make_eval_step(model, eval_metric)
    n = len(data)
    b = micro_batch_size
    n_pad = (-n) % b
    tokens = np.concatenate(
        [data.tokens, np.zeros((n_pad,) + data.tokens.shape[1:], np.int32)])
    mask = np.concatenate(
        [data.pad_mask, np.zeros((n_pad,) + data.pad_mask.shape[1:],
                                 np.float32)])
    ctx = _layout()
    dp, dp_rank = (1, 0) if ctx is None else (ctx.dp, ctx.dp_rank)
    rows = -(-b // dp)
    device = model.device
    loud = is_rank_0()
    total = 0.0
    t0 = time.perf_counter()
    for it in range(0, len(tokens), b):
        if (it // b) % log_interval == 0 and loud:
            print(f"> working on iteration: {it // b}", flush=True)
        tb, mb = tokens[it:it + b], mask[it:it + b]
        if dp > 1:
            fill = rows * dp - b
            tb = np.concatenate([tb, np.zeros((fill,) + tb.shape[1:],
                                              tb.dtype)])
            mb = np.concatenate([mb, np.zeros((fill,) + mb.shape[1:],
                                              mb.dtype)])
            lo = dp_rank * rows
            tb, mb = tb[lo:lo + rows], mb[lo:lo + rows]
        total += step(params, torch.from_numpy(np.ascontiguousarray(tb))
                      .to(device),
                      torch.from_numpy(np.ascontiguousarray(mb)).to(device))
    dt = time.perf_counter() - t0
    if loud:
        print(f"> evaluated {n} samples in {dt:.1f}s", flush=True)
    return total


def evaluate_and_print_results(task: str, model, params, data,
                               micro_batch_size: int = 8,
                               log_interval: int = 100) -> dict:
    """The JAX package's result lines (JAX :88-123); returns the metrics."""
    eval_metric = metric_for_task(task)
    output = evaluate(model, params, data, eval_metric, micro_batch_size,
                      log_interval)

    string = f" validation results on {task} | "
    if eval_metric == "loss":
        num_tokenized_tokens = data.num_tokenized_tokens
        num_original_tokens = data.num_original_tokens
        val_loss = output / (num_tokenized_tokens - 1)
        ppl = math.exp(min(20, val_loss))
        token_ratio = (num_tokenized_tokens - 1) / (num_original_tokens - 1)
        adjusted_ppl = math.exp(min(20, val_loss * token_ratio))
        out = {"avg_loss": val_loss, "ppl": ppl,
               "adjusted_ppl": adjusted_ppl, "token_ratio": token_ratio}
        string += f"avg loss: {val_loss:.4E} | "
        string += f"ppl: {ppl:.4E} | "
        string += f"adjusted ppl: {adjusted_ppl:.4E} | "
        string += f"token ratio: {token_ratio} |"
    else:
        num_examples = len(data)
        acc = output / num_examples
        out = {"num_correct": output, "num_examples": num_examples,
               "accuracy": acc}
        string += f"number correct: {output:.4E} | "
        string += f"total examples: {num_examples:.4E} | "
        string += f"avg accuracy: {acc:.4E}"

    if is_rank_0():
        length = len(string) + 1
        print("-" * length)
        print(string)
        print("-" * length, flush=True)
    return out
