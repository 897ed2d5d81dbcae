"""Zero-shot GPT evaluation, WikiText-103 perplexity and LAMBADA accuracy
(port of tasks/zeroshot/evaluate.py): the evaluation set is fixed-shape
arrays, and one step per batch computes the masked loss sum ("loss") or
the count of fully correct cloze samples ("accuracy"). The forward has
no attention mask, so under `--use_flash_attn` its attention is the flash
kernel (K4)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from megatron_llm_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)


def metric_for_task(task: str) -> str:
    if task == "LAMBADA":
        return "accuracy"
    if task == "WIKITEXT103":
        return "loss"
    raise NotImplementedError(f"{task} task is not implemented.")


def make_eval_step(model, eval_metric: str):
    """step(params, tokens (b, s+1), pad_mask (b, s)) -> the batch's
    contribution, a float (JAX :33-56)."""

    @torch.no_grad()
    def step(params, tokens, pad_mask):
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        logits, _ = model.forward(params, inp)
        if eval_metric == "loss":
            losses = vocab_parallel_cross_entropy(logits, labels)
            return float(torch.sum(losses * pad_mask))
        if eval_metric == "accuracy":
            pred = torch.argmax(logits, dim=-1)
            correct = (pred == labels) | (pad_mask == 0.0)
            # a sample counts only if every scored position is right
            sample_ok = torch.all(correct, dim=-1)
            # fully padded filler rows (the batch's pad) score 0
            real = torch.any(pad_mask > 0.0, dim=-1)
            return float(torch.sum((sample_ok & real).float()))
        raise NotImplementedError(eval_metric)

    return step


def evaluate(model, params, data, eval_metric: str,
             micro_batch_size: int = 8, log_interval: int = 100) -> float:
    """The metric's sum over `data` (JAX :59-85): the sample count padded
    to a whole batch with zero-mask rows, so that every step has one
    shape."""
    step = make_eval_step(model, eval_metric)
    n = len(data)
    b = micro_batch_size
    n_pad = (-n) % b
    tokens = np.concatenate(
        [data.tokens, np.zeros((n_pad,) + data.tokens.shape[1:], np.int32)])
    mask = np.concatenate(
        [data.pad_mask, np.zeros((n_pad,) + data.pad_mask.shape[1:],
                                 np.float32)])
    device = model.device
    total = 0.0
    t0 = time.perf_counter()
    for it in range(0, len(tokens), b):
        if (it // b) % log_interval == 0:
            print(f"> working on iteration: {it // b}", flush=True)
        total += step(params,
                      torch.from_numpy(tokens[it:it + b]).to(device),
                      torch.from_numpy(mask[it:it + b]).to(device))
    dt = time.perf_counter() - t0
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

    length = len(string) + 1
    print("-" * length)
    print(string)
    print("-" * length, flush=True)
    return out
