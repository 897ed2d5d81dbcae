"""Pretrain BERT: masked LM plus sentence-order prediction (port of the
root pretrain_bert.py).

    python -m megatron_llm_tpu_torch.pretrain_bert --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 512 \\
        --micro_batch_size 4 --global_batch_size 8 --bf16 \\
        --data_path corpus_text_document \\
        --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt \\
        --train_iters 1000 --save ckpt

The JAX entry's flags (`arguments.py` plus `--masked_lm_prob` /
`--mask_prob`, `--short_seq_prob` and `--no_binary_head`): a sentence-
split corpus (`tools/preprocess_data.py --split_sentences`), split by
document ranges into BertDatasets, loaded as dict batches
(`build_pretraining_data_loader(..., keys=BERT_KEYS)`) and turned into
`BertModel.loss` keywords by `get_batch`, the trainer's batch builder.
It runs on the first CUDA card; `main(argv, device="cpu")` runs on the
CPU (the tests do).

Under torchrun it trains at tensor, sequence and data parallelism with
the ZeRO-1 optimizer, one process per rank on `cuda:{LOCAL_RANK %
device_count}` (finetune.py's layout flags; JAX :95-98 initialises the
same dp x tp layout):

    torchrun --nproc_per_node 4 -m megatron_llm_tpu_torch.pretrain_bert \
        ... --tensor_model_parallel_size 2 --sequence_parallel \
        --use_distributed_optimizer [--distributed_backend gloo]

A rank loads its rows of every global microbatch of micro_batch_size x
dp samples (JAX :113-130), and a save at world size > 1 writes per-rank
files. Pipeline and context parallelism are refused with the JAX
entry's messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.arguments import args_to_configs, build_base_parser
from megatron_llm_tpu_torch.models import BertModel
from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    initialize_parallel,
    maybe_initialize_distributed,
    rank_device,
)
from megatron_llm_tpu_torch.parallel.sharding import check_tp
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

BERT_KEYS = ["text", "types", "labels", "is_random", "loss_mask",
             "padding_mask"]

def get_batch(raw: dict) -> dict:
    """The loader's dict -> `BertModel.loss` keywords (JAX :29-39): the
    -1 label filler becomes 0, which the loss mask leaves out."""
    return {
        "tokens": raw["text"],
        "labels": np.maximum(np.asarray(raw["labels"]), 0),
        "loss_mask": np.asarray(raw["loss_mask"], np.float32),
        "attention_mask": raw["padding_mask"],
        "tokentype_ids": raw["types"],
        "sop_labels": raw["is_random"],
    }


# the JAX entries' refusals (pretrain_bert.py :88-94, pretrain_t5.py
# :94-100, pretrain_ict.py :84-88, tasks/main.py :101-104)
PP_REFUSAL = {"encoder": "encoder pretraining: pp>1 not supported "
                         "(GPT-only pipeline)",
              "encoder-decoder": "encoder-decoder pretraining: pp>1 not "
                                 "supported"}
CP_REFUSAL = "--context_parallel_size: ring attention is causal-only; {}"


def check_encoder_layout(
        pcfg, family: str = "encoder",
        what: str = "encoder pretraining doesn't support cp") -> None:
    """The encoder family's layouts: pipeline and context parallelism
    refused with the JAX entries' messages (`family` "encoder" or
    "encoder-decoder" names the pp message, `what` ends the cp one);
    tensor, sequence and data parallelism run."""
    if pcfg.pipeline_parallel_size != 1:
        raise ValueError(PP_REFUSAL[family])
    if pcfg.context_parallel_size != 1:
        raise ValueError(CP_REFUSAL.format(what))


def initialize_encoder_parallel(args, mcfg, pcfg, device) -> None:
    """Install the dp x tp context (JAX :95-98: `initialize_parallel(dp,
    pp=1, tp, sequence_parallel)`) when there is a process group (joined
    before the configs are built, `maybe_initialize_distributed`, so that
    dp defaults to the ranks over tp) or the layout needs one; one rank
    without a group runs no collective. The caller ends with
    `destroy_parallel`."""
    check_tp(mcfg, pcfg.tensor_parallel_size)
    if dist.is_initialized() or pcfg.world_size > 1:
        initialize_parallel(
            dp=pcfg.data_parallel_size, pp=1,
            tp=pcfg.tensor_parallel_size,
            sequence_parallel=pcfg.sequence_parallel,
            backend=args.distributed_backend, device=device)


def entry_configs(entry, argv, device, model_name, add_args, fix=None,
                  extra_ids=False, family="encoder",
                  what="encoder pretraining doesn't support cp"):
    """The start the encoder family's entries share (this one,
    pretrain_t5, pretrain_ict): refuse a missing card, parse `argv` with
    the base flags and `add_args(parser)`'s, refuse the GPT-family data
    paths, build the tokenizer (with --vocab_extra_ids when `extra_ids`;
    the vocabulary padded for tp) and the `model_name` configs, apply
    `fix(args, mcfg) -> mcfg`, read --use_checkpoint_args, refuse pp and
    cp (`check_encoder_layout(pcfg, family, what)`) and install the
    layout. Returns (args, tokenizer, mcfg, pcfg, tcfg, dargs, this
    rank's device); the caller ends with `destroy_parallel`."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry}: no CUDA device (call "
                           f"main(argv, device='cpu') to train on the CPU)")
    p = build_base_parser()
    add_args(p)
    args = p.parse_args(argv)
    if args.train_data_path or args.valid_data_path or args.test_data_path:
        raise SystemExit(
            "--train_data_path/--valid_data_path/--test_data_path are "
            "GPT-family knobs; this entry point uses --data_path + --split")
    # torchrun's group first: dp defaults to the ranks over tp
    device = rank_device(device)
    maybe_initialize_distributed(args.distributed_backend, device)
    tokenizer = build_tokenizer(
        args.tokenizer_type or "BertWordPieceLowerCase",
        vocab_file=args.vocab_file,
        make_vocab_size_divisible_by=args.make_vocab_size_divisible_by,
        tensor_parallel_size=args.tensor_model_parallel_size,
        vocab_extra_ids=args.vocab_extra_ids if extra_ids else 0)
    args.model_name = model_name
    mcfg, pcfg, tcfg, dargs = args_to_configs(args, tokenizer.vocab_size)
    if fix is not None:
        mcfg = fix(args, mcfg)
    if args.use_checkpoint_args and args.load:
        from megatron_llm_tpu_torch.training.checkpointing import (
            load_model_config_from_checkpoint,
        )

        mcfg = load_model_config_from_checkpoint(args.load, mcfg)
    check_encoder_layout(pcfg, family, what)
    initialize_encoder_parallel(args, mcfg, pcfg, device)
    return args, tokenizer, mcfg, pcfg, tcfg, dargs, device


def train_entry(model, tcfg, pcfg, batch_builder, keys, train_ds,
                valid_ds=None):
    """Train `model` on dict batches of `keys` from `train_ds` (and
    `valid_ds` for evaluation when given), this rank's rows of each
    global microbatch, save under --save and return the final
    `TrainState`."""
    from megatron_llm_tpu_torch.data.data_samplers import (
        build_pretraining_data_loader,
    )
    from megatron_llm_tpu_torch.parallel.multihost import process_row_range
    from megatron_llm_tpu_torch.training.trainer import Trainer

    trainer = Trainer(model, tcfg, pcfg, batch_builder=batch_builder)
    state = trainer.setup()
    # a dp rank loads its rows of each global microbatch (JAX :113-130)
    rows = process_row_range(trainer.ctx, tcfg.micro_batch_size
                             * pcfg.data_parallel_size)
    trainer.train_data_iterator = build_pretraining_data_loader(
        train_ds, state.consumed_train_samples, tcfg.micro_batch_size,
        pcfg.data_parallel_size, trainer.num_microbatches_calc.get,
        keys=keys, row_range=rows)
    if valid_ds is not None:
        trainer.valid_data_iterator = build_pretraining_data_loader(
            valid_ds, 0, tcfg.micro_batch_size, pcfg.data_parallel_size, 1,
            keys=keys, row_range=rows)
    state = trainer.train(state)
    if tcfg.save:
        trainer._save(state, blocking=True)
    return state


def main(argv=None, device="cuda"):
    """Parse `argv` (sys.argv when None), build the tokenizer, configs,
    model and datasets, train and, with --save, save; returns the final
    `TrainState`."""
    from megatron_llm_tpu_torch.data.dataset_utils import (
        build_train_valid_test_datasets,
    )

    def add_args(p):
        # --mask_prob is the reference spelling
        p.add_argument("--masked_lm_prob", "--mask_prob", type=float,
                       default=0.15)
        p.add_argument("--short_seq_prob", type=float, default=0.1)
        p.add_argument("--no_binary_head", action="store_true")

    args, tokenizer, mcfg, pcfg, tcfg, dargs, device = entry_configs(
        "pretrain_bert", argv, device, "bert", add_args,
        fix=lambda args, mcfg: dataclasses.replace(
            mcfg, add_binary_head=not args.no_binary_head))
    try:
        model = BertModel(mcfg, device=device)
        num_samples = (tcfg.train_iters or 0) * tcfg.global_batch_size
        train_ds, valid_ds, _ = build_train_valid_test_datasets(
            dargs.data_path, dargs.split,
            [num_samples, tcfg.eval_iters * tcfg.global_batch_size, 0],
            mcfg.seq_length, args.masked_lm_prob, args.short_seq_prob,
            tcfg.seed, tokenizer, dataset_type="standard_bert",
            binary_head=not args.no_binary_head)
        return train_entry(model, tcfg, pcfg, get_batch, BERT_KEYS,
                           train_ds, valid_ds)
    finally:
        destroy_parallel()


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
