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

The encoder trains on one card: pipeline and context parallelism are
refused as the JAX entry refuses them, and tensor, sequence or data
parallelism raise naming ROADMAP.md A6, where the encoder's parallel
layouts are queued.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.arguments import args_to_configs, build_base_parser
from megatron_llm_tpu_torch.models import BertModel
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


def check_single_card(pcfg, what: str) -> None:
    """The encoder family's layouts in this port: pp and cp refused as in
    the JAX package, tp, SP and dp naming their ROADMAP item."""
    if pcfg.pipeline_parallel_size != 1:
        raise ValueError(f"{what}: pipeline_parallel_size > 1 is not "
                         f"supported (the pipeline is GPT-only)")
    if pcfg.context_parallel_size != 1:
        raise ValueError(f"{what}: context parallelism is causal-only; "
                         f"the encoder does not support cp")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if (pcfg.tensor_parallel_size != 1 or pcfg.sequence_parallel
            or pcfg.data_parallel_size != 1 or world != 1):
        raise ValueError(
            f"{what} at tp {pcfg.tensor_parallel_size}, sequence_parallel "
            f"{pcfg.sequence_parallel}, dp {pcfg.data_parallel_size}, "
            f"world size {world}: not ported yet (the encoder's parallel "
            f"layouts, ROADMAP.md A6)")


def entry_configs(entry, what, argv, device, model_name, add_args,
                  fix=None, extra_ids=False):
    """The start the encoder family's entries share (this one,
    pretrain_t5, pretrain_ict): refuse a missing card, parse `argv` with
    the base flags and `add_args(parser)`'s, refuse the GPT-family data
    paths, build the tokenizer (with --vocab_extra_ids when `extra_ids`)
    and the `model_name` configs, apply `fix(args, mcfg) -> mcfg`, read
    --use_checkpoint_args and refuse what `check_single_card` refuses.
    Returns (args, tokenizer, mcfg, pcfg, tcfg, dargs)."""
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
    check_single_card(pcfg, what)
    return args, tokenizer, mcfg, pcfg, tcfg, dargs


def train_entry(model, tcfg, pcfg, batch_builder, keys, train_ds,
                valid_ds=None):
    """Train `model` on dict batches of `keys` from `train_ds` (and
    `valid_ds` for evaluation when given), save under --save and return
    the final `TrainState`."""
    from megatron_llm_tpu_torch.data.data_samplers import (
        build_pretraining_data_loader,
    )
    from megatron_llm_tpu_torch.training.trainer import Trainer

    trainer = Trainer(model, tcfg, pcfg, batch_builder=batch_builder)
    state = trainer.setup()
    trainer.train_data_iterator = build_pretraining_data_loader(
        train_ds, state.consumed_train_samples, tcfg.micro_batch_size,
        pcfg.data_parallel_size, trainer.num_microbatches_calc.get,
        keys=keys)
    if valid_ds is not None:
        trainer.valid_data_iterator = build_pretraining_data_loader(
            valid_ds, 0, tcfg.micro_batch_size, pcfg.data_parallel_size, 1,
            keys=keys)
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

    args, tokenizer, mcfg, pcfg, tcfg, dargs = entry_configs(
        "pretrain_bert", "BERT pretraining", argv, device, "bert", add_args,
        fix=lambda args, mcfg: dataclasses.replace(
            mcfg, add_binary_head=not args.no_binary_head))
    model = BertModel(mcfg, device=device)

    num_samples = (tcfg.train_iters or 0) * tcfg.global_batch_size
    train_ds, valid_ds, _ = build_train_valid_test_datasets(
        dargs.data_path, dargs.split,
        [num_samples, tcfg.eval_iters * tcfg.global_batch_size, 0],
        mcfg.seq_length, args.masked_lm_prob, args.short_seq_prob,
        tcfg.seed, tokenizer, dataset_type="standard_bert",
        binary_head=not args.no_binary_head)
    return train_entry(model, tcfg, pcfg, get_batch, BERT_KEYS, train_ds,
                       valid_ds)


if __name__ == "__main__":
    main()
