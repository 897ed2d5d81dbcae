"""Pretrain T5 on span corruption (port of the root pretrain_t5.py).

    python -m megatron_llm_tpu_torch.pretrain_t5 --num_layers 12 \\
        --hidden_size 768 --num_attention_heads 12 --kv_channels 64 \\
        --ffn_hidden_size 3072 --seq_length 512 --decoder_seq_length 128 \\
        --micro_batch_size 16 --global_batch_size 16 --bf16 \\
        --data_path corpus_text_document --vocab_extra_ids 100 \\
        --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt \\
        --train_iters 1000 --save ckpt

The JAX entry's flags (`arguments.py` plus `--masked_lm_prob` /
`--mask_prob`, `--short_seq_prob` and `--decoder_seq_length`;
`--vocab_extra_ids` defaults to 100, the sentinel tokens): a sentence-
split corpus (`tools/preprocess_data.py --split_sentences`), split by
document ranges into T5Datasets, loaded as dict batches
(`build_pretraining_data_loader(..., keys=T5_KEYS)`) and turned into
`T5Model.loss` keywords by `get_batch`, the trainer's batch builder.
It runs on the first CUDA card; `main(argv, device="cpu")` runs on the
CPU (the tests do).

Under torchrun it trains at tensor, sequence and data parallelism with
ZeRO-1, as pretrain_bert does (`pretrain_bert.entry_configs`, JAX
:101-104); pipeline and context parallelism are refused with the JAX
entry's messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

from megatron_llm_tpu_torch.models import T5Model
from megatron_llm_tpu_torch.parallel.mesh import destroy_parallel
from megatron_llm_tpu_torch.pretrain_bert import entry_configs, train_entry

T5_KEYS = ["text_enc", "text_dec", "labels", "loss_mask", "enc_mask",
           "dec_mask"]


def get_batch(raw: dict) -> dict:
    """The loader's dict -> `T5Model.loss` keywords (JAX :28-38): the -1
    label filler becomes 0, which the loss mask leaves out."""
    return {
        "encoder_input_ids": raw["text_enc"],
        "decoder_input_ids": raw["text_dec"],
        "lm_labels": np.maximum(np.asarray(raw["labels"]), 0),
        "loss_mask": np.asarray(raw["loss_mask"], np.float32),
        "encoder_attn_mask": raw["enc_mask"],
        "decoder_attn_mask": raw["dec_mask"],
    }


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
        p.add_argument("--decoder_seq_length", type=int, default=128)
        # span corruption needs sentinel tokens
        p.set_defaults(vocab_extra_ids=100)

    args, tokenizer, mcfg, pcfg, tcfg, dargs, device = entry_configs(
        "pretrain_t5", argv, device, "t5", add_args,
        fix=lambda args, mcfg: dataclasses.replace(
            mcfg, max_position_embeddings=max(mcfg.seq_length,
                                              args.decoder_seq_length)),
        extra_ids=True, family="encoder-decoder",
        what="encoder-decoder pretraining doesn't support cp")
    try:
        model = T5Model(mcfg, device=device)
        num_samples = (tcfg.train_iters or 0) * tcfg.global_batch_size
        train_ds, valid_ds, _ = build_train_valid_test_datasets(
            dargs.data_path, dargs.split,
            [num_samples, tcfg.eval_iters * tcfg.global_batch_size, 0],
            mcfg.seq_length, args.masked_lm_prob, args.short_seq_prob,
            tcfg.seed, tokenizer, dataset_type="t5",
            max_seq_length_dec=args.decoder_seq_length)
        return train_entry(model, tcfg, pcfg, get_batch, T5_KEYS, train_ds,
                           valid_ds)
    finally:
        destroy_parallel()


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
