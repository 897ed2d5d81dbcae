"""Pretrain the ICT biencoder (port of the root pretrain_ict.py).

    python -m megatron_llm_tpu_torch.pretrain_ict --num_layers 12 \\
        --hidden_size 768 --num_attention_heads 12 --seq_length 256 \\
        --micro_batch_size 32 --global_batch_size 32 --bf16 \\
        --data_path corpus_text_document --titles_data_path titles_document \\
        --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt \\
        --train_iters 1000 --save ckpt

The inverse-cloze retrieval loss: each pseudo-query's positive is its
own evidence block, the batch's other blocks its negatives. The JAX
entry's flags (`arguments.py` plus `--titles_data_path`,
`--query_in_block_prob`, `--use_one_sent_docs`,
`--biencoder_projection_dim` and
`--biencoder_shared_query_context_model`): a sentence-split corpus of
evidence blocks and a titles corpus of one item a document (`tools/
preprocess_data.py` with and without `--split_sentences`), read by one
ICTDataset over the whole corpus (no validation split, as in the JAX
entry), loaded as dict batches (`keys=ICT_KEYS`) and turned into
`BiEncoderModel.loss` keywords by `get_batch`. The towers are BERT's
preset without the binary head. It runs on the first CUDA card;
`main(argv, device="cpu")` runs on the CPU (the tests do).

Under torchrun it trains at tensor, sequence and data parallelism with
ZeRO-1, as pretrain_bert does (`pretrain_bert.entry_configs`, JAX
:89-92): under dp each query's softmax runs over the global batch's
contexts (models/biencoder.py). The dataset's draws depend on the order
samples are read, so every rank reads each whole global microbatch and
keeps its rows (data/data_samplers.py). Pipeline and context
parallelism are refused with the JAX entry's messages.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel
from megatron_llm_tpu_torch.parallel.mesh import destroy_parallel
from megatron_llm_tpu_torch.pretrain_bert import entry_configs, train_entry

ICT_KEYS = ["query_tokens", "query_pad_mask", "context_tokens",
            "context_pad_mask"]


def get_batch(raw: dict) -> dict:
    """The loader's dict -> `BiEncoderModel.loss` keywords (JAX
    :28-36)."""
    return {
        "query_tokens": raw["query_tokens"],
        "query_mask": raw["query_pad_mask"],
        "context_tokens": raw["context_tokens"],
        "context_mask": raw["context_pad_mask"],
    }


def main(argv=None, device="cuda"):
    """Parse `argv` (sys.argv when None), build the tokenizer, configs,
    model and dataset, train and, with --save, save; returns the final
    `TrainState`."""
    from megatron_llm_tpu_torch.data.ict_dataset import ICTDataset
    from megatron_llm_tpu_torch.data.indexed_dataset import make_dataset

    def add_args(p):
        p.add_argument("--titles_data_path", type=str, required=True)
        p.add_argument("--query_in_block_prob", type=float, default=0.1)
        p.add_argument("--use_one_sent_docs", action="store_true")
        p.add_argument("--biencoder_projection_dim", type=int, default=0)
        p.add_argument("--biencoder_shared_query_context_model",
                       action="store_true")

    # BERT towers without the binary head
    args, tokenizer, mcfg, pcfg, tcfg, dargs, device = entry_configs(
        "pretrain_ict", argv, device, "bert", add_args,
        fix=lambda args, mcfg: dataclasses.replace(mcfg,
                                                   add_binary_head=False))
    try:
        model = BiEncoderModel(
            mcfg, projection_dim=args.biencoder_projection_dim,
            shared_query_context_model=(
                args.biencoder_shared_query_context_model),
            device=device)
        data_prefix = dargs.data_path if isinstance(dargs.data_path, str) \
            else dargs.data_path[0]
        train_ds = ICTDataset(
            name="train", block_dataset=make_dataset(data_prefix, "mmap"),
            title_dataset=make_dataset(args.titles_data_path, "mmap"),
            data_prefix=data_prefix, num_epochs=None,
            max_num_samples=(tcfg.train_iters or 0)
            * tcfg.global_batch_size,
            max_seq_length=mcfg.seq_length,
            query_in_block_prob=args.query_in_block_prob, seed=tcfg.seed,
            tokenizer=tokenizer, use_one_sent_docs=args.use_one_sent_docs)
        return train_entry(model, tcfg, pcfg, get_batch, ICT_KEYS, train_ds)
    finally:
        destroy_parallel()


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
