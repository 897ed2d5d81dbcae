"""Build the open-retrieval evidence embedding store (port of the root
tools/build_retrieval_index.py): embed every evidence block with a
biencoder checkpoint's context tower, store row_id -> embedding in an
`OpenRetrievalDataStore`, and merge the per-process shards.

    python -m megatron_llm_tpu_torch.tools.build_retrieval_index \\
        --evidence_data_path wiki-evidence.tsv \\
        --embedding_path wiki-embeds.npz \\
        --load ckpts/retriever --use_checkpoint_args \\
        --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt \\
        --retriever_seq_length 256 --indexer_batch_size 128

It runs on the first CUDA card; `main(argv, device="cpu")` runs on the
CPU. Under torch.distributed each rank embeds rows `rank::world` and
writes its shard; rank 0 merges after a barrier. The store feeds
`tasks.main --task RETRIEVER-EVAL --embedding_path`; it is the JAX
package's `.npz` layout, so its evaluator reads it too.
"""

from __future__ import annotations

import argparse
import time

import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--evidence_data_path", required=True,
                   help="DPR-format evidence tsv: id \\t text \\t title")
    p.add_argument("--embedding_path", required=True,
                   help="output .npz embedding store")
    p.add_argument("--load", default=None,
                   help="biencoder checkpoint dir (omit for a random "
                        "model: smoke-test mode)")
    p.add_argument("--use_checkpoint_args", action="store_true")
    p.add_argument("--tokenizer_type", default="BertWordPieceLowerCase")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--null_vocab_size", type=int, default=None)
    p.add_argument("--retriever_seq_length", type=int, default=256)
    p.add_argument("--indexer_batch_size", type=int, default=128)
    p.add_argument("--indexer_log_interval", type=int, default=1000)
    p.add_argument("--biencoder_projection_dim", type=int, default=0)
    p.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    # architecture (overridden by --use_checkpoint_args)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    return p


def main(argv=None, device="cuda"):
    """Build the store; returns its path."""
    import torch.distributed as dist

    from megatron_llm_tpu_torch.config import bert_config
    from megatron_llm_tpu_torch.data.orqa_wiki_dataset import (
        OpenRetrievalEvidenceDataset,
    )
    from megatron_llm_tpu_torch.data.realm_index import (
        OpenRetrievalDataStore,
    )
    from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel
    from megatron_llm_tpu_torch.tasks.orqa.evaluate import embed_batch
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_retrieval_index: no CUDA device (call "
                           "main(argv, device='cpu') to run on the CPU)")
    args = build_parser().parse_args(argv)
    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        tokenizer_model=args.tokenizer_model,
        null_vocab_size=args.null_vocab_size)
    cfg = bert_config(
        num_layers=args.num_layers, hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        seq_length=args.retriever_seq_length,
        padded_vocab_size=tokenizer.padded_vocab_size)
    if args.load and args.use_checkpoint_args:
        from megatron_llm_tpu_torch.training.checkpointing import (
            load_model_config_from_checkpoint,
        )

        cfg = load_model_config_from_checkpoint(args.load, cfg)
    model = BiEncoderModel(
        cfg, projection_dim=args.biencoder_projection_dim,
        shared_query_context_model=args.biencoder_shared_query_context_model,
        device=device)
    if args.load:
        from megatron_llm_tpu_torch.training.checkpointing import (
            load_checkpoint,
        )

        restored = load_checkpoint(args.load, model.abstract_params(),
                                   None, None, no_load_optim=True,
                                   device=device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {args.load}")
        params = restored[0]
    else:
        print("WARNING: no --load; indexing with RANDOM weights "
              "(smoke-test mode)", flush=True)
        params = model.init(seed=0)
    tower = params["shared"] if "shared" in params else params["context"]

    dataset = OpenRetrievalEvidenceDataset(args.evidence_data_path)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    my_rows = list(range(rank, len(dataset), world))
    store = OpenRetrievalDataStore(args.embedding_path,
                                   load_from_path=False, rank=rank)

    bs = args.indexer_batch_size
    t0 = time.time()
    for lo in range(0, len(my_rows), bs):
        rows = [dataset[i] for i in my_rows[lo:lo + bs]]
        emb = embed_batch(model, tower, tokenizer, [r["text"] for r in rows],
                          args.retriever_seq_length, bs)
        store.add_block_data([r["row_id"] for r in rows], emb)
        if (lo // bs) % max(args.indexer_log_interval, 1) == 0:
            done = lo + len(rows)
            rate = done / max(time.time() - t0, 1e-9)
            print(f"rank {rank}: embedded {done}/{len(my_rows)} rows "
                  f"({rate:.1f} rows/s)", flush=True)

    store.save_shard()
    if world > 1:
        dist.barrier()  # every shard is written before the merge
    if rank == 0:
        store.merge_shards_and_save()
    print(f"rank {rank}: done", flush=True)
    return store.embedding_path


if __name__ == "__main__":
    main()
