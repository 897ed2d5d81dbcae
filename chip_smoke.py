#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one output line each (a failure raises and exits non-zero):

1. device: the card's name and power limit from nvidia-smi;
2. build: the hand-written kernels built from this checkout's sources
   (one nvcc per CUDA C++ source, started together; Triton's compiler for
   the RMSNorm), each timed; phase 3's checks of K1, K2, K3 and K4-K6,
   then phases 27 and 28 (K4's and K1's downstream paths), run while
   paged_attention.cu, the slowest, still compiles, and K7's after it; then ptxas's report of decode_attention.cu,
   flash_attention.cu and paged_attention_tc.cu (`-Xptxas -v`:
   registers, stack and spills of each kernel instance) beside K4's, K5's,
   K6's and K7-tc's dynamic shared memory, the latter with bf16 and with
   int8 pools (ptxas_decode, ptxas_flash, ptxas_paged_tc);
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the shapes of the paths that run it (bf16, max-abs 2e-2: the
   attention kernels round p to bf16 before normalising, the plain
   versions after; flash gradients within 2e-2 of their reference's
   max-abs), and each kernel's time beside its plain version's, one
   library call's and the least time the card could take; K1 at four
   shapes (Llama-2-7B's decode batch, one 4096-position request,
   Llama-2-70B's and Falcon-7B's attention widths) in both cache layouts
   and with a length on the card, both of its designs timed; K7 in both of
   its designs (tc, on the tensor cores, for bf16 q with bf16 or int8
   pools, and present, for fp32 pools) where each takes the shape, at
   Llama-2-7B's,
   Llama-2-70B's and Falcon-7B's (qpk 71, tc only) attention shapes, both
   designs' times in the same call; K7
   also with int8 pools (the tc design's output elements that round
   otherwise than the exact float64 answer, summed over draws, held to
   twice the present design's on the same inputs, and two controls with
   a bf16 or hi/lo p * v_scale operand shown to fail that check), a
   window of 1024 (binding, and covering:
   bitwise the fp launch), both, and three packed documents over one
   slot's pages (kernel_check_paged_variants, kernel_time_paged_variants,
   both designs timed for every variant, and int8 pools at Llama-2-70B's
   widths too), with NaN below every chunk's floor kept out of the
   output; K2 with rstd and K3 also in fp16 (within 5e-3 of max(1, the
   reference's max-abs)); K4, K5 and K6 also in their fp16
   instantiations at the training shape, Llama-2-70B's GQA and full
   attention (within 5e-3, about 5 fp16 ulps at 1), timed beside the
   plain fp16 versions, SDPA in fp16 and the bound
   (kernel_check_flash_fp16, kernel_time_flash_fp16);
4. model: Llama-2-7B at full width and depth, random bf16 weights from a
   fixed seed on the card, built once for every route;
5. serving (whole-batch route, `MegatronServer(engine=None)`): a greedy
   batch of 4 prompts, a sampled, a score-only and a beam request; each
   decode step of the first two replays one captured CUDA graph. The
   launch counters (which replays move as launches do) are set to 0
   before the requests and read after; the decode kernel must have run
   32 times per replayed decode step, the flash forward 32 times (the
   score-only request's no-cache forward);
6. path check: the greedy output teacher-forced back through the same
   cached decode path with the kernels off (plain RMSNorm, plain decode
   attention) on the card; log-probs within 5e-2 max-abs (greedy tokens
   need not match: a random-init 7B has near-flat logits, so argmax
   flips on bf16 rounding);
7. throughput of the greedy batch: prefill ms, the call's capture
   seconds, decode ms per step, the card's ms per decode forward beside
   the weight-streaming floor, tokens/s, and, from the same call run
   again under torch.profiler (CUDA activity only), the card's busy ms
   in that call and its idle share 1 - busy/wall;
8. serving_engine (the continuous-batching route, `MegatronServer(
   engine=DecodeEngine(...))` at the launcher's defaults: 8 slots, page
   64, max_context 2048, horizon 8, chunks of 256, prefix cache on): 16
   requests from concurrent client threads, more than the slots, with
   prompts of 20 to 1500 ids, two sharing a 700-token prefix, one
   sampled and one streamed over SSE. Every engine of phases 8-14b
   captures each round bucket at `start()` (`warmup_compile=True`; the
   window phase, drained without a serve thread, calls `warmup()`) and
   replays a CUDA graph for every round. The counters are set to 0
   before the traffic: the paged kernel must have run 32 times per paged
   forward of the engine's round log (every launch its tc design), the
   RMSNorm kernel too, the decode kernel not at all; the
   prefix cache must show a hit and a copy-on-write copy, and every page
   must be free or cached at the end;
9. path_check_engine: the engine's greedy outputs that asked for
   log-probs, re-scored teacher-forced with the kernels off on the card;
   log-probs within 5e-2 max-abs, greedy-token match fraction printed;
10. throughput_engine: wall time and generated tokens/s over the whole
   traffic, ms per decode-token advance and per mixed round, TTFT p50,
   the device ms of one 8-slot paged decode step beside the weight
   floor, the device ms of one mixed round's paged forward and K7's part
   of it (torch.profiler), peak memory;
10b. graph_capture (at 2 of 32 layers, CAPTURE_LAYERS): 8 of the
   engine's greedy requests queued and drained
   by the bf16 engine with every round a replayed graph, and the same
   queue's first rounds (every mixed round and 4 decode rounds) with
   every round called eagerly (the private `_eager`), and phase 5's
   greedy batch decoded eagerly (`_eager=True`) and captured for its
   first 64 decode steps (GRAPH_WB_STEPS), in this one call: after those rounds, captured streams equal to eager token for
   token, equal page and prefix-cache accounting; ms per decode advance
   (and per mixed round) of each, the card's busy ms over the run
   window (torch.profiler, CUDA activity only, the rounds themselves
   traced) and the idle share 1 - busy/wall of that window (the
   whole-batch call likewise), the
   card's ms of one 8-slot decode round of 8 steps at 1000 positions
   (eager: its kernels in a torch.profiler trace; captured: replays on
   CUDA events) with its top kernels, the graphs, capture seconds and
   the reserved memory warmup added; one captured round
   replayed under `torch.cuda.set_sync_debug_mode("error")`; a captured
   decode advance must be faster than an eager one on both routes;
11. serving_engine_int8: the same traffic through the same server with
   int8 pools and int8 weights (`kv_dtype="int8"`,
   `quantize_weights=True`); every K7 launch the int8 variant on the tc
   design; the outputs re-scored teacher-forced on a kernels-off int8
   engine within 5e-2; printed: drift against the bf16 engine, pool bytes
   per token, tokens/s, ms per decode advance, the device ms of a decode
   step and of a mixed round's forward (and K7's part) with K7's tc
   design, the one the path runs;
12. serving_engine_window: the 7B's first 2 of 32 layers (WINDOW_LAYERS)
   with `attention_window_size=1024`, max_context 4096, 12 requests (8
   reaching 1564-3128 positions) queued and drained in a pool of 8 x 21
   pages that their reach overflows: the streams bitwise those of the
   mask-only engine, pages reclaimed, no slot above 21 pages, every page
   back, a kernels-off windowed re-score within 5e-2, every K7 launch
   the window variant;
13. serving_engine_spec_whole_prompt (at 2 of 32 layers, SPEC_LAYERS):
   8 requests (4 with repeating prompts) over HTTP through the chunked
   engine, with `spec_decode_k=4` and with whole-prompt admission:
   acceptance, tokens/s and TTFT of each, and log-probs within 5e-2 of
   the chunked engine's over each request's common prefix;
14. packed_docs_prefill: three documents packed into one slot's pages,
   prefilled by one paged `LlamaModel.forward` with "doc_starts" floors:
   K7 once per layer, the doc variant each time; log-probs within 5e-2 of
   the kernels-off forward and of each document's own forward;
14b. serving_engine_fp32: Llama-2-7B widths at 2 of 32 layers in fp32
   (weights, compute, pools) behind the same server, 4 requests: every K7
   launch the present design (fp32 pools); log-probs re-scored on a
   kernels-off fp32 engine within 1e-3. Also, after the kernel checks,
   kernel_time_paged_fp32: K7's present design at this engine's own
   shape (fp32 q and pools, its decode and mixed rounds) against its
   plain version (1e-3), beside SDPA in fp32 and the bound;
14c. launcher_llama (the serving entry path, after the 7B of phase 4 is
   written out and freed): its first 4 of 32 layers
   (LLAMA_LAUNCH_LAYERS) written as an HF Llama directory
   (config.json, bf16 safetensors in 2 GB shards with an index) by the
   port's converter and writer, converted by the CLI's
   `convert_weights.main([--direction hf2native --dtype bfloat16 ...])`
   in this process into a release whose every leaf equals the smoke's
   bit for bit; then the launcher's `main([--load <release>
   --warmup_compile ...])` in a thread, at its engine defaults, serving
   over HTTP from concurrent clients the first 8 greedy requests of
   phase 8, the streamed one, and one after the other a beam-2 and a
   score-only request. Counters set to 0 before the traffic: K7 once a
   layer per paged forward (tc), K1 once a layer per beam decode step, K4
   once a layer (the score request), K2 never; the greedy streams
   teacher-forced through the kernels-off forward within 5e-2. Then two
   greedy requests, one at a
   time, answered equally by the launcher started as a subprocess
   (`python -m ...run_text_generation_server`). Printed: the seconds of
   the HF write, the conversion, the load, the warmup capture and the
   subprocess's start to its banner; bytes written, tokens/s, TTFT p50,
   ms per decode advance (wall, device), GPU memory after the start;
14c'. launcher_fleet: 14c's release served by two engine replicas on
   the card through the launcher's `--router_replicas 2`, in a thread.
   (a) `--prefill_replicas 1 --cost_registry --perf_sentinel_ksigma 6
   --trace_dir --record_dir`: 6 greedy prompts of 300-1100 ids take the
   two-stage route (prefill on replica 0, KV pages exported and imported
   into replica 1, every imported page bit for bit the donor's), 2 short
   ones go direct; POST /profile traces 2 rounds whose kernels include
   K7's; the Prometheus /metrics parses back with the requests' count;
   the detected chip spec is the H100's. (b) `--recover_requests
   --fleet_controller --chaos kill=0@3`: 8 greedy requests sharing a
   512-id system prefix go by affinity to replica 0, which is killed
   after its third submit; zero requests fail, one replacement, the
   flight-record dump written, the condemned engine collected and the
   card's reserved memory back. Both runs' streams held to 14c's single
   engine on the same prompts (teacher-forced through the kernels-off
   forward within 5e-2, token agreement printed); K7 once a layer per
   paged forward on each replica (counts set to 0 before each run);
14d. serving_tp: 14c's release served by `torchrun --nproc_per_node 2
   -m megatron_llm_tpu_torch.tools.run_text_generation_server
   --serving_tp 2 --distributed_backend gloo`, two ranks on cuda:0, each
   holding 16 of the 32 KV groups of every pool, tp rank 0 the HTTP
   front: 14c's 8 greedy requests from concurrent clients, then a score
   and a beam request (rank 0's whole tree). The greedy log-probs within
   5e-2 of 14c's tp 1 streams over each common prefix, each rank's pool
   bytes half of 14c's, K7 on each rank once a layer per paged forward
   of the leader's round log (every launch tc; each rank prints its
   counts as it stops), rank 0's K1 once a layer per beam step and K4
   once a layer, rank 1's never; the rounds uncaptured (banner and
   /metrics). Printed: each rank's memory after the start, ms per decode
   advance and per mixed round (eager, gloo through the host), the
   seconds to the banner. Also, after the kernel checks,
   kernel_time_serving_tp2: K7 (tc, bf16 and int8 pools, decode and
   mixed rounds) and K1 ("gtd" and the ring's "tgd") at a tp 2 rank's
   16 groups against their plain versions, beside SDPA and the bound;
14e. launcher_falcon: Falcon-7B at full width, 2 of its 32 layers
   (FALCON_LAYERS; 16 before the serving_tp phase, 8 before the
   overlap_dropout phase, 4 before the bert phase), random bf16
   weights from a seed written as a release by `save_checkpoint(
   release=True)`; native2hf then hf2native through the CLI's `main`
   (in this process) at full width and 2 layers, bit-exact; the launcher (`--model falcon`) in a
   thread: 8 engine requests, a beam-2 and a score-only request, K7 (tc,
   qpk 71) and K1 (tensor_cores, qpk 71) counted as in 14c, K4 never
   (Falcon runs no flash); the greedy streams teacher-forced through the
   kernels-off forward within 5e-2; tokens/s, TTFT p50, ms per decode
   advance (wall, device) beside the weight floor, an eager decode
   step's top kernels, and K7's and K1's device ms a launch at these
   shapes (torch.profiler). The files live
   under build/launcher_smoke/ (about 27 GB at the peak) and are deleted
   after their checks;
15. train (the serving model and pools freed first): Llama-2-7B widths at
   8 of its 32 layers, seq 4096, flash attention and the fused RMSNorm,
   full recompute, bf16 compute on fp32 params and AdamW state, trained
   for 8 steps of 4 microbatches through `Trainer.setup()` / `train()` on
   one fixed batch of seeded tokens. The counters are set to 0 before
   `train()`: K2-K6 must have run exactly the launches the code implies;
   every loss finite, no step skipped, the last loss below the first;
16. path_check_train (run between setup and training): one microbatch's
   loss and gradients at the initial weights with the kernels on and off
   (grouped attention, plain RMSNorm): loss within 2e-2, global gradient
   norm within 5e-2 relative, every leaf's gradient cosine >= 0.98;
17. throughput_train: median ms per step, tokens/s, model TFLOP/s (6 N
   per token) and its share of 989, peak memory, and a torch.profiler
   trace of one step: the top 10 CUDA kernels by device time, the share
   of the step the card was busy, and the device ms of K4, K5 and K6 in
   the step with their share of it;
18. finetune_data and finetune (the training entry path, after the
   train phase's model is freed): two JSONL corpora of seeded token ids
   (about 1.5 M tokens each, documents of 64-8192) through the port's
   `preprocess_data` (NullTokenizer; 2 spawned workers for the first,
   1 for the second), then
   `finetune.main(argv)` three times at Llama-2-7B widths with 1 of 32
   layers (FT_ENTRY_LAYERS; 2 before the overlap_dropout phase), seq
   4096, 4 microbatches, bf16 on fp32
   AdamW, full recompute, blend 0.7/0.3, eval every 3 steps: R trains 6
   steps with an async save at 3 and the final save at 6
   (keep_latest_n 1), with the recipe's `--tensorboard_dir
   --log_timers_to_tensorboard` and `--trace_dir`,
   `--device_cost_registry`, `--perf_sentinel_ksigma 8`,
   `--log_memory_to_tensorboard` and a profile window over step 5; K is
   R without them, with --exit_signal_handler, `--flight_record_dir` and
   a SIGTERM after step 3, so it makes its emergency save at 3, dumps its
   flight record and returns; C loads K and trains steps 4-6, with no
   save.
   The counters are set to 0 before each run and read after it: K4, K5
   and K6 run exactly the launches the code implies (eval forwards
   included), K1, K2, K3 and K7 never. C resumes at iteration 3 with 12
   samples consumed, its losses equal R's bit for bit and its final state
   R's final checkpoint leaf by leaf (telemetry on trains the bits
   telemetry off does); R's event file, read back by the port's reader with its
   CRCs, holds lm-loss at steps 1-6 equal to R's losses, its span trace
   a train-step span a step, its profile window K4-K6 by kernel name;
   K's SIGTERM dump loads with its goodput snapshot; the g++ sample
   indices equal their numpy version and the first batches are the
   samples the sampler names. Printed with the card's name and power
   limit: the registry's train.step FLOPs beside the analytic count, the
   telemetry's ms a step (R's steps against K's and C's), ms per step
   (median of R's steps 2-6) beside the train phase's, model TFLOP/s,
   the loader's host ms a step, preprocess s, each save's blocked ms
   and commit s, bytes on disk and the load's s. The checkpoints live
   under build/finetune_smoke/ and are deleted after their checks;
17b. train_remat (between 17 and 18): phase 15's trainer from its initial
   weights and batch, 2 steps under each recompute policy ("full",
   "selective", "save_dots", "offload", and "full" on the first 4 layers
   by `recompute_method` block): ms a step, peak memory, GEMM and flash
   device ms of a profiled step, launches a step checked against the
   policy (K4 2 L M under full, L M under the named-save-point policies,
   (L + 4) M under block), step 1's loss and gradient norm equal across
   policies;
19. finetune_modes (on phase 18's corpora, no --save): `finetune.main`
   at 2 of 32 layers (FT_LAYERS, the depth of phases 19-22) in (a) the fine-tuning recipe's training flags
   (flash, selective recompute, bf16), and the same in a process of
   its own with the recipe's parallel flags (`--tensor_model_parallel_size
   1 --sequence_parallel --use_distributed_optimizer`) under `torchrun
   --nproc_per_node 1`, an NCCL group of world size 1: launches equal,
   losses and grad norms within 2e-2 / 5e-2 (bit for bit printed), ms a
   step within 3% of the recipe's without those flags, both timed in
   that process in the order A4, plain, plain, A4; (b) fp16 with the
   dynamic scaler
   from 2^32 for 16 steps (the scale and skip sequence follows the
   scaler's rule, at least 3 steps taken, K4-K6 in fp16 only), (c)
   hidden, attention and LIMA dropout under full recompute (no flash
   launch: the grouped path) beside one step without recompute at the
   same seed (step 1's loss and gradient norm equal);
20. finetune_parallel: `torchrun --nproc_per_node 4` runs `finetune.main`
   in four ranks (this script's rank mode, `--finetune-rank`) at tp 2 x
   dp 2 with sequence parallelism and ZeRO-1 over gloo, every rank on
   cuda:0 and every collective staged through host memory, on the
   recipe's flags and phase 18's corpora: 1 step (PAR_STEPS; 2 before
   the bert phase) and a save (run P, with `--tensorboard_dir` and
   `--trace_dir`: rank 0's is the one event file, every rank writes its
   trace), then the same ranks resume it for step 2, and world size 1
   resumes it too.
   Losses and grad norms within 2e-2 / 5e-2 of (a)'s world-size-1 run
   (the same weights and global batches); every rank reports the same;
   K4-K6 8 launches a rank a step; the save is per-rank files (each
   rank its pieces, one writer a piece, a marker a rank, rank 0
   committing), and each rank's slice of every leaf read back from the
   pieces equals what the rank held (a positional checksum of every
   leaf's bits); step 3 after either resume within 2e-2 of (a)'s.
   Printed: per-rank peak memory and their sum, the backend and the
   staging, ms a step labelled as gloo through the host on one shared
   card, each rank's save and commit seconds and rank 0's host RSS
   before the save and its peak after the commit. Then the same four
   ranks run encoder_parallel's entries (phase 20b). Also, after the kernel
   checks, kernel_time_flash_tp2: K4-K6 at a tp 2 rank's attention
   shape (g 16) beside SDPA and their plain versions, within 2e-2;
20b. encoder_parallel: phase 20's four ranks then run
   `pretrain_bert.main` (BERT-large widths), `pretrain_t5.main`
   (T5-base) and `pretrain_ict.main` (BERT-base towers, separate) at
   2 layers (a side), 1 step each, at tp 2 x dp 2 with sequence
   parallelism and ZeRO-1, dropout on, bf16, on phase 23's vocabulary
   and corpus (written before phase 20); this process runs each at world
   size 1 with the same depth, weights, global batch (one microbatch)
   and seed: losses within 2e-2 and grad norms within 5e-2, every rank
   the same, K1-K7 launched on no rank. Printed with the card's name and
   power limit: ms a step on each rank (gloo through the host, one card
   shared), per-rank peak memory, ICT's loss beside ln 32;
20c. lm_tasks_parallel: phase 20's four ranks last run `tasks.main`
   for WIKITEXT103 and LAMBADA under `--use_flash_attn` and MSDP-PROMPT
   (knowledge, then response) at tp 2 x dp 2 with sequence parallelism
   (gloo), on phases 27 and 28's model (Llama-2-7B widths at 4 of 32
   layers, the seed's weights) and files, held to those phases' world
   size 1 runs: the WikiText average loss within 1e-3, at every LAMBADA
   answer position each rank's top logit of its vocabulary shard within
   5e-2 of world size 1's, the shard's and the global argmax equal where
   world size 1's top-2 margin is at least 5e-2, and the verdicts sample
   by sample (one under that margin counted and printed), each MSDP stream
   teacher-forced through the fp32 plain model within 5e-2, every rank
   the same metrics; K4 on every rank once a layer an evaluation batch
   and K1 once a layer a decode step, each at the rank's 16 KV groups.
   Printed with the card's name and power limit: the corpora's sizes,
   ms an evaluation batch and a decode step on each rank (gloo through
   the host, one card shared);
21. pipeline: `torchrun --nproc_per_node 2` runs `finetune.main` at pp 2
   (`--pipeline_model_parallel_size 2 --pipeline_remat tick
   --async_pipeline_dispatch`: each tick's next receive posted before
   it computes, the recipe's flags, 2 of 32 layers, 1 a stage) over
   gloo, both stages on
   cuda:0: 1 step (PP_STEPS; 2 before lm_tasks_parallel) and a save
   with the optimizer state, then
   the same ranks resume it (optimizer state included) for step 2 and
   serve it through the API (a pipelined score, four greedy requests
   through the stage ring), and world size 1 resumes the save for step 2
   and serves it whole-batch. Losses and grad norms within 2e-2 / 5e-2
   of world size 1 (phase 19's (a)), step 2 at pp 2 and pp 1 within
   1e-4, every leaf of the checkpoint (Adam moments included) cut into
   each stage's pieces equal to what the stage held, the scorer's
   log-probs within 5e-2 of the whole-batch route's and the ring's over
   each common prefix within 5e-2 of the one-rank route run on the
   ring's row groups (the same GEMM rows; the drift of the 4-row route
   from the 2-row one is printed beside it); per rank K4 8, K5 4, K6 4
   a step, the scorer's K4 once a stage layer, the ring's K1 in "tgd"
   once a stage layer a decode tick. Also, after the kernel checks,
   kernel_time_decode_ring: K1 on one layer's "tgd" slice of the ring's
   stacked cache against its plain version, beside SDPA and the bound;
21b. overlap_dropout: the pipeline phase's two ranks (rank mode, run
   last in the same torchrun) run `finetune.main` at dp 2 with ZeRO-1
   under `--overlap_grad_reduce --overlap_param_gather` and
   `--hidden_dropout 0.1` (the recipe's flags, flash on) over gloo,
   both ranks on cuda:0, 2 steps (OVERLAP_STEPS), held to
   world size 1 with the same flags but the overlap ones: losses within
   2e-2, grad norms within 5e-2; K4-K6 per rank as the layout implies
   (once a layer and local microbatch, 2 a step); the layer group's
   reduce-scatter issued inside the backward; a (1, 4096, 4096)
   hidden-dropout mask and a (1, 8, 1, 256, 4096) slice of an
   attention-dropout mask drawn on the card equal to the CPU's bit for
   bit, and the card's ms for the hidden mask and for a layer's whole
   (1, 32, 1, 4096, 4096) attention mask;
22. context_parallel: `torchrun --nproc_per_node 2` runs `finetune.main`
   at cp 2 (`--context_parallel_size 2`, the recipe's flags, 2 of 32
   layers, seq 4096: 2048 positions a rank; attention the ring of
   parallel/ring_attention.py) over gloo, both ranks on cuda:0: 1 step
   (CP_STEPS; 2 before lm_tasks_parallel) and a save with the optimizer
   state, then the same ranks resume it for step 2 and run ring
   attention at the recipe's CodeLlama-7B preset
   (seq 16384, 8192 a rank, g 32, d 128) against the one-rank K4-K6 on
   the whole sequence on the card (o within 5e-3, o, dq, dk, dv
   cosines >= 0.98) and one layer under each recompute policy (K4 twice a visible
   hop under full, once under the others), and world size 1 resumes
   the save for step 2. Losses and grad
   norms within 2e-2 / 5e-2 of world size 1 ((a)), step 2 at cp 2,
   world size 1 and uninterrupted within 2e-2, every leaf of the
   checkpoint equal to what each rank held; per rank K4, K5 and K6 by
   mask: cp rank 0 8 causal a step, rank 1 8 causal and 8 full (its
   diagonal block and rank 0's). Also, after the kernel checks,
   kernel_time_flash_cp_hops: K4-K6 at the ring's hop shapes (s = t =
   2048 and 8192, causal and full) beside SDPA and the bound, o, lse,
   dq, dk and dv within 2e-2 of their plain versions (run a few KV
   groups at a time) at each;
23. bert (the encoder family, last; its inputs made before phase 20):
   a synthetic WordPiece vocabulary
   of 30522 entries (the specials, words and ## pieces; padded to
   30592) and a synthetic corpus of 200 documents through the port's
   `preprocess_data --split_sentences --tokenizer_type
   BertWordPieceLowerCase` (and a title a document, the document's
   first words, without `--split_sentences`, for phase 25; the three
   phases share both), then `pretrain_bert.main` at
   examples/pretrain_bert.sh's BERT-large widths and flags (24 layers,
   hidden 1024, 16 heads, seq 512, micro batch 4, global batch 8, bf16;
   6 steps, an eval at step 3, the final save without the optimizer
   state): every loss finite, the first step's loss recomputed on its
   batch with its dropout masks equal to it in bf16 and within 2e-2 in
   fp32; then `tasks.main --task MNLI` and `--task RACE` from that
   checkpoint on synthetic files in the readers' layouts (1 epoch each):
   every encoder leaf loaded equal to the checkpoint's bit for bit,
   every loss finite, the validation accuracy printed. The counters are
   set to 0 before each of the three runs and must stay 0: the padding
   mask sends attention to the grouped path and LayerNorm has no kernel,
   so the encoder path launches none of K1-K7. Printed with the card's
   name and power limit: ms a step after the first, tokens/s, model
   TFLOP/s (6 N a token plus attention) and its share of 989, peak
   memory; and one more step on the first batch under torch.profiler:
   its busy and idle share, GEMM ms and the ten largest kernels.
24. t5: `pretrain_t5.main` at examples/pretrain_t5.sh's T5-base widths
   and flags (12 layers a side, hidden 768, 12 heads, kv_channels 64,
   ffn 3072, encoder seq 512, decoder seq 128, micro and global batch
   16, `--vocab_extra_ids 100`: vocabulary 30720, bf16; 6 steps, an
   eval at step 3, the final save without the optimizer state) on phase
   23's corpus, with the checks and prints of phase 23's pretraining:
   no kernel launch (every attention carries a dense mask, the norms
   are LayerNorm), every loss finite, step 1 recomputed in bf16 equal
   and in fp32 within 2e-2; tokens/s counts encoder and decoder tokens,
   model TFLOP/s 6 N a token of each side (the tied head on the
   decoder's) plus attention (encoder self, decoder self and cross);
25. ict: `pretrain_ict.main` at examples/pretrain_ict.sh's BERT-base
   widths (12 layers, hidden 768, 12 heads, seq 256; separate towers,
   projection 0, micro and global batch 32: each query's softmax over
   the batch's 32 blocks; bf16; 6 steps and the final save) on phase
   23's corpus and its titles, with phase 24's checks and prints (step
   1's loss beside ln 32); tokens/s counts query and context tokens;
26. retrieval (ORQA over phase 25's towers, no kernel launch): the
   port's `tools/build_retrieval_index` embeds 4096 100-word passages of
   phase 23's corpus with the context tower into an `.npz` store (s and
   passages/s); `tasks.main --task RETRIEVER-EVAL` from that store and
   `--task ICT-ZEROSHOT-NQ` embedding the evidence itself, at one batch
   shape, retrieve equal top-100 ids for 256 NQ-format questions (their
   hit rates printed); the exact MIPS search (`data/realm_index.
   MIPSIndex`, TF32 off) over 2^21 random fp32 rows of width 768 on the
   card (6.44 GB; DPR's Wikipedia index holds 21M), 1024 queries,
   top-100: ms beside the bound (2 Q d N fp32 operations at 67 TFLOP/s,
   49.2 ms) and its products' and top-k's ms, and on a 64k-row subset in
   chunks of 16k the ids equal one top-k over the same products; then
   `--task RET-FINETUNE-NQ` from the checkpoint, 4 steps of 32 DPR
   samples with hard negatives: losses finite, step 1 recomputed in bf16
   equal and in fp32 within 2e-2 of the loss;
27. zeroshot (run in phase 2's window): `tasks.main --task WIKITEXT103`
   (8 windows of 4096 at `--overlapping_eval 2048`) and `--task
   LAMBADA` (16 cloze passages) at Llama-2-7B widths and 4 of 32 layers
   (LLAMA_LAUNCH_LAYERS), random weights at the init std, in bf16 with
   `--use_flash_attn`: K4 once a layer a forward, counted; the same
   model in fp32 with plain attention: the mean loss within 5e-2, and
   the cloze answers are that fp32 model's own greedy next tokens, so
   its accuracy is 1.0; printed: the bf16 verdicts that differ and how
   many of those sit inside the bf16 error of the fp32 top-two margin;
28. msdp (run in phase 2's window): `tasks.main --task MSDP-PROMPT`,
   knowledge then response prompts, 4 test dialogs, 32 greedy tokens,
   at phase 27's widths on a seeded byte-level BPE of 32000 entries,
   through the whole-batch API: K1 once a layer a decode step, counted;
   each stream teacher-forced through the fp32 plain model within 5e-2;
   then `--task MSDP-EVAL-F1` on the knowledge output.

Then a line of each phase's seconds, a line of the processes the run
still had to stop, one JSON line of the kernels, the nvidia-smi line,
and the last line `{"ok": true, "device": {...}}`.

Every process the run starts ends with it: the script is its
descendants' child subreaper, so a process orphaned by a parent that
exited (torchrun starts each rank in a session of its own) comes back
to it; before the result, and in `finally` when a phase fails, it stops
the multiprocessing resource tracker that preprocess_data's pool
started, then terminates, kills and reaps every descendant left.
Without a CUDA card it exits 2 and prints no result.
"""

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

# the processes this script starts (torchrun ranks, launchers) import
# what it imports: the bytecode goes under the checkout's build/ (set
# before the imports below, inherited by every child), so that each
# process loads it instead of compiling the same sources again (a rank's
# first step otherwise compiles torch._dynamo's, which
# torch.utils.checkpoint imports at its first call)
os.environ.setdefault("PYTHONPYCACHEPREFIX", str(
    Path(__file__).resolve().parent / "build" / "pycache"))
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
sys.dont_write_bytecode = False

import numpy as np
import torch

from megatron_llm_tpu_torch.config import (
    REMAT_POLICIES,
    ParallelConfig,
    TrainConfig,
    falcon_config,
    llama_config,
)
from megatron_llm_tpu_torch.convert import hf as hf_conv
from megatron_llm_tpu_torch.convert import safetensors_io
from megatron_llm_tpu_torch.inference.engine import (
    DecodeEngine,
    horizon_buckets,
    mixed_width_buckets,
)
from megatron_llm_tpu_torch.inference.generation import (
    bucket_prefill_len,
    decode_log,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.inference import graph_capture as gcap
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.inference.tokenization import tokenize_prompts
from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
from megatron_llm_tpu_torch.ops import _build
from megatron_llm_tpu_torch.ops import decode_attention as dec
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.ops.quantization import quantize_rows
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.telemetry import histograms_from_prometheus
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs
from megatron_llm_tpu_torch.training import checkpointing as ckpt
from megatron_llm_tpu_torch.training.trainer import Trainer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
BF16_TOL = 2e-2
# fp16 kernels against their plain fp16 versions: about 5 fp16 ulps at 1
# (bf16's 2e-2 is about 2.5 of its ulps); both round at the same places
FP16_TOL = 5e-3
PATH_LP_TOL = 5e-2
SEED = 0
# Random weights at the config's init std (0.02) make a 7B whose log-probs
# move by ~0.2 under any one-ulp bf16 change (measured on the H100: the
# kernels-off no-cache forward differs from the kernels-off cached path
# by 0.23), which hides the kernels' own error. At 0.005 that noise floor
# is ~0.016 and the 5e-2 path check measures the kernels. `--init-std`
# sets it.
INIT_STD = 0.005


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase, **kw):
    print(f"{phase}: " + json.dumps(kw), flush=True)


PR_SET_CHILD_SUBREAPER = 36  # prctl(2)


def become_subreaper():
    """Orphaned descendants are reparented to this process, not init."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
          f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")


def descendants(root: int) -> list:
    """[(pid, command line)] of every live process below `root`, from
    /proc (zombies included: they still need reaping)."""
    kids = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:  # it exited while the table was read
            continue
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        kids.setdefault(ppid, []).append(int(entry))
    out, todo = [], list(kids.get(root, []))
    while todo:
        pid = todo.pop()
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = ""
        out.append((pid, cmd.strip()))
        todo += kids.get(pid, [])
    return out


def stop_tree(root: int, grace_s: float = 5.0) -> list:
    """SIGTERM every descendant of `root`, SIGKILL what is left after
    `grace_s`, and reap those that are this process's children: the
    command lines found."""
    found = descendants(root)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in descendants(root):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            for pid, _ in descendants(os.getpid()):
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
            if not descendants(root):
                return [cmd for _, cmd in found]
            time.sleep(0.05)
    check(not descendants(root), f"processes left below {root}: "
          f"{descendants(root)}")
    return [cmd for _, cmd in found]


def stop_children() -> list:
    """The resource tracker stopped (it ignores SIGTERM and would
    outlive this process until it reads EOF), then every other
    descendant: the command lines found."""
    import multiprocessing.resource_tracker as rt

    tracker = rt._resource_tracker
    stopped = []
    if tracker._pid is not None:
        stopped.append("multiprocessing resource tracker "
                       f"(pid {tracker._pid})")
        tracker._stop()
    return stopped + stop_tree(os.getpid())


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=100, warmup=5) -> float:
    """Mean ms per call on CUDA events, after a warm-up, launched from
    the host one call at a time (a short kernel then measures the host's
    launch rate, not the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, per_graph=50, replays=10) -> float:
    """Mean ms per call on the card: `per_graph` calls captured in one
    CUDA graph, replayed and timed on CUDA events, so the host's launch
    cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # on the warm-up stream: its arrival counters are sized already
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * per_graph)


def profiled_ms(fn, iters=20, warmup=3) -> float:
    """Mean device ms per call: the CUDA kernels' time in a torch.profiler
    trace of `iters` calls. For a call that launches several kernels
    through autograd (a library backward), which a CUDA graph does not
    capture here and which CUDA events around the calls would time at the
    host's launch rate."""
    for _ in range(warmup - 1):
        fn()
    return top_kernels(fn, calls=iters)[0] or 0.0


def cuda_trace(fn):
    """`fn()` under torch.profiler with CUDA activity only: (its result,
    wall s, [(name, start ns, end ns)] of the card's kernels and copies).
    The raw events, not the parsed event list, which takes the host
    seconds to minutes for a window of many thousand kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return out, wall, events


def kernel_totals(events):
    """{kernel name: device ms} summed over `events`."""
    out = {}
    for name, a, b in events:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def busy_ms(events):
    """The union of the events' intervals, in ms: the card's busy time."""
    busy, end = 0, 0
    for a, b in sorted((a, b) for _, a, b in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def top_kernels(fn, calls=3, n=10):
    """(device ms per call, [[kernel, ms per call]] of the n largest) in a
    torch.profiler trace of `calls` calls after one warm-up; (None, [])
    when the trace shows no device time (a graph replay whose kernels
    the profiler does not see)."""
    fn()
    _, _, events = cuda_trace(lambda: [fn() for _ in range(calls)])
    kernels = kernel_totals(events)
    if not kernels:
        return None, []
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:n]
    return (sum(kernels.values()) / calls,
            [[k[:100], round(ms / calls, 4)] for k, ms in top])


def rotating(make, n):
    """A call that cycles through n independent input sets, so repeated
    launches find the inputs out of L2 as the serving path does (each
    layer reads its own cache)."""
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]
    return pick


# ---------------------------------------------------------------------------
# phases 2-3: build and kernel checks
# ---------------------------------------------------------------------------


CUDA_SOURCES = ("decode_attention.cu", "paged_attention.cu",
                "paged_attention_tc.cu", "flash_attention.cu")


# each source's library, loaded once its build has ended
LIBRARIES = {"decode_attention.cu": lambda: dec._library(),
             "paged_attention.cu": lambda: pa._library(),
             "paged_attention_tc.cu": lambda: pa._library("tc"),
             "flash_attention.cu": lambda: fa._library("fwd")}


def start_builds():
    """One nvcc per CUDA C++ source, all started together, while Triton
    compiles the RMSNorm kernels; returns the builds for `await_builds`
    (the smoke checks the kernels of the sources that end first while
    the others compile)."""
    t0 = time.perf_counter()
    builds = {src: _build.start_build(src) for src in CUDA_SOURCES}
    x = torch.randn(4, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    rms.fused_rms_norm(x, w)  # Triton JIT of K2
    torch.cuda.synchronize()
    seconds = {"rmsnorm_triton_s": round(time.perf_counter() - t0, 2)}
    t1 = time.perf_counter()
    _, rstd = rms.rms_norm_fwd(x, w, 1e-5, with_rstd=True)
    rms.rms_norm_bwd(x, w, rstd, x)  # K2 with rstd and K3, at first launch
    torch.cuda.synchronize()
    seconds["rmsnorm_bwd_triton_s"] = round(time.perf_counter() - t1, 2)
    return {"t0": t0, "all": builds, "pending": dict(builds),
            "seconds": seconds}


def build_kernels():
    """Every kernel built and loaded (for a script that drives phases on
    their own)."""
    await_builds(start_builds(), *CUDA_SOURCES)


def await_builds(builds, *sources):
    """Wait for the builds of `sources` and load their libraries, each
    build's seconds from the common start to when this wait saw it end
    (a build that ended while earlier checks ran reads as their end);
    when the last has ended, print them and the ptxas reports."""
    pending, seconds = builds["pending"], builds["seconds"]
    while any(src in pending for src in sources):
        for src in [src for src in sources if src in pending]:
            proc, lib = pending[src]
            if proc is None or proc.poll() is not None:
                _build.finish_build(proc, lib)
                key = src.replace(".", "_") + "_s"
                seconds[key] = round(time.perf_counter() - builds["t0"], 2)
                del pending[src]
                LIBRARIES[src]()
        time.sleep(0.05)
    if pending:
        return
    say("build", **seconds,
        libraries=[lib.name for _, lib in builds["all"].values()])
    say("ptxas_decode", **ptxas_of("decode_attention.cu", 0))
    say("ptxas_flash", **ptxas_flash())
    say("ptxas_paged_tc", **ptxas_paged_tc())


def ptxas_report(log):
    """{kernel instance: its registers, stack, spills (and static shared
    memory)} from `nvcc -Xptxas -v` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"((?:flash|paged|decode)_[a-z_]+_kernel)I"
                          r"((?:f|13__nv_bfloat16|L[ib]\d+E)+)E", m.group(1))
            args = re.findall(r"(f|__nv_bfloat16|L[ib]\d+E)",
                              k.group(2)) if k else ()
            args = [{"f": "float", "__nv_bfloat16": "bf16"}.get(
                a, a[2:-1]) for a in args]
            name = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def ptxas_of(source, dyn):
    """ptxas's report of one source's kernels beside their dynamic shared
    memory `dyn`, and the spilled bytes of all of them together."""
    log = _build.build_log(source)
    if log is None:
        return {"report": "not built in this run (library cached)"}
    report = ptxas_report(log)
    spills = sum(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
                 for r in report.values())
    return {"kernels": report, "dynamic_smem_bytes": dyn,
            "spill_bytes": spills}


def ptxas_flash():
    """flash_attention.cu: K4's, K6's and K5's registers, spills and
    dynamic shared memory by head size."""
    smem = fa._library("smem")
    return ptxas_of("flash_attention.cu", {
        f"{label} d{d}": smem(kernel, d)
        for kernel, label in ((0, "flash_fwd"), (1, "flash_bwd_dkv"),
                              (2, "flash_bwd_dq"))
        for d in (64, 128, 256)})


def ptxas_paged_tc():
    """paged_attention_tc.cu: K7's tensor-core design, by head size, with
    bf16 pools (<DP,0>) and int8 pools (<DP,1>)."""
    smem = pa._library("smem")
    return ptxas_of("paged_attention_tc.cu",
                    {f"paged_attn_tc {pools} d{d}": smem(d, int8)
                     for int8, pools in ((0, "bf16"), (1, "int8"))
                     for d in (64, 128, 256)})


# (label, (b, g, qpk, d, T)) of K1's shapes, each timed at length T:
# Llama-2-7B's decode batch at the longest cache the greedy batch reaches
# (the whole-batch route's shape), one long request, Llama-2-70B's and
# Falcon-7B's attention widths (Falcon itself is not served: correctness
# and time only)
DECODE_DESIGNS = ("tensor_cores", "cuda_cores")
DECODE_SHAPES = (("llama2_7b_b4", (4, 32, 1, 128, 320)),
                 ("llama2_7b_b1_long", (1, 32, 1, 128, 4096)),
                 ("llama2_70b_attn", (4, 8, 8, 128, 2048)),
                 ("falcon_7b_attn", (4, 1, 71, 64, 2048)))


def decode_bound_ms(b, g, qpk, d, length, elt=2):
    """K1's least time: K/V of `length` positions, q and out, over 3.35
    TB/s, or 4 flops per (head, position, element) over the peak of the
    units the bf16 launch's design runs its products on (the bf16 tensor
    cores for "tensor_cores", fp32 CUDA cores for "cuda_cores"), whichever
    is larger."""
    nbytes = (2 * b * g * length * d + 2 * b * g * qpk * d) * elt
    flops = 4 * b * g * qpk * length * d
    peak = (BF16_FLOPS if dec.decode_design(torch.bfloat16, qpk)
            == "tensor_cores" else FP32_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_decode_kernel():
    """K1 against its plain version at each shape, in both cache layouts
    (tgd: one layer's slice of a stacked (2, b, T, g, d) cache, read in
    place), at lengths around its split size, with a device-side length
    too, NaN past the length kept out; then each shape's time in both
    designs beside the plain version, SDPA and the bound, in this one
    call."""
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs, plans = {}, {}
    for label, (b, g, qpk, d, T) in DECODE_SHAPES:
        plans[label] = {"design": dec.decode_design(bf, qpk)}
        for design in DECODE_DESIGNS:
            nsplit, S = dec.split_plan(b, g, qpk, d, T, bf, design)
            plans[label][design] = {"nsplit": nsplit, "split": S}
        q = torch.randn(b, 1, g, qpk, d, generator=gen, device="cuda").to(bf)
        stacked = [torch.randn(2, b, T, g, d, generator=gen,
                               device="cuda").to(bf) for _ in range(2)]
        caches = {"tgd": (stacked[0][1], stacked[1][1]),
                  "gtd": (stacked[0][1].transpose(1, 2).contiguous(),
                          stacked[1][1].transpose(1, 2).contiguous())}
        lengths = {1, 63, 64, 65, T}
        for design in DECODE_DESIGNS:
            S = plans[label][design]["split"]
            lengths |= {S - 1, S + 1}
        lengths = sorted(lengths & set(range(1, T + 1)))
        for layout, (k, v) in caches.items():
            for length in lengths:
                ref = dec._xla_decode(q, k, v, length, layout)
                dev_len = torch.tensor(length, dtype=torch.int32,
                                       device="cuda")
                for design in DECODE_DESIGNS:
                    kw = dict(layout=layout, design=design)
                    got = dec.decode_attention(q, k, v, length, **kw)
                    on_card = dec.decode_attention(q, k, v, dev_len, **kw)
                    torch.cuda.synchronize()
                    check(torch.isfinite(got.float()).all(),
                          f"K1 {label} finite")
                    check(torch.equal(got, on_card),
                          f"K1 {label} {design} device length {length}")
                    err = (got.float() - ref.float()).abs().max().item()
                    key = f"{label}_{layout}_{design}"
                    errs[key] = max(errs.get(key, 0.0), err)
                    check(err <= BF16_TOL,
                          f"K1 {label} {layout} {design} length {length}: "
                          f"{err}")
        k, v = caches["gtd"]
        cut = max(1, T // 2 - 3)
        clean = [dec.decode_attention(q, k, v, cut, design=dn)
                 for dn in DECODE_DESIGNS]
        k[:, :, cut:] = float("nan")
        v[:, :, cut:] = float("nan")
        for dn, c in zip(DECODE_DESIGNS, clean):
            dirty = dec.decode_attention(q, k, v, cut, design=dn)
            torch.cuda.synchronize()
            check(torch.equal(c, dirty),
                  f"K1 {label} {dn}: NaN past the length reached the output")
        del q, stacked, caches, k, v
    say("kernel_check_decode_attention", max_abs_err=errs, tol=BF16_TOL,
        splits=plans, nan_past_length="ok")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for label, (b, g, qpk, d, T) in DECODE_SHAPES:
        set_bytes = 2 * b * g * T * d * 2
        n_sets = min(64, max(2, -(-100_000_000 // set_bytes)))  # > 2x L2

        def make(i):
            return tuple(torch.randn(shape, generator=gen,
                                     device="cuda").to(bf)
                         for shape in ((b, 1, g, qpk, d), (b, g, T, d),
                                       (b, g, T, d)))
        pick = rotating(make, n_sets)
        row = {"shape": f"b{b} g{g} qpk{qpk} d{d} length{T} bf16",
               "input_sets": n_sets, **plans[label]}
        row["design"] = plans[label]["design"]
        row["eager_launch_ms"] = time_ms(
            lambda: dec.decode_attention(*pick(), T))
        # both designs in turns
        for design in DECODE_DESIGNS + DECODE_DESIGNS[::-1]:
            row.setdefault(f"{design}_ms", []).append(device_ms(
                lambda: dec.decode_attention(*pick(), T, design=design)))
        row["ms"] = min(row[f"{row['design']}_ms"])
        row["plain_ms"] = device_ms(lambda: dec._xla_decode(*pick(), T),
                                    per_graph=10, replays=5)

        def library():
            q, k, v = pick()
            # the group's qpk heads as qpk query rows over the group's
            # cache: every head sees every position, no mask
            return sdpa(q.reshape(b, g, qpk, d), k, v)
        row["library_ms"] = device_ms(library)
        row["bound_ms"], row["bound_by"] = decode_bound_ms(b, g, qpk, d, T)
        times[label] = row
        del pick
        torch.cuda.empty_cache()
    say("kernel_time_decode_attention", **times)
    main = times["llama2_7b_b4"]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "megatron_llm_tpu_torch/csrc/decode_attention.cu",
        "replaces": "megatron_llm_tpu/ops/decode_attention.py:115",
        "design": "split-cache, merge in the last block; tensor_cores "
                  "(mma.sync) from qpk 4 on, cuda_cores below",
        "max_abs_err": max(errs.values()), "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "eager_launch_ms": main["eager_launch_ms"], "shape": main["shape"],
        "shapes": times,
    }


def check_rmsnorm_kernel():
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    h = 4096
    scale = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf)
    errs = {}
    for n in (4, 4 * 64):
        x = torch.randn(n, h, generator=gen, device="cuda").to(bf)
        got = rms.fused_rms_norm(x, scale, 1e-5)
        ref = rms.rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        errs[f"n{n}"] = (got.float() - ref.float()).abs().max().item()
        check(errs[f"n{n}"] <= BF16_TOL, f"K2 n={n}: {errs[f'n{n}']}")
    say("kernel_check_rmsnorm", max_abs_err=errs, tol=BF16_TOL)

    n = 4  # a decode step's rows at b = 4
    pick = rotating(lambda i: torch.randn(n, h, generator=gen,
                                          device="cuda").to(bf), 64)
    eager_ms = time_ms(lambda: rms.fused_rms_norm(pick(), scale, 1e-5))
    kernel_ms = device_ms(lambda: rms.fused_rms_norm(pick(), scale, 1e-5))
    plain_ms = device_ms(lambda: rms.rms_norm(pick(), scale, 1e-5))
    lib = getattr(torch.nn.functional, "rms_norm", None)
    library_ms = None if lib is None else device_ms(
        lambda: lib(pick(), (h,), scale, 1e-5))
    nbytes = 2 * n * h * 2 + h * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
        4 * n * h / FP32_FLOPS * 1e3
    return {
        "name": "rmsnorm_fwd", "route": "triton",
        "source": "megatron_llm_tpu_torch/ops/rmsnorm.py",
        "replaces": "megatron_llm_tpu/ops/rmsnorm.py:50",
        "max_abs_err": max(errs.values()), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "eager_launch_ms": eager_ms,
        "shape": f"n{n} h{h} bf16",
    }


# the engine's pool shape at the smoke's configuration: page 64, 32 pages
# (2048 positions) a slot, 8 slots. (start, chunk_len) per slot.
PAGE, SLOT_PAGES = 64, 32
PAGED_BATCHES = {
    # a decode round: caches ending on both sides of page boundaries,
    # an idle slot, the longest slot
    "decode": (1, [(0, 1), (62, 1), (63, 1), (64, 1), (699, 1),
                   (2046, 1), (0, 0), (1499, 1)]),
    # a mixed round: a first 256-token chunk, a 100-token chunk starting
    # mid-page, six decode rows padded to the chunk width
    "mixed": (256, [(0, 256), (700, 100), (1, 1), (64, 1), (130, 1),
                    (1000, 1), (2046, 1), (511, 1)]),
}


def paged_inputs(batch, g, qpk, d, gen, dtype=torch.bfloat16):
    """Inputs of one paged launch (bf16 unless `dtype`) with the chunks'
    K/V already scattered; table entries past each slot's reach are the
    null page."""
    C, spans = PAGED_BATCHES[batch]
    nc = len(spans)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    P = 1 + nc * SLOT_PAGES
    k_pages, v_pages = rnd(P, PAGE, g, d), rnd(P, PAGE, g, d)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(nc, SLOT_PAGES, dtype=torch.int32, device="cuda")
    for c, (start, ln) in enumerate(spans):
        owned = -(-max(start + ln, 1) // PAGE)
        pt[c, :owned] = perm[c * SLOT_PAGES:c * SLOT_PAGES + owned].int()
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32,
                        device="cuda")
    q = rnd(nc, C, g, qpk, d)
    pa.scatter_chunk_kv(rnd(nc, C, g, d), rnd(nc, C, g, d), k_pages,
                        v_pages, pt, starts, lens)
    return q, k_pages, v_pages, pt, starts, lens


def plant_nans(batch, k_pages, v_pages, pt):
    """NaN into the null page, every page no slot owns, and every owned
    position at or past each chunk's end."""
    owned = torch.zeros(k_pages.shape[0], dtype=torch.bool, device="cuda")
    owned[pt.long().flatten()] = True
    owned[0] = False
    k_pages[~owned] = float("nan")
    v_pages[~owned] = float("nan")
    table = pt.cpu().numpy()
    for c, (start, ln) in enumerate(PAGED_BATCHES[batch][1]):
        end = start + ln
        for j in range(end // PAGE, SLOT_PAGES):
            pg = int(table[c, j])
            if pg:
                lo = end - j * PAGE if j == end // PAGE else 0
                k_pages[pg, lo:] = float("nan")
                v_pages[pg, lo:] = float("nan")


def paged_bound_ms(batch, g, qpk, d, elt=2, peak=BF16_FLOPS):
    """The least time for one launch: the larger of the bytes it must
    move (each needed K/V position of each chunk, the valid q rows, the
    whole output; `elt` bytes an element) over 3.35 TB/s and its
    operations (4 per q row, key and head dimension over the causal
    span) over `peak` (bf16's by default)."""
    C, spans = PAGED_BATCHES[batch]
    kv_pos = sum(start + ln for start, ln in spans if ln)
    q_rows = sum(ln for _, ln in spans)
    nbytes = elt * (2 * kv_pos * g * d + q_rows * g * qpk * d
                    + len(spans) * C * g * qpk * d)
    flops = 4 * sum(start + t + 1 for start, ln in spans
                    for t in range(ln)) * qpk * g * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# (g, qpk, d) of the attention shapes K7 is held to: Llama-2-7B, Llama-2-70B
# (GQA, qpk 8) and Falcon-7B (multi-query, qpk 71: the tc design only)
PAGED_SHAPES = (("llama2_7b", (32, 1, 128)), ("llama2_70b_attn", (8, 8, 128)),
                ("falcon_7b_attn", (1, 71, 64)))


def paged_designs(qpk):
    return ("tc", "present") if qpk <= 16 else ("tc",)


def check_paged_kernel():
    """K7 in each design that takes the shape against its plain version
    on a decode and a mixed round, pad rows zeros, NaN outside the
    chunks' reach kept out; then both designs' times at the 7B shape in
    one call, beside the plain version, SDPA and the bound. Returns the
    rows of the present design and of the tc design."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {}
    for label, (g, qpk, d) in PAGED_SHAPES:
        for batch in PAGED_BATCHES:
            q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
            ref = pa._xla_paged_reference(q, kp, vp, pt, starts, lens)
            C = q.shape[1]
            pad = torch.arange(C, device="cuda")[None, :] >= lens[:, None]
            got = {}
            for design in paged_designs(qpk):
                got[design] = pa.paged_attention(q, kp, vp, pt, starts, lens,
                                                 design=design)
                torch.cuda.synchronize()
                err = (got[design].float() - ref.float()).abs().max().item()
                errs[f"{label}_{batch}_{design}"] = err
                check(err <= BF16_TOL, f"K7 {design} {label} {batch}: {err}")
                check(bool((got[design][pad] == 0).all()),
                      f"K7 {design} {label} {batch} pad rows")
            del ref
            plant_nans(batch, kp, vp, pt)
            for design in got:
                dirty = pa.paged_attention(q, kp, vp, pt, starts, lens,
                                           design=design)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dirty.float()).all())
                      and torch.equal(dirty, got[design]),
                      f"K7 {design} {label} {batch}: NaN outside the "
                      f"chunks' reach reached the output")
            del q, kp, vp, got
            torch.cuda.empty_cache()
    say("kernel_check_paged_attention", max_abs_err=errs, tol=BF16_TOL,
        nan_guard="ok")

    # time at the 7B shape, rotating over 4 input sets (the needed K/V
    # of one decode set is 73 MB, above the 50 MB L2); both designs in
    # this one call
    g, qpk, d = 32, 1, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for batch in PAGED_BATCHES:
        sets = [paged_inputs(batch, g, qpk, d, gen) for _ in range(4)]
        pick = rotating(lambda i: sets[i], 4)
        design = pa.paged_design(torch.bfloat16, torch.bfloat16, PAGE)
        eager_ms = time_ms(lambda: pa.paged_attention(*pick()))
        by_design = {
            f"{dn}_ms": device_ms(lambda: pa.paged_attention(*pick(),
                                                             design=dn))
            for dn in ("tc", "present")}
        plain_ms = device_ms(lambda: pa._xla_paged_reference(*pick()),
                             per_graph=10, replays=5)
        del sets

        # library yardstick: SDPA on K/V already gathered to the dense
        # (nc, g, T, d) view; the gather itself is left out of its time
        def dense(i):
            q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
            nc, C, gq, hq, dq = q.shape
            T = SLOT_PAGES * PAGE
            k = kp[pt.long()].reshape(nc, T, gq, dq).transpose(1, 2)
            v = vp[pt.long()].reshape(nc, T, gq, dq).transpose(1, 2)
            rows = torch.arange(C, device="cuda")
            mask = (torch.arange(T, device="cuda")[None, None, :]
                    <= (starts[:, None] + rows[None, :])[:, :, None])
            mask |= (rows[None, :, None] >= lens[:, None, None]) \
                & (torch.arange(T, device="cuda") == 0)  # pad rows: col 0
            return (q.reshape(nc, C, gq * hq, dq).transpose(1, 2),
                    k.contiguous(), v.contiguous(), mask[:, None])
        lib = rotating(dense, 4)
        library_ms = device_ms(lambda: _sdpa(sdpa, lib()))
        bound, bound_by = paged_bound_ms(batch, g, qpk, d)
        times[batch] = {"design": design, "ms": by_design[f"{design}_ms"],
                        **by_design, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library_ms,
                        "eager_launch_ms": eager_ms}
        del lib
        torch.cuda.empty_cache()
    say("kernel_time_paged_attention", **times)
    shapes = {"decode": "decode round: 8 slots C1 g32 qpk1 d128 page64 bf16 "
                        "(attended lengths 1,63,64,65,700,2047,idle,1500)",
              "mixed": "mixed round: C256, chunks 256@0 and 100@700, 6 "
                       "decode rows"}
    rows = []
    for design, name, src, main, other in (
            ("present", "ragged_paged_attention", "paged_attention.cu",
             "decode", "mixed"),
            ("tc", "ragged_paged_attention_tc", "paged_attention_tc.cu",
             "mixed", "decode")):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"megatron_llm_tpu_torch/csrc/{src}",
            "replaces": "megatron_llm_tpu/ops/prefill_attention.py:135",
            "max_abs_err": max(v for k, v in errs.items()
                               if k.endswith(design)),
            **times[main], "design": design,
            "ms": times[main][f"{design}_ms"],
            "shape": shapes[main],
            other: dict(times[other], ms=times[other][f"{design}_ms"],
                        shape=shapes[other]),
            "launches_by_path": {}, "launches": 0})
    return rows


def time_paged_fp32(kernels):
    """K7's present design at the fp32-pool engine's own shape (Llama-2-7B
    widths, fp32 q and pools, page 64, the engine's decode and mixed
    rounds): against its plain version (1e-3, the fp32 engine's log-prob
    bar), beside SDPA in fp32 on the gathered dense view and the bound
    (4-byte elements, fp32's peak: the design computes on CUDA cores)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 67)
    g, qpk, d, f32 = 32, 1, 128, torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for batch in PAGED_BATCHES:
        sets = [(paged_inputs(batch, g, qpk, d, gen, f32), dict(
            k_scales=None, v_scales=None, window=None, doc_starts=None))
            for _ in range(4)]
        design = pa.paged_design(f32, f32, PAGE)
        check(design == "present", f"K7 at fp32 pools: {design}")
        got = _launch(pa.paged_attention, sets[0])
        ref = _launch(pa._xla_paged_reference, sets[0])
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(err <= FP32_LP_TOL, f"K7 fp32 {batch}: {err}")
        del got, ref
        pick = rotating(lambda i: sets[i], 4)
        lib = rotating(lambda i: banded_sdpa_inputs(*sets[i]), 4)
        bound, by = paged_bound_ms(batch, g, qpk, d, elt=4, peak=FP32_FLOPS)
        out[batch] = {
            "design": design, "max_abs_err": err,
            "ms": device_ms(lambda: _launch(pa.paged_attention, pick())),
            "plain_ms": device_ms(
                lambda: _launch(pa._xla_paged_reference, pick()),
                per_graph=10, replays=5),
            "library_ms": device_ms(lambda: _sdpa(sdpa, lib())),
            "bound_ms": bound, "bound_by": by}
        del sets, pick, lib
        torch.cuda.empty_cache()
    say("kernel_time_paged_fp32", card=nvidia_smi(),
        shape=f"g{g} qpk{qpk} d{d} page{PAGE} fp32 q and pools (the fp32 "
              f"engine's rounds)", **out)
    for row in kernels:
        if row["name"] == "ragged_paged_attention":
            row["fp32_engine_shape"] = out


def _sdpa(sdpa, args):
    q, k, v, mask = args
    return sdpa(q, k, v, attn_mask=mask)


# K7's variants beside fp pools: (int8 pools, window, document floors).
# The window binds on the longer slots of both batches; "window_covering"
# reaches past every slot and must launch bitwise the fp kernel.
WINDOW = 1024
K7_VARIANTS = {"int8": (True, None, False), "window": (False, WINDOW, False),
               "window_covering": (False, 4096, False),
               "int8_window": (True, WINDOW, False),
               "doc": (False, None, True)}
# three packed documents over slot 0's pages: [0, 700), [700, 1500),
# [1500, 2048); per batch (chunk width, [(start, chunk_len, doc floor)])
PACKED_DOCS = {
    "decode": (1, [(699, 1, 0), (1499, 1, 700), (2047, 1, 1500)]),
    "mixed": (256, [(444, 256, 0), (1244, 256, 700), (1500, 256, 1500)]),
}


def variant_inputs(batch, variant, g, qpk, d, gen):
    """(args, kw) of one K7 launch of `variant` on `batch`: the fp inputs
    of `paged_inputs` with their pools quantized for int8 (the chunks'
    K/V scattered again through the quantizing scatter), or for "doc"
    the three packed documents over one slot's pages."""
    int8, window, doc = K7_VARIANTS[variant]
    if doc:
        C, spans = PACKED_DOCS[batch]
        nc = len(spans)
        P = 1 + nc * SLOT_PAGES  # room for `plant_nans_below` to unshare

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        k_pages, v_pages = rnd(P, PAGE, g, d), rnd(P, PAGE, g, d)
        pt = (torch.randperm(SLOT_PAGES, generator=gen, device="cuda")
              + 1).int()[None].repeat(nc, 1).contiguous()
        starts, lens, floors = (torch.tensor(
            [x[i] for x in spans], dtype=torch.int32, device="cuda")
            for i in range(3))
        q = rnd(nc, C, g, qpk, d)
        pa.scatter_chunk_kv(rnd(nc, C, g, d), rnd(nc, C, g, d), k_pages,
                            v_pages, pt, starts, lens)
        return (q, k_pages, v_pages, pt, starts, lens), dict(
            k_scales=None, v_scales=None, window=window, doc_starts=floors)
    q, kp, vp, pt, starts, lens = paged_inputs(batch, g, qpk, d, gen)
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = quantize_rows(kp), quantize_rows(vp)
        C = q.shape[1]
        pa.scatter_chunk_kv(*(torch.randn(len(starts), C, g, d,
                                          generator=gen, device="cuda")
                              .to(torch.bfloat16) for _ in range(2)),
                            kp, vp, pt, starts, lens, ks, vs)
    return (q, kp, vp, pt, starts, lens), dict(
        k_scales=ks, v_scales=vs, window=window, doc_starts=None)


def paged_exact(q, k_pages, v_pages, page_table, starts, chunk_lens,
                k_scales=None, v_scales=None, window=None, doc_starts=None,
                pv_terms=None):
    """K7's function in float64 (pools dequantized exactly, the softmax
    and both products in float64): the answer both designs and the plain
    version round, to hold their errors against. With int8 pools and
    `pv_terms`, the PV product instead takes p * v_scale (p before its
    normalisation) as the sum of `pv_terms` bf16 terms, each the bf16
    rounding of what the terms before it left, times the raw integer V,
    as the tc design's wgmmas do: 3 terms keep fp32's 24 significant
    bits, 1 is a single bf16 operand (the control that the error check
    must catch)."""
    nc, C, g, qpk, d = q.shape
    P = k_pages.shape[1]
    T = page_table.shape[1] * P
    pt = page_table.long()
    k, v = k_pages[pt].double(), v_pages[pt].double()
    if k_scales is not None:
        k = k * k_scales[pt].double()[..., None]
        vs = v_scales[pt].double().reshape(nc, T, g).transpose(1, 2)
        if pv_terms is None:
            v = v * v_scales[pt].double()[..., None]
    k = k.reshape(nc, T, g, d).transpose(1, 2)
    v = v.reshape(nc, T, g, d).transpose(1, 2)
    tok = torch.arange(C * qpk, device=q.device) // qpk
    pos = starts.long()[:, None] + tok[None, :]
    cols = torch.arange(T, device=q.device)[None, None, :]
    mask = cols > pos[:, :, None]
    lo = pa._row_floors(starts, C, qpk, window, doc_starts)
    if lo is not None:
        mask = mask | (cols < lo[:, :, None])
    qb = q.double().permute(0, 2, 1, 3, 4).reshape(nc, g, C * qpk, d)
    s = (qb @ k.transpose(-1, -2)) / d ** 0.5
    s = s.masked_fill(mask[:, None], float("-inf"))
    if pv_terms is None:
        # rows that see nothing (pad rows) come out zero
        out = torch.softmax(s, -1).nan_to_num(0.0) @ v
    else:
        p = (s - s.amax(-1, keepdim=True)).exp().nan_to_num(0.0)
        left, pv = p * vs[:, :, None, :].nan_to_num(0.0), 0.0
        for _ in range(pv_terms):
            term = left.to(torch.bfloat16).double()
            pv, left = pv + term, left - term
        out = (pv @ v) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = out.masked_fill(~(tok[None, :] < chunk_lens[:, None])[:, None, :,
                                                                  None], 0)
    return out.reshape(nc, g, C, qpk, d).permute(0, 2, 1, 3, 4)


def nearest_bf16(x):
    """float64 `x` rounded to the nearest bf16 (torch converts through
    fp32, rounding twice): the better of the converted value and its two
    bf16 neighbours."""
    best = x.to(torch.bfloat16)
    bits = best.view(torch.int16)
    for step in (-1, 1):
        c = (bits + step).view(torch.bfloat16)
        closer = (torch.isfinite(c) & (x != 0)
                  & ((c.double() - x).abs() < (best.double() - x).abs()))
        best = torch.where(closer, c, best)
    return best


def misrounded(x, exact_bf16):
    """Elements of a bf16 output that differ from the correctly rounded
    exact answer: a count that falls to the few whose exact value lies
    within the design's own error of a rounding boundary, so it grows
    with any precision the design loses before the output's rounding
    (a max-abs error is set by the largest output's rounding instead)."""
    return int((x != exact_bf16).sum().item())


def chunk_floors(args, kw):
    """Each chunk's lowest attendable position (its first row's floor)."""
    starts = args[4].tolist()
    lo = [0] * len(starts)
    if kw["window"]:
        lo = [max(0, s - kw["window"] + 1) for s in starts]
    if kw["doc_starts"] is not None:
        lo = [max(a, b) for a, b in zip(lo, kw["doc_starts"].tolist())]
    return lo


def plant_nans_below(args, kw):
    """NaN at every position below each chunk's floor (in the scale pools
    of int8 pools), table entries of pages wholly below it reclaimed to
    the null page, and NaN in the null page. Packed documents first get
    private copies of their shared pages (same values, so the clean
    output stands), since one document's floor lies above another's
    positions."""
    q, kp, vp, pt, starts, lens = args
    targets = (kw["k_scales"], kw["v_scales"]) if kw["k_scales"] \
        is not None else (kp, vp)
    if kw["doc_starts"] is not None:
        for c in range(1, pt.shape[0]):
            own = torch.arange(1 + c * SLOT_PAGES, 1 + (c + 1) * SLOT_PAGES,
                               dtype=torch.int32, device="cuda")
            for x in (kp, vp):
                x[own.long()] = x[pt[c].long()]
            pt[c] = own
    table = pt.cpu().numpy()
    for c, lo in enumerate(chunk_floors(args, kw)):
        for j in range(-(-lo // PAGE)):
            pg = int(table[c, j])
            for x in targets:
                x[pg, :min(PAGE, lo - j * PAGE)] = float("nan")
        pt[c, :lo // PAGE] = 0
    for x in targets:
        x[0] = float("nan")


def variant_bound_ms(args, kw):
    """Least time of one variant launch: the bytes of each chunk's needed
    K/V positions ([floor, start + len), with the scales for int8: (d +
    4) / (2 d) of the bf16 bytes), its valid q rows and the whole output
    over 3.35 TB/s, or its operations over the bf16 peak, whichever is
    larger."""
    q, kp = args[0], args[1]
    nc, C, g, qpk, d = q.shape
    starts, lens = args[4].tolist(), args[5].tolist()
    per_pos = 2 * g * ((d + 4) if kw["k_scales"] is not None else 2 * d)
    nbytes, flops = 0, 0
    for lo, s, n in zip(chunk_floors(args, kw), starts, lens):
        if not n:
            continue
        nbytes += per_pos * (s + n - lo) + 2 * n * g * qpk * d
        for t in range(n):
            row_lo = lo if not kw["window"] else max(lo, s + t
                                                     - kw["window"] + 1)
            flops += 4 * (s + t + 1 - row_lo) * qpk * g * d
    nbytes += 2 * nc * C * g * qpk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def banded_sdpa_inputs(args, kw):
    """The library yardstick of a variant with floors: SDPA on K/V
    gathered to the dense (nc, g, T, d) view with the band (window or
    document) mask; pad rows keep column 0 so no row is empty."""
    q, kp, vp, pt, starts, lens = args
    nc, C, g, qpk, d = q.shape
    T = pt.shape[1] * PAGE
    k = kp[pt.long()].reshape(nc, T, g, d).transpose(1, 2).contiguous()
    v = vp[pt.long()].reshape(nc, T, g, d).transpose(1, 2).contiguous()
    rows = torch.arange(C, device="cuda")
    pos = (starts[:, None] + rows[None, :])[:, :, None]
    cols = torch.arange(T, device="cuda")[None, None, :]
    lo = torch.zeros_like(pos)
    if kw["window"]:
        lo = pos - kw["window"] + 1
    if kw["doc_starts"] is not None:
        lo = torch.maximum(lo, kw["doc_starts"][:, None, None])
    mask = (cols <= pos) & (cols >= lo)
    mask |= (rows[None, :, None] >= lens[:, None, None]) & (cols == 0)
    return (q.reshape(nc, C, g * qpk, d).transpose(1, 2), k, v,
            mask[:, None])


# input draws whose misrounded elements an int8 row's check sums: a decode
# round holds 32768 output elements, about ten of them misrounded by a
# design that keeps p in fp32 (H100), too few for a ratio to mean much
INT8_ERROR_DRAWS = {"decode": 8, "mixed": 1}


def int8_errors(draws):
    """The int8 tc design's error beside the present design's on the same
    inputs, summed over `draws` ((args, kw, tc output, plain output) of
    one int8 row): the elements each output rounds otherwise than the
    exact (float64) answer correctly rounded (`misrounded`), for tc,
    present, the plain version and two controls computed in float64 with
    p * v_scale cut to one bf16 term (a bf16 p operand: the precision the
    tc design must not lose) and to two (a hi/lo pair); and each design's
    largest max-abs error against the plain version, which the output's
    rounding at its largest elements sets."""
    names = ("tc", "present", "plain", "control_bf16_p_vs", "control_hi_lo")
    count = dict.fromkeys(names, 0)
    vs_plain = {"tc": 0.0, "present": 0.0}
    for args, kw, got, ref in draws:
        exact = nearest_bf16(paged_exact(*args, **kw))
        outs = {"tc": got, "plain": ref,
                "present": pa.paged_attention(*args, **kw, design="present")}
        for name, terms in (("control_bf16_p_vs", 1), ("control_hi_lo", 2)):
            outs[name] = paged_exact(*args, **kw, pv_terms=terms).to(
                torch.bfloat16)
        for name, x in outs.items():
            count[name] += misrounded(x, exact)
        for name in vs_plain:
            vs_plain[name] = max(vs_plain[name], (
                outs[name].float() - ref.float()).abs().max().item())
        del exact, outs
    return {"draws": len(draws), "elements": sum(d[2].numel()
                                                 for d in draws),
            "misrounded": count, "max_abs_vs_plain": vs_plain,
            "max_abs_within_twice_present": vs_plain["tc"]
            <= 2 * vs_plain["present"]}


def check_paged_variants(k7_row):
    """K7's int8 epilogue and lower bounds at the engine's pool shape (8
    slots, g 32, d 128, page 64, 2048 positions a slot), on a decode and a
    mixed batch: int8 pools, a binding window of 1024, a covering window
    (bitwise the fp launch), int8 with the window, and three packed
    documents over one slot's pages, each against its plain version
    (bf16 output, fp32 accumulation, max-abs 2e-2 as for K4) in the
    design `paged_design` picks (bf16 pools: tc for the mixed rounds);
    int8 rows also by `int8_errors`: tc's misrounded elements at most
    twice the present design's, and each control's above that bar.
    NaN below each chunk's floor must not reach the output. Then each
    variant's time beside its bound, plain version and library call, and
    for bf16 pools both designs' times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    g, qpk, d = 32, 1, 128
    errs, int8_errs = {}, {}
    for variant in K7_VARIANTS:
        for batch in PAGED_BATCHES:
            args, kw = variant_inputs(batch, variant, g, qpk, d, gen)
            got = pa.paged_attention(*args, **kw)
            ref = pa._xla_paged_reference(*args, **kw)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"K7 {variant} output dtype")
            err = (got.float() - ref.float()).abs().max().item()
            errs[f"{variant}_{batch}"] = err
            check(err <= BF16_TOL, f"K7 {variant} {batch}: {err}")
            if K7_VARIANTS[variant][0]:
                check(pa.paged_design(args[0].dtype, args[1].dtype, PAGE)
                      == "tc", f"K7 {variant}: int8 pools not on tc")
                draws = [(args, kw, got, ref)]
                for _ in range(INT8_ERROR_DRAWS[batch] - 1):
                    a, k = variant_inputs(batch, variant, g, qpk, d, gen)
                    draws.append((a, k, pa.paged_attention(*a, **k),
                                  pa._xla_paged_reference(*a, **k)))
                e = int8_errors(draws)
                del draws
                int8_errs[f"{variant}_{batch}"] = e
                n = e["misrounded"]
                check(n["tc"] <= 2 * n["present"],
                      f"K7 {variant} {batch}: tc misrounds {n['tc']} "
                      f"elements, more than twice the present design's "
                      f"{n['present']}")
                for control in ("control_bf16_p_vs", "control_hi_lo"):
                    check(n[control] > 2 * n["present"],
                          f"K7 {variant} {batch}: the {control} control "
                          f"passes the error check ({n}): it is blind")
            if variant == "window_covering":
                plain_fp = pa.paged_attention(*args)
                check(torch.equal(got, plain_fp),
                      f"K7 covering window {batch} is not bitwise no window")
            if kw["window"] or kw["doc_starts"] is not None:
                plant_nans_below(args, kw)
                dirty = pa.paged_attention(*args, **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dirty.float()).all())
                      and torch.equal(dirty, got),
                      f"K7 {variant} {batch}: NaN below the floor reached "
                      f"the output")
    say("kernel_check_paged_variants", max_abs_err=errs, tol=BF16_TOL,
        int8_tc_vs_present=int8_errs, nan_below_floor="ok",
        covering_window_bitwise=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    # (row, variant, (g, qpk, d)): the engine's widths, and int8 pools at
    # Llama-2-70B's attention widths (qpk 8)
    timed = [(v, v, (g, qpk, d)) for v in ("int8", "window", "int8_window",
                                           "doc")]
    timed.append(("int8_llama2_70b_attn", "int8", (8, 8, 128)))
    for row_name, variant, (tg, tq, td) in timed:
        times = {}
        for batch in PAGED_BATCHES:
            sets = [variant_inputs(batch, variant, tg, tq, td, gen)
                    for _ in range(4)]
            pick = rotating(lambda i: sets[i], 4)
            kernel_ms = device_ms(lambda: _launch(pa.paged_attention, pick()))
            # both designs in turns: tc, present, present, tc
            by_design = {}
            for dn in ("tc", "present", "present", "tc"):
                by_design.setdefault(f"{dn}_ms", []).append(device_ms(
                    lambda: _launch(pa.paged_attention, pick(), design=dn)))
            by_design = {k: min(v) for k, v in by_design.items()}
            plain_ms = device_ms(
                lambda: _launch(pa._xla_paged_reference, pick()),
                per_graph=10, replays=5)
            library_ms = None  # int8: no one library call reads int8 K/V
            if not K7_VARIANTS[variant][0]:
                lib = rotating(lambda i: banded_sdpa_inputs(*sets[i]), 4)
                library_ms = device_ms(lambda: _sdpa(sdpa, lib()))
                del lib
            bound, bound_by = variant_bound_ms(*sets[0])
            q0, kp0 = sets[0][0][:2]
            times[batch] = {"ms": kernel_ms, **by_design,
                            "design": pa.paged_design(q0.dtype, kp0.dtype,
                                                      PAGE),
                            "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": bound_by,
                            "library_ms": library_ms}
            del sets
            torch.cuda.empty_cache()
        rows[row_name] = dict(
            times["decode"], mixed=times["mixed"],
            shape=f"g{tg} qpk{tq} d{td}",
            max_abs_err=max(errs[f"{variant}_{b}"] for b in PAGED_BATCHES))
    say("kernel_time_paged_variants", **rows)
    k7_row["variants"] = rows
    k7_row["variant_shape"] = (
        "as the K7 row; int8 pools with (P, 64, 32) fp32 scale pools; "
        f"window {WINDOW}; doc: three packed documents over one slot's "
        "pages, decode rows at 699/1499/2047 and 256-token chunks")


def _launch(fn, inputs, **extra):
    args, kw = inputs
    return fn(*args, **kw, **extra)


# ---------------------------------------------------------------------------
# phases 4-7: Llama-2-7B on the whole-batch route
# ---------------------------------------------------------------------------


def busy_window(fn):
    """`fn()` under torch.profiler with CUDA activity only (the host's
    launches pay no per-op recording): (its result, wall s, the card's
    busy s in that window: the union of its kernels' and copies'
    intervals; None when the trace shows no device activity)."""
    out, wall, events = cuda_trace(fn)
    return out, wall, (busy_ms(events) / 1e3 if events else None)


def replay_ms(fn, n=20):
    """Mean ms per call of `fn` (a graph replay) on CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def whole_batch_timing(model, params, toks, lens, kw, eager=False):
    """A `generate_tokens` call (captured, or `_eager`) at shapes the
    caller has run already (phase 5's requests, or the eager call before
    the captured one), timed: wall ms, the prefill forward's ms alone,
    the call's capture seconds (its warm-up steps included; 0 eager),
    decode steps and ms per step (wall less prefill and capture); then
    the same call again under torch.profiler: its wall, the card's busy
    ms in it, the idle share 1 - busy/wall of that traced window and,
    beside it, over the timed call's wall (the trace slows the host's
    side: the lower bound). Returns (record, output)."""
    def call():
        return generate_tokens(model, params, toks, lens, _eager=eager,
                               **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = decode_log[-1]
    _, p_wall, busy = busy_window(call)
    with torch.inference_mode():
        dp = model.prepare_decode_params(params)
        caches = model.init_kv_caches(*toks.shape)
        prefix = torch.from_numpy(toks[:, :kw["prefill_len"]]).long().cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(dp, prefix, kv_caches=caches)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
    capture = rec["capture_s"]
    return {"wall_ms": wall * 1e3, "prefill_ms": prefill * 1e3,
            "capture_ms": capture * 1e3,
            "static_cache_bytes": rec["cache_bytes"],
            "decode_steps": rec["steps"],
            "decode_ms_per_step": (wall - prefill - capture)
            / rec["steps"] * 1e3,
            "profiled_wall_ms": p_wall * 1e3,
            "device_busy_ms": busy * 1e3 if busy else "not measured",
            "device_idle_share_traced": 1 - busy / p_wall if busy
            else "not measured",
            "device_idle_share_untraced_wall": 1 - busy / wall if busy
            else "not measured",
            "captured": rec["captured"]}, out


def put(port, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    check(resp.status == 200, f"PUT {list(payload)} -> {resp.status} {body}")
    return body


def build_model(init_std):
    """Llama-2-7B at full width and depth, bf16 weights drawn on the card
    from SEED; built once and served by both routes."""
    t0 = time.perf_counter()
    cfg = llama_config(7, params_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16, use_fused_rmsnorm=True,
                       init_method_std=init_std)
    model = LlamaModel(cfg)
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    say("model", config="llama2-7b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
        ffn=cfg.ffn_hidden_size, vocab=cfg.padded_vocab_size,
        init_std=init_std, weight_bytes=weight_bytes,
        init_s=round(time.perf_counter() - t0, 2))
    return cfg, model, params, weight_bytes


def serve_whole_batch(kernels, cfg, model, params, weight_bytes):
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    server = MegatronServer(model, params, tok, engine=None)
    server.run("127.0.0.1", 0, block=False)
    port = server._httpd.server_address[1]
    rs = np.random.RandomState(SEED)
    lens = [20, 75, 130, 200]
    prompts = [" ".join(map(str, rs.randint(0, 31999, n))) for n in lens]
    try:
        zero_counts()

        # greedy batch: each decode step one replay of a captured graph
        decode_log.clear()
        t_req = time.perf_counter()
        greedy = put(port, {"prompts": prompts, "tokens_to_generate": 64,
                            "logprobs": True, "top_k": 1})
        t_req = time.perf_counter() - t_req
        calls = list(decode_log)
        steps = sum(r["steps"] for r in calls)
        warm = sum(r["warmup_steps"] for r in calls)
        k1_greedy = dec.decode_attention.launches
        check(len(calls) == 1 and calls[0]["captured"] and steps > 0,
              f"the whole-batch decode did not replay a captured step: "
              f"{calls}")
        check(k1_greedy == cfg.num_layers * (steps + warm),
              f"K1 launches {k1_greedy} != {cfg.num_layers} x ({steps} "
              f"replayed + {warm} warm-up steps)")
        out_ids = [list(map(int, t.split())) for t in greedy["text"]]
        for ids, n, p in zip(out_ids, lens, prompts):
            check(ids[:n] == list(map(int, p.split())), "prompt echoed")
            check(n < len(ids) <= n + 64, f"greedy length {len(ids)}")
            check(len(ids) == n + 64 or ids[-1] == tok.eod,
                  "row ended short without eod")
        lp = np.asarray(greedy["logprobs"], np.float64)
        check(lp.shape == (4, 319) and np.isfinite(lp).all(),
              f"greedy logprobs {lp.shape}")

        sampled = put(port, {"prompts": prompts[:2], "tokens_to_generate": 32,
                             "top_p": 0.9, "random_seed": 1234})
        for t, n in zip(sampled["text"], lens):
            check(n < len(t.split()) <= n + 32, "sampled length")
        scored = put(port, {"prompts": prompts, "tokens_to_generate": 0,
                            "logprobs": True})
        check(np.isfinite(np.asarray(scored["logprobs"])).all(), "scores")
        check([len(t.split()) for t in scored["text"]] == lens, "score echo")
        beam = put(port, {"prompts": prompts[:1], "tokens_to_generate": 16,
                          "beam_width": 2})
        check(len(beam["text"]) == 2 and len(beam["scores"]) == 2
              and all(lens[0] < len(t.split()) <= lens[0] + 16
                      for t in beam["text"]), "beam answer")
        launches = {"decode_attention": dec.decode_attention.launches,
                    "rmsnorm_fwd": rms.fused_rms_norm.launches,
                    "flash_fwd": fa.flash_fwd.launches}
        check(all(v > 0 for v in launches.values()), f"launches {launches}")
        # the score-only request's no-cache forward is the only one: one
        # flash forward per layer, no backward
        check(launches["flash_fwd"] == cfg.num_layers
              and fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == 0,
              f"flash launches {launches}")
        say("serving", requests=["greedy", "sampled", "score", "beam"],
            greedy_decode_steps=steps, greedy_warmup_steps=warm,
        decode_attention_launches_greedy=k1_greedy,
            launches=launches, greedy_request_s=round(t_req, 3))
    finally:
        server.stop()
    for row in kernels:
        if row["name"] in launches:
            by = row.setdefault("launches_by_path", {})
            by["whole_batch"] = launches[row["name"]]
            row["launches"] = sum(by.values())

    # phase 6: the greedy output teacher-forced back through the same
    # cached decode path (same prefill bucket, same GEMM shapes) with both
    # kernels off, so that the kernels are the only difference
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
    n_out = [len(ids) for ids in out_ids]
    buf = np.full((4, lp.shape[1] + 1), tok.eod, np.int64)
    for i, ids in enumerate(out_ids):
        buf[i, :len(ids)] = ids
    kw = dict(prefill_len=bucket_prefill_len(min(lens)), top_k=1,
              vocab_size=tok.vocab_size, termination_id=tok.eod)
    forced = generate_tokens(plain, params, buf, np.asarray(n_out),
                             return_log_probs=True, **kw)
    forced = forced.log_probs.cpu().numpy()
    err = max(np.abs(forced[i, :n - 1] - lp[i, :n - 1]).max()
              for i, n in enumerate(n_out))
    toks0, lens0 = tokenize_prompts(tok, prompts, 64)
    # for information: the no-cache full forward (other GEMM shapes, so
    # other bf16 rounding) against the served log-probs
    full = score_tokens(plain, params, buf[:, :max(n_out)]).cpu().numpy()
    full_err = max(np.abs(full[i, :n - 1] - lp[i, :n - 1]).max()
                   for i, n in enumerate(n_out))
    say("path_check", max_abs_logprob_err=float(err), tol=PATH_LP_TOL,
        full_forward_max_abs_logprob_err=float(full_err))
    check(err <= PATH_LP_TOL, f"re-scored logprobs {err}")

    # phase 7: throughput of the greedy batch, run again outside the
    # server with the kernels on, warm (cuBLAS and Triton have seen these
    # shapes, the step is captured)
    rec, _ = whole_batch_timing(model, params, toks0, lens0, kw)
    # the card's own time for one decode forward alone: a single-token 7B
    # forward (kernels on, cache length 300 of 320) captured in a graph
    with torch.inference_mode():
        dp = model.prepare_decode_params(params)
        caches = dict(model.init_kv_caches(4, toks0.shape[1]), offset=299)
        tok1 = torch.from_numpy(toks0[:, 299:300]).long().to(model.device)
        forward_device_ms = device_ms(
            lambda: model.forward(dp, tok1, kv_caches=caches),
            per_graph=4, replays=5)
    wall = rec["wall_ms"] / 1e3
    say("throughput", batch=4, prefill_tokens=kw["prefill_len"],
        decode_steps=rec["decode_steps"], prefill_ms=rec["prefill_ms"],
        capture_ms=rec["capture_ms"],
        decode_ms_per_step=rec["decode_ms_per_step"],
        decode_forward_device_ms=forward_device_ms,
        profiled_call_wall_ms=rec["profiled_wall_ms"],
        profiled_call_device_busy_ms=rec["device_busy_ms"],
        profiled_call_device_idle_share=rec["device_idle_share_traced"],
        device_idle_share_untraced_wall=rec[
            "device_idle_share_untraced_wall"],
        weight_stream_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        generate_s=wall, requested_tokens_per_s=4 * 64 / wall,
        decoded_tokens_per_s=4 * rec["decode_steps"] / (
            wall - rec["prefill_ms"] / 1e3 - rec["capture_ms"] / 1e3),
        static_cache_bytes=rec["static_cache_bytes"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return toks0, lens0, kw


# ---------------------------------------------------------------------------
# phases 8-10: Llama-2-7B on the continuous-batching route
# ---------------------------------------------------------------------------


def paged_forwards(rounds):
    """The paged forwards an engine's rounds ran (a decode round one a
    step of its horizon, a mixed or verify round one), from its round
    log: replayed graphs call no Python forward to count."""
    return sum(r["decode_steps"] for r in rounds)


def put_raw(port, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    if payload.get("stream"):
        return resp.status, [json.loads(line[6:]) for line in
                             data.splitlines() if line.startswith("data: ")]
    return resp.status, json.loads(data)


def get_text(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    check(resp.status == 200, f"GET {path} -> {resp.status}")
    return body


def post_json(port, path, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    return resp.status, body


def get_json(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    check(resp.status == 200, f"GET {path} -> {resp.status}")
    return body


def engine_traffic():
    """(name, prompt ids, payload) of the 16 engine requests: 12 greedy
    with log-probs (prompts 20-1500 ids, 64-128 new tokens), two that
    share a 700-token prefix (the second is sent once the first is
    answered, so its pages are registered), one sampled, one streamed."""
    rs = np.random.RandomState(SEED + 7)

    def ids(n):
        return [int(x) for x in rs.randint(0, 31999, n)]

    def text(x):
        return " ".join(map(str, x))

    out = []
    for i, (n, gen) in enumerate(zip(
            (20, 1500, 300, 75, 900, 130, 1200, 450, 40, 640, 1000, 210),
            (128, 64, 96, 80, 72, 112, 64, 100, 120, 88, 76, 104))):
        p = ids(n)
        out.append((f"greedy{i}", p, {"prompts": [text(p)], "top_k": 1,
                                      "tokens_to_generate": gen,
                                      "logprobs": True}))
    prefix = ids(700)
    for name, tail in (("shared_a", 40), ("shared_b", 20)):
        p = prefix + ids(tail)
        out.append((name, p, {"prompts": [text(p)], "top_k": 1,
                              "tokens_to_generate": 64}))
    out[-2][2]["then"] = "shared_b"  # sent once shared_a is answered
    p = ids(180)
    out.append(("sampled", p, {"prompts": [text(p)], "top_p": 0.9,
                               "random_seed": 1234,
                               "tokens_to_generate": 64}))
    p = ids(250)
    out.append(("stream", p, {"prompts": [text(p)], "top_k": 1,
                              "tokens_to_generate": 96, "stream": True}))
    return out


def engine_kwargs(tok, **over):
    """The launcher's defaults: 8 slots, page 64, max_context 2048,
    horizon 8, chunks of 256, prefix cache; every round bucket captured
    at `start()` (`warmup_compile`)."""
    kw = dict(slots=8, page_size=64, max_context=2048, step_horizon=8,
              prefill_chunk_tokens=256, prefix_cache=True,
              termination_id=tok.eod, vocab_size=tok.vocab_size,
              warmup_compile=True)
    kw.update(over)
    return kw


def drive_engine(eng, model, tok, params, traffic):
    """The traffic from concurrent client threads through
    `MegatronServer(engine=eng)` (a "then" request is sent once the one
    before it is answered), with every launch count set to 0 just before
    and read just after. Returns the run's record."""
    server = MegatronServer(model, params, tok, engine=eng)
    server.run("127.0.0.1", 0, block=False)
    port = server._httpd.server_address[1]
    results = {}
    then = {name: payload["then"] for name, _, payload in traffic
            if "then" in payload}
    by_name = {name: payload for name, _, payload in traffic}

    def client(name):
        payload = {k: v for k, v in by_name[name].items() if k != "then"}
        results[name] = put_raw(port, payload)
        if name in then:
            client(then[name])

    try:
        zero_counts()
        threads = [threading.Thread(target=client, args=(name,))
                   for name, _, _ in traffic if name not in then.values()]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_start
        launches = kernel_counts()
        variants = dict(pa.ragged_paged_attention.variant_launches)
        check(all(not th.is_alive() for th in threads), "engine clients hung")
        metrics = get_json(port, "/metrics")
    finally:
        server.stop()
    rounds = list(eng._round_log)
    return {"results": results, "launches": launches, "variants": variants,
            "metrics": metrics, "wall": wall,
            "paged": paged_forwards(rounds), "rounds": rounds,
            "graphs": eng.graph_stats()}


def check_outputs(traffic, run, tok):
    """Every answer echoes its prompt and stops at its budget or eod;
    returns (generated tokens, [(name, prompt, out, log-probs)] of the
    requests that asked for log-probs)."""
    generated, scored = 0, []
    for name, prompt, payload in traffic:
        status, body = run["results"][name]
        check(status == 200, f"engine {name} -> {status} {body}")
        gen = payload["tokens_to_generate"]
        if payload.get("stream"):
            toks = [e["token"] for e in body[:-1]]
            final = body[-1]
            check(final.get("done") and final["tokens"] == toks
                  and final["text"] == " ".join(map(str, prompt + toks)),
                  "SSE tokens equal the final text")
            out = prompt + toks
        else:
            out = list(map(int, body["text"][0].split()))
        check(out[:len(prompt)] == prompt, f"{name}: prompt echoed")
        check(len(prompt) < len(out) <= len(prompt) + gen
              and (len(out) == len(prompt) + gen or out[-1] == tok.eod),
              f"{name}: length {len(out)}")
        generated += len(out) - len(prompt)
        if payload.get("logprobs"):
            lp = body["logprobs"][0]
            check(len(lp) == len(out) - 1 and np.isfinite(lp).all(),
                  f"{name}: logprobs")
            scored.append((name, prompt, out, lp))
    return generated, scored


def check_paged_launches(cfg, run, label, variant=None, tc=True):
    """K7 ran once per layer per paged forward (under `variant` every
    time, when given), every launch in the tc design when `tc` (bf16 q
    with bf16 or int8 pools of page 64) and in the present design
    otherwise (fp32 pools); K2 ran, K1 and K4 did not."""
    k7 = run["launches"]["ragged_paged_attention"]
    check(k7 == cfg.num_layers * run["paged"] and k7 > 0,
          f"{label}: K7 launches {k7} != {cfg.num_layers} x {run['paged']} "
          f"paged forwards")
    if variant is not None:
        check(run["variants"][variant] == k7,
              f"{label}: K7 {variant} launches {run['variants']}")
    v = run["variants"]
    check(v["tc" if tc else "present"] == k7, f"{label}: K7 designs {v}")
    check(run["launches"]["rmsnorm_fwd"] > 0, f"{label}: K2 did not run")
    check(run["launches"]["decode_attention"] == 0, f"{label}: K1 ran")
    check(run["launches"]["flash_fwd"] == 0, f"{label}: K4 ran")


K7_ROWS = {"ragged_paged_attention": "present",
           "ragged_paged_attention_tc": "tc"}


def note_launches(kernels, path, run):
    """Add one engine path's launches to the K2 row and to K7's two rows,
    each design's launches to its own row, and the path's launches by
    variant and design to the present design's row."""
    for row in kernels:
        if row["name"] == "rmsnorm_fwd":
            row["launches_by_path"][path] = run["launches"]["rmsnorm_fwd"]
            row["launches"] = sum(row["launches_by_path"].values())
        design = K7_ROWS.get(row["name"])
        if design is not None:
            row["launches_by_path"][path] = run["variants"][design]
            row["launches"] = sum(row["launches_by_path"].values())
        if design == "present":
            row.setdefault("variant_launches_by_path", {})[path] = {
                k: v for k, v in run["variants"].items() if v}


def free_cuda():
    """Return the memory of what the caller dropped (engines hold
    reference cycles, so collect first)."""
    gc.collect()
    torch.cuda.empty_cache()


def rescore(eng, scored):
    """Each (prompt, out) teacher-forced through `eng` as one prompt
    (chunked prefill, one token generated): the log-probs of out[1:]."""
    reqs = [eng.submit(out, 1, top_k=1, return_log_probs=True,
                       use_eod_for_early_termination=False)
            for _, _, out, _ in scored]
    eng.drain()
    return [r.result(60)[1][:len(out) - 1]
            for r, (_, _, out, _) in zip(reqs, scored)]


def compare_streams(ref, other):
    """Greedy agreement of two runs of the same requests: the share of
    generated positions with equal tokens, and the largest |log-prob
    difference| over each pair's common prefix (where the contexts are
    still equal)."""
    agree, total, err = 0, 0, 0.0
    for (_, prompt, a, la), (_, _, b, lb) in zip(ref, other):
        n = min(len(a), len(b))
        agree += sum(x == y for x, y in zip(a[len(prompt):n],
                                            b[len(prompt):n]))
        total += len(a) - len(prompt)
        k = next((i for i in range(n) if a[i] != b[i]), n)
        if k > 1:
            err = max(err, float(np.abs(np.asarray(la[:k - 1])
                                        - np.asarray(lb[:k - 1])).max()))
    return agree / max(total, 1), err


def decode_step_device_ms(model, eng):
    """The card's own time for one 8-slot paged decode step (slots at
    length 1000) on the engine's pools and decode tree, captured in a
    CUDA graph (the engine is stopped)."""
    with torch.inference_mode():
        pt = torch.zeros(eng.slots, eng.max_pages_per_slot,
                         dtype=torch.int32, device="cuda")
        for i in range(eng.slots):
            pt[i, :16] = torch.arange(1 + 16 * i, 17 + 16 * i)
        lens = torch.full((eng.slots,), 1000, dtype=torch.int32,
                          device="cuda")
        pools_k, pools_v, pools_ks, pools_vs = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens,
                  "chunk_lens": torch.ones_like(lens)}
        if pools_ks:
            caches["k_scales_layers"] = pools_ks
            caches["v_scales_layers"] = pools_vs
        tok1 = torch.zeros(eng.slots, 1, dtype=torch.long, device="cuda")
        return device_ms(
            lambda: model.forward(eng._dec_params, tok1, kv_caches=caches,
                                  position_ids=lens.long()[:, None]),
            per_graph=4, replays=5)


def mixed_round_device_ms(model, eng, calls=3):
    """The card's own time for one mixed round's paged forward on the
    engine's pools and decode tree (the engine is stopped): the kernel
    check's mixed batch (chunks 256@0 and 100@700, six decode rows, width
    256), the CUDA kernels' time in a torch.profiler trace, in all and
    K7's part, per forward."""
    C, spans = PAGED_BATCHES["mixed"]
    dev = eng._pools[0][0].device
    n = eng.max_pages_per_slot
    with torch.inference_mode():
        pt = (1 + torch.arange(eng.slots * n, dtype=torch.int32,
                               device=dev)).view(eng.slots, n)
        lens = torch.tensor([s for s, _ in spans], dtype=torch.int32,
                            device=dev)
        clen = torch.tensor([k for _, k in spans], dtype=torch.int32,
                            device=dev)
        pools_k, pools_v, pools_ks, pools_vs = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens, "chunk_lens": clen}
        if pools_ks:
            caches["k_scales_layers"] = pools_ks
            caches["v_scales_layers"] = pools_vs
        toks = torch.zeros(eng.slots, C, dtype=torch.long, device=dev)
        pos = lens.long()[:, None] + torch.arange(C, device=dev)[None, :]

        def forward():
            model.forward(eng._dec_params, toks, kv_caches=dict(caches),
                          position_ids=pos)
        forward()
        _, _, events = cuda_trace(lambda: [forward() for _ in range(calls)])
    kernels = kernel_totals(events)
    total = sum(kernels.values())
    k7 = sum(ms for name, ms in kernels.items() if "paged_attn" in name)
    return total / calls, k7 / calls


def ms_per_advance(rounds):
    dec = [r for r in rounds if not r["prefill_tokens"]]
    steps = sum(r["decode_steps"] for r in dec
                if "spec_emitted" not in r)
    spec = [r for r in dec if "spec_emitted" in r]
    emitted = sum(r["spec_emitted"] / max(r["decode_slots"], 1)
                  for r in spec)
    return sum(r["ms"] for r in dec) / max(steps + emitted, 1)


def serve_engine(kernels, cfg, model, params, weight_bytes):
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, **engine_kwargs(tok))
    setup_s = time.perf_counter() - t0
    traffic = engine_traffic()
    run = drive_engine(eng, model, tok, params, traffic)
    generated, greedy = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine", "fp")
    metrics = run["metrics"]
    check(metrics["serve_prefix_hits"] >= 1
          and metrics["serve_prefix_cow_copies"] >= 1,
          f"prefix hit and COW copy: {metrics}")
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"pages after the traffic: {metrics}")
    rounds = run["rounds"]
    note_launches(kernels, "engine", run)
    kernels[2]["launches_per_engine_round"] = \
        run["launches"]["ragged_paged_attention"] / len(rounds)
    say("serving_engine", requests=len(traffic), slots=eng.slots,
        paged_forwards=run["paged"], rounds=len(rounds),
        mixed_rounds=sum(1 for r in rounds if r["prefill_tokens"]),
        launches=run["launches"], setup_s=round(setup_s, 2),
        prefix_hits=metrics["serve_prefix_hits"],
        prefix_hit_tokens=metrics["serve_prefix_hit_tokens"],
        prefix_cow_copies=metrics["serve_prefix_cow_copies"],
        pages_free=metrics["serve_pages_free"],
        prefix_cached_pages=metrics["serve_prefix_cached_pages"],
        num_pages=eng.num_pages)

    # phase 9: the greedy outputs teacher-forced through the same weights
    # on the no-cache forward with both kernels off (plain RMSNorm, plain
    # attention)
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
    err, match, total = 0.0, 0, 0
    with torch.inference_mode():
        for _, prompt, out, lp in greedy:
            seq = torch.tensor(out, device="cuda")[None]
            logits, _ = plain.forward(params, seq[:, :-1])
            lps = torch.log_softmax(logits[0].float(), -1)
            forced = lps.gather(1, seq[0, 1:, None])[:, 0].cpu().numpy()
            err = max(err, float(np.abs(forced - np.asarray(lp)).max()))
            am = lps.argmax(-1).cpu().numpy()[len(prompt) - 1:]
            match += int((am == np.asarray(out[len(prompt):])).sum())
            total += len(out) - len(prompt)
    say("path_check_engine", requests=len(greedy),
        max_abs_logprob_err=err, tol=PATH_LP_TOL,
        greedy_token_match_fraction=match / total)
    check(err <= PATH_LP_TOL, f"engine re-scored logprobs {err}")

    # phase 10: throughput of the traffic, and the card's own time for one
    # 8-slot paged decode step
    dec_rounds = [r for r in rounds if not r["prefill_tokens"]]
    mixed = [r for r in rounds if r["prefill_tokens"]]
    advance = ms_per_advance(rounds)
    step_ms = decode_step_device_ms(model, eng)
    mixed_ms, mixed_k7_ms = mixed_round_device_ms(model, eng)
    say("throughput_engine", wall_s=run["wall"], generated_tokens=generated,
        generated_tokens_per_s=generated / run["wall"],
        decode_rounds=len(dec_rounds), decode_ms_per_advance=advance,
        mixed_rounds=len(mixed),
        mixed_round_ms=sum(r["ms"] for r in mixed) / max(len(mixed), 1),
        mixed_forward_device_ms=mixed_ms or "not measured",
        mixed_forward_k7_device_ms=mixed_k7_ms or "not measured",
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        ttft_p95_ms=metrics["serve_ttft_p95_ms"],
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {"greedy": greedy, "bytes_per_token": eng.kv_bytes_per_token(),
            "tokens_per_s": generated / run["wall"],
            "decode_ms_per_advance": advance, "decode_step_device_ms": step_ms}


# ---------------------------------------------------------------------------
# phase 10b: the same traffic eagerly and captured, in one call
# ---------------------------------------------------------------------------

CAPTURE_REQUESTS = 8
# the phase's depth: 2 of Llama-2-7B's 32 layers (16 before the bert
# phase, 4 before the t5 and ict phases), which keeps the whole smoke
# within its time on a slow host
CAPTURE_LAYERS = 2


def _engine_device_ms(eng, horizon=8, length=1000):
    """The card's ms for one decode round of `horizon` steps with every
    slot live at `length` (pages 1.. of the drained engine's pool): on
    an `_eager` engine the round's kernels in a torch.profiler trace;
    else the captured round's replay on CUDA events, and its kernels'
    profile. Returns (ms, top kernels, the round's host arrays, its
    runner)."""
    n, per = eng.slots, -(-(length + horizon) // eng.page_size)
    pt = np.zeros_like(eng._pt)
    for i in range(n):
        pt[i, :per] = 1 + i * per + np.arange(per)
    host = {**eng._null_scan_args(horizon), "page_table": pt,
            "lengths": np.full(n, length, np.int32),
            "active": np.ones(n, bool)}
    with torch.inference_mode():
        runner = eng._step_fn(horizon, True)
        ms, top = top_kernels(lambda: runner(**host))
        if runner.captured:
            ms = replay_ms(lambda: runner(**host), n=10)
        return ms, top, host, runner


EAGER_DECODE_ROUNDS = 4
# decode steps of the whole-batch eager-against-captured comparison
GRAPH_WB_STEPS = 64


def eager_prefix(eng):
    """Step the engine until it has run EAGER_DECODE_ROUNDS decode rounds
    (every prompt admitted by then): the eager side's share of the
    traffic. Returns the rounds run."""
    while sum(not r["prefill_tokens"] for r in eng._round_log) \
            < EAGER_DECODE_ROUNDS:
        check(eng.step(), "the engine drained before the eager prefix")
    return len(eng._round_log)


def _traced_drain(model, params, tok, traffic, eager, rounds=None):
    """The same traffic again, on a fresh engine (warmed up unless
    `eager`), drained (or stepped `rounds` rounds) under `busy_window`:
    (rounds, wall s, busy s)."""
    eng = DecodeEngine(model, params, **engine_kwargs(
        tok, warmup_compile=False))
    eng._eager = eager
    if not eager:
        eng.warmup()
    for p, g in traffic:
        eng.submit(p, g, top_k=1, return_log_probs=True)
    run = eng.drain if rounds is None else \
        (lambda: [eng.step() for _ in range(rounds)])
    _, wall, busy = busy_window(run)
    return len(eng._round_log), wall, busy


def graph_capture_phase(kernels, cfg, model, params, whole_batch):
    """Llama-2-7B widths at CAPTURE_LAYERS of its 32 layers (a view of the
    serving model's first layers): the first 8 greedy requests of
    the engine traffic queued and drained (a fixed schedule) by the bf16
    engine with every round a replayed CUDA graph, and the same queue's
    first rounds (every mixed round and EAGER_DECODE_ROUNDS decode rounds:
    the eager prefix) with every round called eagerly (the private
    `_eager`); and the whole-batch greedy batch decoded eagerly and
    captured. Gates: after the eager prefix's rounds the captured
    engine's streams equal the eager ones token for token (log-probs
    too), with equal page and prefix-cache accounting; every paged
    forward's K7 launches counted through replays; ms per decode advance
    lower captured than eager on both routes; one captured decode round
    replays under `torch.cuda.set_sync_debug_mode("error")` (its
    read-back left out). The device's busy time comes from the same
    rounds run again under torch.profiler (their count is checked): idle
    is 1 - busy/wall over that traced window, and, beside it, over the
    untraced run's wall (the trace slows the host's side of a round: the
    untraced figure is the lower bound)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    cfg, params = first_layers(cfg, params, CAPTURE_LAYERS, copy=False)
    model = LlamaModel(cfg)
    traffic = [(p, pl["tokens_to_generate"]) for name, p, pl
               in engine_traffic() if name.startswith("greedy")]
    traffic = traffic[:CAPTURE_REQUESTS]
    runs = {}
    prefix = None  # the eager prefix's rounds
    for mode in ("eager", "captured"):
        eng = DecodeEngine(model, params, **engine_kwargs(
            tok, warmup_compile=False))
        eng._eager = mode == "eager"
        free_cuda()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        if mode == "captured":
            eng.warmup()
        warmup_s = time.perf_counter() - t0
        graph_bytes = torch.cuda.memory_reserved() - reserved
        reqs = [eng.submit(p, g, top_k=1, return_log_probs=True)
                for p, g in traffic]
        zero_counts()
        t0 = time.perf_counter()
        if mode == "eager":
            prefix = eager_prefix(eng)
        else:
            for _ in range(prefix):
                eng.step()
        c = eng.counters()
        # the streams and the accounting after the eager prefix's rounds
        at_prefix = ([(list(r.tokens), list(r.log_probs or []))
                      for r in reqs],
                     ({k: c[k] for k in c if k.startswith(
                         ("serve_pages", "serve_prefix", "serve_steps",
                          "serve_prefill", "serve_admitted",
                          "serve_retired"))}, sorted(eng._free_pages)))
        if mode == "captured":
            eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = list(eng._round_log)
        mixed = [r["ms"] for r in rounds if r["prefill_tokens"]]
        run = {"at_prefix": at_prefix,
               "launches": kernel_counts(),
               "variants": dict(pa.ragged_paged_attention.variant_launches),
               "paged": paged_forwards(rounds), "wall_s": wall,
               "decode_ms_per_advance": ms_per_advance(rounds),
               "mixed_round_ms": sum(mixed) / max(len(mixed), 1),
               "rounds": len(rounds), "mixed_rounds": len(mixed)}
        if mode == "captured":
            run["outs"] = [r.result(60) for r in reqs]
            run["pages_free"] = eng.counters()["serve_pages_free"]
        check_paged_launches(cfg, run, f"graph_capture_{mode}", "fp")
        if mode == "captured":
            stats = eng.graph_stats()
            flags = (True, False)
            check(set(eng._step_fns) == {(h, f) for f in flags for h in
                                         horizon_buckets(eng.step_horizon)}
                  and set(eng._mixed_fns) == {
                      (w, f) for f in flags for w in
                      mixed_width_buckets(eng.prefill_chunk_tokens)}
                  and stats["graphs"] == len(eng._step_fns)
                  + len(eng._mixed_fns), f"graphs {stats}")
            run.update(graphs=stats["graphs"], warmup_s=warmup_s,
                       capture_s=stats["capture_s"],
                       graph_memory_reserved_bytes=graph_bytes)
        (run["decode_round_device_ms"], run["decode_round_top_kernels_ms"],
         host, runner) = _engine_device_ms(eng)
        if run["decode_round_device_ms"] is None:  # no device time traced
            run["decode_round_device_ms"] = "not measured"
        if mode == "captured":
            # the round's replay (its input copies included) under the
            # sync check; the read-back after it is the one intended sync
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.inference_mode():
                    chosen, _ = runner(**host)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(bool((chosen >= 0).all()), "sync-checked round output")
            run["sync_debug_replay"] = "ok"
        eng = runner = None
        free_cuda()
        n_rounds, t_wall, busy = _traced_drain(
            model, params, tok, traffic, mode == "eager",
            prefix if mode == "eager" else None)
        check(n_rounds == len(rounds),
              f"traced drain: {n_rounds} rounds, untraced {len(rounds)}")
        run.update(traced_wall_s=t_wall,
                   device_busy_s=busy or "not measured",
                   device_idle_share_traced=1 - busy / t_wall if busy
                   else "not measured",
                   device_idle_share_untraced_wall=1 - busy / wall if busy
                   else "not measured")
        runs[mode] = run
        free_cuda()
    e, g = runs["eager"], runs["captured"]
    (e_out, e_acc), (g_out, g_acc) = e["at_prefix"], g["at_prefix"]
    check([t for t, _ in g_out] == [t for t, _ in e_out],
          "engine: captured greedy streams differ from eager")
    lp_diff = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for (_, a), (_, b) in zip(g_out, e_out) if a), default=0.0)
    check(g_acc == e_acc, f"engine accounting {g_acc} != {e_acc}")

    toks, lens, kw = whole_batch
    # the whole-batch comparison on GRAPH_WB_STEPS decode steps of the
    # same 4 rows (a row whose prompt runs past them stays teacher-forced)
    cut = kw["prefill_len"] + GRAPH_WB_STEPS + 1
    toks, lens = toks[:, :cut], np.minimum(lens, cut)
    wb = {}
    for mode in ("eager", "captured"):
        wb[mode], out = whole_batch_timing(model, params, toks, lens, kw,
                                           eager=mode == "eager")
        wb[mode]["out"] = out
    we, wg = wb["eager"]["out"], wb["captured"]["out"]
    check(torch.equal(we.tokens, wg.tokens)
          and torch.equal(we.lengths, wg.lengths),
          "whole batch: captured tokens differ from eager")
    for rec in wb.values():
        del rec["out"]
    summary = {m: {k: v for k, v in r.items()
                   if k not in ("outs", "at_prefix")}
               for m, r in runs.items()}
    say("graph_capture", layers=CAPTURE_LAYERS, requests=len(traffic),
        engine=summary, engine_streams_equal_through_round=prefix,
        engine_accounting_equal=True,
        engine_pages_free=g["pages_free"],
        engine_logprob_max_abs_diff=lp_diff,
        whole_batch=wb, whole_batch_tokens_equal=True,
        nvidia_smi=nvidia_smi())
    check(g["decode_ms_per_advance"] < e["decode_ms_per_advance"],
          "engine: a captured decode advance is not faster than eager")
    check(wb["captured"]["decode_ms_per_step"]
          < wb["eager"]["decode_ms_per_step"],
          "whole batch: a captured step is not faster than eager")


def serve_engine_int8(kernels, cfg, model, params, bf16):
    """Llama-2-7B with int8 pools and int8 weights at the launcher's
    defaults, the same 16 requests over HTTP. Path check: the served
    outputs re-scored teacher-forced on a kernels-off int8 engine (plain
    paged attention and RMSNorm, the same quantized tree) within 5e-2.
    Printed, not gated: drift against the bf16 engine's prompt
    log-probs and greedy tokens, pool bytes per token, tokens/s."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, **engine_kwargs(
        tok, kv_dtype="int8", quantize_weights=True))
    setup_s = time.perf_counter() - t0
    traffic = engine_traffic()
    run = drive_engine(eng, model, tok, params, traffic)
    generated, scored = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine_int8", "int8")
    metrics = run["metrics"]
    check(metrics["serve_kv_dtype"] == "int8", f"kv dtype {metrics}")
    check(metrics["serve_prefix_hits"] >= 1
          and metrics["serve_prefix_cow_copies"] >= 1,
          f"int8 prefix hit and COW copy: {metrics}")
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"int8 pages after the traffic: {metrics}")
    note_launches(kernels, "engine_int8", run)
    advance = ms_per_advance(run["rounds"])
    # device ms of a decode step and of a mixed round's forward with K7's
    # tc design, the one the path ran (kernel_time_paged_variants times
    # the present design's int8 rows)
    step = decode_step_device_ms(model, eng)
    mixed, mixed_k7 = mixed_round_device_ms(model, eng)
    device = {"tc": {"decode_step_device_ms": [step],
                     "mixed_forward_device_ms": [mixed],
                     "mixed_forward_k7_device_ms": [mixed_k7]}}
    step_ms = step
    bytes_per_token = eng.kv_bytes_per_token()
    eng = None
    free_cuda()

    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    off = DecodeEngine(plain, params, **engine_kwargs(
        tok, kv_dtype="int8", quantize_weights=True, prefix_cache=False))
    # the reference's rounds run uncaptured (the private `_eager`, as in
    # graph_capture): a one-time re-score pays no capture
    off._eager = True
    forced = rescore(off, scored)
    off = None
    free_cuda()
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    prompt_drift = max(
        float(np.abs(np.asarray(lp[:len(p) - 1])
                     - np.asarray(ref[:len(p) - 1])).max())
        for (_, p, _, lp), (_, _, _, ref) in zip(scored, bf16["greedy"]))
    agree, common_err = compare_streams(bf16["greedy"], scored)
    say("serving_engine_int8", requests=len(traffic),
        paged_forwards=run["paged"], launches=run["launches"],
        k7_variant_launches=run["variants"], setup_s=round(setup_s, 2),
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        drift_vs_bf16_prompt_logprob_max_abs=prompt_drift,
        drift_vs_bf16_common_prefix_logprob_max_abs=common_err,
        greedy_token_agreement_vs_bf16=agree,
        kv_bytes_per_token=bytes_per_token,
        kv_bytes_per_token_bf16=bf16["bytes_per_token"],
        generated_tokens=generated, wall_s=run["wall"],
        generated_tokens_per_s=generated / run["wall"],
        generated_tokens_per_s_bf16=bf16["tokens_per_s"],
        decode_ms_per_advance=advance,
        decode_ms_per_advance_bf16=bf16["decode_ms_per_advance"],
        decode_step_device_ms=step_ms,
        decode_step_device_ms_bf16=bf16["decode_step_device_ms"],
        k7_design_device_ms=device,
        present_design_decode_step_device_ms_earlier="29.8-30.0 (PERF.md)",
        ttft_p50_ms=run["metrics"]["serve_ttft_p50_ms"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(err <= PATH_LP_TOL, f"int8 re-scored logprobs {err}")


WINDOW_SERVE = 1024
# the window phase's depth: 2 of Llama-2-7B's 32 layers (8 before the
# bert phase, 4 before the t5 and ict phases), which keeps the whole
# smoke within its time
WINDOW_LAYERS = 2


def window_traffic():
    """8 requests whose prompt and generation pass the window (prompts
    1500-3000 ids, 64-128 new tokens) and 4 short ones, all greedy with
    log-probs."""
    rs = np.random.RandomState(SEED + 9)
    out = []
    for i, (n, gen) in enumerate(zip(
            (1500, 3000, 2100, 1800, 2600, 1650, 2900, 2300, 40, 200, 90, 350),
            (128, 64, 96, 112, 80, 128, 72, 100, 64, 48, 96, 32))):
        out.append((f"w{i}", [int(x) for x in rs.randint(0, 31999, n)], gen))
    return out


def serve_engine_window(kernels, cfg, model, params):
    """Llama-2-7B widths at WINDOW_LAYERS of its 32 layers (a view of the
    serving model's first layers) with a window of 1024, max_context
    4096, page_budget 8 x
    the window's slot bound (168 pages): the traffic is queued on the
    engine and drained (a fixed schedule, so the two runs below compare
    bitwise). Gates: reclamation ON gives the streams of the mask-only
    OFF engine (full budget) bit for bit; pages were reclaimed; no slot
    held more than the bound; every page is back at the end; a
    teacher-forced re-score on a kernels-off windowed engine agrees
    within 5e-2."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    wcfg, params = first_layers(dataclasses.replace(
        cfg, attention_window_size=WINDOW_SERVE), params, WINDOW_LAYERS,
        copy=False)
    wmodel = LlamaModel(wcfg)
    bound = -(-(WINDOW_SERVE + 256) // 64) + 1
    kw = engine_kwargs(tok, max_context=4096, prefix_cache=False)
    traffic = window_traffic()
    reach = sum(-(-(len(p) + g) // 64) for _, p, g in traffic)

    def run(reclaim, budget):
        eng = DecodeEngine(wmodel, params, window_reclaim=reclaim,
                           page_budget=budget, **kw)
        reqs = [eng.submit(p, g, top_k=1, return_log_probs=True)
                for _, p, g in traffic]
        peak = [0]
        inner = eng._step_inner

        def step():
            did = inner()
            peak[0] = max([peak[0]] + [s.mapped - s.reclaimed
                                       for s in eng._slots])
            return did
        eng._step_inner = step
        eng.warmup()  # drained without start(): capture first
        zero_counts()
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [r.result(60) for r in reqs]
        rec = {"outs": [(list(t), list(lp)) for t, lp in outs],
               "launches": kernel_counts(),
               "variants": dict(pa.ragged_paged_attention.variant_launches),
               "paged": paged_forwards(eng._round_log),
               "rounds": list(eng._round_log),
               "wall": wall, "peak": peak[0], "counters": eng.counters(),
               "bound": eng._window_slot_pages(), "num_pages": eng.num_pages}
        return rec

    on = run(True, 8 * bound * 64)
    free_cuda()
    off = run(False, None)
    free_cuda()
    check(on["bound"] == bound, f"window slot bound {on['bound']} != {bound}")
    check(reach > on["num_pages"] - 1,
          f"the traffic's reach ({reach} pages) fits the budget")
    check(on["outs"] == off["outs"],
          "window: reclamation ON is not bitwise the mask-only engine")
    c = on["counters"]
    check(c["serve_window_reclaimed_pages"] > 0, "no page was reclaimed")
    check(on["peak"] <= bound, f"a slot held {on['peak']} > {bound} pages")
    check(c["serve_pages_in_use"] == 0
          and c["serve_pages_free"] == on["num_pages"] - 1,
          f"window pages after the traffic: {c}")
    check_paged_launches(wcfg, on, "engine_window", "window")
    note_launches(kernels, "engine_window", on)

    plain = LlamaModel(dataclasses.replace(wcfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    eng = DecodeEngine(plain, params, page_budget=8 * bound * 64, **kw)
    scored = [(name, p, list(t), lp) for (name, p, _), (t, lp) in
              zip(traffic, on["outs"])]
    forced = rescore(eng, scored)
    eng = None
    free_cuda()
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    generated = sum(len(t) - len(p) for (_, p, _), (t, _) in
                    zip(traffic, on["outs"]))
    say("serving_engine_window", window=WINDOW_SERVE, layers=WINDOW_LAYERS,
        requests=len(traffic),
        max_context=4096, budget_pages=on["num_pages"] - 1,
        slot_bound_pages=bound, traffic_reach_pages=reach,
        peak_pages_per_slot=on["peak"],
        reclaimed_pages=c["serve_window_reclaimed_pages"],
        on_equals_off_bitwise=True, paged_forwards=on["paged"],
        launches=on["launches"], k7_variant_launches=on["variants"],
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        generated_tokens=generated, wall_s_on=on["wall"],
        wall_s_off=off["wall"],
        generated_tokens_per_s_on=generated / on["wall"],
        generated_tokens_per_s_off=generated / off["wall"],
        decode_ms_per_advance_on=ms_per_advance(on["rounds"]),
        decode_ms_per_advance_off=ms_per_advance(off["rounds"]),
        ttft_p50_ms_on=c["serve_ttft_p50_ms"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(err <= PATH_LP_TOL, f"window re-scored logprobs {err}")


def spec_traffic():
    """8 greedy requests with log-probs: 4 whose prompts repeat a block
    (the traffic prompt-lookup drafting is for) and 4 of random ids."""
    rs = np.random.RandomState(SEED + 13)

    def text(x):
        return " ".join(map(str, x))

    out = []
    for i, (n, gen) in enumerate(zip((600, 900, 1200, 300, 150, 700, 1400,
                                      400),
                                     (128, 96, 64, 112, 128, 80, 64, 100))):
        if i < 4:
            block = [int(x) for x in rs.randint(0, 31999, 24 + 8 * i)]
            p = (block * (n // len(block) + 1))[:n]
        else:
            p = [int(x) for x in rs.randint(0, 31999, n)]
        out.append((f"s{i}", p, {"prompts": [text(p)], "top_k": 1,
                                 "tokens_to_generate": gen,
                                 "logprobs": True}))
    return out


# the spec and whole-prompt phase's depth: 2 of Llama-2-7B's 32 layers
# (16 before the bert phase, 4 before the t5 and ict phases), which
# keeps the whole smoke within its time
SPEC_LAYERS = 2


def serve_engine_spec_and_whole_prompt(kernels, cfg, model, params):
    """At SPEC_LAYERS of the 7B's 32 layers (a view of the serving
    model's first layers), the same 8 requests over HTTP through the
    chunked engine without
    speculation, with `spec_decode_k=4`, and with whole-prompt admission
    (`prefill_chunk_tokens=0`): acceptance rate, tokens/s and TTFT of
    each; greedy agreement with the chunked engine and log-probs within
    5e-2 over each request's common prefix (other chunk widths are
    other GEMM shapes, so the card does not promise bitwise equality)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    cfg, params = first_layers(cfg, params, SPEC_LAYERS, copy=False)
    model = LlamaModel(cfg)
    traffic = spec_traffic()
    runs = {}
    for mode, over in (("chunked", {}), ("spec", {"spec_decode_k": 4}),
                       ("whole_prompt", {"prefill_chunk_tokens": 0,
                                         "prefix_cache": False})):
        eng = DecodeEngine(model, params, **engine_kwargs(tok, **over))
        run = drive_engine(eng, model, tok, params, traffic)
        run["generated"], run["scored"] = check_outputs(traffic, run, tok)
        check(run["metrics"]["serve_pages_in_use"]
              - run["metrics"].get("serve_prefix_cached_pages", 0) == 0,
              f"{mode}: pages after the traffic {run['metrics']}")
        if mode != "chunked":
            check_paged_launches(cfg, run, f"engine_{mode}", "fp")
            note_launches(kernels, f"engine_{mode}", run)
        runs[mode] = run
        eng = None
        free_cuda()
    spec = runs["spec"]["metrics"]
    check(spec["serve_spec_rounds"] > 0, f"no spec round ran: {spec}")
    report = {}
    for mode in ("chunked", "spec", "whole_prompt"):
        r = runs[mode]
        agree, err = compare_streams(runs["chunked"]["scored"], r["scored"])
        report[mode] = {
            "generated_tokens_per_s": r["generated"] / r["wall"],
            "wall_s": r["wall"], "ttft_p50_ms": r["metrics"]["serve_ttft_p50_ms"],
            "ttft_p95_ms": r["metrics"]["serve_ttft_p95_ms"],
            "decode_ms_per_advance": ms_per_advance(r["rounds"]),
            "paged_forwards": r["paged"], "rounds": len(r["rounds"]),
            "greedy_token_agreement_vs_chunked": agree,
            "common_prefix_logprob_max_abs_vs_chunked": err}
    report["spec"].update(
        accept_rate=spec["serve_spec_accept_rate"],
        spec_rounds=spec["serve_spec_rounds"],
        proposed=spec["serve_spec_proposed"],
        accepted=spec["serve_spec_accepted"])
    say("serving_engine_spec_whole_prompt", layers=SPEC_LAYERS,
        requests=len(traffic), tol=PATH_LP_TOL, **report)
    for mode in ("spec", "whole_prompt"):
        err = report[mode]["common_prefix_logprob_max_abs_vs_chunked"]
        check(err <= PATH_LP_TOL, f"{mode} log-probs vs chunked {err}")


def packed_docs_prefill(kernels, cfg, model, params):
    """Three documents packed into one slot's pages and prefilled by one
    paged `LlamaModel.forward` as three chunks with "doc_starts" floors
    (the packed-document path of K7). Counts zeroed just before, read
    just after: K7 once per layer, every launch the doc variant. Each
    document's log-probs within 5e-2 of the kernels-off forward of the
    same packed batch and of that document's own no-cache forward (no
    attention crosses a document; RoPE scores depend on relative
    positions only)."""
    lens, C, page = (256, 200, 300), 300, 64
    starts = (0, 256, 456)
    pages = -(-sum(lens) // page)
    rs = np.random.RandomState(SEED + 17)
    docs = [rs.randint(0, 31999, n) for n in lens]
    toks = np.zeros((3, C), np.int64)
    for i, d in enumerate(docs):
        toks[i, :len(d)] = d
    toks = torch.from_numpy(toks).cuda()
    dev = {k: torch.tensor(v, dtype=torch.int32, device="cuda")
           for k, v in (("lengths", starts), ("chunk_lens", lens),
                        ("doc_starts", starts))}
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False,
                                           use_flash_attn=False))
    dp = model.prepare_decode_params(params)
    outs = []
    with torch.inference_mode():
        for m in (model, plain):
            caches = m.init_paged_kv_caches(3, 1 + pages, page, pages)
            caches["page_table"] = torch.arange(
                1, 1 + pages, dtype=torch.int32, device="cuda").repeat(3, 1)
            zero_counts()
            logits, _ = m.forward(dp, toks, kv_caches=dict(caches, **dev))
            torch.cuda.synchronize()
            if m is model:
                launches = kernel_counts()
                variants = dict(pa.ragged_paged_attention.variant_launches)
            outs.append(torch.log_softmax(logits.float(), -1))
        alone = [torch.log_softmax(plain.forward(params, torch.from_numpy(
            d[None]).cuda())[0][0].float(), -1) for d in docs]
    err_off = max((outs[0][i, :n] - outs[1][i, :n]).abs().max().item()
                  for i, n in enumerate(lens))
    err_alone = max((outs[0][i, :n] - alone[i]).abs().max().item()
                    for i, n in enumerate(lens))
    k7 = launches["ragged_paged_attention"]
    say("packed_docs_prefill", documents=list(lens), launches=launches,
        k7_variant_launches=variants,
        max_abs_logprob_err_vs_kernels_off=err_off,
        max_abs_logprob_err_vs_each_document_alone=err_alone,
        tol=PATH_LP_TOL)
    check(k7 == cfg.num_layers and variants["doc"] == k7
          and variants["tc"] == k7,
          f"packed docs: K7 launches {launches} {variants}")
    check(err_off <= PATH_LP_TOL and err_alone <= PATH_LP_TOL,
          f"packed docs log-probs {err_off} {err_alone}")
    note_launches(kernels, "packed_docs_prefill",
                  {"launches": launches, "variants": variants})


FP32_LAYERS = 2
FP32_REQUESTS = ("greedy0", "greedy2", "greedy3", "greedy5")
FP32_LP_TOL = 1e-3


def serve_engine_fp32(kernels, init_std):
    """Llama-2-7B widths at 2 of its 32 layers with fp32 weights, compute
    and pools (the pools of an fp32 model), served by the engine at the
    launcher's defaults over HTTP: the fp32-pool path of K7, which runs
    its present design. Counts zeroed before the traffic, read after: K7
    once per layer per paged forward, every launch present. The outputs
    re-scored teacher-forced on a kernels-off fp32 engine on the same
    weights: log-probs within 1e-3."""
    cfg = llama_config(7, num_layers=FP32_LAYERS, params_dtype=torch.float32,
                       compute_dtype=torch.float32, use_fused_rmsnorm=True,
                       init_method_std=init_std)
    model = LlamaModel(cfg)
    params = model.init(seed=SEED + 23)
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    eng = DecodeEngine(model, params, **engine_kwargs(tok))
    traffic = [x for x in engine_traffic() if x[0] in FP32_REQUESTS]
    run = drive_engine(eng, model, tok, params, traffic)
    generated, scored = check_outputs(traffic, run, tok)
    check_paged_launches(cfg, run, "engine_fp32", "fp", tc=False)
    metrics = run["metrics"]
    check(metrics["serve_pages_free"] + metrics["serve_prefix_cached_pages"]
          == eng.num_pages - 1, f"fp32 pages after the traffic: {metrics}")
    note_launches(kernels, "engine_fp32", run)
    eng = None
    free_cuda()
    plain = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                           use_decode_attn=False))
    off = DecodeEngine(plain, params, **engine_kwargs(tok,
                                                      prefix_cache=False))
    forced = rescore(off, scored)
    off = None
    err = max(float(np.abs(np.asarray(f) - np.asarray(lp)).max())
              for f, (_, _, _, lp) in zip(forced, scored))
    say("serving_engine_fp32", layers=FP32_LAYERS, requests=len(traffic),
        paged_forwards=run["paged"], launches=run["launches"],
        k7_variant_launches=run["variants"], generated_tokens=generated,
        wall_s=run["wall"], path_check_max_abs_logprob_err=err,
        tol=FP32_LP_TOL)
    check(err <= FP32_LP_TOL, f"fp32 re-scored logprobs {err}")
    del model, plain, params
    free_cuda()


# ---------------------------------------------------------------------------
# phases 14c-14d: the serving entry path (converter CLI -> release ->
# launcher -> HTTP) for Llama-2-7B and Falcon-7B
# ---------------------------------------------------------------------------

REPO_DIR = Path(__file__).resolve().parent
LAUNCH_DIR = REPO_DIR / "build" / "launcher_smoke"
LLAMA_DISK_GB, FALCON_DISK_GB = 30, 20
LAUNCHER_REQUESTS = 8  # the first greedy requests of engine_traffic()
BEAM_GEN = 16
LAUNCH_TIMEOUT_S = 900


def need_disk(gb):
    """Free GB where the phase writes; raises, with the numbers, unless
    its files fit."""
    LAUNCH_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(LAUNCH_DIR).free / 1e9
    check(free >= gb, f"{LAUNCH_DIR}: {free:.1f} GB free, the phase writes "
                      f"about {gb} GB")
    return free


def convert_here(*argv):
    """`convert_weights.main(argv)` in this process: the CLI's own
    parsing and conversion without a fresh interpreter's start (about 8
    s on the H100's host); returns its seconds."""
    from megatron_llm_tpu_torch.tools import convert_weights

    t0 = time.perf_counter()
    convert_weights.main([str(a) for a in argv])
    return time.perf_counter() - t0


def release_leaves_equal(ckpt_dir, params):
    """Every leaf of the release in `ckpt_dir` equals `params`' (on the
    card) bit for bit; returns the number of leaves."""
    flat = torch.load(Path(ckpt_dir) / "release" / "model",
                      map_location="cpu", mmap=True, weights_only=True)
    ref = ckpt.flatten(params)
    check(sorted(flat) == sorted(ref), f"release leaves {sorted(flat)}")
    for k, v in ref.items():
        check(flat[k].dtype == v.dtype and flat[k].shape == v.shape
              and torch.equal(flat[k].to(v.device), v),
              f"release leaf {k} differs from the smoke's weights")
    return len(ref)


def tree_bytes(tree):
    """Bytes of a parameter tree (the decode tree's layers are a tuple)."""
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tree_bytes(x) for x in tree.values())
    return tree.numel() * tree.element_size()


class InThreadLauncher:
    """The launcher's `main(argv)` on the card in a thread of this
    process, started and stopped as a caller of `ready` does."""

    def __init__(self, argv):
        box, ready = {}, threading.Event()

        def run():
            try:
                rtgs.main(argv, ready=lambda launch: (
                    box.update(launch=launch), ready.set()))
            except BaseException as e:  # noqa: BLE001 - raised below
                box["error"] = e
                ready.set()

        self.box = box
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        ready.wait(LAUNCH_TIMEOUT_S)
        if "error" in box:
            raise box["error"]
        check("launch" in box, "the launcher did not start")
        launch = box["launch"]
        self.port, self.load_s, self.setup_s = (launch.port, launch.load_s,
                                                launch.setup_s)
        self.server = launch.server

    def stop(self):
        """main stops the engine, frees the model and returns."""
        self.box.pop("launch").stop()
        self.server = None
        self.thread.join(timeout=300)
        check(not self.thread.is_alive(), "the launcher did not return")
        if "error" in self.box:
            raise self.box["error"]
        free_cuda()


def launcher_traffic(stream=True):
    """The first 8 greedy requests of the engine traffic (prompts 20-1500,
    64-128 new tokens) and, with `stream`, the streamed one; and the
    whole-batch pair, a beam-2 request and a score-only request."""
    traffic = engine_traffic()
    out = traffic[:LAUNCHER_REQUESTS]
    if stream:
        out += [x for x in traffic if x[0] == "stream"]
    p, q = traffic[2][1][:200], traffic[4][1][:300]

    def text(x):
        return " ".join(map(str, x))

    whole = [("beam", p, {"prompts": [text(p)], "beam_width": 2,
                          "tokens_to_generate": BEAM_GEN}),
             ("score", [p, q], {"prompts": [text(p), text(q)],
                                "tokens_to_generate": 0, "logprobs": True})]
    return out, whole


def drive_launcher(port, eng, traffic, whole):
    """The engine traffic from concurrent client threads and, from one
    more, the beam and score requests one after the other (the
    whole-batch route takes one request at a time); every launch count
    set to 0 just before, read just after."""
    results = {}

    def client(name, payload):
        results[name] = put_raw(port, payload)

    def serial():
        for name, _, payload in whole:
            results[name] = put_raw(port, payload)

    threads = [threading.Thread(target=client, args=(name, payload))
               for name, _, payload in traffic]
    threads.append(threading.Thread(target=serial))
    n0 = len(eng._round_log)
    zero_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    variants = dict(pa.ragged_paged_attention.variant_launches)
    check(all(not th.is_alive() for th in threads), "launcher clients hung")
    rounds = list(eng._round_log)[n0:]
    return {"results": results, "launches": launches, "variants": variants,
            "wall": wall, "rounds": rounds, "paged": paged_forwards(rounds)}


def check_launcher_run(cfg, run, whole, flash):
    """The beam answer (2 texts, finite scores) and the score-only answer
    (the prompts echoed, finite log-probs); K7 ran once per layer per
    paged forward, every launch tc; K1 once per layer per beam decode
    step; K4 once per layer (the score request's no-cache forward) where
    the config runs flash, else never; K2, K3, K5, K6 never. Returns the
    beam's decode steps."""
    (_, p, _), (_, pq, _) = whole
    status, beam = run["results"]["beam"]
    check(status == 200 and len(beam["text"]) == 2
          and len(beam["scores"]) == 2 and np.isfinite(beam["scores"]).all()
          and all(len(p) < len(t.split()) <= len(p) + BEAM_GEN
                  for t in beam["text"]), f"beam answer {status} {beam}")
    status, score = run["results"]["score"]
    check(status == 200 and [len(t.split()) for t in score["text"]]
          == [len(x) for x in pq], f"score answer {status}")
    for lp, x in zip(score["logprobs"], pq):
        check(np.isfinite(lp[:len(x) - 1]).all(), "score logprobs")
    n, L = run["launches"], cfg.num_layers
    k1, k7 = n["decode_attention"], n["ragged_paged_attention"]
    steps = k1 // L
    check(k1 == L * steps and 1 <= steps <= BEAM_GEN,
          f"K1 launches {k1}: not {L} x the beam's decode steps")
    check(k7 == L * run["paged"] and k7 > 0 and run["variants"]["tc"] == k7,
          f"K7 launches {k7} (designs {run['variants']}) != {L} x "
          f"{run['paged']} paged forwards, all tc")
    check(n["flash_fwd"] == (L if flash else 0)
          and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 0,
          f"flash launches {n}")
    check(n["rmsnorm_fwd"] == n["rmsnorm_bwd"] == 0, f"K2/K3 ran: {n}")
    return steps


def note_launcher_launches(kernels, path, run):
    """The path's launches on the K1, K4 and K7 rows (and K2's, 0)."""
    note_launches(kernels, path, run)
    for row in kernels:
        if row["name"] in ("decode_attention", "flash_fwd"):
            by = row["launches_by_path"]
            by[path] = run["launches"][row["name"]]
            row["launches"] = sum(by.values())


def sequential_greedy(port, payloads):
    """The payloads one at a time: each answer's token ids."""
    out = []
    for payload in payloads:
        status, body = put_raw(port, payload)
        check(status == 200, f"sequential greedy -> {status} {body}")
        out.append(list(map(int, body["text"][0].split())))
    return out


def sequential_payloads():
    rs = np.random.RandomState(SEED + 41)
    return [{"prompts": [" ".join(map(str, rs.randint(0, 31999, n)))],
             "tokens_to_generate": 32, "top_k": 1} for n in (300, 60)]


def launcher_subprocess(argv, payloads):
    """The launcher started as a user starts it, `python -m ...`: seconds
    to its banner line, its answers to `payloads` sent one at a time, and
    the banner. SIGINT stops it (main drains and returns); it is killed
    if it does not exit."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "megatron_llm_tpu_torch.tools.run_text_generation_server", *argv],
        cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, banner = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                banner.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        banner.wait(LAUNCH_TIMEOUT_S)
        banner_s = time.perf_counter() - t0
        check(banner.is_set(), "the launcher subprocess printed no "
                               "banner:\n" + "".join(lines)[-3000:])
        line = next(x for x in lines if x.startswith("serving "))
        port = int(re.search(r"http://[^:/]+:(\d+)/api", line).group(1))
        answers = sequential_greedy(port, payloads)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    check(proc.returncode == 0, f"launcher subprocess rc {proc.returncode}:"
                                "\n" + "".join(lines)[-3000:])
    return banner_s, answers, line.strip()


# the serving entry path's depth: Llama-2-7B's width at 4 of its 32
# layers (the HF write still takes two 2 GB shards), to keep the whole
# smoke within 950 s beside the pipeline and context_parallel phases
LLAMA_LAUNCH_LAYERS = 4


def first_layers(cfg, params, n, copy=True):
    """The config and weights of the first n layers: copies (the whole
    model can be freed), or with `copy=False` views of the whole
    model's."""
    layers = ckpt.unflatten({k: v[:n].clone() if copy else v[:n] for k, v
                             in ckpt.flatten(params["layers"]).items()})
    return dataclasses.replace(cfg, num_layers=n), dict(params,
                                                        layers=layers)


def convert_llama(cfg, params):
    """The smoke's Llama-2-7B weights (phase 4) at LLAMA_LAUNCH_LAYERS of
    its 32 layers written as an HF Llama directory (config.json, sharded
    bf16 safetensors with an index) through the port's converter and
    writer, then converted by the CLI's hf2native (`convert_weights.main`
    in this process) into a bf16 release, whose every leaf must equal the
    smoke's bit for bit. Runs while the
    weights are on the card; returns the conversion's facts and the
    weights it converted."""
    cfg, params = first_layers(cfg, params, LLAMA_LAUNCH_LAYERS)
    free_gb = need_disk(LLAMA_DISK_GB)
    hf_dir, rel_dir = LAUNCH_DIR / "hf_llama", LAUNCH_DIR / "llama"
    for d in (hf_dir, rel_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    sd = hf_conv.native_to_hf_llama(params, cfg, dtype=torch.bfloat16)
    safetensors_io.write_hf_config(str(hf_dir), safetensors_io.llama_hf_config(
        cfg, cfg.padded_vocab_size, torch.bfloat16))
    # 2 GB shards: the 3.77 GB of 8 layers still take the sharded layout
    hf_bytes = safetensors_io.save_sharded(sd, str(hf_dir),
                                           max_shard_bytes=2 * 10**9)
    del sd
    free_cuda()
    hf_write_s = time.perf_counter() - t0
    shards = len(list(hf_dir.glob("*.safetensors")))
    convert_s = convert_here("--model", "llama", "--direction", "hf2native",
                             "--dtype", "bfloat16", "--input", hf_dir,
                             "--output", rel_dir)
    leaves = release_leaves_equal(rel_dir, params)
    shutil.rmtree(hf_dir)
    return {"disk_free_gb": free_gb, "hf_write_s": hf_write_s,
            "hf_bytes": hf_bytes, "hf_shards": shards,
            "convert_s": convert_s, "release_leaves_equal": leaves,
            "release_bytes": dir_bytes(rel_dir / "release"),
            "release": rel_dir}, (cfg, params)


def teacher_forced(model, params, greedy):
    """The greedy outputs teacher-forced through `model`'s no-cache
    forward: the largest |log-prob difference| and the share of
    generated positions where its argmax is the stream's token."""
    err, match, total = 0.0, 0, 0
    with torch.inference_mode():
        for _, prompt, out, lp in greedy:
            seq = torch.tensor(out, device=model.device)[None]
            logits, _ = model.forward(params, seq[:, :-1])
            lps = torch.log_softmax(logits[0].float(), -1)
            forced = lps.gather(1, seq[0, 1:, None])[:, 0].cpu().numpy()
            err = max(err, float(np.abs(forced - np.asarray(lp)).max()))
            am = lps.argmax(-1).cpu().numpy()[len(prompt) - 1:]
            match += int((am == np.asarray(out[len(prompt):])).sum())
            total += len(out) - len(prompt)
    return err, match / max(total, 1)


def launcher_llama(kernels, conv, weights):
    """Llama-2-7B widths at LLAMA_LAUNCH_LAYERS layers from the converted
    release through the launcher, in a thread (`--warmup_compile`, the
    engine defaults: 8 slots, page 64, max_context 2048, chunks of 256,
    prefix cache), then as a subprocess. The greedy streams teacher-forced
    through the kernels-off forward on the converted weights within
    5e-2; the subprocess answers two greedy requests, one at a time, as
    the in-thread launcher did."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    argv = ["--load", str(conv.pop("release")), "--model", "llama",
            "--tokenizer_type", "NullTokenizer", "--null_vocab_size",
            "31999", "--host", "127.0.0.1", "--port", "0"]
    torch.cuda.reset_peak_memory_stats()
    srv = InThreadLauncher(argv + ["--warmup_compile"])
    eng, model = srv.server.engine, srv.server.generator.model
    cfg = model.cfg
    mem = {"memory_after_start_gb": torch.cuda.memory_allocated() / 1e9,
           "params_fp32_gb": tree_bytes(srv.server.generator.params) / 1e9,
           "decode_copy_gb": tree_bytes(eng._dec_params) / 1e9,
           "kv_pool_gb": eng.kv_pool_bytes() / 1e9}
    pool_bytes = eng.kv_pool_bytes()
    decode_bytes = tree_bytes(eng._dec_params)
    graphs = eng.graph_stats()
    traffic, whole = launcher_traffic()
    run = drive_launcher(srv.port, eng, traffic, whole)
    generated, greedy = check_outputs(traffic, run, tok)
    beam_steps = check_launcher_run(cfg, run, whole, flash=True)
    seq = sequential_greedy(srv.port, sequential_payloads())
    # the single-engine streams the fleet runs are held to
    fleet_ref = [sequential_scored(srv.port, prompts)
                 for prompts in fleet_traffic()]
    metrics = get_json(srv.port, "/metrics")
    eng.stop()  # its serve thread: the card is timed alone
    step_ms = decode_step_device_ms(model, eng)
    note_launcher_launches(kernels, "launcher_llama", run)
    del eng, model
    srv.stop()
    banner_s, sub, banner = launcher_subprocess(argv, sequential_payloads())
    check(sub == seq, "the subprocess launcher's answers differ from the "
                      "in-thread launcher's")
    plain, wparams = kernels_off(weights)
    err, agree = teacher_forced(plain, wparams, greedy)
    del plain, wparams
    free_cuda()
    check(err <= PATH_LP_TOL, f"launcher streams teacher-forced through "
                              f"the kernels-off forward: log-probs {err}")
    say("launcher_llama", card=nvidia_smi(), config="llama2-7b",
        layers=cfg.num_layers, **conv, load_s=srv.load_s,
        engine_setup_s=srv.setup_s, warmup_capture_s=graphs["capture_s"],
        graphs=graphs["graphs"], subprocess_banner_s=banner_s,
        subprocess_banner=banner, subprocess_answers_equal=True,
        requests=len(traffic) + len(whole), paged_forwards=run["paged"],
        launches=run["launches"], k7_variant_launches=run["variants"],
        beam_decode_steps=beam_steps, generated_tokens=generated,
        wall_s=run["wall"], generated_tokens_per_s=generated / run["wall"],
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        decode_ms_per_advance=ms_per_advance(run["rounds"]),
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
        greedy_token_match_fraction_kernels_off=agree,
        path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL, **mem,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the release and the tp 1 streams serve the serving_tp phase, the
    # fleet's prompts' streams the launcher_fleet phase
    return {"argv": argv, "greedy": greedy, "layers": cfg.num_layers,
            "kv_pool_bytes": pool_bytes, "fleet_ref": fleet_ref,
            "decode_ms_per_advance": ms_per_advance(run["rounds"])}


def kernels_off(weights):
    """The plain (kernels-off) model of the converted weights, and the
    weights: what the launchers' streams are teacher-forced through."""
    wcfg, wparams = weights
    return LlamaModel(dataclasses.replace(
        wcfg, use_decode_attn=False, use_flash_attn=False,
        use_fused_rmsnorm=False)), wparams


# ---------------------------------------------------------------------------
# the serving fleet: the launcher's --router_replicas on the release of
# launcher_llama, two engine replicas sharing the card
# ---------------------------------------------------------------------------

FLEET_GEN = 32
FLEET_SYSTEM = 512  # run (b)'s shared system prefix, in tokens
FLEET_REPLICAS = 2


def fleet_traffic():
    """(a) 6 prompts of 300-1100 ids (2 or more full pages of 64: the
    router's two-stage route) and 2 short ones (direct); (b) 8 prompts
    sharing a FLEET_SYSTEM-token system prefix."""
    rs = np.random.RandomState(SEED + 53)

    def ids(n):
        return [int(x) for x in rs.randint(0, 31999, n)]

    disagg = [ids(n) for n in (300, 1100, 640, 820, 450, 980, 40, 90)]
    system = ids(FLEET_SYSTEM)
    return disagg, [system + ids(n) for n in (20, 35, 50, 28, 44, 60, 33,
                                              25)]


def fleet_payload(prompt, logprobs=False):
    return {"prompts": [" ".join(map(str, prompt))],
            "tokens_to_generate": FLEET_GEN, "top_k": 1,
            "logprobs": logprobs}


def sequential_scored(port, prompts):
    """Each prompt alone, greedy with log-probs: [(tokens, log-probs)]."""
    out = []
    for prompt in prompts:
        status, body = put_raw(port, fleet_payload(prompt, logprobs=True))
        check(status == 200, f"single-engine fleet reference -> {status}")
        out.append((list(map(int, body["text"][0].split())),
                    body["logprobs"][0]))
    return out


def concurrent_greedy(port, prompts):
    """The prompts from concurrent client threads: [(status, tokens or
    the error body)] in prompt order."""
    results = [None] * len(prompts)

    def client(i):
        status, body = put_raw(port, fleet_payload(prompts[i]))
        results[i] = (status, list(map(int, body["text"][0].split()))
                      if status == 200 else body)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=LAUNCH_TIMEOUT_S)
    check(all(not th.is_alive() for th in threads), "fleet clients hung")
    return results


def hold_streams(plain, params, prompts, streams, refs):
    """The fleet's greedy streams held to the single-engine streams
    `refs` [(tokens, log-probs)] on the same prompts: the share of
    generated tokens that agree, the largest |log-prob| difference
    between the fleet's tokens teacher-forced through the kernels-off
    forward and the single engine's log-probs over the prefix where the
    streams agree, and the largest gap between the kernels-off forward's
    best log-prob and that of the fleet's token anywhere (each fleet
    token is a greedy pick up to bf16 noise)."""
    agree = total = 0
    err = gap = 0.0
    with torch.inference_mode():
        for prompt, out, (ref, ref_lp) in zip(prompts, streams, refs):
            seq = torch.tensor(out, device=plain.device)[None]
            logits, _ = plain.forward(params, seq[:, :-1])
            lps = torch.log_softmax(logits[0].float(), -1)
            forced = lps.gather(1, seq[0, 1:, None])[:, 0].cpu().numpy()
            best = lps.max(-1).values.cpu().numpy()
            n = len(prompt) - 1
            gap = max(gap, float((best[n:] - forced[n:]).max()))
            same = 0
            while (len(prompt) + same < min(len(out), len(ref))
                   and out[len(prompt) + same] == ref[len(prompt) + same]):
                same += 1
            agree += same
            total += len(out) - len(prompt)
            if same:
                err = max(err, float(np.abs(
                    forced[n:n + same] - np.asarray(ref_lp)[n:n + same])
                    .max()))
    return agree / max(total, 1), err, gap


def fleet_launches(kernels, path, engines, counts, variants, warm=0,
                   calls=None):
    """K7 launched once a layer and paged forward of every replica's
    rounds (plus `warm`, the launches a replacement's warm-up made),
    every launch tc, on each replica; K1, K2 and K4 never. Notes the
    path on the kernels line; returns K7 launches by replica. `calls`
    (`dispatch_logger`'s) are named in a failure."""
    L = engines[0].cfg.num_layers
    by = {}
    for eng in engines:
        rid = eng.replica_id
        by[rid] = by.get(rid, 0) + L * paged_forwards(eng._round_log)
    k7 = counts["ragged_paged_attention"]
    check(k7 == sum(by.values()) + warm and variants["tc"] == k7,
          f"{path}: K7 launches {k7} (designs {variants}) != {L} x the "
          f"replicas' paged forwards {by} + {warm} warm-up; the engines' "
          f"device calls {dispatch_forwards(calls or [], L)}")
    check(all(v > 0 for v in by.values()) and len(by) == FLEET_REPLICAS,
          f"{path}: K7 did not run on every replica: {by}")
    check(counts["decode_attention"] == counts["flash_fwd"]
          == counts["rmsnorm_fwd"] == 0, f"{path}: launches {counts}")
    note_launcher_launches(kernels, path, {
        "launches": counts, "variants": variants})
    return by


def dispatch_logger(calls):
    """A `DecodeEngine._run` wrapper (for `patched`) that appends each
    device call but the idle "noop" to `calls` as (replica, kind, key,
    captured here): every forward an engine ran, whether or not a round
    log holds it."""
    runners = {"step": "_step_fns", "mixed": "_mixed_fns",
               "spec": "_spec_fns"}

    def make(orig):
        def run(self, kind, key, args):
            if kind != "noop":
                fns = getattr(self, runners.get(kind, ""), None)
                calls.append((self.replica_id, kind, tuple(key),
                              fns is not None and tuple(key) not in fns))
            return orig(self, kind, key, args)
        return run
    return make


def dispatch_forwards(calls, layers):
    """K7 launches the logged device calls imply, by replica: a decode
    runner of horizon h h forwards a call, a mixed or verify runner and a
    whole-prompt prefill one, a runner captured by the call WARMUP_RUNS
    more (its eager runs before the capture); and the calls by kind."""
    by, kinds = {}, collections.Counter()
    for rid, kind, key, new in calls:
        kinds[f"r{rid}:{kind}{list(key) if kind != 'prefill' else ''}"
              f"{':captured' if new else ''}"] += 1
        fw = key[0] if kind == "step" else int(kind in ("mixed", "spec",
                                                        "prefill"))
        by[rid] = by.get(rid, 0) + layers * fw * (
            1 + (gcap.WARMUP_RUNS if new else 0))
    return by, dict(kinds)


def warmup_launches(eng, warmups):
    """K7 launches of `warmups` warm-ups of a captured engine: every
    runner's paged forwards (its horizon, or 1) a layer, in the capture's
    eager runs once and in each warm-up's idle replay."""
    fw = (sum(h for h, _ in eng._step_fns) + len(eng._mixed_fns)
          + len(eng._spec_fns))
    return eng.cfg.num_layers * fw * (gcap.WARMUP_RUNS + warmups)


def fleet_disagg(kernels, tp1, plain, wparams):
    """Run (a): `--router_replicas 2 --prefill_replicas 1` with the cost
    registry, the perf sentinel, span traces and flight records, in a
    thread. Long prompts prefill on replica 0 and hand their pages to
    replica 1; every imported page equals the donor's bit for bit; the
    streams are held to launcher_llama's; POST /profile traces K7; the
    Prometheus /metrics parses back."""
    trace_dir, record_dir = LAUNCH_DIR / "fleet_traces", LAUNCH_DIR / "fleet_a"
    for d in (trace_dir, record_dir):
        shutil.rmtree(d, ignore_errors=True)
    srv = InThreadLauncher(tp1["argv"] + [
        "--warmup_compile", "--router_replicas", str(FLEET_REPLICAS),
        "--prefill_replicas", "1", "--cost_registry",
        "--perf_sentinel_ksigma", "6", "--trace_dir", str(trace_dir),
        "--record_dir", str(record_dir)])
    router = srv.server.engine
    pre, dec_rep = router.replicas
    engines = [pre.engine, dec_rep.engine]
    handoffs = {}  # id(payload) -> its hand-off (the payload kept alive)
    export, imp = pre.export_prefix, dec_rep.import_prefix

    def timed_export(prompt):
        t0 = time.perf_counter()
        payload = export(prompt)
        if payload is not None:
            handoffs[id(payload)] = {
                "export_ms": (time.perf_counter() - t0) * 1e3,
                "pages": payload["pages"], "payload": payload,
                "bytes": sum(t.numel() * t.element_size()
                             for k in ("k", "v", "ks", "vs")
                             for t in payload[k])}
        return payload

    def timed_import(payload):
        t0 = time.perf_counter()
        res = imp(payload)
        handoffs[id(payload)]["import_ms"] = (time.perf_counter() - t0) * 1e3
        return res

    def pages_equal(payload):
        """The receiver's pages of the payload's chain, bit for bit the
        donor's rows (registered full prompt pages are never written
        again, so after the run is after the import)."""
        eng = dec_rep.engine
        pages = torch.as_tensor(eng._prefix.lookup(payload["tokens"] + [0])
                                .pages[:payload["pages"]], device=eng.device)
        return len(pages) == payload["pages"] and all(
            torch.equal(pool.index_select(0, pages).cpu(), rows)
            for group, k in zip(eng._pools, ("k", "v", "ks", "vs"))
            for pool, rows in zip(group, payload[k]))

    pre.export_prefix, dec_rep.import_prefix = timed_export, timed_import
    prompts, _ = fleet_traffic()
    backlog = {0: 0.0, 1: 0.0}
    sampling = threading.Event()

    def sample():
        while not sampling.is_set():
            for i, eng in enumerate(engines):
                backlog[i] = max(backlog[i], eng.modeled_backlog_seconds())
            time.sleep(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    zero_counts()
    sampler.start()
    t0 = time.perf_counter()
    results = concurrent_greedy(srv.port, prompts)
    wall = time.perf_counter() - t0
    sampling.set()
    sampler.join()
    counts, variants = kernel_counts(), dict(
        pa.ragged_paged_attention.variant_launches)
    check(all(st == 200 for st, _ in results), f"fleet (a) answers "
                                               f"{results}")
    streams = [out for _, out in results]
    pre.export_prefix, dec_rep.import_prefix = export, imp
    handoffs = list(handoffs.values())
    for h in handoffs:
        h["pages_bit_equal"] = pages_equal(h.pop("payload"))
    by = fleet_launches(kernels, "launcher_fleet_disagg", engines, counts,
                        variants)
    stats = router.router_stats()
    paths = sorted(d["path"] for d in router.decision_log())
    check(paths == ["direct"] * 2 + ["two_stage"] * 6
          and stats["serve_prefill_replica"] == 6 and len(handoffs) == 6
          and all(h["pages_bit_equal"] for h in handoffs)
          and stats["serve_transfer_pages"] == sum(
              h["pages"] for h in handoffs),
          f"fleet (a) routing {paths}, stats {stats}, hand-offs "
          f"{handoffs}")
    agree, err, gap = hold_streams(plain, wparams, prompts, streams,
                                   tp1["fleet_ref"][0])
    check(err <= PATH_LP_TOL and gap <= PATH_LP_TOL,
          f"fleet (a) streams against the single engine: log-probs "
          f"{err}, greedy gap {gap}")
    # POST /profile: 2 rounds of the prefill replica, then one long prompt
    prof_dir = trace_dir / "profile"
    status, _ = post_json(srv.port, "/profile",
                          {"rounds": 2, "trace_dir": str(prof_dir)})
    check(status == 200, f"POST /profile -> {status}")
    check(put_raw(srv.port, fleet_payload(prompts[0]))[0] == 200,
          "the profiled request")
    deadline = time.monotonic() + 120
    while not list(prof_dir.glob("profile_engine-r0_*.json")):
        check(time.monotonic() < deadline, "no profiler trace written")
        time.sleep(0.1)
    (prof,) = prof_dir.glob("profile_engine-r0_*.json")
    names = {e.get("name", "") for e in json.loads(prof.read_text())[
        "traceEvents"]}
    k7_names = sorted(n for n in names if "paged_attn_tc_kernel" in n)
    check(k7_names, "the profiler trace names no K7 kernel")
    text = get_text(srv.port, "/metrics?format=prometheus")
    hists = {h.name: h for h in histograms_from_prometheus(text)}
    admitted = sum(e.counters()["serve_admitted"] for e in engines)
    check(hists["serve_ttft_ms"].count == admitted,
          f"Prometheus TTFT count {hists['serve_ttft_ms'].count} != "
          f"{admitted} admitted")
    metrics = get_json(srv.port, "/metrics")
    chip = engines[0].chip.label() if engines[0].chip else None
    check(chip == "h100:detected", f"chip spec {chip}")
    memory = get_json(srv.port, "/memory")
    costs = [e.costs.snapshot()["records"] for e in engines]
    sentinel = [e.counters().get("serve_perf_regressions") for e in engines]
    srv.stop()
    traces = sorted(p.name for p in trace_dir.glob("trace_engine-r*.json"))
    check(len(traces) == FLEET_REPLICAS, f"span traces {traces}")
    n_layers = engines[0].cfg.num_layers
    say("launcher_fleet_disagg", card=nvidia_smi(), layers=n_layers,
        replicas="1 prefill + 1 decode", requests=len(prompts),
        routes=paths, wall_s=wall,
        generated_tokens_per_s=sum(len(o) - len(p) for p, o in
                                   zip(prompts, streams)) / wall,
        k7_launches_by_replica=by, launches=counts,
        router={k: v for k, v in stats.items() if k != "replicas"},
        handoffs=handoffs,
        handoff_bytes_per_page_layer=[
            h["bytes"] / (h["pages"] * n_layers) for h in handoffs],
        export_ms=[h["export_ms"] for h in handoffs],
        import_ms=[h["import_ms"] for h in handoffs],
        exported_pages_bit_equal=all(h["pages_bit_equal"]
                                     for h in handoffs),
        token_agreement_single_engine=agree,
        path_check_max_abs_logprob_err=err, greedy_gap=gap,
        tol=PATH_LP_TOL, chip_spec=chip,
        modeled_backlog_s_peak_by_replica=backlog,
        h100_peak_bf16_flops=BF16_FLOPS,
        cost_records_by_replica=[len(c) for c in costs],
        cost_records_replica0=costs[0],
        perf_regressions=sentinel, profile_trace=prof.name,
        profile_k7_kernel_names=k7_names[:2], span_traces=traces,
        prometheus_ttft_count=hists["serve_ttft_ms"].count,
        prometheus_histograms=sorted(hists),
        metrics_serve_admitted=metrics.get("serve_admitted"),
        memory_devices=memory["devices"])


def fleet_recover(kernels, tp1, plain, wparams):
    """Run (b): `--router_replicas 2 --recover_requests --fleet_controller
    --chaos kill=0@3`, in a thread. 8 greedy requests sharing a system
    prefix go by affinity to replica 0, which dies after its third
    submit; its requests are resubmitted, the controller replaces it, and
    every request answers (zero failed) with the single engine's streams
    up to the kernels-off bar. The condemned replica's memory goes back:
    its engine is collected and the card's reserved memory returns."""
    import weakref

    record_dir = LAUNCH_DIR / "fleet_b"
    shutil.rmtree(record_dir, ignore_errors=True)
    srv = InThreadLauncher(tp1["argv"] + [
        "--warmup_compile", "--router_replicas", str(FLEET_REPLICAS),
        "--recover_requests", "--fleet_controller", "--chaos", "kill=0@3",
        "--record_dir", str(record_dir)])
    router = srv.server.engine
    engines = [rep.engine for rep in router.replicas]
    doomed = weakref.ref(engines[0])
    free_cuda()
    reserved_before = torch.cuda.memory_reserved()
    _, prompts = fleet_traffic()
    calls = []
    with patched(DecodeEngine, "_run", dispatch_logger(calls)):
        zero_counts()
        t0 = time.perf_counter()
        # the first request alone registers the system prefix on replica
        # 0, so the rest follow it there by affinity (and arm the kill)
        results = concurrent_greedy(srv.port, prompts[:1])
        results += concurrent_greedy(srv.port, prompts[1:])
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        while router.router_stats().get("serve_fleet_replaced", 0) < 1:
            check(time.monotonic() < deadline, "no replacement")
            time.sleep(0.05)
        counts, variants = kernel_counts(), dict(
            pa.ragged_paged_attention.variant_launches)
    failed = [r for r in results if r[0] != 200]
    check(not failed, f"fleet (b) failed requests: {failed}")
    streams = [out for _, out in results]
    new = router.replicas[0].engine
    check(new is not engines[0] and new.replica_id == 0,
          "replica 0 was not replaced")
    by = fleet_launches(kernels, "launcher_fleet_recover",
                        engines + [new], counts, variants,
                        warm=warmup_launches(new, 2), calls=calls)
    stats = router.router_stats()
    record = router.flight_record()
    replace = [e for e in record.get("fleet", []) if e["kind"] == "replace"]
    dumps = sorted(p.name for p in record_dir.glob(
        "flight_record_engine-poison-r0_*.json"))
    check(stats["serve_fleet_replaced"] == 1 and len(replace) == 1
          and dumps and stats["router_affinity_hits"] >= 1
          and stats["serve_resubmitted"] >= 1,
          f"fleet (b): stats {stats}, replace events {replace}, dumps "
          f"{dumps}")
    agree, err, gap = hold_streams(plain, wparams, prompts, streams,
                                   tp1["fleet_ref"][1])
    check(err <= PATH_LP_TOL and gap <= PATH_LP_TOL,
          f"fleet (b) streams against the single engine: log-probs "
          f"{err}, greedy gap {gap}")
    del engines, new
    free_cuda()
    reserved_after = torch.cuda.memory_reserved()
    collected = doomed() is None
    check(collected and reserved_after <= reserved_before + 2**29,
          f"the condemned replica's memory: collected {collected}, "
          f"reserved {reserved_before} -> {reserved_after} bytes")
    srv.stop()
    say("launcher_fleet_recover", card=nvidia_smi(),
        replicas=FLEET_REPLICAS, chaos="kill=0@3", requests=len(prompts),
        system_prefix_tokens=FLEET_SYSTEM, wall_s=wall,
        failed_requests=len(failed),
        fleet_replaced=stats["serve_fleet_replaced"],
        resubmitted=stats["serve_resubmitted"],
        affinity_hits=stats["router_affinity_hits"],
        replacement_s=replace[0].get("recovery_s"),
        replace_event={k: v for k, v in replace[0].items() if k != "t"},
        flight_record_dumps=dumps, k7_launches_by_replica=by,
        k7_launches_by_device_calls=dispatch_forwards(
            calls, tp1["layers"]),
        launches=counts,
        reserved_gb_before_kill=reserved_before / 1e9,
        reserved_gb_after_replacement=reserved_after / 1e9,
        condemned_engine_collected=collected,
        token_agreement_no_chaos=agree,
        path_check_max_abs_logprob_err=err, greedy_gap=gap,
        tol=PATH_LP_TOL,
        router={k: v for k, v in stats.items() if k != "replicas"})


def launcher_fleet(kernels, tp1, weights):
    """The fleet runs (a) and (b) on launcher_llama's release; their
    streams are held to launcher_llama's through the kernels-off
    forward on the converted weights."""
    plain, wparams = kernels_off(weights)
    t0 = time.perf_counter()
    fleet_disagg(kernels, tp1, plain, wparams)
    free_cuda()
    a_s = time.perf_counter() - t0
    fleet_recover(kernels, tp1, plain, wparams)
    free_cuda()
    return {"disagg_s": a_s, "recover_s": time.perf_counter() - t0 - a_s}


# ---------------------------------------------------------------------------
# tensor-parallel serving: the launcher at --serving_tp 2, two gloo ranks
# sharing the card
# ---------------------------------------------------------------------------

TP_SERVE = 2
TP_GROUPS = 32 // TP_SERVE  # a tp 2 rank's share of Llama-2-7B's groups
RANK_STARTED = re.compile(
    r"tp rank (\d+) \(pid (\d+)\): kv pool (\d+) bytes, ([0-9.]+) GiB "
    r"allocated, ([0-9.]+) GiB reserved")
RANK_STOPPED = re.compile(r"tp rank (\d+) stopped: (\{.*\})$")


def time_serving_tp2(kernels):
    """K7 (tc design; bf16 and int8 pools, the engine's decode and mixed
    rounds) and K1 ("gtd" at the whole-batch shape of 4 rows and 320
    positions, "tgd" on the pp ring's stacked slice) at a tp 2 rank's 16
    of Llama-2-7B's 32 groups: each against its plain version (2e-2),
    beside SDPA (none reads int8 K/V) and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    g, qpk, d, bf = TP_GROUPS, 1, 128, torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k7 = {}
    for pool in ("bf16", "int8"):
        for batch in PAGED_BATCHES:
            if pool == "int8":
                sets = [variant_inputs(batch, "int8", g, qpk, d, gen)
                        for _ in range(4)]
            else:
                sets = [(paged_inputs(batch, g, qpk, d, gen), dict(
                    k_scales=None, v_scales=None, window=None,
                    doc_starts=None)) for _ in range(4)]
            q0, kp0 = sets[0][0][:2]
            design = pa.paged_design(q0.dtype, kp0.dtype, PAGE)
            check(design == "tc", f"K7 {pool} at the tp 2 shape: {design}")
            got = _launch(pa.paged_attention, sets[0])
            ref = _launch(pa._xla_paged_reference, sets[0])
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            check(err <= BF16_TOL, f"K7 {pool} {batch} at the tp 2 shape: "
                                   f"{err}")
            del got, ref
            pick = rotating(lambda i: sets[i], 4)
            row = {"design": design, "max_abs_err": err,
                   "ms": device_ms(lambda: _launch(pa.paged_attention,
                                                   pick())),
                   "plain_ms": device_ms(
                       lambda: _launch(pa._xla_paged_reference, pick()),
                       per_graph=10, replays=5),
                   "library_ms": None}
            if pool == "bf16":
                lib = rotating(lambda i: banded_sdpa_inputs(*sets[i]), 4)
                row["library_ms"] = device_ms(lambda: _sdpa(sdpa, lib()))
                del lib
            row["bound_ms"], row["bound_by"] = variant_bound_ms(*sets[0])
            k7[f"{pool}_{batch}"] = row
            del sets, pick
            torch.cuda.empty_cache()
    plan = pp_ring_plan(pp_prompts())
    k1 = {}
    for layout in ("gtd", "tgd"):
        if layout == "gtd":
            b, T = 4, 320
            length = T
            q = torch.randn(b, 1, g, qpk, d, generator=gen,
                            device="cuda").to(bf)
            k, v = (torch.randn(b, g, T, d, generator=gen,
                                device="cuda").to(bf) for _ in range(2))
            kt, vt = k, v
            shape = f"b{b} g{g} qpk{qpk} d{d} length{T} bf16 gtd"
        else:
            b, nm, T = plan["rows"], plan["groups"], plan["max_len"]
            length = T - 1
            stacked = [torch.randn(FT_LAYERS // PP_RANKS, nm, b, T, g, d,
                                   generator=gen, device="cuda").to(bf)
                       for _ in range(2)]
            k, v = stacked[0][-1, 1], stacked[1][-1, 1]
            q = torch.randn(b, 1, g, qpk, d, generator=gen,
                            device="cuda").to(bf)
            kt = k[:, :length].transpose(1, 2)
            vt = v[:, :length].transpose(1, 2)
            shape = (f"b{b} g{g} qpk{qpk} d{d} length{length}, the tgd "
                     f"slice of a stacked ({FT_LAYERS // PP_RANKS}, {nm}, "
                     f"{b}, {T}, {g}, {d}) bf16 cache")
        ref = dec._xla_decode(q, k, v, length, layout)
        got = dec.decode_attention(q, k, v, length, layout=layout)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(err <= BF16_TOL, f"K1 {layout} at the tp 2 shape: {err}")
        bound, by = decode_bound_ms(b, g, qpk, d, length)
        k1[layout] = {
            "shape": shape, "design": dec.decode_design(bf, qpk),
            "max_abs_err": err,
            "ms": device_ms(lambda: dec.decode_attention(
                q, k, v, length, layout=layout)),
            "plain_ms": device_ms(lambda: dec._xla_decode(
                q, k, v, length, layout), per_graph=10, replays=5),
            "library_ms": device_ms(lambda: sdpa(
                q.reshape(b, g, qpk, d), kt, vt)),
            "bound_ms": bound, "bound_by": by}
        del q, k, v, kt, vt, ref, got
        torch.cuda.empty_cache()
    say("kernel_time_serving_tp2", card=nvidia_smi(),
        shape=f"g{g} qpk{qpk} d{d} (a tp 2 rank of Llama-2-7B)", k7=k7,
        k1=k1)
    for row in kernels:
        if row["name"] == "ragged_paged_attention_tc":
            row["tp2_rank_shape"] = k7
        elif row["name"] == "decode_attention":
            row["tp2_rank_shape"] = k1


def tp_launcher_requests(port, traffic, whole):
    """The greedy requests from concurrent client threads, then the score
    and the beam request one after the other (rank 0's whole tree)."""
    results = {}

    def client(name, payload):
        results[name] = put_raw(port, payload)

    threads = [threading.Thread(target=client, args=(name, payload))
               for name, _, payload in traffic]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(all(not th.is_alive() for th in threads), "tp clients hung")
    for name, _, payload in sorted(whole, key=lambda x: x[0] != "score"):
        results[name] = put_raw(port, payload)
    return results, wall


def serving_tp_phase(kernels, tp1):
    """launcher_llama's release served by `torchrun --nproc_per_node 2 -m
    ...run_text_generation_server --serving_tp 2 --distributed_backend
    gloo`: two ranks on cuda:0, each its 16 groups of every pool, tp rank
    0 the HTTP front. The LAUNCHER_REQUESTS greedy requests over HTTP,
    then a score and a beam request (rank 0's whole tree). Held: the
    greedy log-probs within 5e-2 of launcher_llama's tp 1 streams over
    each common prefix; each rank's pool bytes exactly half of tp 1's; K7
    a rank once a layer per paged forward of the leader's round log, all
    tc; rank 0's K1 once a layer per beam step and K4 once a layer (the
    score), rank 1's neither; /metrics says the rounds are uncaptured.
    Printed: each rank's memory after the start, ms per decode advance
    and per mixed round (eager rounds, gloo through the host), the
    seconds to the banner."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    L = tp1["layers"]
    argv = tp1["argv"] + ["--serving_tp", str(TP_SERVE),
                          "--distributed_backend", "gloo"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(TP_SERVE), "-m",
           "megatron_llm_tpu_torch.tools.run_text_generation_server", *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO_DIR, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, banner = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                banner.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    started, pid0 = {}, None
    try:
        banner.wait(LAUNCH_TIMEOUT_S)
        banner_s = time.perf_counter() - t0
        check(banner.is_set(), "the tp launcher printed no banner:\n"
              + "".join(lines)[-4000:])
        deadline = time.monotonic() + 120
        while len(started) < TP_SERVE and time.monotonic() < deadline:
            for x in list(lines):
                m = RANK_STARTED.search(x)
                if m:
                    started[int(m.group(1))] = {
                        "pid": int(m.group(2)), "kv_pool_bytes":
                        int(m.group(3)), "allocated_gib": float(m.group(4)),
                        "reserved_gib": float(m.group(5))}
            time.sleep(0.1)
        check(sorted(started) == list(range(TP_SERVE)),
              "the tp ranks' start lines:\n" + "".join(lines)[-4000:])
        pid0 = started[0]["pid"]
        line = next(x for x in lines if x.startswith("serving ")).strip()
        port = int(re.search(r"http://[^:/]+:(\d+)/api", line).group(1))
        traffic, whole = launcher_traffic(stream=False)
        results, wall = tp_launcher_requests(port, traffic, whole)
        metrics = get_json(port, "/metrics")
        health = get_json(port, "/health")
    finally:
        # Ctrl-C reaches rank 0, which drains and releases rank 1
        if pid0 is not None:
            os.kill(pid0, signal.SIGINT)
        else:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            stop_tree(proc.pid)
            proc.wait()
    reader.join(timeout=10)
    text = "".join(lines)
    check(proc.returncode == 0, f"tp launcher rc {proc.returncode}:\n"
                                + text[-4000:])
    stopped = {int(m.group(1)): json.loads(m.group(2)) for m in
               (RANK_STOPPED.search(x.strip()) for x in lines) if m}
    check(sorted(stopped) == list(range(TP_SERVE)),
          "the tp ranks' stop lines:\n" + text[-4000:])
    run = {"results": results}
    generated, greedy = check_outputs(traffic, run, tok)
    agree, err = compare_streams(tp1["greedy"], greedy)
    check(err <= PATH_LP_TOL, f"tp 2 streams against tp 1: log-probs {err}")
    status, beam = results["beam"]
    check(status == 200 and len(beam["text"]) == 2
          and np.isfinite(beam["scores"]).all(), f"tp beam {status} {beam}")
    status, score = results["score"]
    check(status == 200 and all(np.isfinite(lp[:len(x) - 1]).all() for lp, x
                                in zip(score["logprobs"], whole[1][1])),
          f"tp score {status}")
    rounds = stopped[0]["rounds"]
    paged = rounds["paged_forwards"]
    launches = {}
    for r in range(TP_SERVE):
        n = stopped[r]["launches"]
        k7 = n["ragged_paged_attention"]
        check(k7 == L * paged and k7 > 0
              and n["ragged_paged_attention:tc"] == k7,
              f"tp rank {r}: K7 {k7} launches, not {L} x {paged} paged "
              f"forwards all tc ({n})")
        check(n["fused_rms_norm"] == n["flash_bwd_dq"] == 0,
              f"rank {r}: {n}")
        if r == 0:
            steps = n["decode_attention"] // L
            check(n["decode_attention"] == L * steps
                  and 1 <= steps <= BEAM_GEN
                  and n["decode_attention:gtd"] == n["decode_attention"],
                  f"tp rank 0 K1 {n}")
            check(n["flash_fwd"] == L, f"tp rank 0 K4 {n}")
        else:
            check(n["decode_attention"] == n["flash_fwd"] == 0,
                  f"tp rank {r} ran the whole-batch route: {n}")
        launches[r] = {k: n[k] for k in (
            "ragged_paged_attention", "ragged_paged_attention:tc",
            "decode_attention", "flash_fwd")}
        check(started[r]["kv_pool_bytes"] * TP_SERVE == tp1["kv_pool_bytes"],
              f"tp rank {r} pool {started[r]['kv_pool_bytes']} bytes, tp 1 "
              f"{tp1['kv_pool_bytes']}")
    check(metrics["serve_captured"] is False
          and metrics["serve_kv_pool_bytes"] == started[0]["kv_pool_bytes"],
          f"tp metrics {metrics}")
    check(health["status"] == "ok", f"tp health {health}")
    check("tp2 mesh (gloo, rounds uncaptured)" in line, line)
    shutil.rmtree(tp1["argv"][1])
    for row in kernels:
        name = {"ragged_paged_attention_tc": "ragged_paged_attention",
                "decode_attention": "decode_attention",
                "flash_fwd": "flash_fwd"}.get(row["name"])
        if name is not None:
            by = row.setdefault("launches_by_path", {})
            by["serving_tp"] = sum(launches[r][name]
                                   for r in range(TP_SERVE))
            row["launches"] = sum(by.values())
    say("serving_tp", card=nvidia_smi(), layers=L, ranks=TP_SERVE,
        backend="gloo", banner=line, banner_s=banner_s,
        rank_memory_after_start=started, kv_pool_bytes_tp1=tp1[
            "kv_pool_bytes"], requests=len(traffic) + len(whole),
        generated_tokens=generated, wall_s=wall,
        generated_tokens_per_s=generated / wall,
        greedy_token_match_fraction_tp1=agree,
        max_abs_logprob_err_tp1=err, tol=PATH_LP_TOL,
        paged_forwards=paged, launches_by_rank=launches,
        decode_ms_per_advance=rounds["decode_ms_per_advance"],
        decode_ms_per_advance_tp1_captured=tp1["decode_ms_per_advance"],
        mixed_round_ms_p50=rounds["mixed_round_ms_p50"],
        rounds=rounds, serve_captured=metrics["serve_captured"],
        note="eager rounds, every collective staged through host memory "
             "(gloo, two ranks on one card): the host's time, not NVLink")


def kernel_ms(top, names):
    """Ms per call of the kernels in `top` (`top_kernels`' list) whose
    names hold any of `names`."""
    return sum(ms for name, ms in top if any(s in name for s in names))


def falcon_kernel_ms(model, eng):
    """On the launcher's decode tree and pools (the engine stopped), from
    torch.profiler traces of eager calls: an 8-slot paged decode step at
    1000 positions (its device ms, its top kernels and K7's ms a
    launch), a mixed round's forward (K7's ms a launch), and a
    beam-shaped dense decode step, 2 rows at 216 positions (K1's ms a
    launch)."""
    L = model.cfg.num_layers
    with torch.inference_mode():
        pt = torch.zeros(eng.slots, eng.max_pages_per_slot,
                         dtype=torch.int32, device="cuda")
        for i in range(eng.slots):
            pt[i, :16] = torch.arange(1 + 16 * i, 17 + 16 * i)
        lens = torch.full((eng.slots,), 1000, dtype=torch.int32,
                          device="cuda")
        pools_k, pools_v, _, _ = eng._pools
        caches = {"k_pages_layers": pools_k, "v_pages_layers": pools_v,
                  "page_table": pt, "lengths": lens,
                  "chunk_lens": torch.ones_like(lens)}
        tok1 = torch.zeros(eng.slots, 1, dtype=torch.long, device="cuda")
        step_ms, top = top_kernels(lambda: model.forward(
            eng._dec_params, tok1, kv_caches=caches,
            position_ids=lens.long()[:, None]), n=100)
        dense = dict(model.init_kv_caches(2, 256), offset=216)
        beam_tok = torch.zeros(2, 1, dtype=torch.long, device="cuda")
        _, beam_top = top_kernels(lambda: model.forward(
            eng._dec_params, beam_tok, kv_caches=dense), n=100)
    _, k7_mixed = mixed_round_device_ms(model, eng)
    return {"eager_decode_step_device_ms": step_ms,
            "eager_decode_step_top_kernels": top[:8],
            "k7_tc_decode_ms_per_launch": kernel_ms(top, ("paged_attn",)) / L,
            "k7_tc_mixed_ms_per_launch": k7_mixed / L,
            "k1_tensor_cores_ms_per_launch": kernel_ms(
                beam_top, ("decode_mma_kernel", "decode_split_kernel")) / L}


# a cut of depth leaves every width, kernel shape and route as it was:
# Falcon-7B's depth on the serving entry path is 2 of 32 layers since the
# bert phase (4 before, 8 before the overlap_dropout phase, 16 before
# the serving_tp phase), to keep the whole smoke within 950 s; the
# phase's round trip converts its first 2 layers
FALCON_LAYERS = 2


def launcher_falcon(kernels, init_std):
    """Falcon-7B at full width and FALCON_LAYERS of its 32 layers (hidden
    4544, 71 query heads on 1 KV head, d 64, ffn 18176, vocab 65024),
    random bf16
    weights from a seed written as a release by `save_checkpoint(
    release=True)` (the layout hf2native writes); the converters checked
    at full width and 2 layers (native2hf then hf2native through the
    CLI's `main` in this process, bit-exact); then the launcher (`--model falcon`) in a thread: 8
    engine requests, a beam-2 and a score-only request. K7 (tc, qpk 71)
    and K1 (tensor_cores, qpk 71) on the path; the greedy streams
    teacher-forced through the kernels-off forward within 5e-2."""
    free_gb = need_disk(FALCON_DISK_GB)
    rel_dir, small, hf2, back = (LAUNCH_DIR / n for n in (
        "falcon", "falcon_2l", "hf_falcon_2l", "falcon_2l_back"))
    for d in (rel_dir, small, hf2, back):
        shutil.rmtree(d, ignore_errors=True)
    cfg = falcon_config(7, num_layers=FALCON_LAYERS,
                        params_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16,
                        init_method_std=init_std)
    check(dec.decode_design(torch.bfloat16, cfg.q_per_kv) == "tensor_cores",
          "K1's design at qpk 71")
    model = FalconModel(cfg)
    params = model.init(seed=SEED + 43)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(str(rel_dir), 0, params, model_cfg=cfg, release=True)
    release_write_s = time.perf_counter() - t0
    release_bytes = dir_bytes(rel_dir / "release")

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = dict(params, layers=ckpt.unflatten(
        {k: v[:2] for k, v in ckpt.flatten(params["layers"]).items()}))
    ckpt.save_checkpoint(str(small), 0, params2, model_cfg=cfg2,
                         release=True)
    trip_s = convert_here("--model", "falcon", "--direction", "native2hf",
                          "--input", small, "--output", hf2)
    trip_s += convert_here("--model", "falcon", "--direction", "hf2native",
                           "--dtype", "bfloat16", "--input", hf2,
                           "--output", back)
    trip_leaves = release_leaves_equal(back, params2)
    for d in (small, hf2, back):
        shutil.rmtree(d)
    del params2

    tok = build_tokenizer("NullTokenizer", null_vocab_size=65023)
    srv = InThreadLauncher([
        "--load", str(rel_dir), "--model", "falcon", "--tokenizer_type",
        "NullTokenizer", "--null_vocab_size", "65023", "--host",
        "127.0.0.1", "--port", "0", "--warmup_compile"])
    eng, served = srv.server.engine, srv.server.generator.model
    mem_gb = torch.cuda.memory_allocated() / 1e9
    decode_bytes = tree_bytes(eng._dec_params)
    graphs = eng.graph_stats()
    traffic, whole = launcher_traffic(stream=False)
    run = drive_launcher(srv.port, eng, traffic, whole)
    generated, greedy = check_outputs(traffic, run, tok)
    beam_steps = check_launcher_run(served.cfg, run, whole, flash=False)
    metrics = get_json(srv.port, "/metrics")
    eng.stop()  # its serve thread: the card is timed alone
    step_ms = decode_step_device_ms(served, eng)
    kernel_times = falcon_kernel_ms(served, eng)
    note_launcher_launches(kernels, "launcher_falcon", run)
    del eng, served
    srv.stop()

    # the greedy outputs teacher-forced through the no-cache forward with
    # the kernels off, on the smoke's own weights (the release's values)
    plain = FalconModel(dataclasses.replace(cfg, use_decode_attn=False))
    err, match_fraction = teacher_forced(plain, params, greedy)
    shutil.rmtree(rel_dir)
    del model, plain, params
    free_cuda()
    say("launcher_falcon", card=nvidia_smi(), config="falcon-7b",
        layers=cfg.num_layers, hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads, kv_heads=cfg.num_query_groups,
        head_dim=cfg.head_dim, ffn=cfg.ffn_hidden_size,
        vocab=cfg.padded_vocab_size, init_std=init_std,
        disk_free_gb=free_gb, release_write_s=release_write_s,
        release_bytes=release_bytes, two_layer_round_trip_s=trip_s,
        two_layer_round_trip_leaves_equal=trip_leaves, load_s=srv.load_s,
        engine_setup_s=srv.setup_s, warmup_capture_s=graphs["capture_s"],
        graphs=graphs["graphs"], memory_after_start_gb=mem_gb,
        requests=len(traffic) + len(whole), paged_forwards=run["paged"],
        launches=run["launches"], k7_variant_launches=run["variants"],
        beam_decode_steps=beam_steps, generated_tokens=generated,
        wall_s=run["wall"], generated_tokens_per_s=generated / run["wall"],
        ttft_p50_ms=metrics["serve_ttft_p50_ms"],
        decode_ms_per_advance=ms_per_advance(run["rounds"]),
        decode_step_device_ms=step_ms,
        weight_stream_floor_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
        **kernel_times, path_check_max_abs_logprob_err=err, tol=PATH_LP_TOL,
        greedy_token_match_fraction=match_fraction)
    check(err <= PATH_LP_TOL, f"falcon re-scored logprobs {err}")


# ---------------------------------------------------------------------------
# phase 3 (training kernels): K2 with rstd, K3, and flash K4-K6
# ---------------------------------------------------------------------------


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rmsnorm_train_numbers(dtype, tol, gen):
    """K2 writing rstd and K3 against `_plain_fwd` / `_plain_bwd` at a
    training microbatch's rows (n = seq 4096, h 4096) in `dtype` with the
    fp32 scale parameter: (errors, errors relative to max(1, the
    reference's max-abs), the forward's and the backward's numbers)."""
    n, h, eps = 4096, 4096, 1e-5

    def make(i):
        x = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
        g = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
        return x, g
    scale = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    x, g = make(0)
    out, rstd = rms.rms_norm_fwd(x, scale, eps, with_rstd=True)
    ref_out, ref_rstd = rms._plain_fwd(x, scale, eps)
    dx, ds = rms.rms_norm_bwd(x, scale, rstd, g)
    ref_dx, ref_ds = rms._plain_bwd(x, scale, ref_rstd, g)
    torch.cuda.synchronize()
    errs = {"out": max_err(out, ref_out), "rstd": max_err(rstd, ref_rstd),
            "dx": max_err(dx, ref_dx), "dscale": max_err(ds, ref_ds)}
    # against max(1, the reference's max-abs): normalised rows times the
    # scale reach |out| ~ 5, where one bf16 ulp is 0.03
    rel = {k: errs[k] / max(1.0, ref.abs().max().item())
           for k, ref in (("out", ref_out), ("rstd", ref_rstd),
                          ("dx", ref_dx), ("dscale", ref_ds))}
    for k, v in rel.items():
        check(v <= tol, f"K2-rstd/K3 {dtype} {k}: {v}")

    # four input sets of 64 MB: out of the 50 MB L2
    pick = rotating(make, 4)
    lib = torch.nn.functional.rms_norm
    scale_lib = scale.to(dtype)
    fwd = {
        "ms": device_ms(lambda: rms.rms_norm_fwd(pick()[0], scale, eps,
                                                 with_rstd=True)),
        "plain_ms": device_ms(lambda: rms._plain_fwd(pick()[0], scale, eps),
                              per_graph=10, replays=5),
        "library_ms": device_ms(lambda: lib(pick()[0], (h,), scale_lib,
                                            eps)),
    }
    sets = [(xi, gi, rms.rms_norm_fwd(xi, scale, eps, True)[1])
            for xi, gi in (make(i) for i in range(4))]
    bpick = rotating(lambda i: sets[i], 4)
    bwd = {
        "ms": device_ms(lambda: _k3(bpick, scale)),
        "plain_ms": device_ms(lambda: _k3(bpick, scale, plain=True),
                              per_graph=10, replays=5),
    }
    # library: F.rms_norm's backward alone, on a retained graph
    xl = sets[0][0].clone().requires_grad_(True)
    wl = scale_lib.clone().requires_grad_(True)
    yl = lib(xl, (h,), wl, eps)
    bwd["library_ms"] = profiled_ms(lambda: torch.autograd.grad(
        yl, (xl, wl), sets[0][1], retain_graph=True))
    del sets, xl, wl, yl
    # bounds: each input read once, each output written once, at 3.35 TB/s;
    # operations (~4 and ~10 a element) at the fp32 rate
    for row, nbytes, flops in (
            (fwd, 2 * n * h * 2 + 4 * h + 4 * n, 4 * n * h),
            (bwd, 3 * n * h * 2 + 4 * n + 2 * 4 * h, 10 * n * h)):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        row.update(bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations")
    name = str(dtype).replace("torch.", "")
    shape = f"n{n} h{h} {name}, fp32 scale"
    return errs, rel, dict(fwd, shape=shape), dict(bwd, shape=shape)


def check_rmsnorm_bwd_kernel(k2_row):
    """K2 writing rstd and K3 at a training microbatch's rows, in bf16
    (the training path's) and in fp16 (`--fp16`'s): errors within 2e-2
    (bf16) and 5e-3 (fp16: about 5 of its ulps at 1) of max(1, the
    reference's max-abs), times beside the plain versions, F.rms_norm and
    the bound. Adds the rstd variant's and the fp16 numbers to K2's row
    and returns K3's row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs, rel, fwd, bwd = _rmsnorm_train_numbers(torch.bfloat16, BF16_TOL,
                                                 gen)
    errs16, rel16, fwd16, bwd16 = _rmsnorm_train_numbers(torch.float16,
                                                         FP16_TOL, gen)
    say("kernel_check_rmsnorm_bwd", max_abs_err=errs, rel_err=rel,
        tol=BF16_TOL, fp16_max_abs_err=errs16, fp16_rel_err=rel16,
        fp16_tol=FP16_TOL)
    k2_row["rstd_variant"] = dict(fwd, max_abs_err=errs["out"])
    k2_row["fp16_variant"] = dict(fwd16, max_abs_err=errs16["out"],
                                  rel_err=rel16["out"])
    return dict({
        "name": "rmsnorm_bwd", "route": "triton",
        "source": "megatron_llm_tpu_torch/ops/rmsnorm.py",
        "replaces": "megatron_llm_tpu/ops/rmsnorm.py:59",
        "max_abs_err": errs["dx"],
        "fp16_variant": dict(bwd16, max_abs_err=errs16["dx"],
                             rel_err=rel16["dx"]),
    }, **bwd)


def _k3(pick, scale, plain=False):
    x, g, rstd = pick()
    if plain:
        return rms._plain_bwd(x, scale, rstd, g)
    return rms.rms_norm_bwd(x, scale, rstd, g)


FLASH_CASES = (
    # label, (b, s, t, g, qpk, d, causal)
    ("llama2_7b_train", (1, 4096, 4096, 32, 1, 128, True)),
    ("llama2_70b_attn", (1, 2048, 2048, 8, 8, 128, True)),
    ("full_attention", (2, 1000, 1536, 8, 1, 128, False)),
    ("ragged_s1000", (1, 1000, 1000, 32, 1, 128, True)),
)


def flash_inputs(shape, gen, dtype=torch.bfloat16):
    b, s, t, g, qpk, d, _ = shape

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda").to(dtype)
    return rnd(b, s, g, qpk, d), rnd(b, t, g, d), rnd(b, t, g, d), \
        rnd(b, s, g, qpk, d)


def flash_errors(q, k, v, do, causal, dlse=None):
    """K4 (o, lse) against `_xla_reference_with_lse`; K5 and K6 against
    `_plain_bwd` from the plain forward's o and lse: max-abs errors, the
    gradients' relative to their reference's max-abs."""
    b, s, g, qpk, _ = q.shape
    o, lse = fa._fwd(q, k, v, causal)
    o_ref, lse_ref = fa._xla_reference_with_lse(q, k, v, causal)
    rows = fa._lse_bsgq_to_rows(lse_ref, b, s, g, qpk)
    dl = None if dlse is None else fa._lse_bsgq_to_rows(dlse, b, s, g, qpk)
    grads = fa._bwd(q, k, v, o, lse, do, causal, dl)
    refs = fa._plain_bwd(q, k, v, o_ref, rows, do, causal, dl)
    torch.cuda.synchronize()
    errs = {"o": max_err(o, o_ref), "lse": max_err(lse, rows)}
    errs["o_rel"] = errs["o"] / max(1.0, o_ref.float().abs().max().item())
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        errs[name] = max_err(got, ref)
        errs[name + "_rel"] = errs[name] / ref.float().abs().max().item()
    return errs


def flash_errors_by_group(q, k, v, do, causal, groups=4):
    """`flash_errors` for b 1 where the plain versions' fp32 (s, t)
    tensors of every group at once do not fit (~35 GB at s = t = 8192):
    K4-K6 run once on the whole input, the plain versions `groups` KV
    groups at a time (groups are independent), each against its slice of
    the kernels' results. o's error is also given relative to its
    reference's max-abs (`o_rel`), without flash_errors' floor of 1."""
    b, s, g, qpk, _ = q.shape
    o, lse = fa._fwd(q, k, v, causal)
    grads = fa._bwd(q, k, v, o, lse, do, causal)
    lse = lse.reshape(b, g, s * qpk)
    errs = {n: 0.0 for n in ("o", "lse", "dq", "dk", "dv")}
    peak = {n: 0.0 for n in ("o", "dq", "dk", "dv")}
    for g0 in range(0, g, groups):
        sl = slice(g0, g0 + groups)
        qg, kg, vg, dog = (x[:, :, sl] for x in (q, k, v, do))
        o_ref, lse_ref = fa._xla_reference_with_lse(qg, kg, vg, causal)
        rows = fa._lse_bsgq_to_rows(lse_ref, b, s, groups, qpk)
        refs = fa._plain_bwd(qg, kg, vg, o_ref, rows, dog, causal)
        errs["lse"] = max(errs["lse"], max_err(
            lse[:, sl].reshape(rows.shape), rows))
        for name, got, ref in zip(("o", "dq", "dk", "dv"),
                                  (o,) + tuple(grads), (o_ref,) + refs):
            errs[name] = max(errs[name], max_err(got[:, :, sl], ref))
            peak[name] = max(peak[name], ref.float().abs().max().item())
        del o_ref, lse_ref, rows, refs
    torch.cuda.synchronize()
    for name in peak:
        errs[name + "_rel"] = errs[name] / peak[name]
    return errs


def causal_pairs(s, t, causal):
    """(query position, key) pairs a head attends: sum of min(t, p + 1)."""
    if not causal:
        return s * t
    full = min(s, t)
    return full * (full + 1) // 2 + max(s - t, 0) * t


def flash_bounds(shape):
    """Least time of K4, K5 and K6 at `shape`: the larger of their bf16
    tensor-core operations over 989 TFLOP/s (4, 6 and 8 flops a head, a
    pair and a d column: QK^T + PV; QK^T + dO V^T + dS K; QK^T + V dO^T +
    P^T dO + dS^T Q) and the bytes each must move over 3.35 TB/s."""
    b, s, t, g, qpk, d, causal = shape
    pairs = causal_pairs(s, t, causal) * b * g * qpk
    qb = 2 * b * s * g * qpk * d
    kvb = 2 * b * t * g * d
    rowb = 4 * b * s * g * qpk
    out = {}
    for name, f, nbytes in (("fwd", 4, 2 * qb + 2 * kvb + rowb),
                            ("dq", 6, 3 * qb + 2 * kvb + 2 * rowb),
                            ("dkv", 8, 2 * qb + 4 * kvb + 2 * rowb)):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = f * pairs * d / BF16_FLOPS * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations",
                     f * pairs * d)
    return out


def check_flash_kernels():
    """K4, K5 and K6 against their plain versions at the training shape
    (Llama-2-7B heads, s 4096, causal), Llama-2-70B's attention (g 8,
    qpk 8), full attention with t != s, a ragged s, and once with a
    nonzero lse cotangent; two backward runs bitwise equal; times at the
    training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {}
    for label, shape in FLASH_CASES:
        q, k, v, do = flash_inputs(shape, gen)
        errs[label] = flash_errors(q, k, v, do, shape[-1])
        del q, k, v, do
        torch.cuda.empty_cache()
    shape = (2, 512, 512, 8, 4, 128, True)
    q, k, v, do = flash_inputs(shape, gen)
    dlse = torch.randn(2, 512, 8, 4, generator=gen, device="cuda")
    errs["with_dlse"] = flash_errors(q, k, v, do, True, dlse)
    for label, e in errs.items():
        check(e["o"] <= BF16_TOL and e["lse"] <= 1e-3,
              f"K4 {label}: {e}")
        for name in ("dq", "dk", "dv"):
            check(e[name + "_rel"] <= BF16_TOL, f"K5/K6 {label} {name}: {e}")

    main = FLASH_CASES[0][1]
    b, s, t, g, qpk, d, causal = main
    q, k, v, do = flash_inputs(main, gen)
    o, lse = fa._fwd(q, k, v, causal)
    first = fa._bwd(q, k, v, o, lse, do, causal)
    second = fa._bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "flash backward is not deterministic")
    del first, second
    say("kernel_check_flash", max_abs_err=errs, tol=BF16_TOL,
        grad_tol="2e-2 of the reference's max-abs", deterministic=True)

    # times at the training shape (one input set is 134 MB: out of L2)
    qf, kf, vf, dof = fa._fold_q(q), fa._fold_kv(k), fa._fold_kv(v), \
        fa._fold_q(do)
    delta = fa._delta_rows(o, do).contiguous()
    ms = {
        "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, qpk, causal),
                         per_graph=5, replays=4),
        "dq": device_ms(lambda: fa.flash_bwd_dq(qf, kf, vf, dof, lse, delta,
                                                qpk, causal),
                        per_graph=5, replays=4),
        "dkv": device_ms(lambda: fa.flash_bwd_dkv(qf, kf, vf, dof, lse,
                                                  delta, qpk, causal),
                         per_graph=5, replays=4),
    }
    # the wrappers' layout copies around the kernels: q, k, v folded (and
    # o unfolded by the caller's reshape) in the forward; q, k, v, dO
    # folded and delta in the backward
    copies = {
        "fwd": device_ms(lambda: (fa._fold_q(q), fa._fold_kv(k),
                                  fa._fold_kv(v),
                                  o.reshape(b, s, -1).contiguous()),
                         per_graph=5, replays=4),
        "bwd": device_ms(lambda: (fa._fold_q(q), fa._fold_kv(k),
                                  fa._fold_kv(v), fa._fold_q(do),
                                  fa._delta_rows(o, do).contiguous()),
                         per_graph=5, replays=4),
    }
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3),
    }
    torch.cuda.empty_cache()
    # library yardstick: SDPA on (b, heads, s, d), forward, and the
    # backward alone on a retained graph; our forward + backward through
    # autograd on the same (profiler) clock
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, g * qpk, d).transpose(1, 2).detach() \
        .requires_grad_(True)
    ks = k.transpose(1, 2).detach().requires_grad_(True)
    vs = v.transpose(1, 2).detach().requires_grad_(True)
    dos = do.reshape(b, s, g * qpk, d).transpose(1, 2)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True),
                            per_graph=5, replays=4)
    ys = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
    lib_bwd = profiled_ms(lambda: torch.autograd.grad(
        ys, (qs, ks, vs), dos, retain_graph=True), iters=10)
    lib_fwd_bwd = profiled_ms(lambda: torch.autograd.grad(
        sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True), (qs, ks, vs),
        dos), iters=10)
    qa, ka, va = (x.detach().requires_grad_(True) for x in (q, k, v))
    ours_fwd_bwd = profiled_ms(lambda: torch.autograd.grad(
        fa.flash_attention(qa, ka, va, causal), (qa, ka, va), do),
        iters=10)
    del ys, qs, ks, vs, qa, ka, va
    torch.cuda.empty_cache()
    bounds = flash_bounds(main)
    tflops = {n: bounds[n][2] / (ms[n] * 1e-3) / 1e12 for n in ms}
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal bf16"
    say("kernel_time_flash", ms=ms, plain_ms=plain, layout_copy_ms=copies,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        library_fwd_bwd_ms=lib_fwd_bwd, ours_fwd_bwd_ms=ours_fwd_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, achieved_tflops=tflops,
        shape=label)
    rows = []
    for name, which, line, err, plain_ms, lib in (
            ("flash_fwd", "fwd", 262, max(e["o"] for e in errs.values()),
             plain["fwd"], lib_fwd),
            ("flash_bwd_dq", "dq", 388, max(e["dq"] for e in errs.values()),
             plain["bwd"], lib_bwd),
            ("flash_bwd_dkv", "dkv", 448,
             max(max(e["dk"], e["dv"]) for e in errs.values()), plain["bwd"],
             lib_bwd)):
        row = {
            "name": name, "route": "cuda",
            "source": "megatron_llm_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"megatron_llm_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[which], "plain_ms": plain_ms,
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            "library_ms": lib, "achieved_tflops": tflops[which],
            "shape": label, "design": "wgmma+tma",
        }
        if which != "fwd":
            row["plain_and_library_cover"] = "the whole backward (dq, dk, dv)"
        rows.append(row)
    rows[0].update(layout_copy_ms=copies["fwd"], fwd_bwd_ms=ours_fwd_bwd,
                   library_fwd_bwd_ms=lib_fwd_bwd)
    rows[1]["layout_copy_ms"] = copies["bwd"]
    return rows


FLASH_FP16_CASES = (FLASH_CASES[0], FLASH_CASES[1], FLASH_CASES[2])


def check_flash_fp16():
    """The fp16 instantiations of K4, K5 and K6 (`--fp16` training)
    against their plain versions in fp16: o within FP16_TOL of max(1, its
    reference's max-abs), lse within 1e-3, each gradient within FP16_TOL
    of its reference's max-abs, at the training shape, Llama-2-70B's GQA
    and full attention; then the times at the training shape beside the
    plain versions, SDPA in fp16 and the bound (the bf16 count of
    operations: the tensor cores' fp16 rate is bf16's 989 TFLOP/s).
    Returns the three rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    h = torch.float16
    errs = {}
    for label, shape in FLASH_FP16_CASES:
        q, k, v, do = flash_inputs(shape, gen, h)
        errs[label] = e = flash_errors(q, k, v, do, shape[-1])
        check(e["o_rel"] <= FP16_TOL and e["lse"] <= 1e-3,
              f"K4 fp16 {label}: {e}")
        for name in ("dq", "dk", "dv"):
            check(e[name + "_rel"] <= FP16_TOL,
                  f"K5/K6 fp16 {label} {name}: {e}")
        del q, k, v, do
        torch.cuda.empty_cache()
    say("kernel_check_flash_fp16", max_abs_err=errs, tol=FP16_TOL,
        grad_tol=f"{FP16_TOL} of the reference's max-abs",
        card=nvidia_smi())

    main = FLASH_CASES[0][1]
    b, s, t, g, qpk, d, causal = main
    q, k, v, do = flash_inputs(main, gen, h)
    o, lse = fa._fwd(q, k, v, causal)
    b4 = fa._rows4(lse.contiguous(), b * g, s * qpk)
    qf, kf, vf, dof = fa._fold_q(q), fa._fold_kv(k), fa._fold_kv(v), \
        fa._fold_q(do)
    delta = fa._rows4(fa._delta_rows(o, do).contiguous(), b * g, s * qpk)
    ms = {
        "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, qpk, causal),
                         per_graph=5, replays=4),
        "dq": device_ms(lambda: fa.flash_bwd_dq(qf, kf, vf, dof, b4, delta,
                                                qpk, causal),
                        per_graph=5, replays=4),
        "dkv": device_ms(lambda: fa.flash_bwd_dkv(qf, kf, vf, dof, b4,
                                                  delta, qpk, causal),
                         per_graph=5, replays=4),
    }
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3),
    }
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, g * qpk, d).transpose(1, 2).detach() \
        .requires_grad_(True)
    ks = k.transpose(1, 2).detach().requires_grad_(True)
    vs = v.transpose(1, 2).detach().requires_grad_(True)
    dos = do.reshape(b, s, g * qpk, d).transpose(1, 2)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True),
                            per_graph=5, replays=4)
    ys = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
    lib_bwd = profiled_ms(lambda: torch.autograd.grad(
        ys, (qs, ks, vs), dos, retain_graph=True), iters=10)
    del ys, qs, ks, vs
    torch.cuda.empty_cache()
    bounds = flash_bounds(main)
    tflops = {n: bounds[n][2] / (ms[n] * 1e-3) / 1e12 for n in ms}
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal fp16"
    say("kernel_time_flash_fp16", ms=ms, plain_ms=plain,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, achieved_tflops=tflops,
        shape=label, card=nvidia_smi())
    rows = []
    for name, which, line, err, plain_ms, lib in (
            ("flash_fwd_fp16", "fwd", 262,
             max(e["o"] for e in errs.values()), plain["fwd"], lib_fwd),
            ("flash_bwd_dq_fp16", "dq", 388,
             max(e["dq"] for e in errs.values()), plain["bwd"], lib_bwd),
            ("flash_bwd_dkv_fp16", "dkv", 448,
             max(max(e["dk"], e["dv"]) for e in errs.values()),
             plain["bwd"], lib_bwd)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "megatron_llm_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"megatron_llm_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[which], "plain_ms": plain_ms,
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            "library_ms": lib, "achieved_tflops": tflops[which],
            "shape": label, "design": "wgmma+tma, fp16 instantiation",
            "launches": 0, "launches_by_path": {},
        })
        if which != "fwd":
            rows[-1]["plain_and_library_cover"] = \
                "the whole backward (dq, dk, dv)"
    return rows


# ---------------------------------------------------------------------------
# phases 11-13: training at Llama-2-7B width
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_MICRO, TRAIN_STEPS = 8, 4, 8


def train_config():
    """Llama-2-7B widths at 8 of its 32 layers, seq 4096, the kernels on,
    full recompute (examples/pretrain_gpt.sh passes
    --recompute_granularity full), bf16 compute on fp32 params."""
    return llama_config(7, num_layers=TRAIN_LAYERS,
                        params_dtype=torch.float32,
                        compute_dtype=torch.bfloat16,
                        use_flash_attn=True, use_fused_rmsnorm=True,
                        remat_policy="full")


def train_tcfg(steps, log_interval=1):
    return TrainConfig(micro_batch_size=1, global_batch_size=TRAIN_MICRO,
                       train_iters=steps, lr=3e-4, lr_decay_style="constant",
                       adam_beta2=0.95, adam_eps=1e-5, weight_decay=0.1,
                       clip_grad=1.0, log_interval=log_interval,
                       eval_interval=0, seed=SEED)


def kernel_counts():
    return {"rmsnorm_fwd": rms.fused_rms_norm.launches,
            "rmsnorm_bwd": rms.rms_norm_bwd.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "decode_attention": dec.decode_attention.launches,
            "ragged_paged_attention": pa.ragged_paged_attention.launches}


FLASH_WRAPPERS = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                  "flash_bwd_dkv": fa.flash_bwd_dkv}


def fp16_counts():
    """The flash kernels' fp16 launches (part of kernel_counts())."""
    return {name: fn.launches_by_dtype["float16"]
            for name, fn in FLASH_WRAPPERS.items()}


def zero_counts():
    for fn in (rms.fused_rms_norm, rms.rms_norm_bwd, fa.flash_fwd,
               fa.flash_bwd_dq, fa.flash_bwd_dkv, dec.decode_attention,
               pa.ragged_paged_attention):
        fn.launches = 0
    dec.decode_attention.launches_by_layout = dict.fromkeys(
        dec.decode_attention.launches_by_layout, 0)
    fa.reset_counts()
    pa.ragged_paged_attention.variant_launches = dict.fromkeys(
        pa.ragged_paged_attention.variant_launches, 0)


def step_events(trainer):
    """The trainer's flight recorder's `step` events: per step its
    iteration, loss, ms and goodput bucket."""
    return [e for e in trainer.recorder.snapshot()["events"]
            if e["kind"] == "step"]


def train_slice(kernels):
    """8 steps of 4 microbatches through Trainer.setup()/train() on one
    fixed global batch (memorisation): AdamW as in the Llama 2 paper
    (beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0), lr 3e-4 held
    constant over the short run."""
    cfg = train_config()
    model = LlamaModel(cfg)
    tcfg = train_tcfg(TRAIN_STEPS)
    text = np.random.RandomState(SEED + 11).randint(
        0, cfg.padded_vocab_size,
        (TRAIN_MICRO, 1, cfg.seq_length + 1)).astype(np.int32)
    trainer = Trainer(model, tcfg,
                      ParallelConfig(num_microbatches=TRAIN_MICRO),
                      train_data_iterator=(text for _ in range(TRAIN_STEPS)))
    t0 = time.perf_counter()
    state = trainer.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats_log = []
    inner = trainer.train_step

    def step(st, txt, *a):
        out = inner(st, txt, *a)
        stats_log.append({k: out[k] for k in ("skipped", "grad_norm")})
        return out
    trainer.train_step = step
    # phase 12 at the initial weights, where the gradients are large
    path_check_train(cfg, model, state, text)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel_counts()
    trainer.train_step = inner
    L, M, S = TRAIN_LAYERS, TRAIN_MICRO, TRAIN_STEPS
    # per step: the flash forward and every layer norm run twice per layer
    # (forward and recompute), the final norm once; the backward kernels
    # once per layer (the final norm's backward too)
    expected = {"flash_fwd": 2 * L * M * S, "flash_bwd_dq": L * M * S,
                "flash_bwd_dkv": L * M * S,
                "rmsnorm_fwd": (2 * L + 1 + 2 * L) * M * S,
                "rmsnorm_bwd": (2 * L + 1) * M * S,
                "decode_attention": 0, "ragged_paged_attention": 0}
    losses = [r["loss"] for r in step_events(trainer)]
    skipped = [int(x["skipped"]) for x in stats_log]
    gnorms = [float(x["grad_norm"]) for x in stats_log]
    say("train", config="llama2-7b widths", layers=L,
        hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
        ffn=cfg.ffn_hidden_size, vocab=cfg.padded_vocab_size,
        seq=cfg.seq_length, micro_batches=M, steps=S,
        params=trainer._n_params, remat=cfg.resolved_remat_policy,
        losses=losses, grad_norms=gnorms, skipped=skipped,
        launches=launches, expected_launches=expected,
        setup_s=round(setup_s, 2), train_s=round(train_s, 2),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(state.iteration == S and len(losses) == S, "train steps")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(not any(skipped), f"skipped steps {skipped}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == expected, f"launches {launches} != {expected}")
    for row in kernels:
        if row["name"] == "rmsnorm_fwd":
            row["launches_by_path"]["train"] = launches["rmsnorm_fwd"]
            row["launches"] = sum(row["launches_by_path"].values())
        elif row["name"] in ("rmsnorm_bwd", "flash_fwd", "flash_bwd_dq",
                             "flash_bwd_dkv"):
            paths = row.setdefault("launches_by_path", {})
            paths["train"] = launches[row["name"]]
            row["launches"] = sum(paths.values())
            row["launches_per_train_step"] = launches[row["name"]] / S
    return cfg, model, trainer, state, text


def path_check_train(cfg, model, state, text):
    """One microbatch's loss and gradients at the same (initial) weights
    with the kernels on and off (grouped attention and plain RMSNorm)."""
    from megatron_llm_tpu_torch.training.trainer import get_batch

    plain = LlamaModel(dataclasses.replace(cfg, use_flash_attn=False,
                                           use_fused_rmsnorm=False))
    micro = {k: v[0] for k, v in get_batch(text[:1],
                                            device=model.device).items()}
    leaves = tree_leaves(state.params)
    out = []
    for m in (model, plain):
        loss = m.loss(state.params, **micro)
        grads = torch.autograd.grad(loss, leaves)
        out.append((loss.item(), grads))
        del loss
    (l_on, g_on), (l_off, g_off) = out
    n_on = torch.sqrt(sum(g.double().square().sum() for g in g_on)).item()
    n_off = torch.sqrt(sum(g.double().square().sum() for g in g_off)).item()
    cos = [torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()
        for a, b in zip(g_on, g_off)]
    del out, g_on, g_off
    torch.cuda.empty_cache()
    say("path_check_train", loss_on=l_on, loss_off=l_off,
        loss_abs_diff=abs(l_on - l_off), loss_tol=2e-2,
        grad_norm_on=n_on, grad_norm_off=n_off,
        grad_norm_rel_diff=abs(n_on - n_off) / n_off, grad_norm_tol=5e-2,
        min_leaf_cosine=min(cos), cosine_tol=0.98, leaves=len(cos))
    check(abs(l_on - l_off) <= 2e-2, f"train loss on/off {l_on} {l_off}")
    check(abs(n_on - n_off) / n_off <= 5e-2,
          f"grad norm on/off {n_on} {n_off}")
    check(min(cos) >= 0.98, f"leaf gradient cosine {min(cos)}")


# cuBLAS's GEMM kernels by name on the H100 (cuBLAS 12: nvjet and
# sm90_xmma kernels; CUTLASS-built ones)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def step_profile(trainer, state, text):
    """One more training step under torch.profiler (CUDA activity only):
    its wall ms, the card's busy ms, the kernels' ms in all, by flash
    kernel and for cuBLAS's GEMMs, and the ten largest kernels."""
    def step():
        stats = trainer.train_step(state, text)
        float(stats["loss"])
    _, wall, events = cuda_trace(step)
    kernels = kernel_totals(events)
    flash = {k: sum(ms for n, ms in kernels.items()
                    if f"flash_{k}_kernel" in n)
             for k in ("fwd", "bwd_dq", "bwd_dkv")}
    gemm = sum(ms for n, ms in kernels.items()
               if any(g in n.lower() for g in GEMM_NAMES)
               and "flash" not in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3,
            "busy_ms": busy_ms(events) if events else "not measured",
            "device_ms": sum(kernels.values()), "flash_ms": flash,
            "gemm_ms": gemm,
            "top10_kernels_ms": [[n[:120], round(ms, 3)] for n, ms in top]}


def throughput_train(trainer, state, text):
    """Step time over steps 2-8 (the first pays Triton's and cuBLAS's
    first calls), tokens/s, model TFLOP/s (6 N a token, the trainer's own
    formula) against 989, peak memory; then one more step under
    torch.profiler for the kernels' device time and the busy share."""
    ms = [r["ms"] for r in step_events(trainer)[1:]]
    med = float(np.median(ms))
    tokens = TRAIN_MICRO * trainer.cfg.seq_length
    tok_s, tflops = trainer.throughput(TRAIN_MICRO, med / 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = step_profile(trainer, state, text)
    wall, busy, device = prof["wall_ms"], prof["busy_ms"], prof["device_ms"]
    flash_ms = sum(prof["flash_ms"].values())
    say("throughput_train", steps_timed=len(ms), step_ms_median=med,
        step_ms=ms, tokens_per_step=tokens, tokens_per_s=tok_s,
        model_tflops=tflops, model_tflops_share_of_989=tflops / 989.0,
        peak_memory_gb_train=peak, profiled_step_wall_ms=wall,
        profiled_device_busy_ms=busy,
        device_busy_share=(busy / wall if isinstance(busy, float)
                           else "not measured"),
        device_kernel_ms_total=device, gemm_ms=prof["gemm_ms"],
        flash_kernels_ms=prof["flash_ms"], flash_ms=flash_ms,
        flash_share_of_step_wall=flash_ms / wall,
        flash_share_of_device_ms=(flash_ms / device if device
                                  else "not measured"),
        top10_kernels_ms=prof["top10_kernels_ms"], card=nvidia_smi())
    return med


def add_launches(kernels, path, launches, fp16=None):
    """Adds a path's launches to the kernels' rows: the flash kernels'
    fp16 launches (`fp16`, by kernel) to their fp16 rows, the rest to
    each kernel's row."""
    fp16 = fp16 or {}
    for row in kernels:
        name = row["name"]
        base = name[:-5] if name.endswith("_fp16") else name
        n = fp16.get(base, 0) if name.endswith("_fp16") \
            else launches.get(name, 0) - fp16.get(name, 0)
        if base not in launches or not n:
            continue
        paths = row.setdefault("launches_by_path", {})
        paths[path] = paths.get(path, 0) + n
        row["launches"] = sum(paths.values())


# 2 steps a policy since the t5 and ict phases (3 before): the step ms
# is the second's
REMAT_STEPS = 2


def activation_gb(model, params, text):
    """One microbatch's memory above what is resident before it (params,
    optimizer state and the gradients, already allocated), in GB: what
    its forward leaves for the backward (the tensors the policy keeps,
    the layers' inputs), the forward's peak, and the forward and
    backward's peak (set at the backward's end, where every layer's fp32
    weight gradient is live before the stacked leaves' gradients are
    assembled, whatever the policy)."""
    from megatron_llm_tpu_torch.training.trainer import get_batch

    micro = {k: v[0] for k, v in get_batch(text[:1],
                                            device=model.device).items()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = model.loss(params, **micro)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    fwd_peak = torch.cuda.max_memory_allocated() - base
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for p in leaves:
        p.grad = None
    return {"forward_held_gb": held / 1e9, "forward_peak_gb": fwd_peak / 1e9,
            "forward_backward_peak_gb": peak / 1e9}


# (label, policy, overrides): the trainer of phase 15 under each policy
REMAT_RUNS = (
    ("full", "full", {}),
    ("selective", "selective", {}),
    ("save_dots", "save_dots", {}),
    ("offload", "offload", {}),
    ("full_block4", "full", dict(recompute_method="block",
                                 recompute_num_layers=4)),
)


def train_remat(kernels, cfg, text):
    """Phase 15's trainer (Llama-2-7B widths, 8 layers, seq 4096, 4
    microbatches, the same initial weights from the same seed and the
    same batch) under each recompute policy for REMAT_STEPS steps:
    ms a step (median of steps 2 on), the step's peak memory (the
    optimizer's, the same for all) and one microbatch's activation memory
    (`activation_gb`: what the forward leaves for the backward, the
    forward's peak, the forward and backward's peak), and from one more
    profiled step the GEMMs' and the flash kernels' device ms; the
    launches of each kernel a step, checked against the policy: K4
    twice a remat'd layer and microbatch under "full" and once under the
    named-save-point policies (their kept o and lse answer the
    recompute), K5 and K6 once, K2 twice a layer plus the final norm in
    the forward and again in each recompute. Step 1's loss and gradient
    norm must be equal across policies (bit for bit: the kept products
    and the recomputed ones are the same kernels on the same inputs)."""
    L, M, S = TRAIN_LAYERS, TRAIN_MICRO, REMAT_STEPS
    pcfg = ParallelConfig(num_microbatches=M)
    runs = {}
    for label, policy, over in REMAT_RUNS:
        rcfg = dataclasses.replace(cfg, remat_policy=policy, **over)
        trainer = Trainer(LlamaModel(rcfg), train_tcfg(S, log_interval=S),
                          pcfg, train_data_iterator=(text for _ in range(S)))
        state = trainer.setup()
        stats_log = []
        inner = trainer.train_step

        def step(st, txt, *a):
            out = inner(st, txt, *a)
            stats_log.append((float(out["loss"]), float(out["grad_norm"]),
                              int(out["skipped"])))
            return out
        trainer.train_step = step
        torch.cuda.synchronize()
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.train(state)
        torch.cuda.synchronize()
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        trainer.train_step = inner
        prof = step_profile(trainer, state, text)
        act = activation_gb(trainer.model, state.params, text)
        n_remat = L if rcfg.recompute_method == "uniform" \
            else rcfg.recompute_num_layers
        k4 = L + (n_remat if policy == "full" else 0)
        expected = {"flash_fwd": k4 * M * S, "flash_bwd_dq": L * M * S,
                    "flash_bwd_dkv": L * M * S,
                    "rmsnorm_fwd": (2 * L + 1 + 2 * n_remat) * M * S,
                    "rmsnorm_bwd": (2 * L + 1) * M * S,
                    "decode_attention": 0, "ragged_paged_attention": 0}
        check(launches == expected,
              f"train_remat {label}: launches {launches} != {expected}")
        check(not any(sk for _, _, sk in stats_log)
              and all(np.isfinite([lo for lo, _, _ in stats_log])),
              f"train_remat {label}: {stats_log}")
        add_launches(kernels, "train_remat", launches)
        runs[label] = {
            "policy": policy, "recompute_method": rcfg.recompute_method,
            "remat_layers": n_remat,
            "step_ms": [r["ms"] for r in step_events(trainer)],
            "step_ms_median": float(np.median(
                [r["ms"] for r in step_events(trainer)[1:]])),
            "peak_memory_gb": peak, **act,
            "step1_loss": stats_log[0][0],
            "step1_grad_norm": stats_log[0][1],
            "losses": [lo for lo, _, _ in stats_log],
            "launches_per_step": {k: v / S for k, v in launches.items()},
            "gemm_ms": prof["gemm_ms"], "flash_ms": prof["flash_ms"],
            "profiled_step": {k: prof[k] for k in ("wall_ms", "busy_ms",
                                                   "device_ms")},
            "top10_kernels_ms": prof["top10_kernels_ms"][:5]}
        del trainer, state, inner, step
        free_cuda()
    first = runs["full"]
    diffs = {label: {"loss": r["step1_loss"] - first["step1_loss"],
                     "grad_norm": r["step1_grad_norm"]
                     - first["step1_grad_norm"]}
             for label, r in runs.items()}
    say("train_remat", card=nvidia_smi(), config="llama2-7b widths",
        layers=L, seq=cfg.seq_length, micro_batches=M, steps=S,
        runs=runs, step1_diff_from_full=diffs,
        step1_bitwise_equal=all(d == {"loss": 0.0, "grad_norm": 0.0}
                                for d in diffs.values()))
    check(all(d["loss"] == 0.0 for d in diffs.values()),
          f"step-1 losses differ across policies: {diffs}")
    check(all(abs(d["grad_norm"]) <= 1e-6 * first["step1_grad_norm"]
              for d in diffs.values()),
          f"step-1 gradient norms differ across policies: {diffs}")


# the depth of finetune_modes, finetune_parallel, pipeline (1 layer a
# stage) and context_parallel, which are held to each other
FT_LAYERS, FT_SEQ, FT_STEPS, FT_MICRO, FT_EVAL_INTERVAL = 2, 4096, 6, 4, 3
# the entry path's save-and-resume runs (phase 18): four 8.0 GB commits
# at 2 layers where 4 layers would make them 12.86 GB each
FT_ENTRY_LAYERS = 1
FT_CORPUS_TOKENS = 1_500_000
FT_DIR = Path(__file__).resolve().parent / "build" / "finetune_smoke"


def write_corpus(path, seed):
    """JSONL documents of random token ids from `seed` (ids below 31999,
    NullTokenizer's eod), lengths 64-8192, about FT_CORPUS_TOKENS in
    all."""
    rs = np.random.RandomState(seed)
    n = 0
    with open(path, "w") as f:
        while n < FT_CORPUS_TOKENS:
            ids = rs.randint(0, 31999, rs.randint(64, 8193))
            f.write(json.dumps({"text": " ".join(map(str, ids))}) + "\n")
            n += len(ids)
    return n


def finetune_argv(data, save, *extra):
    """`python -m megatron_llm_tpu_torch.finetune`'s flags: Llama-2-7B
    widths at FT_ENTRY_LAYERS of 32 layers, seq 4096, 4 microbatches of
    1, bf16 on fp32 AdamW as in the train phase (lr 3e-4 held constant),
    full recompute; eval every 3 steps, an interval save every 3 into
    `save` (no save for None)."""
    flags = (f"--model_name llama2 --model_size 7 --num_layers "
             f"{FT_ENTRY_LAYERS} "
             f"--seq_length {FT_SEQ} --micro_batch_size 1 "
             f"--global_batch_size {FT_MICRO} --bf16 "
             f"--recompute_granularity full --lr 3e-4 "
             f"--lr_decay_style constant --adam_beta2 0.95 --adam_eps 1e-5 "
             f"--weight_decay 0.1 --clip_grad 1.0 --tokenizer_type "
             f"NullTokenizer --null_vocab_size 31999 --split 98,2,0 "
             f"--train_iters {FT_STEPS} --eval_interval {FT_EVAL_INTERVAL} "
             f"--eval_iters 1 --log_interval 1 --seed {SEED} "
             f"--save_interval 3 --keep_latest_n 1").split()
    return flags + ["--data_path", "0.7", data[0], "0.3", data[1],
                    *(["--save", save] if save else []), *extra]


def host_rss_gb():
    """(this process's resident set now, its peak so far), GB."""
    import resource

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    now = pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


@contextlib.contextmanager
def patched(obj, name, make):
    """`obj.name` replaced by make(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def finetune_run(argv, sigterm_after=None, on_state=None):
    """One `finetune.main(argv)` with the launch counters set to 0 just
    before it, and the host facts the checks need: per step its
    iteration, loss, ms, loader ms and batch; the datasets; each save's
    blocked ms and commit s; the load's s; the state setup resumed to;
    the parallel context's backend and whether it staged collectives
    through the host. `on_state(state)` sees the final state."""
    from megatron_llm_tpu_torch import data as ft_data
    from megatron_llm_tpu_torch import finetune
    from megatron_llm_tpu_torch.training import trainer as trainer_mod
    from megatron_llm_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )

    rec = {"steps": [], "saves": [], "commits": [], "loads": [],
           "stats": [], "save_rss": []}

    def train_step(inner):
        def step(self, state, text, *a):
            stats = inner(self, state, text, *a)
            rec["stats"].append({
                "loss": float(stats["loss"]),
                "grad_norm": float(stats["grad_norm"]),
                "skipped": int(stats["skipped"]),
                "loss_scale": float(stats["loss_scale"])
                if "loss_scale" in stats else None})
            rec.setdefault("first_batch", (state.iteration, np.array(text)))
            if sigterm_after is not None and state.iteration == \
                    sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return stats
        return step

    def train(inner):
        def run(self, state):
            out = inner(self, state)
            # the loader's ms of a step: its batch-generator span
            # (under --trace_dir)
            loader = {e["args"].get("step"): e["dur"] / 1e3
                      for e in self.tracer.events()
                      if e["name"] == "batch-generator"}
            rec["steps"] = [dict(r, data_ms=loader.get(r["step"]))
                            for r in step_events(self)]
            rec["costs"] = None if self.costs is None \
                else self.costs.rows()
            rec["telemetry"] = {
                "profile_path": self.profile_path,
                "trace_path": self.trace_path,
                "gauges": {k: v for k, v in self.timers.gauges().items()
                           if isinstance(v, (int, float, str))},
                "dumps": self.recorder.dumps,
                "dump_path": self.recorder.last_dump_path,
                "goodput": self.ledger.snapshot()}
            rec["n_params"] = self._n_params
            rec["groups_in_backward"] = [
                f.groups_in_backward() for f in self._train_steps.values()]
            return out
        return run

    def setup(inner):
        def run(self, *a):
            state = inner(self, *a)
            rec["resumed"] = (state.iteration, state.consumed_train_samples)
            return state
        return run

    def save(inner):
        def run(self, iteration, *a, **kw):
            rss = host_rss_gb()
            out = inner(self, iteration, *a, **kw)
            rec["saves"].append((iteration, self.last_blocked_ms))
            rec["save_rss"].append({"iteration": iteration,
                                    "rss_gb_before": rss[0],
                                    "peak_rss_gb_before": rss[1]})
            return out
        return run

    def commit(inner):
        def run(self, path, iteration, *a):
            inner(self, path, iteration, *a)
            rec["commits"].append((iteration, self.last_commit_s))
            for r in rec["save_rss"]:
                if r["iteration"] == iteration:
                    r["peak_rss_gb_after_commit"] = host_rss_gb()[1]
        return run

    def load(inner):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            rec["loads"].append(time.perf_counter() - t0)
            return out
        return run

    def datasets(inner):
        def run(*a, **kw):
            rec["datasets"] = inner(*a, **kw)
            return rec["datasets"]
        return run

    def layout(inner):
        def run(*a, **kw):
            ctx = inner(*a, **kw)
            rec["parallel"] = {"backend": ctx.backend, "staged": ctx.staged,
                               "world": ctx.world_size, "dp": ctx.dp,
                               "pp": ctx.pp, "cp": ctx.cp, "tp": ctx.tp,
                               "rank": ctx.rank,
                               "sequence_parallel": ctx.sequence_parallel}
            return ctx
        return run

    def clock(key):
        def make(inner):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **kw)
                finally:
                    rec["clock_s"][key] = rec["clock_s"].get(key, 0.0) + (
                        time.perf_counter() - t0)
            return run
        return make

    rec["clock_s"] = {}
    prev = signal.getsignal(signal.SIGTERM)
    with contextlib.ExitStack() as stack:
        # where a run's seconds go: set-up, steps, saves and the wait
        # for their commit
        for obj, name, key in (
                (ft_data, "build_train_valid_test_datasets", "datasets"),
                (trainer_mod.Trainer, "setup", "setup"),
                (trainer_mod.Trainer, "train", "train"),
                (trainer_mod.Trainer, "train_step", "steps"),
                (trainer_mod.Trainer, "_save", "saves"),
                (trainer_mod.Trainer, "_wait_for_commit", "commit_wait")):
            stack.enter_context(patched(obj, name, clock(key)))
        for obj, name, make in (
                (finetune, "initialize_parallel", layout),
                (trainer_mod.Trainer, "train_step", train_step),
                (trainer_mod.Trainer, "train", train),
                (trainer_mod.Trainer, "setup", setup),
                (trainer_mod, "load_checkpoint", load),
                (CheckpointManager, "save", save),
                (CheckpointManager, "_commit", commit),
                (CheckpointManager, "save_pieces", save),
                (CheckpointManager, "_commit_pieces", commit),
                (ft_data, "build_train_valid_test_datasets", datasets)):
            stack.enter_context(patched(obj, name, make))
        zero_counts()
        t0 = time.perf_counter()
        state = finetune.main(argv)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = kernel_counts()
        rec["fp16"] = fp16_counts()
        rec["by_causal"] = {name: dict(fn.launches_by_causal)
                            for name, fn in FLASH_WRAPPERS.items()}
    signal.signal(signal.SIGTERM, prev)
    rec["iteration"] = state.iteration
    rec["consumed"] = state.consumed_train_samples
    if on_state is not None:
        on_state(state)
    del state
    free_cuda()
    return rec


def expected_finetune_launches(steps, evals):
    """K4 runs twice a layer and microbatch (forward and the full
    recompute) and once a layer for each eval batch; K5 and K6 once a
    layer and microbatch; nothing else."""
    L, M = FT_ENTRY_LAYERS, FT_MICRO
    return {"flash_fwd": 2 * L * M * steps + L * evals,
            "flash_bwd_dq": L * M * steps, "flash_bwd_dkv": L * M * steps,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def checkpoint_leaves_equal(ckpt_dir, state):
    """Leaf by leaf, bit for bit, the model and optim files of a
    checkpoint directory (mmap'd, compared on the card) against a run's
    final state, as a save of it writes them."""
    n = 0
    for name, flat in (("model", ckpt.flatten(state.params)),
                       ("optim", ckpt.optim_flat(state.opt_state))):
        a = torch.load(os.path.join(ckpt_dir, name), mmap=True,
                       weights_only=True)
        check(set(a) == set(flat), f"{name} leaves differ")
        for k in a:
            check(torch.equal(a[k].cuda(), flat[k].detach().cuda()),
                  f"{name} leaf {k} differs between the runs")
            n += 1
    return n


def dir_bytes(path):
    """The bytes of every file under `path` (per-rank pieces included)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def check_finetune_data(rec):
    """The g++ helpers' sample indices against their numpy version, per
    corpus; the first global batch against the samples the sampler
    names (0-3 of the blend)."""
    from megatron_llm_tpu_torch.data import helpers

    train = rec["datasets"][0]
    n = 0
    for ds in train.datasets:
        sizes = ds.indexed_dataset.sizes
        tpe = int(np.sum(sizes[np.unique(ds.doc_idx)]))
        epochs = len(ds.doc_idx) // len(np.unique(ds.doc_idx))
        plain = helpers.build_sample_idx_np(sizes, ds.doc_idx, FT_SEQ,
                                            epochs, tpe)
        check(np.array_equal(plain, ds.sample_idx),
              "g++ sample index != numpy")
        n += len(plain)
    step, first = rec["first_batch"]
    want = np.stack([train[i]["text"] for i in range(FT_MICRO)])
    check(step == 1 and np.array_equal(first.reshape(FT_MICRO, -1), want),
          "first batch != the sampler's samples")
    return n


def telemetry_argv(tel):
    """Run R's telemetry flags: the recipe's tensorboard flags
    (examples/finetune.sh:77), the span tracer, the cost registry, the
    armed perf sentinel, the memory gauges, and the profile window over
    step 5, all under `tel`."""
    return ["--tensorboard_dir", str(tel / "tb"),
            "--log_timers_to_tensorboard", "--trace_dir",
            str(tel / "trace"), "--device_cost_registry",
            "--perf_sentinel_ksigma", "8", "--log_memory_to_tensorboard",
            "--profile", "--profile_step_start", "4",
            "--profile_step_end", "5", "--profile_dir",
            str(tel / "profile")]


def check_finetune_telemetry(R, K, C, tel):
    """Run R's event file read back by the port's own reader (both CRCs
    of every record): lm-loss at steps 1-6 equal to R's logged losses
    (float32), the recipe's iteration-time and the card's memory gauges;
    R's span trace: one train-step span a step; its profile window
    (step 5): K4, K5 and K6 by kernel name; K's sigterm dump: loads, with
    the goodput snapshot; the registry's train.step FLOPs beside the
    analytic count. Also the telemetry's cost a step: R's steps 2, 3 and
    6 (telemetry on, outside the profile window) against K's 2 and 3 and
    C's 5 and 6 (telemetry off), the same batches."""
    from megatron_llm_tpu_torch.telemetry.chipspec import (
        train_flops_per_token,
    )
    from megatron_llm_tpu_torch.training.tensorboard import read_events

    files = sorted((tel / "tb").glob("events.out.tfevents.*"))
    check(len(files) == 1, f"R's event files {files}")
    scalars = {}
    for ev in read_events(str(files[0])):
        for v in ev.get("values", []):
            if "simple_value" in v:
                scalars.setdefault(v["tag"], {})[ev["step"]] = \
                    v["simple_value"]
    losses = {s["step"]: s["loss"] for s in R["steps"]}
    check(scalars.get("lm-loss") == {
        k: float(np.float32(v)) for k, v in losses.items()}
        and sorted(losses) == list(range(1, 7)),
        f"lm-loss events {scalars.get('lm-loss')} != R's {losses}")
    for tag, steps in (("iteration-time", range(1, 7)),
                       ("mem-bytes-in-use", range(1, 7)),
                       ("max-memory-allocated-bytes", [0])):
        check(sorted(scalars.get(tag, {})) == list(steps),
              f"event tag {tag}: steps {sorted(scalars.get(tag, {}))}")
    trace_path = R["telemetry"]["trace_path"]
    with open(trace_path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e["name"] == "train-step"]
    check([e["args"]["step"] for e in spans] == list(range(1, 7)),
          f"train-step spans {[e['args'] for e in spans]}")
    with open(R["telemetry"]["profile_path"]) as f:
        window = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    named = {k: sum(f"{k}_kernel" in e["name"] for e in window)
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # step 5 of full recompute: K4 twice a layer and microbatch, K5 and
    # K6 once
    want = {"flash_fwd": 2 * FT_ENTRY_LAYERS * FT_MICRO,
            "flash_bwd_dq": FT_ENTRY_LAYERS * FT_MICRO,
            "flash_bwd_dkv": FT_ENTRY_LAYERS * FT_MICRO}
    check(named == want, f"profile window kernels {named} != {want}")
    dumps = sorted((tel / "K_records").glob("flight_record_sigterm_*"))
    check(len(dumps) == 1, f"K's sigterm dumps {dumps}")
    with open(dumps[0]) as f:
        dump = json.load(f)
    check(dump["extra"]["step"] == 3
          and dump["extra"]["goodput"]["productive_steps"] == 2,
          f"K's sigterm dump {dump['extra']}")
    rec = next(r for r in R["costs"] if r["contract"] == "train.step")
    analytic = train_flops_per_token(
        R["n_params"], FT_ENTRY_LAYERS, 4096, FT_SEQ) * FT_MICRO * FT_SEQ
    on = [R["steps"][i]["ms"] for i in (1, 2, 5)]
    off = [K["steps"][1]["ms"], K["steps"][2]["ms"], C["steps"][1]["ms"],
           C["steps"][2]["ms"]]
    gauges = R["telemetry"]["gauges"]
    return {"event_tags": sorted(scalars), "lm_loss_events": scalars[
                "lm-loss"], "train_step_spans": len(spans),
            "profile_window_kernels": named,
            "profile_window_kernel_events": len(window),
            "sigterm_dump": str(dumps[0].name),
            "registry_train_step_flops": rec["flops"],
            "registry_train_step_bytes": rec["bytes_accessed"],
            "analytic_train_step_flops": analytic,
            "registry_over_analytic": rec["flops"] / analytic,
            "train_mfu": gauges.get("train_mfu"),
            "train_mfu_source": gauges.get("train_mfu_source"),
            "chip_spec": gauges.get("chip_spec"),
            "train_step_hbm_frac": gauges.get("train_step_hbm_frac"),
            "goodput_R": R["telemetry"]["goodput"],
            "step_ms_telemetry_on_R_2_3_6": on,
            "step_ms_telemetry_off_K_2_3_C_5_6": off,
            "telemetry_ms_per_step_median_diff":
                float(np.median(on) - np.median(off)),
            "profiled_step_ms_R_5": R["steps"][4]["ms"],
            "registry_step_ms_R_1": R["steps"][0]["ms"],
            "first_step_ms_K_1": K["steps"][0]["ms"]}


def finetune_phase(kernels, train_step_ms):
    """The training entry path: two seeded JSONL corpora through
    preprocess_data, then `finetune.main` three times: R uninterrupted
    (interval save at 3, final at 6) with every telemetry flag of the
    recipe and more (`telemetry_argv`), K the same with SIGTERM after
    step 3 (emergency save at 3, its flight record dumped), C resuming K
    to 6 without a save. C's losses and final state must equal R's final
    checkpoint bit for bit: the telemetry changes nothing the trainer
    computes."""
    from megatron_llm_tpu_torch.tools import preprocess_data

    shutil.rmtree(FT_DIR, ignore_errors=True)
    FT_DIR.mkdir(parents=True)
    data, tokens, t_pre = [], 0, 0.0
    # A through 2 spawned workers, B in this process (since the t5 and
    # ict phases; a spawned pool's start costs seconds in this process)
    for name, seed, workers in (("A", SEED + 31, "2"),
                                ("B", SEED + 37, "1")):
        jsonl = FT_DIR / f"{name}.jsonl"
        tokens += write_corpus(jsonl, seed)
        t0 = time.perf_counter()
        preprocess_data.main([
            "--input", str(jsonl), "--output_prefix", str(FT_DIR / name),
            "--tokenizer_type", "NullTokenizer", "--null_vocab_size",
            "31999", "--append_eod", "--workers", workers])
        t_pre += time.perf_counter() - t0
        data.append(str(FT_DIR / f"{name}_text_document"))
    free_gb = shutil.disk_usage(FT_DIR).free / 1e9
    say("finetune_data", card=nvidia_smi(), corpus_tokens=tokens,
        preprocess_s=t_pre,
        disk_free_gb_before_saves=free_gb)

    r_dir, k_dir = str(FT_DIR / "R"), str(FT_DIR / "K")
    tel = FT_DIR / "telemetry"
    runs = {"R": finetune_run(finetune_argv(
        data, r_dir, *telemetry_argv(tel)))}
    runs["K"] = finetune_run(finetune_argv(data, k_dir,
                                           "--exit_signal_handler",
                                           "--flight_record_dir",
                                           str(tel / "K_records")),
                             sigterm_after=3)
    c_state = []
    runs["C"] = finetune_run(finetune_argv(data, None, "--load", k_dir),
                             on_state=c_state.append)
    R, K, C = runs["R"], runs["K"], runs["C"]
    for name, (steps, evals) in {"R": (6, 2), "K": (3, 1),
                                 "C": (3, 1)}.items():
        want = expected_finetune_launches(steps, evals)
        check(runs[name]["launches"] == want,
              f"run {name} launches {runs[name]['launches']} != {want}")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in R["launches"]}

    r_losses = {s["step"]: s["loss"] for s in R["steps"]}
    c_losses = {s["step"]: s["loss"] for s in C["steps"]}
    check(sorted(r_losses) == list(range(1, 7)), f"R steps {r_losses}")
    check(all(np.isfinite(list(r_losses.values()))), "R losses")
    check([s["step"] for s in K["steps"]] == [1, 2, 3]
          and K["iteration"] == 3, "K did not stop at iteration 3")
    check(K["saves"][-1][0] == 3 and os.path.isfile(
        os.path.join(k_dir, "iter_0000003", "COMPLETE")),
        "K made no save at 3")
    check(C["resumed"] == (3, 12), f"C resumed at {C['resumed']}")
    check(sorted(c_losses) == [4, 5, 6], f"C steps {c_losses}")
    check(all(c_losses[s] == r_losses[s] for s in (4, 5, 6)),
          f"C losses {c_losses} != R's {r_losses}")
    check(C["consumed"] == R["consumed"] == 24, "consumed samples")
    step, first = C["first_batch"]
    want = np.stack([R["datasets"][0][i]["text"] for i in range(12, 16)])
    check(step == 4 and np.array_equal(first.reshape(FT_MICRO, -1), want),
          "C's first batch is not samples 12-15")
    samples = check_finetune_data(R)
    telemetry = check_finetune_telemetry(R, K, C, tel)
    r_final = os.path.join(r_dir, "iter_0000006")
    ckpt_bytes = dir_bytes(r_final)
    leaves = checkpoint_leaves_equal(r_final, c_state.pop())
    check(not os.path.exists(os.path.join(r_dir, "iter_0000003")),
          "keep_latest_n 1 left iteration 3 in R")
    # the corpora stay for finetune_modes
    shutil.rmtree(r_dir)
    shutil.rmtree(k_dir)

    ms = [s["ms"] for s in R["steps"][1:]]
    med = float(np.median(ms))
    # the trainer's formula: 6 N FLOPs a token
    tok_s = FT_MICRO * FT_SEQ / (med / 1e3)
    tflops = tok_s * 6 * R["n_params"] / 1e12
    say("finetune", card=nvidia_smi(),
        config="llama2-7b widths via finetune.main",
        layers=FT_ENTRY_LAYERS, seq=FT_SEQ, micro_batches=FT_MICRO,
        params=R["n_params"], losses_R=[r_losses[s] for s in range(1, 7)],
        losses_C=[c_losses[s] for s in (4, 5, 6)],
        resumed_iteration=C["resumed"][0],
        resumed_consumed_samples=C["resumed"][1],
        step_ms_median_2_6=med, step_ms_R=[s["ms"] for s in R["steps"]],
        train_phase_step_ms_median=train_step_ms,
        tokens_per_s=tok_s, model_tflops=tflops,
        loader_ms_per_step=[s["data_ms"] for s in R["steps"]],
        loader_ms_median=float(np.median([s["data_ms"]
                                          for s in R["steps"]])),
        saves_blocked_ms={n: r["saves"] for n, r in runs.items()},
        commits_s={n: r["commits"] for n, r in runs.items()},
        load_s=C["loads"], checkpoint_bytes=ckpt_bytes,
        checkpoint_leaves_equal=leaves, sample_idx_rows_checked=samples,
        run_wall_s={n: r["wall_s"] for n, r in runs.items()},
        telemetry=telemetry,
        launches=launches, expected_launches={
            k: sum(expected_finetune_launches(*se)[k]
                   for se in ((6, 2), (3, 1), (3, 1)))
            for k in launches})
    for row in kernels:
        if row["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row["launches_by_path"]["finetune"] = launches[row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
    return data


def mode_argv(data, *extra):
    """`finetune.main`'s flags for finetune_modes: Llama-2-7B widths at
    FT_LAYERS of 32 layers, seq 4096, 4 microbatches of 1, the corpora
    of finetune_data, no evaluation and no --save (a commit costs 16-27
    s); the mode's flags in `extra`."""
    flags = (f"--model_name llama2 --model_size 7 --num_layers {FT_LAYERS} "
             f"--seq_length {FT_SEQ} --micro_batch_size 1 "
             f"--global_batch_size {FT_MICRO} --tokenizer_type "
             f"NullTokenizer --null_vocab_size 31999 --split 98,2,0 "
             f"--eval_interval 1000 --eval_iters 1 --log_interval 1 "
             f"--seed {SEED}").split()
    return flags + ["--data_path", "0.7", data[0], "0.3", data[1],
                    *extra]


# examples/finetune.sh's training flags, less what the port does not run
# on one card
RECIPE = ("--use_flash_attn --recompute_granularity selective --lr 3e-4 "
          "--min_lr 1e-6 --lr_decay_style cosine --lr_warmup_iters 1 "
          "--weight_decay 0.1 --clip_grad 1.0 --adam_beta1 0.9 "
          "--adam_beta2 0.95 --adam_eps 1e-5 --hidden_dropout 0.0 "
          "--attention_dropout 0.0 --position_embedding_type rotary "
          "--rope_scaling_factor 1.0").split()
# the recipe's parallel flags at one rank (examples/finetune.sh:12,57-62),
# run (a) again under torchrun
RECIPE_A4_FLAGS = ["--tensor_model_parallel_size", "1", "--sequence_parallel",
                   "--use_distributed_optimizer"]
RECIPE_LEFT_OUT = {
    "--tensor_model_parallel_size 8": "1 on one card; tp 2 in "
    "finetune_parallel",
    "--pipeline_model_parallel_size": "1 in (a); 2 in the pipeline "
    "phase",
    "--context_parallel_size": "1 in (a); 2 in the context_parallel "
    "phase",
    "--tensorboard_dir, --log_timers_to_tensorboard":
        "run R of the finetune phase (and run P of finetune_parallel)",
    "--save, --load, --use_checkpoint_args, --save_interval":
        "no saves here (phase 18 holds the checkpoints)",
    "--eval_interval 50 --eval_iters 10": "no evaluation in a short run",
    "--lr_warmup_iters 2000": "1: a warmup longer than the run is refused",
}
FP16_STEPS = 16


def scaler_rule(skipped, initial=2.0 ** 32, hysteresis=2, min_scale=1.0,
                window=1000):
    """The scale each step uses under the dynamic scaler's rule (JAX
    optimizer/grad_scaler.py:63-86), given which steps overflowed."""
    out, scale, hyst, growth = [], initial, hysteresis, 0
    for bad in skipped:
        out.append(scale)
        if bad:
            hyst, growth = hyst - 1, 0
            if hyst <= 0:
                scale = max(scale / 2, min_scale)
        else:
            growth += 1
            if growth == window:
                scale, growth, hyst = scale * 2, 0, hysteresis
    return out


def finetune_modes(kernels, data):
    """`finetune.main` at Llama-2-7B widths (FT_LAYERS of 32, seq 4096) in
    the single-card training modes, the counters set to 0 before each
    run: (a) the fine-tuning recipe's training flags (flash, selective
    recompute, bf16, its AdamW): K4 once a layer and microbatch, and
    again under torchrun with the recipe's parallel flags at world size
    1, whose step costs at most 3% more than the recipe's without them,
    both timed in that torchrun process (the record of (a) is returned,
    for finetune_parallel); (b) the
    same in fp16 with the default dynamic scaler from 2^32: the scale and
    skip sequence follows the scaler's rule, the scale comes down and at
    least three steps are taken, K4-K6 run their fp16 instantiations;
    (c) hidden, attention and LIMA dropout under full recompute: no
    flash launch (attention dropout takes the grouped path), and step
    1's gradient norm equal to a run without recompute at the same seed
    (the recompute draws the same masks). Printed with the card's name
    and power limit: ms a step, losses, the sequences, launches."""
    out = {}
    recipe = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    # (a), and again under torchrun with the recipe's parallel flags: an
    # NCCL group of world size 1, where every mapping is the identity
    # and ZeRO-1 at dp 1 the replicated AdamW. The flags' step-time cost
    # is read in that fresh process alone, from runs with and without
    # them in the order A4, plain, plain, A4 (this long-lived process
    # steps up to 7% slower on some hosts)
    a = finetune_run(recipe)
    a4 = recipe + RECIPE_A4_FLAGS
    timing = run_ranks([a4, recipe, recipe, a4], nproc=1)[0][0]
    a_a4 = timing[0]
    b = finetune_run(mode_argv(data, *RECIPE, "--fp16", "--train_iters",
                               str(FP16_STEPS)))
    drop = ["--hidden_dropout", "0.1", "--attention_dropout", "0.1",
            "--lima_dropout", "--use_flash_attn", "--bf16", "--lr", "3e-4",
            "--lr_decay_style", "constant", "--clip_grad", "1.0"]
    c = finetune_run(mode_argv(data, *drop, "--recompute_granularity",
                               "full", "--train_iters", "3"))
    c_none = finetune_run(mode_argv(data, *drop, "--train_iters", "1"))
    L, M = FT_LAYERS, FT_MICRO
    for name, run, steps in (("a", a, 4), ("b", b, FP16_STEPS),
                             ("a_a4", a_a4, 4)):
        want = {"flash_fwd": L * M * steps, "flash_bwd_dq": L * M * steps,
                "flash_bwd_dkv": L * M * steps, "rmsnorm_fwd": 0,
                "rmsnorm_bwd": 0, "decode_attention": 0,
                "ragged_paged_attention": 0}
        check(run["launches"] == want,
              f"finetune_modes ({name}) launches {run['launches']} != {want}")
    check(a["fp16"] == dict.fromkeys(FLASH_WRAPPERS, 0)
          and b["fp16"] == {k: b["launches"][k] for k in FLASH_WRAPPERS},
          "finetune_modes: the fp16 run must launch the fp16 kernels only")
    for name, run in (("c", c), ("c_none", c_none)):
        check(all(run["launches"][k] == 0 for k in FLASH_WRAPPERS),
              f"finetune_modes ({name}): flash ran under attention dropout")
    scales = [st["loss_scale"] for st in b["stats"]]
    skipped = [st["skipped"] for st in b["stats"]]
    check(scales == scaler_rule(skipped),
          f"loss scale sequence {scales} does not follow the rule for "
          f"skips {skipped}")
    check(min(scales) < 2.0 ** 32 and skipped.count(0) >= 3,
          f"fp16: scale {scales}, skips {skipped}")
    check(all(st["skipped"] == 0 for st in a["stats"] + c["stats"]),
          "finetune_modes: a bf16 step was skipped")
    check(a_a4["launches"] == a["launches"],
          f"finetune_modes (a) with the A4 flags launched "
          f"{a_a4['launches']} != {a['launches']}")
    check(a_a4["parallel"] == {"backend": "nccl", "staged": False,
                               "world": 1, "dp": 1, "pp": 1, "cp": 1,
                               "tp": 1, "rank": 0,
                               "sequence_parallel": False},
          f"finetune_modes (a) under torchrun: {a_a4.get('parallel')}")
    a4_equal = [x["loss"] == y["loss"] and x["grad_norm"] == y["grad_norm"]
                for x, y in zip(a["stats"], a_a4["stats"])]
    check(all(abs(x["loss"] - y["loss"]) <= BF16_TOL
              and abs(x["grad_norm"] - y["grad_norm"])
              <= PATH_LP_TOL * y["grad_norm"]
              for x, y in zip(a["stats"], a_a4["stats"])),
          f"finetune_modes (a): the A4 flags moved the run: "
          f"{a_a4['stats']} != {a['stats']}")
    g_full, g_none = c["stats"][0]["grad_norm"], c_none["stats"][0][
        "grad_norm"]
    check(c["stats"][0]["loss"] == c_none["stats"][0]["loss"]
          and abs(g_full - g_none) <= 1e-6 * g_none,
          f"dropout: full {c['stats'][0]} != none {c_none['stats'][0]}")
    for name, run in (("a_recipe", a), ("a_recipe_a4_flags", a_a4),
                      ("b_fp16", b), ("c_dropout_full", c),
                      ("c_dropout_none", c_none)):
        ms = [st["ms"] for st in run["steps"]]
        out[name] = {
            "step_ms": ms, "step_ms_median": float(np.median(ms[1:] or ms)),
            "losses": [st["loss"] for st in run["stats"]],
            "grad_norms": [st["grad_norm"] for st in run["stats"]],
            "launches": run["launches"], "fp16_launches": run["fp16"],
            "wall_s": run["wall_s"]}
    out["b_fp16"].update(loss_scales=scales, skipped=skipped,
                         clean_steps=skipped.count(0))
    check(all(run["launches"] == a["launches"] for run in timing),
          f"finetune_modes (a) timing runs launched "
          f"{[run['launches'] for run in timing]} != {a['launches']}")
    # steps 2-4 of each run, pooled by flags
    with_a4, plain = ([ms for run in runs for ms in
                       [st["ms"] for st in run["steps"]][1:]]
                      for runs in ((timing[0], timing[3]),
                                   (timing[1], timing[2])))
    ms_ratio = float(np.median(with_a4)) / float(np.median(plain))
    out["a_recipe_a4_flags"].update(
        argv_extra=" ".join(RECIPE_A4_FLAGS), launcher="torchrun "
        "--nproc_per_node 1 (NCCL, world size 1)",
        bitwise_equal_by_step=a4_equal,
        step_ms_ratio_to_a_recipe=out["a_recipe_a4_flags"]["step_ms_median"]
        / out["a_recipe"]["step_ms_median"])
    out["a4_cost_fresh_process"] = {
        "order": "A4, plain, plain, A4 in one torchrun process",
        "step_ms_by_run": [[st["ms"] for st in run["steps"]]
                           for run in timing],
        "a4_steps_2_4_median": float(np.median(with_a4)),
        "plain_steps_2_4_median": float(np.median(plain)),
        "step_ms_ratio": ms_ratio}
    check(abs(ms_ratio - 1.0) <= 0.03,
          f"finetune_modes (a): the A4 flags cost {ms_ratio:.4f}x a step "
          f"(in one fresh process: {out['a4_cost_fresh_process']})")
    say("finetune_modes", card=nvidia_smi(), layers=FT_LAYERS, seq=FT_SEQ,
        micro_batches=FT_MICRO, recipe_flags=" ".join(RECIPE),
        recipe_left_out=RECIPE_LEFT_OUT, runs=out,
        dropout_step1_grad_norm={"full": g_full, "none": g_none,
                                 "bitwise_equal": g_full == g_none})
    for path, run in (("finetune_modes", a), ("finetune_modes", b),
                      ("finetune_modes", a_a4)):
        add_launches(kernels, path, run["launches"], run["fp16"])
    return a


# ---------------------------------------------------------------------------
# ranks in processes of their own: finetune.main under torchrun
# ---------------------------------------------------------------------------

# tp 2 x dp 2 with the recipe's parallel flags, four ranks sharing the card
# through gloo (NCCL cannot put two ranks on one device)
PAR_FLAGS = ["--tensor_model_parallel_size", "2", "--sequence_parallel",
             "--use_distributed_optimizer", "--distributed_backend", "gloo"]
PAR_RANKS, PAR_TP, PAR_DP = 4, 2, 2
# steps before the save (a gloo step takes 8-23 s on the card; 2 before
# the bert phase)
PAR_STEPS = 1
RANK_TIMEOUT_S = 600
# a positional checksum: any changed bit of a leaf changes it
_FP_CHUNK, _FP_MOD = 1 << 24, 65521


def fingerprint(x: torch.Tensor) -> int:
    """sum(bits[i] * (i % 65521 + 1)) mod 2^64 over the leaf's raw bits,
    in chunks on the card (the sum wraps, so its order does not
    matter)."""
    flat = x.detach().contiguous().view(-1)
    bits = flat.view(torch.int32 if flat.element_size() == 4
                     else torch.int16)
    total = 0
    for lo in range(0, bits.numel(), _FP_CHUNK):
        chunk = bits[lo:lo + _FP_CHUNK].to("cuda", torch.int64)
        w = (torch.arange(lo, lo + chunk.numel(), device="cuda")
             % _FP_MOD) + 1
        total += int((chunk * w).sum())
    return total % (1 << 64)


def state_fingerprints(state) -> dict:
    """Leaf name (the checkpoint files' names) -> fingerprint of this
    rank's piece."""
    out = {k: fingerprint(v) for k, v in ckpt.flatten(state.params).items()}
    for prefix, tree in (("m.", state.opt_state.m),
                         ("v.", state.opt_state.v)):
        out.update({prefix + k: fingerprint(v)
                    for k, v in ckpt.flatten(tree).items()})
    return out


def finetune_rank(out_dir, argvs_file):
    """Rank mode (`chip_smoke.py --finetune-rank OUT ARGVS`, one process
    per rank under torchrun, or alone): `finetune.main` for each argv of
    the JSON list in ARGVS, each with the counters set to 0 just before
    it; writes OUT/rank<RANK>.json with each run's step stats, host
    facts, launches, peak memory and the final state's fingerprints."""
    argvs = json.loads(Path(argvs_file).read_text())
    runs = []
    for argv in argvs:
        if isinstance(argv, dict):  # a phase's entry other than finetune
            runs.append(cp_ring(**argv) if "ring_seq" in argv
                        else cp_remat(**argv) if "policies" in argv
                        else encoder_run(**argv) if "encoder" in argv
                        else lm_task_run(**argv) if "lm_task" in argv
                        else pp_serve(**argv))
            continue
        fps = {}
        torch.cuda.reset_peak_memory_stats()
        rec = finetune_run(argv, on_state=lambda st: fps.update(
            state_fingerprints(st)))
        keep = ("stats", "steps", "launches", "fp16", "by_causal", "wall_s",
                "saves", "save_rss", "groups_in_backward",
                "commits", "loads", "iteration", "consumed", "resumed",
                "parallel", "n_params", "clock_s", "telemetry")
        out = {k: rec[k] for k in keep if k in rec}
        out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   fingerprints={k: str(v) for k, v in fps.items()})
        runs.append(out)
        print(f"rank {os.environ.get('RANK', '0')}: run {len(runs)} "
              f"wall {rec['wall_s']:.1f} s, commits {rec['commits']}, "
              f"loads {rec['loads']}, peak {out['peak_gb']:.2f} GB",
              flush=True)
    rank = int(os.environ.get("RANK", "0"))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(runs))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def run_ranks(argvs, nproc=None, timeout_s=RANK_TIMEOUT_S):
    """`finetune.main` for each argv in turn in `nproc` ranks under
    torchrun (world size nproc), or in one plain process for None: the
    rank records in rank order and rank 0's log. Past `timeout_s` every
    process of the run is killed and the phase fails."""
    out = FT_DIR / f"ranks-{time.monotonic_ns()}"
    out.mkdir(parents=True)
    (out / "argv.json").write_text(json.dumps(argvs))
    mode = [str(Path(__file__).resolve()), "--finetune-rank", str(out),
            str(out / "argv.json")]
    cmd = [sys.executable, *mode] if nproc is None else [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(nproc), *mode]
    log = out / "log.txt"
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                # the ranks run in sessions of their own: stop them by
                # the process tree, then torchrun
                stop_tree(proc.pid)
                proc.kill()
                proc.wait()
    text = log.read_text()
    check(proc.returncode == 0, f"ranks exited {proc.returncode} "
          f"({' '.join(cmd[:6])} ...):\n{text[-6000:]}")
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nproc or 1)]
    shutil.rmtree(out)
    return recs, text


def parallel_expected_launches(steps, dp=PAR_DP):
    """K4 once a layer and local microbatch under selective recompute
    (the forward keeps its output), K5 and K6 once; no eval."""
    n = FT_LAYERS * FT_MICRO // dp * steps
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def check_parallel_checkpoint(ck_dir, rank_fps, ctxs=None, zero1=True,
                              bucket_mb=4.0, overlap_grads=False):
    """Read each rank's slice of every leaf of the checkpoint the tracker
    names from its per-rank pieces (by default the slices of tp2 x dp2;
    else of the layouts `ctxs`, one a rank), as a resume reads them, and
    hold its fingerprint to the piece the rank saved: (leaves checked,
    iteration). The checkpoint must be the per-rank form with every
    rank's marker. A checkpoint without optimizer state is held to the
    ranks' parameters. Only the pieces that overlap a rank's slice are
    read, memory mapped."""
    from types import SimpleNamespace

    from megatron_llm_tpu_torch.training.trainer import StateLayout

    path, meta = ckpt.tracked_checkpoint(ck_dir)
    check(os.path.isdir(os.path.join(path, "model")),
          f"{path} is not the per-rank form")
    check(len(os.listdir(os.path.join(path, ckpt.DONE_DIR)))
          == len(rank_fps), f"{path}: not every rank's marker")
    model = ckpt.Pieces(path, "model")
    optim = ckpt.Pieces(path, "optim") \
        if os.path.isdir(os.path.join(path, "optim")) else None
    tmpl = ckpt.unflatten({k: torch.empty(model.shapes[k],
                                          dtype=model.dtypes[k],
                                          device="meta")
                           for k in model.names()})
    leaves = {k: model for k in model.names()}
    if optim is not None:
        leaves.update({k: optim for k in optim.names()
                       if k.startswith(("m.", "v."))})
    if ctxs is None:
        ctxs = [SimpleNamespace(tp=PAR_TP, dp=PAR_DP, tp_rank=r % PAR_TP,
                                dp_rank=r // PAR_TP)
                for r in range(len(rank_fps))]
    layouts = []
    for r, (fps, ctx) in enumerate(zip(rank_fps, ctxs)):
        if optim is None:
            fps = {k: v for k, v in fps.items()
                   if not k.startswith(("m.", "v."))}
            rank_fps[r] = fps
        check(set(leaves) == set(fps), f"rank {r}: checkpoint leaves "
              f"{sorted(set(leaves) ^ set(fps))[:4]} differ")
        layouts.append(StateLayout(ctx, None, tmpl, zero1=zero1,
                                   bucket_mb=bucket_mb,
                                   overlap_grads=overlap_grads))
    checked = 0
    for name, pieces in leaves.items():
        for r, (lay, fps) in enumerate(zip(layouts, rank_fps)):
            # on the card first: the checksum's int64 widening runs there
            piece = pieces.read(name, lay.region(
                name, pieces.shapes[name])).to("cuda")
            got = str(fingerprint(piece))
            check(got == fps[name], f"rank {r}: {name} read from the "
                  f"checkpoint's pieces is not the rank's saved piece")
            checked += 1
            del piece
    del model, optim, leaves
    return checked, meta["iteration"]


def check_parallel_telemetry(tel, first):
    """Run P's telemetry: one event file, rank 0's (only rank 0 writes
    tensorboard), with lm-loss at every step equal to rank 0's losses;
    one span trace a rank, the rank in its name, a train-step span a
    step."""
    from megatron_llm_tpu_torch.training.tensorboard import read_events

    files = sorted((tel / "tb").glob("events.out.tfevents.*"))
    check(len(files) == 1, f"run P's event files {files}")
    lm = {ev["step"]: v["simple_value"]
          for ev in read_events(str(files[0]))
          for v in ev.get("values", []) if v["tag"] == "lm-loss"}
    want = {s["step"]: float(np.float32(s["loss"]))
            for s in first[0]["steps"]}
    check(lm == want and len(want) == PAR_STEPS,
          f"run P lm-loss events {lm} != rank 0's {want}")
    traces = {}
    for r, run in enumerate(first):
        path = run["telemetry"]["trace_path"]
        check(path is not None and Path(path).name.startswith(
            f"trace_train_rank{r}_"), f"rank {r}'s trace {path}")
        with open(path) as f:
            traces[r] = sum(e["name"] == "train-step"
                            for e in json.load(f)["traceEvents"])
    check(set(traces.values()) == {PAR_STEPS}
          and len(list((tel / "trace").iterdir())) == PAR_RANKS,
          f"run P's traces {traces}")
    return {"event_files": [f.name for f in files], "lm_loss_events": lm,
            "train_step_spans_per_rank": traces}


def finetune_parallel(kernels, data, one, enc, lm):
    """`torchrun --nproc_per_node 4 ... finetune.main` at tp 2 x dp 2
    with sequence parallelism and ZeRO-1 over gloo, the four ranks on
    cuda:0, on the recipe's flags at Llama-2-7B widths (FT_LAYERS of 32,
    seq 4096, selective recompute, bf16, global batch 4): PAR_STEPS steps
    and a save, then the same ranks resume it for one more step; world
    size 1 resumes it too. Held to `one` (finetune_modes' run (a): world
    size 1, the
    same weights and batches): losses within 2e-2, grad norms within
    5e-2; the checkpoint cut back into each rank's pieces bit for bit;
    K4-K6 launches per rank as the layout implies; per-rank peak
    memory. The same four ranks then run the encoder_parallel phase's
    entries (`encoder_argvs(enc)`) and the lm_tasks_parallel phase's
    tasks (`lm_task_argvs(*lm)`): returns their records, (encoder
    records, task records), one list a rank each, which those phases
    check."""
    ck = FT_DIR / "parallel_ck"
    tel = FT_DIR / "parallel_telemetry"
    base = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    t0 = time.perf_counter()
    n, after = str(PAR_STEPS), ["--exit_interval", str(PAR_STEPS + 1)]
    # run P: the recipe's tensorboard flag and the span tracer; then the
    # encoder entries in the same ranks
    ranks, log = run_ranks(
        [base + PAR_FLAGS + ["--exit_interval", n, "--save_interval", n,
                             "--save", str(ck), "--tensorboard_dir",
                             str(tel / "tb"), "--trace_dir",
                             str(tel / "trace")],
         base + PAR_FLAGS + ["--load", str(ck)] + after]
        + [{"encoder": m, "argv": par} for m, par, _ in encoder_argvs(enc)]
        + [{"lm_task": n, "argv": a} for n, a in lm_task_argvs(*lm)],
        nproc=PAR_RANKS)
    ranks_s = time.perf_counter() - t0
    n_enc = len(encoder_argvs(enc))
    encoder_recs = [r[2:2 + n_enc] for r in ranks]
    lm_recs = [r[2 + n_enc:] for r in ranks]
    first = [r[0] for r in ranks]
    resumed = [r[1] for r in ranks]
    ref = one["stats"]
    p_telemetry = check_parallel_telemetry(tel, first)
    for r, run in enumerate(first):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": 4, "dp": PAR_DP, "pp": 1,
                                  "cp": 1, "tp": PAR_TP, "rank": r,
                                  "sequence_parallel": True},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == first[0]["stats"],
              f"rank {r} reports another global loss or grad norm")
        check(run["launches"] == parallel_expected_launches(PAR_STEPS),
              f"rank {r} launches {run['launches']} != "
              f"{parallel_expected_launches(PAR_STEPS)}")
        check(resumed[r]["resumed"] == [PAR_STEPS, FT_MICRO * PAR_STEPS]
              and resumed[r]["launches"] == parallel_expected_launches(1),
              f"rank {r} resumed {resumed[r].get('resumed')} with "
              f"{resumed[r]['launches']}")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(first[0]["stats"], ref)]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(first[0]["stats"], ref)]
    check(len(loss_err) == PAR_STEPS and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"tp2 x dp2 against world size 1: loss err {loss_err}, grad "
          f"norm rel err {gnorm_err}")
    leaves, iteration = check_parallel_checkpoint(
        ck, [run["fingerprints"] for run in first])
    check(iteration == PAR_STEPS, f"the save is at iteration {iteration}")
    t0 = time.perf_counter()
    ws1 = finetune_run(base + ["--load", str(ck)] + after)
    ws1_s = time.perf_counter() - t0
    step4 = {"tp2_dp2_resumed": resumed[0]["stats"][0]["loss"],
             "world1_resumed": ws1["stats"][0]["loss"],
             "world1_uninterrupted": ref[PAR_STEPS]["loss"]}
    check(ws1["resumed"] == (PAR_STEPS, FT_MICRO * PAR_STEPS) and abs(
        step4["world1_resumed"] - step4["tp2_dp2_resumed"]) <= BF16_TOL
        and abs(step4["world1_resumed"] - step4["world1_uninterrupted"])
        <= BF16_TOL, f"step {PAR_STEPS + 1} after the resume: {step4}")
    ckpt_bytes = dir_bytes(os.path.join(ck, f"iter_{PAR_STEPS:07d}"))
    shutil.rmtree(ck)
    ms = [s["ms"] for s in first[0]["steps"]]
    peak = [run["peak_gb"] for run in first]
    say("finetune_parallel", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PAR_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main in each rank)",
        flags=" ".join(PAR_FLAGS), layout="tp 2 x dp 2, sequence parallel, "
        "ZeRO-1, every rank on cuda:0", backend="gloo",
        collectives_staged_through_host=first[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        losses=[x["loss"] for x in first[0]["stats"]],
        losses_world1=[y["loss"] for y in ref[:PAR_STEPS]],
        grad_norms=[x["grad_norm"] for x in first[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ref[:PAR_STEPS]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL},
        step_ms=ms, step_ms_label="gloo through the host, one card shared "
        "by 4 ranks (not comparable with a one-rank step)",
        step_ms_world1=[s["ms"] for s in one["steps"]],
        peak_gb_per_rank=peak, peak_gb_sum=sum(peak),
        launches_per_rank=[run["launches"] for run in first],
        expected_launches_per_rank=parallel_expected_launches(PAR_STEPS),
        steps_before_save=PAR_STEPS, telemetry_run_P=p_telemetry,
        checkpoint_leaves_checked=leaves, checkpoint_bytes=ckpt_bytes,
        checkpoint_form="per-rank pieces (model/, optim/, done/ a rank)",
        saves_blocked_ms=first[0]["saves"], commits_s=first[0]["commits"],
        saves_blocked_ms_per_rank=[run["saves"] for run in first],
        commits_s_per_rank=[run["commits"] for run in first],
        save_host_rss_gb_rank0=first[0]["save_rss"],
        save_s_rank0=first[0]["clock_s"].get("saves"),
        commit_wait_s_rank0=first[0]["clock_s"].get("commit_wait"),
        load_s_per_rank=[run["loads"] for run in resumed],
        load_s_world1=ws1["loads"], resumed_step_losses=step4,
        ranks_wall_s=ranks_s, world1_resume_wall_s=ws1_s,
        encoder_rank_wall_s_rank0=[r["wall_s"] for r in encoder_recs[0]],
        lm_task_rank_wall_s_rank0=[r["wall_s"] for r in lm_recs[0]],
        rank0_run_wall_s=[first[0]["wall_s"], resumed[0]["wall_s"]],
        rank0_clock_s=[first[0]["clock_s"], resumed[0]["clock_s"]],
        quantized_grad_reduce="not run on the card (CPU tests only)",
        rank0_log_tail=log[-1500:])
    for row in kernels:
        name = row["name"]
        if name in FLASH_WRAPPERS:
            per = [run["launches"][name] + res["launches"][name]
                   for run, res in zip(first, resumed)]
            row["launches_by_path"]["finetune_parallel"] = sum(per)
            row.setdefault("launches_per_rank", {})[
                "finetune_parallel"] = per
            row["launches"] = sum(row["launches_by_path"].values())
    return encoder_recs, lm_recs


# ---------------------------------------------------------------------------
# the encoder family at tp 2 x dp 2 + SP + ZeRO-1: finetune_parallel's four
# ranks run the entries, world size 1 runs them here
# ---------------------------------------------------------------------------

ENC_PAR_LAYERS = 2


def _set_flags(argv, **values):
    """`argv` with each --name's value replaced."""
    argv = list(argv)
    for name, value in values.items():
        argv[argv.index(f"--{name}") + 1] = str(value)
    return argv


def encoder_argvs(enc):
    """(entry module, the ranks' argv, world size 1's argv) of
    pretrain_bert, pretrain_t5 and pretrain_ict at the bert, t5 and ict
    phases' recipes cut to ENC_PAR_LAYERS layers (a side), one step,
    dropout on as in the recipes, bf16. Both runs take the same global
    batch (world size 1 as one microbatch, a dp rank its half) and the
    same padded vocabulary (tp 2 pads to 2 x 128, world size 1 to 256),
    so the same seed draws the same weights."""
    common = ["--vocab_file", str(enc["vocab"]), "--data_path", enc["data"],
              "--train_iters", "1", "--log_interval", "1",
              "--seed", str(SEED)]
    out = []
    for module, recipe, batch, extra in (
            ("pretrain_bert", BERT_RECIPE, BERT_GLOBAL, []),
            ("pretrain_t5", T5_RECIPE, T5_BATCH, []),
            ("pretrain_ict", ICT_RECIPE, ICT_BATCH,
             ["--titles_data_path", enc["titles"]])):
        flags = _set_flags(recipe.split(), num_layers=ENC_PAR_LAYERS,
                           micro_batch_size=batch) + common + extra
        par = _set_flags(flags, micro_batch_size=batch // PAR_DP) \
            + PAR_FLAGS + ["--make_vocab_size_divisible_by", "128"]
        out.append((module, par,
                    flags + ["--make_vocab_size_divisible_by", "256"]))
    return out


def encoder_run(encoder, argv):
    """`<encoder>.main(argv)` (pretrain_bert, pretrain_t5 or
    pretrain_ict, in the smoke's process or in a rank) with the launch
    counters set to 0 just before it: each step's loss, grad norm and
    ms, the K1-K7 launches, the wall, the peak memory and the layout."""
    import importlib

    from megatron_llm_tpu_torch.parallel.mesh import get_context

    entry = importlib.import_module(f"megatron_llm_tpu_torch.{encoder}")
    stats, seen = [], {}

    def train_step(orig):
        def wrapped(self, state, text, *a, **kw):
            out = orig(self, state, text, *a, **kw)
            seen["trainer"] = self
            stats.append({"loss": float(out["loss"]),
                          "grad_norm": float(out["grad_norm"])})
            return out
        return wrapped

    def setup(orig):
        def wrapped(self, *a, **kw):
            ctx = get_context()
            seen["layout"] = None if ctx is None or ctx.world_size == 1 \
                else {"world": ctx.world_size, "dp": ctx.dp, "tp": ctx.tp,
                      "rank": ctx.rank,
                      "sequence_parallel": ctx.sequence_parallel,
                      "backend": ctx.backend, "staged": ctx.staged,
                      "zero1": self.pcfg.use_distributed_optimizer}
            return orig(self, *a, **kw)
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with patched(Trainer, "train_step", train_step), \
            patched(Trainer, "setup", setup):
        state = entry.main(argv)
    wall = time.perf_counter() - t0
    for s, e in zip(stats, step_events(seen["trainer"])):
        s["ms"] = e["ms"]
    rec = {"encoder": encoder, "stats": stats, "launches": kernel_counts(),
           "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "parallel": seen["layout"], "iteration": state.iteration}
    del state, seen
    free_cuda()
    return rec


def encoder_parallel(kernels, enc, recs):
    """pretrain_bert (BERT-large widths), pretrain_t5 (T5-base) and
    pretrain_ict (BERT-base towers) at ENC_PAR_LAYERS layers, one step
    each at tp 2 x dp 2 with sequence parallelism and ZeRO-1 (gloo, the
    four ranks on cuda:0; `recs`, finetune_parallel's records a rank),
    held to world size 1 run here at the same depth, weights, global
    batch, seed and dropout masks: losses within 2e-2, grad norms within
    5e-2, every rank the same loss and grad norm, K1-K7 launched on no
    rank. ICT's step 1 loss is printed beside ln 32: each query's
    softmax runs over the global batch's 32 contexts, not a rank's 16."""
    out = {}
    for i, (module, _, ws1_argv) in enumerate(encoder_argvs(enc)):
        ranks = [r[i] for r in recs]
        ws1 = encoder_run(module, ws1_argv)
        check(ws1["parallel"] is None and not any(ws1["launches"].values()),
              f"{module} at world size 1: {ws1['parallel']}, launches "
              f"{ws1['launches']}")
        for r, rec in enumerate(ranks):
            check(rec["encoder"] == module and rec["iteration"] == 1,
                  f"rank {r}: {rec['encoder']} at {rec['iteration']}")
            check(rec["parallel"] == {
                "world": PAR_RANKS, "dp": PAR_DP, "tp": PAR_TP, "rank": r,
                "sequence_parallel": True, "backend": "gloo",
                "staged": True, "zero1": True},
                f"rank {r} {module} layout {rec['parallel']}")
            check(not any(rec["launches"].values()),
                  f"rank {r} {module} launched {rec['launches']}")
            check([(s["loss"], s["grad_norm"]) for s in rec["stats"]]
                  == [(s["loss"], s["grad_norm"])
                      for s in ranks[0]["stats"]],
                  f"rank {r} reports another {module} loss or grad norm")
        par, one = ranks[0]["stats"][0], ws1["stats"][0]
        loss_err = abs(par["loss"] - one["loss"])
        gnorm_err = abs(par["grad_norm"] - one["grad_norm"]) \
            / one["grad_norm"]
        check(np.isfinite(par["loss"]) and loss_err <= BF16_TOL
              and gnorm_err <= PATH_LP_TOL,
              f"{module} tp2 x dp2 against world size 1: loss "
              f"{par['loss']} vs {one['loss']}, grad norm "
              f"{par['grad_norm']} vs {one['grad_norm']}")
        out[module] = dict(
            loss=par["loss"], loss_world1=one["loss"],
            loss_abs_err=loss_err, grad_norm=par["grad_norm"],
            grad_norm_world1=one["grad_norm"], grad_norm_rel_err=gnorm_err,
            step_ms_per_rank=[r["stats"][0]["ms"] for r in ranks],
            step_ms_world1=one["ms"],
            peak_gb_per_rank=[r["peak_gb"] for r in ranks],
            peak_gb_world1=ws1["peak_gb"],
            wall_s_per_rank=[r["wall_s"] for r in ranks],
            wall_s_world1=ws1["wall_s"])
    ict = out["pretrain_ict"]
    ict.update(ln_global_batch=float(np.log(ICT_BATCH)),
               ln_rank_batch=float(np.log(ICT_BATCH // PAR_DP)),
               loss_minus_ln_global_batch=ict["loss"]
               - float(np.log(ICT_BATCH)))
    say("encoder_parallel", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PAR_RANKS} chip_smoke.py "
        "--finetune-rank (the entries after finetune_parallel's runs)",
        flags=" ".join(PAR_FLAGS), layout="tp 2 x dp 2, sequence parallel, "
        "ZeRO-1, every rank on cuda:0", backend="gloo",
        step_ms_label="gloo through the host, one card shared by 4 ranks "
        "(not comparable with a one-rank step)",
        layers=ENC_PAR_LAYERS, steps=1, dropout="on (the recipes')",
        dtype="bf16", global_batch={"bert": BERT_GLOBAL, "t5": T5_BATCH,
                                    "ict": ICT_BATCH},
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL}, **out)
    for row in kernels:
        row.setdefault("launches_by_path", {})["encoder_parallel"] = 0


# dp 2 with ZeRO-1 under both overlap schedulers, hidden dropout live,
# two ranks sharing the card through gloo
# ---------------------------------------------------------------------------
# the GPT-family tasks of tasks.main at tp 2 x dp 2 + SP: finetune_parallel's
# four ranks run them, held here to the zeroshot and msdp phases' world
# size 1 runs
# ---------------------------------------------------------------------------

LM_TP_FLAGS = ["--tensor_model_parallel_size", "2", "--sequence_parallel",
               "--distributed_backend", "gloo"]
# the rank's KV groups: Llama-2-7B's 32 over tp 2
LM_RANK_GROUPS = 32 // PAR_TP
# LAMBADA samples whose world-size-1 top-2 logit margin is below this may
# flip under another summation order; they are counted, not held
LM_MARGIN = 5e-2
# the WikiText average loss against world size 1's (a reading of 2.5e-5
# in bf16 at tp 2 x dp 2; the loss departs from ln 32000 by about 5e-2 at
# the init std), and each rank's top logit of its vocabulary shard at
# each LAMBADA answer position against world size 1's logits there (the
# zeroshot phase's bf16 logits depart from fp32 by at most 1.3e-2)
LM_WIKI_TOL, LM_LOGIT_TOL = 1e-3, 5e-2


def lm_task_argvs(zs, ms):
    """(name, the ranks' argv) of WIKITEXT103 and LAMBADA under
    `--use_flash_attn` and MSDP-PROMPT knowledge then response: the
    zeroshot and msdp phases' argvs (their model, seed, corpora and
    files) at tp 2 x dp 2 + SP."""
    par = ["--data_parallel_size", str(PAR_DP)] + LM_TP_FLAGS
    zs_argv = _set_flags(zs["flash_argv"], data_parallel_size=PAR_DP)
    out = []
    for task, path, extra in (
            ("WIKITEXT103", zs["wiki"], ["--overlapping_eval",
                                         str(ZS_OVERLAP)]),
            ("LAMBADA", zs["lambada"], [])):
        out.append((task, zs_argv[:] + LM_TP_FLAGS + [
            "--task", task, "--valid_data", path, "--tokenizer_type",
            "NullTokenizer", "--null_vocab_size", "31999",
            "--micro_batch_size", str(ZS_MICRO), *extra]))
    for kind in ("knowledge", "response"):
        out.append((kind, _set_flags(ms["argv"], data_parallel_size=PAR_DP)
                    + par[2:] + [
                        "--task", "MSDP-PROMPT", "--sample_input_file",
                        ms["test"], "--sample_output_file",
                        str(ZS_DIR / f"msdp_{kind}_tp2dp2.txt"),
                        "--prompt_file", ms["prompts"][kind],
                        "--prompt_type", kind]))
    return out


def lm_task_run(lm_task, argv):
    """`tasks.main.main(argv)` in a rank (rank mode), the counters set to
    0 just before it: its result, the kernels' launches, the groups each
    K4 and K1 launch ran at, the ms of each evaluation batch and each
    decode step, LAMBADA's per-position hits (each batch's rows of this
    dp rank) and MSDP's greedy streams with their log-probs."""
    from megatron_llm_tpu_torch.inference import api, generation
    from megatron_llm_tpu_torch.parallel.mesh import get_context
    from megatron_llm_tpu_torch.tasks import main as tasks_main
    from megatron_llm_tpu_torch.tasks.zeroshot import evaluate as zs_eval

    seen = {"k4_bg": [], "k1_g": [], "batch_ms": [], "step_ms": [],
            "hits": [], "shard_top": [], "argmax": [], "streams": []}

    def note_cost(orig):
        def wrapped(qf, kf, causal, products, tensors):
            if products == 2:  # the forward's
                seen["k4_bg"].append(int(qf.shape[0]))
            return orig(qf, kf, causal, products, tensors)
        return wrapped

    def check_k1(orig):
        def wrapped(q, *a, **kw):
            seen["k1_g"].append(int(q.shape[2]))
            return orig(q, *a, **kw)
        return wrapped

    def eval_step(orig):
        def make(model, metric):
            step = orig(model, metric)

            def timed(*a):
                t0 = time.perf_counter()
                out = step(*a)  # a float: the batch has ended
                seen["batch_ms"].append((time.perf_counter() - t0) * 1e3)
                return out
            return timed
        return make

    def argmax(orig):
        def wrapped(logits):
            index = orig(logits)
            top = logits.max(-1)
            seen["shard_top"].append((top.values.float().cpu().tolist(),
                                      top.indices.cpu().tolist()))
            seen["argmax"].append(index.cpu().tolist())
            return index
        return wrapped

    def per_position(orig):
        def wrapped(*a, **kw):
            vals = orig(*a, **kw)
            if lm_task == "LAMBADA":
                seen["hits"].append(vals.cpu().numpy().tolist())
            return vals
        return wrapped

    def decode_step(orig):
        def wrapped(self):
            t0 = time.perf_counter()
            orig(self)
            torch.cuda.synchronize()
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return wrapped

    def generate(orig):
        def wrapped(model, params, tokenizer, prompts, **kw):
            texts, segs, lp, toks = orig(
                model, params, tokenizer, prompts,
                **dict(kw, return_output_log_probs=True))
            seen["streams"].append((tokenizer.tokenize(prompts[0]),
                                    toks[0].tolist(), lp[0].tolist(),
                                    tokenizer.eod))
            return texts, segs, lp, toks
        return wrapped

    def lm_main(orig):
        def wrapped(args, device):
            out = orig(args, device)
            ctx = get_context()
            seen["layout"] = {"world": ctx.world_size, "dp": ctx.dp,
                              "tp": ctx.tp, "pp": ctx.pp, "cp": ctx.cp,
                              "rank": ctx.rank, "dp_rank": ctx.dp_rank,
                              "sequence_parallel": ctx.sequence_parallel,
                              "backend": ctx.backend, "staged": ctx.staged}
            return out
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    decode_log.clear()
    t0 = time.perf_counter()
    with patched(fa, "_note_cost", note_cost), \
            patched(dec, "_check", check_k1), \
            patched(zs_eval, "make_eval_step", eval_step), \
            patched(zs_eval, "_per_position", per_position), \
            patched(zs_eval, "vocab_parallel_argmax", argmax), \
            patched(generation._DecodeLoop, "_step", decode_step), \
            patched(api, "generate_and_post_process", generate), \
            patched(tasks_main, "lm_main", lm_main):
        result = tasks_main.main(argv)
    wall = time.perf_counter() - t0
    rec = {"lm_task": lm_task, "result": result, "wall_s": wall,
           "launches": kernel_counts(),
           "k1_by_layout": dict(dec.decode_attention.launches_by_layout),
           "decode_calls": [dict(r) for r in decode_log],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **seen}
    free_cuda()
    return rec


def lm_tasks_parallel(kernels, zs, ms, recs):
    """WIKITEXT103 and LAMBADA under `--use_flash_attn`, then MSDP-PROMPT
    (knowledge, response) through `tasks.main` in finetune_parallel's
    four gloo ranks at tp 2 x dp 2 + SP (`recs`, a list of runs a rank),
    the zeroshot and msdp phases' model (Llama-2-7B widths at
    LLAMA_LAUNCH_LAYERS of 32 layers, the seed's weights) and corpora,
    held to those phases' world size 1 runs in this process: the WikiText
    average loss within LM_WIKI_TOL; at each LAMBADA answer position each
    rank's top logit of its vocabulary shard within LM_LOGIT_TOL of world
    size 1's logits there, the shard's argmax and the global argmax equal
    where world size 1's top-2 margin is at least LM_MARGIN, and the
    verdicts sample by sample, one under that margin counted and printed
    instead; each MSDP stream teacher-forced through the
    fp32 plain model within 5e-2; every rank the same metrics. K4 on
    each rank once a layer an evaluation batch, every launch at the
    rank's 16 groups; K1 once a layer a decode step on every rank, at
    16 groups. Printed with the card's name and power limit: ms an
    evaluation batch and a decode step on each rank (gloo through the
    host, four ranks on one card)."""
    names = [n for n, _ in lm_task_argvs(zs, ms)]
    runs = {n: [r[i] for r in recs] for i, n in enumerate(names)}
    rows = ZS_MICRO // PAR_DP
    out, k4, k1 = {}, [0] * PAR_RANKS, [0] * PAR_RANKS
    for task in ("WIKITEXT103", "LAMBADA"):
        ranks = runs[task]
        n = len(ranks[0]["hits"]) if task == "LAMBADA" else len(
            ranks[0]["batch_ms"])
        for r, run in enumerate(ranks):
            check(run["layout"] == {"world": PAR_RANKS, "dp": PAR_DP,
                                    "tp": PAR_TP, "pp": 1, "cp": 1,
                                    "rank": r, "dp_rank": r // PAR_TP,
                                    "sequence_parallel": True,
                                    "backend": "gloo", "staged": True},
                  f"{task} rank {r}: layout {run.get('layout')}")
            check(run["result"] == ranks[0]["result"],
                  f"{task}: rank {r} reports {run['result']}, rank 0 "
                  f"{ranks[0]['result']}")
            batches = len(run["batch_ms"])
            lc = run["launches"]
            check(lc["flash_fwd"] == LLAMA_LAUNCH_LAYERS * batches
                  and sum(lc.values()) == lc["flash_fwd"]
                  and run["k4_bg"] == [rows * LM_RANK_GROUPS]
                  * lc["flash_fwd"],
                  f"{task} rank {r}: launches {lc}, K4 b x g "
                  f"{sorted(set(run['k4_bg']))}, expected K4 "
                  f"{LLAMA_LAUNCH_LAYERS} x {batches} batches at "
                  f"{rows} x {LM_RANK_GROUPS}")
            k4[r] += lc["flash_fwd"]
        out[task] = {"result": ranks[0]["result"], "batches": n,
                     "batch_ms_per_rank": [r["batch_ms"] for r in ranks],
                     "wall_s_per_rank": [r["wall_s"] for r in ranks],
                     "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
                     "k4_launches_per_rank": [r["launches"]["flash_fwd"]
                                              for r in ranks]}
    wk = runs["WIKITEXT103"][0]["result"]
    err = abs(wk["avg_loss"] - zs["wiki_avg_loss"])
    check(err <= LM_WIKI_TOL, f"WIKITEXT103 tp2 x dp2 avg loss "
          f"{wk['avg_loss']} against world size 1 {zs['wiki_avg_loss']}")
    out["WIKITEXT103"].update(world1_avg_loss=zs["wiki_avg_loss"],
                              avg_loss_abs_err=err)
    # each sample's verdict, argmax and shard top logits from its dp
    # rank's rows of each batch, against world size 1's logits
    logits = zs["lambada_logits"]
    per = logits.shape[1] // PAR_TP
    top2 = torch.topk(logits, 2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    verdicts, top_err, shard_held, argmax_held = {}, 0.0, 0, 0
    for r, run in enumerate(runs["LAMBADA"]):
        d, t = r // PAR_TP, r % PAR_TP
        check(len(run["shard_top"]) == len(run["hits"]),
              f"LAMBADA rank {r}: {len(run['shard_top'])} argmax calls for "
              f"{len(run['hits'])} batches")
        for b, vals in enumerate(run["hits"]):
            for j, row in enumerate(vals):
                i = b * ZS_MICRO + d * rows + j
                if i >= ZS_LAMBADA:
                    continue
                pos = zs["lambada_answer_pos"][i]
                v = row[pos] > 0.5
                check(verdicts.setdefault(i, v) == v,
                      f"LAMBADA sample {i}: the tp ranks disagree")
                shard = logits[i, t * per:(t + 1) * per]
                s2 = torch.topk(shard, 2).values
                value = run["shard_top"][b][0][j][pos]
                e = abs(value - float(s2[0]))
                top_err = max(top_err, e)
                check(e <= LM_LOGIT_TOL, f"LAMBADA sample {i} rank {r}: "
                      f"shard top logit {value}, world size 1 {float(s2[0])}")
                if float(s2[0] - s2[1]) >= LM_MARGIN:
                    shard_held += 1
                    check(run["shard_top"][b][1][j][pos]
                          == int(shard.argmax()),
                          f"LAMBADA sample {i} rank {r}: shard argmax "
                          f"{run['shard_top'][b][1][j][pos]}, world size 1 "
                          f"{int(shard.argmax())}")
                if margin[i] >= LM_MARGIN:
                    argmax_held += 1
                    check(run["argmax"][b][j][pos] == int(logits[i].argmax()),
                          f"LAMBADA sample {i} rank {r}: argmax "
                          f"{run['argmax'][b][j][pos]}, world size 1 "
                          f"{int(logits[i].argmax())}")
    check(sorted(verdicts) == list(range(ZS_LAMBADA)),
          f"LAMBADA verdicts of {sorted(verdicts)}")
    close = [i for i in range(ZS_LAMBADA) if margin[i] < LM_MARGIN]
    differ = [i for i in range(ZS_LAMBADA)
              if verdicts[i] != zs["lambada_hits"][i]]
    check(set(differ) <= set(close), f"LAMBADA verdicts differ from world "
          f"size 1 at {differ}, margins {[margin[i] for i in differ]}")
    check(int(sum(verdicts.values()))
          == runs["LAMBADA"][0]["result"]["num_correct"],
          "LAMBADA: the verdicts do not sum to the count")
    out["LAMBADA"].update(world1_correct=zs["lambada_correct"],
                          verdicts_differing=differ,
                          samples_under_margin=close,
                          margins_under=[margin[i] for i in close],
                          shard_top_logit_max_abs_err=top_err,
                          shard_argmax_held=shard_held,
                          argmax_held=argmax_held)

    # MSDP: rank 0's file, every rank's streams against fp32 plain
    from megatron_llm_tpu_torch import arguments, finetune

    # the base flags of the msdp argv (its task flags parse later)
    args = arguments.build_base_parser().parse_known_args(ms["argv"])[0]
    # the BPE's 32000 entries pad as the NullTokenizer's do
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    plain_model = finetune.model_provider(args, fp32_plain(
        arguments.args_to_configs)(args, tok.vocab_size)[0])
    params = plain_model.init(seed=SEED)
    for kind in ("knowledge", "response"):
        ranks = runs[kind]
        greedy, per_rank = [], []
        for r, run in enumerate(ranks):
            calls = run["decode_calls"]
            steps = sum(c["steps"] + c["warmup_steps"] for c in calls)
            lc = run["launches"]
            check(lc["decode_attention"] == LLAMA_LAUNCH_LAYERS * steps
                  and steps > 0 and not any(c["captured"] for c in calls)
                  and set(run["k1_g"]) == {LM_RANK_GROUPS},
                  f"MSDP {kind} rank {r}: K1 {lc['decode_attention']} at "
                  f"g {sorted(set(run['k1_g']))}, expected "
                  f"{LLAMA_LAUNCH_LAYERS} x {steps} steps at "
                  f"{LM_RANK_GROUPS}")
            mine = list(range(r // PAR_TP, MSDP_SAMPLES, PAR_DP))
            check(len(run["streams"]) == len(mine),
                  f"MSDP {kind} rank {r}: {len(run['streams'])} requests "
                  f"for samples {mine}")
            partner = ranks[r ^ 1]["streams"]
            check([s[1] for s in run["streams"]] == [s[1] for s in partner],
                  f"MSDP {kind}: tp ranks {r} and {r ^ 1} chose other "
                  f"tokens")
            for prompt, toks, lp, eod in run["streams"]:
                # the stream up to its first end of document, as the
                # msdp phase cuts it
                gen = toks[len(prompt):len(prompt) + MSDP_GEN]
                n = len(prompt) + (gen.index(eod) + 1 if eod in gen
                                   else MSDP_GEN)
                greedy.append((None, prompt, toks[:n], lp[:n - 1]))
            k1[r] += lc["decode_attention"]
            per_rank.append({"steps": steps,
                             "k1": lc["decode_attention"],
                             "step_ms": run["step_ms"],
                             "wall_s": run["wall_s"]})
        err, match = teacher_forced(plain_model, params, greedy)
        check(err <= PATH_LP_TOL, f"MSDP {kind} tp2 x dp2: the streams' "
              f"log-probs {err} from the fp32 plain model's")
        lines = Path(ranks[0]["result"]).read_bytes().split(b"\n")
        check(len(lines) == MSDP_SAMPLES + 1 and not lines[-1],
              f"MSDP {kind} tp2 x dp2 output {lines}")
        ws1 = (ZS_DIR / f"msdp_{kind}_out.txt").read_bytes().split(b"\n")
        out[kind] = {"logprob_max_abs_err_fp32": err,
                     "greedy_match_fp32": match,
                     "lines_equal_world1": sum(
                         a == b for a, b in zip(lines, ws1)) - 1,
                     "per_rank": per_rank}
    del plain_model, params
    free_cuda()
    shutil.rmtree(ZS_DIR)
    for name, per in (("flash_fwd", k4), ("decode_attention", k1)):
        for row in kernels:
            if row["name"] == name:
                row["launches_by_path"]["lm_tasks_parallel"] = sum(per)
                row.setdefault("launches_per_rank", {})[
                    "lm_tasks_parallel"] = per
                row["launches"] = sum(row["launches_by_path"].values())
    say("lm_tasks_parallel", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PAR_RANKS} chip_smoke.py "
        f"--finetune-rank (tasks.main in each rank, after "
        f"finetune_parallel's runs)",
        layout="tp 2 x dp 2, sequence parallel, every rank on cuda:0",
        flags=" ".join(LM_TP_FLAGS), layers=LLAMA_LAUNCH_LAYERS,
        rank_kv_groups=LM_RANK_GROUPS,
        sizes={"wiki_tokens": ZS_WIKI_TOKENS, "overlapping_eval": ZS_OVERLAP,
               "lambada_samples": ZS_LAMBADA, "micro_batch": ZS_MICRO,
               "msdp_samples": MSDP_SAMPLES, "msdp_gen": MSDP_GEN},
        ms_label="gloo through the host, four ranks sharing one card "
        "(not a parallel-efficiency number)", **out,
        k4_launches_per_rank=k4, k1_launches_per_rank=k1,
        tol={"wiki_avg_loss": LM_WIKI_TOL, "lambada_margin": LM_MARGIN,
             "lambada_shard_top_logit": LM_LOGIT_TOL,
             "msdp_logprob": PATH_LP_TOL})


OVERLAP_FLAGS = ["--use_distributed_optimizer", "--overlap_grad_reduce",
                 "--overlap_param_gather", "--distributed_backend", "gloo"]
OVERLAP_RANKS = 2
OVERLAP_STEPS = 2


def overlap_recipe(data):
    """The recipe's flags at FT_LAYERS of 32 layers, seq 4096, with
    `--hidden_dropout 0.1` (attention dropout stays off: it would take
    the grouped path and launch no kernel)."""
    flags = list(RECIPE)
    flags[flags.index("--hidden_dropout") + 1] = "0.1"
    return mode_argv(data, *flags, "--bf16", "--train_iters",
                     str(OVERLAP_STEPS))


def overlap_argv(data):
    return overlap_recipe(data) + OVERLAP_FLAGS


def card_mask_check():
    """One (b, s, h) hidden-dropout mask and one slice of a (b, g, qpk,
    s, t) attention-probability mask (global offsets on every leading
    axis) drawn on the card against the same masks drawn on the CPU, bit
    for bit, and the draws' times on the card: the hidden mask and the
    whole attention mask of a layer at Llama-2-7B widths."""
    from megatron_llm_tpu_torch.models import dropout as dr

    hidden = dr.at(dr.fold_in(SEED + 1, 7), 3, 1024)
    attn = dr.at(dr.fold_in(SEED + 1, 9), 1, 8, 0, 2048, 0)
    out = {}
    for name, stream, shape, timed in (
            ("hidden", hidden, (1, FT_SEQ, 4096), (1, FT_SEQ, 4096)),
            ("attention", attn, (1, 8, 1, 256, FT_SEQ),
             (1, 32, 1, FT_SEQ, FT_SEQ))):
        cuda = dr.bernoulli(stream, 0.9, shape, "cuda")
        t0 = time.perf_counter()
        cpu = dr.bernoulli(stream, 0.9, shape, "cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ms = time_ms(lambda: dr.bernoulli(stream, 0.9, timed, "cuda"),
                     iters=10, warmup=2)
        out[name] = {"shape": list(shape),
                     "equal": bool(torch.equal(cuda.cpu(), cpu)),
                     "keep": float(cpu.float().mean()), "cpu_ms": cpu_ms,
                     "card_shape": list(timed), "card_ms": ms}
        del cuda, cpu
    torch.cuda.empty_cache()
    out["equal"] = all(v["equal"] for v in out.values())
    return out


def overlap_dropout_phase(kernels, data, ranks=None):
    """`torchrun --nproc_per_node 2 ... finetune.main` at dp 2 with
    ZeRO-1 under `--overlap_grad_reduce --overlap_param_gather` and
    hidden dropout 0.1, both ranks on cuda:0 over gloo, at Llama-2-7B
    widths (FT_LAYERS of 32 layers, seq 4096, flash, selective
    recompute, bf16, global batch 4: 2 microbatches of 1 a rank), 3
    steps; held to world size 1 with the same flags but the overlap ones
    (dp 1 refuses them), whose masks are the same bits (models/
    dropout.py): losses within 2e-2, grad norms within 5e-2; K4-K6 per
    rank as the layout implies; each layer group's reduce-scatter
    issued inside the backward. Then a hidden-dropout mask and an
    attention-mask slice drawn on the card against the CPU's, bit for
    bit (`card_mask_check`). `ranks` (records, log):
    the two ranks' records of the run, when the pipeline phase's
    torchrun (the same two ranks) ran it last, which saves a start of
    two processes; else this phase starts its own."""
    base = overlap_recipe(data)
    t0 = time.perf_counter()
    ranks_s = "ran in the pipeline phase's ranks"
    if ranks is None:
        ranks = run_ranks([overlap_argv(data)], nproc=OVERLAP_RANKS)
        ranks_s = time.perf_counter() - t0
    recs, log = ranks
    runs = [r[-1] for r in recs]
    t0 = time.perf_counter()
    ws1 = finetune_run(base)
    ws1_s = time.perf_counter() - t0
    want = parallel_expected_launches(OVERLAP_STEPS,
                                      dp=OVERLAP_RANKS)
    for r, run in enumerate(runs):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": OVERLAP_RANKS,
                                  "dp": OVERLAP_RANKS, "pp": 1, "cp": 1,
                                  "tp": 1, "rank": r,
                                  "sequence_parallel": False},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == runs[0]["stats"],
              f"rank {r} reports another global loss or grad norm")
        check(run["launches"] == want, f"rank {r} launches "
              f"{run['launches']} != {want}")
        check(run["groups_in_backward"] == [1], f"rank {r}: layer groups "
              f"issued in the backward {run['groups_in_backward']}")
    check(all(s["skipped"] == 0 for s in runs[0]["stats"] + ws1["stats"]),
          "overlap_dropout: a step was skipped")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(runs[0]["stats"], ws1["stats"])]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(runs[0]["stats"], ws1["stats"])]
    check(len(loss_err) == OVERLAP_STEPS and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"dp 2 overlap against world size 1: loss err {loss_err}, grad "
          f"norm rel err {gnorm_err}")
    masks = card_mask_check()
    check(masks["equal"], f"a dropout mask drawn on the card differs from "
          f"the CPU's: {masks}")
    say("overlap_dropout", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {OVERLAP_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main in each rank)",
        flags=" ".join(OVERLAP_FLAGS) + " --hidden_dropout 0.1",
        layout="dp 2, ZeRO-1, overlap_grad_reduce + overlap_param_gather, "
        "every rank on cuda:0", backend="gloo",
        collectives_staged_through_host=runs[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        losses=[x["loss"] for x in runs[0]["stats"]],
        losses_world1=[y["loss"] for y in ws1["stats"]],
        grad_norms=[x["grad_norm"] for x in runs[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ws1["stats"]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL},
        step_ms=[st["ms"] for st in runs[0]["steps"]],
        step_ms_label="gloo through the host, one card shared by 2 ranks",
        step_ms_world1=[st["ms"] for st in ws1["steps"]],
        peak_gb_per_rank=[run["peak_gb"] for run in runs],
        launches_per_rank=[run["launches"] for run in runs],
        expected_launches_per_rank=want,
        layer_groups_issued_in_backward=runs[0]["groups_in_backward"],
        ranks_wall_s=ranks_s, rank0_run_wall_s=runs[0]["wall_s"],
        world1_wall_s=ws1_s, rank0_clock_s=runs[0]["clock_s"],
        card_mask=masks,
        rank0_log_tail=log[-1200:])
    for row in kernels:
        name = row["name"]
        if name in FLASH_WRAPPERS:
            per = [run["launches"][name] for run in runs]
            row["launches_by_path"]["overlap_dropout"] = sum(per)
            row["launches_by_path"]["overlap_dropout_world1"] = \
                ws1["launches"][name]
            row.setdefault("launches_per_rank", {})[
                "overlap_dropout"] = per
            row["launches"] = sum(row["launches_by_path"].values())


def time_flash_tp2(kernels):
    """K4, K5 and K6 at a tp 2 rank's attention shape (Llama-2-7B's 32
    heads over 2 ranks: b 1, s 4096, g 16, qpk 1, d 128, causal), their
    errors against the plain versions, beside SDPA's forward and
    backward at the same shape."""
    shape = (1, 4096, 4096, 16, 1, 128, True)
    b, s, t, g, qpk, d, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    q, k, v, do = flash_inputs(shape, gen)
    errs = flash_errors(q, k, v, do, causal)
    check(errs["o"] <= BF16_TOL and all(
        errs[n + "_rel"] <= BF16_TOL for n in ("dq", "dk", "dv")),
        f"K4-K6 at the tp2 shape: {errs}")
    o, lse = fa._fwd(q, k, v, causal)
    qf, kf, vf, dof = fa._fold_q(q), fa._fold_kv(k), fa._fold_kv(v), \
        fa._fold_q(do)
    delta = fa._delta_rows(o, do).contiguous()
    ms = {
        "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, qpk, causal),
                         per_graph=5, replays=4),
        "dq": device_ms(lambda: fa.flash_bwd_dq(qf, kf, vf, dof, lse, delta,
                                                qpk, causal),
                        per_graph=5, replays=4),
        "dkv": device_ms(lambda: fa.flash_bwd_dkv(qf, kf, vf, dof, lse,
                                                  delta, qpk, causal),
                         per_graph=5, replays=4)}
    plain = {
        "fwd": device_ms(lambda: fa._xla_reference_with_lse(q, k, v, causal),
                         per_graph=2, replays=3),
        "bwd": device_ms(lambda: fa._plain_bwd(q, k, v, o, lse, do, causal),
                         per_graph=1, replays=3)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, g * qpk, d).transpose(1, 2).detach() \
        .requires_grad_(True)
    ks = k.transpose(1, 2).detach().requires_grad_(True)
    vs = v.transpose(1, 2).detach().requires_grad_(True)
    dos = do.reshape(b, s, g * qpk, d).transpose(1, 2)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: sdpa(qs, ks, vs, is_causal=causal),
                            per_graph=5, replays=4)
    ys = sdpa(qs, ks, vs, is_causal=causal)
    lib_bwd = profiled_ms(lambda: torch.autograd.grad(
        ys, (qs, ks, vs), dos, retain_graph=True), iters=10)
    del ys, qs, ks, vs
    bounds = flash_bounds(shape)
    label = f"b{b} s{s} g{g} qpk{qpk} d{d} causal bf16 (a tp 2 rank)"
    say("kernel_time_flash_tp2", card=nvidia_smi(), shape=label, ms=ms,
        plain_ms=plain, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        bound_ms={n: bounds[n][0] for n in bounds}, max_abs_err=errs)
    for row in kernels:
        which = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
                 "flash_bwd_dkv": "dkv"}.get(row["name"])
        if which is not None:
            row["tp2_rank_shape"] = {
                "shape": label, "ms": ms[which],
                "plain_ms": plain["fwd" if which == "fwd" else "bwd"],
                "library_ms": lib_fwd if which == "fwd" else lib_bwd,
                "bound_ms": bounds[which][0],
                "bound_by": bounds[which][1]}
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# pipeline parallelism: two stages sharing the card through gloo
# ---------------------------------------------------------------------------

# the recipe's pipeline flags at pp 2 (examples/finetune.sh:13,59) with
# the JAX package's --pipeline_remat, two ranks on cuda:0 through gloo
PP_FLAGS = ["--pipeline_model_parallel_size", "2", "--pipeline_remat",
            "tick", "--async_pipeline_dispatch", "--distributed_backend",
            "gloo"]
PP_RANKS = 2
# steps before the save (3 before the retrieval, zeroshot and msdp phases)
# 1 step before the save (2 before lm_tasks_parallel paid for itself)
PP_STEPS = 1
PP_GEN = 32  # tokens each served request generates
PP_RESUME_TOL = 1e-4


def pp_prompts():
    """Four greedy requests (one ring group of two rows a stage)."""
    rs = np.random.RandomState(SEED + 51)
    return [" ".join(map(str, rs.randint(0, 31999, n)))
            for n in (130, 96, 150, 110)]


def pp_ring_plan(prompts, gen=PP_GEN):
    """The ring's shape for these requests: (rows, groups, max_len,
    prefill_len, decode steps)."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    tokens, lengths = tokenize_prompts(tok, prompts, gen)
    b, max_len = tokens.shape
    prefill = bucket_prefill_len(int(lengths.min()))
    nm = PP_RANKS
    return {"rows": b // nm, "groups": nm, "max_len": max_len,
            "prefill_len": prefill, "steps": max_len - prefill - 1}


def pp_expected_launches(steps):
    """Per rank (a stage of FT_LAYERS / 2 layers): under "tick" each
    microbatch's stage runs forward once without a graph and again in
    the backward, where the recipe's selective recompute keeps K4's
    output: K4 twice a layer and microbatch, K5 and K6 once."""
    n = FT_LAYERS // PP_RANKS * FT_MICRO * steps
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
            "ragged_paged_attention": 0}


def pp_serving_model(argv, ck, ctx):
    """`argv`'s model (finetune's flags) with the checkpoint's weights on
    this rank's card: whole, or under `ctx` this stage's layers."""
    from megatron_llm_tpu_torch import arguments, finetune
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_map
    from megatron_llm_tpu_torch.parallel.mesh import rank_device
    from megatron_llm_tpu_torch.parallel.sharding import shard_params

    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    args = arguments.build_base_parser().parse_args(argv)
    mcfg = arguments.args_to_configs(
        args, tok.vocab_size, world_size=1 if ctx is None else ctx.pp)[0]
    dev = rank_device("cuda")
    model = finetune.model_provider(args, mcfg, device=dev)
    params = ckpt.load_checkpoint(str(ck), model.abstract_params(),
                                  no_load_optim=True, device="cpu")[0]
    if ctx is not None:
        params = shard_params(params, ctx, mcfg)
    return tok, model, tree_map(lambda x: x.to(dev), params)


def pp_requests(model, params, tok, prompts, gen=PP_GEN):
    """A score of `prompts`, then their greedy decode (no early stop),
    through the API, the counters set to 0 before each: the log-probs,
    tokens, launches and seconds."""
    from megatron_llm_tpu_torch.inference import api

    out = {}
    for name, kw in (("score", {}), ("greedy", dict(
            return_output_log_probs=True, top_k_sampling=1,
            use_eod_token_for_early_termination=False))):
        zero_counts()
        t0 = time.perf_counter()
        _, _, lp, toks = api.generate_and_post_process(
            model, params, tok, prompts, 0 if name == "score" else gen, **kw)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "lp": np.asarray(lp, np.float64).tolist(),
                     "tokens": np.asarray(toks).tolist(),
                     "launches": kernel_counts(),
                     "k1_by_layout": dict(
                         dec.decode_attention.launches_by_layout)}
    return out


def pp_group_greedy(model, params, tok, prompts, gen=PP_GEN):
    """The one-rank greedy request of `pp_requests` on each ring group's
    prompts alone (b / PP_RANKS consecutive rows, the ring's GEMM rows;
    the same max_len and prefill here): tokens and log-probs in the
    batch's row order."""
    from megatron_llm_tpu_torch.inference import api

    n = len(prompts) // PP_RANKS
    out = {"tokens": [], "lp": []}
    for i in range(0, len(prompts), n):
        _, _, lp, toks = api.generate_and_post_process(
            model, params, tok, prompts[i:i + n], gen,
            return_output_log_probs=True, top_k_sampling=1,
            use_eod_token_for_early_termination=False)
        out["tokens"] += np.asarray(toks).tolist()
        out["lp"] += np.asarray(lp, np.float64).tolist()
    return out


def pp_serve(argv, ck, prompts):
    """Rank mode's serving entry: the checkpoint `ck` served at pp 2, this
    rank a stage, through the API (every rank the same requests)."""
    from megatron_llm_tpu_torch.parallel.mesh import (
        destroy_parallel,
        initialize_parallel,
    )

    ctx = initialize_parallel(pp=PP_RANKS, backend="gloo", device="cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        tok, model, params = pp_serving_model(argv, ck, ctx)
        out = pp_requests(model, params, tok, prompts)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stage"] = ctx.pp_rank
        del model, params
        free_cuda()
        return out
    finally:
        destroy_parallel()


def pp_stream_errs(prompts, ref, got, gen=PP_GEN):
    """Greedy streams `got` against `ref`: the share of generated
    positions with equal tokens, and the largest |log-prob difference|
    over each row's common prefix."""
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    _, lengths = tokenize_prompts(tok, prompts, gen)
    agree, total, err = 0, 0, 0.0
    for n, a, b, la, lb in zip(lengths, ref["tokens"], got["tokens"],
                               ref["lp"], got["lp"]):
        end = n + gen
        agree += sum(x == y for x, y in zip(a[n:end], b[n:end]))
        total += gen
        k = next((i for i in range(end) if a[i] != b[i]), end)
        err = max(err, float(np.abs(np.asarray(la[:k - 1])
                                    - np.asarray(lb[:k - 1])).max()))
    return agree / total, err


def pipeline_phase(kernels, data, one):
    """`torchrun --nproc_per_node 2 ... finetune.main` at pp 2 with the
    recipe's flags and `--pipeline_remat tick` over gloo, both stages on
    cuda:0, at Llama-2-7B widths (FT_LAYERS of 32 layers, half a stage,
    seq 4096, global batch 4: 4 microbatches of 1): PP_STEPS steps and a
    save with the optimizer state, then the same ranks resume it for one
    more step and serve
    it through the API (a pipelined score and greedy requests through
    the stage ring), and world size 1 resumes it too and serves it
    whole-batch. Held to `one` (finetune_modes' run (a): world size 1,
    the same flags, weights and batches): losses within 2e-2, grad norms
    within 5e-2; that step at pp 2 and at pp 1 within 1e-4; every leaf of
    the checkpoint, Adam moments included, cut into each stage's pieces
    equal to what the stage held; the scorer's log-probs within 5e-2 of
    the whole-batch score; the ring's streams those of the one-rank
    greedy route run on each ring group's rows alone (the ring's GEMM
    rows) over each common prefix, log-probs within 5e-2, the 4-row
    route's drift from both printed beside; K4-K6 per rank as the
    schedule implies, K1 in "tgd" once a stage layer per ring decode
    tick. The two ranks then run the context_parallel phase's entries
    and the overlap_dropout phase's dp 2 run; returned: (cp records,
    overlap records), each with the ranks' log."""
    from types import SimpleNamespace

    ck = FT_DIR / "pipeline_ck"
    base = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    pp = base + PP_FLAGS
    prompts = pp_prompts()
    n, after = str(PP_STEPS), ["--exit_interval", str(PP_STEPS + 1)]
    t0 = time.perf_counter()
    # the context_parallel phase's runs and the overlap_dropout phase's
    # dp 2 run ride these two ranks last (world size 2 too): one start of
    # the two processes, and of their first step's lazy imports
    later = cp_rank_argvs(data) + [overlap_argv(data)]
    ranks, log = run_ranks(
        [pp + ["--exit_interval", n, "--save_interval", n, "--save",
               str(ck)],
         pp + ["--load", str(ck)] + after,
         {"argv": pp, "ck": str(ck), "prompts": prompts}] + later,
        nproc=PP_RANKS)
    ranks_s = time.perf_counter() - t0
    n_cp = len(later) - 1
    later_ranks = (([r[3:3 + n_cp] for r in ranks], log),
                   ([r[3 + n_cp:] for r in ranks], log))
    first, resumed, served = ([r[i] for r in ranks] for i in range(3))
    ref = one["stats"]
    for r, run in enumerate(first):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": PP_RANKS, "dp": 1,
                                  "pp": PP_RANKS, "cp": 1, "tp": 1,
                                  "rank": r, "sequence_parallel": False},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == first[0]["stats"]
              and resumed[r]["stats"] == resumed[0]["stats"],
              f"rank {r} reports another loss or grad norm")
        check(run["launches"] == pp_expected_launches(PP_STEPS),
              f"rank {r} launches {run['launches']} != "
              f"{pp_expected_launches(PP_STEPS)}")
        check(resumed[r]["resumed"] == [PP_STEPS, FT_MICRO * PP_STEPS]
              and resumed[r]["launches"]
              == pp_expected_launches(1),
              f"rank {r} resumed {resumed[r].get('resumed')} with "
              f"{resumed[r]['launches']}")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(first[0]["stats"], ref)]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(first[0]["stats"], ref)]
    check(len(loss_err) == PP_STEPS and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"pp 2 against world size 1: loss err {loss_err}, grad norm "
          f"rel err {gnorm_err}")
    ctxs = [SimpleNamespace(tp=1, dp=1, pp=PP_RANKS, tp_rank=0, dp_rank=0,
                            pp_rank=r) for r in range(PP_RANKS)]
    leaves, iteration = check_parallel_checkpoint(
        ck, [run["fingerprints"] for run in first], ctxs, zero1=False)
    check(iteration == PP_STEPS, f"the save is at iteration {iteration}")
    t0 = time.perf_counter()
    ws1 = finetune_run(base + ["--load", str(ck)] + after)
    ws1_s = time.perf_counter() - t0
    step4 = {"pp2_resumed": resumed[0]["stats"][0]["loss"],
             "pp1_resumed": ws1["stats"][0]["loss"],
             "pp1_uninterrupted": ref[PP_STEPS]["loss"]}
    check(ws1["resumed"] == (PP_STEPS, FT_MICRO * PP_STEPS)
          and abs(step4["pp2_resumed"] - step4["pp1_resumed"])
          <= PP_RESUME_TOL
          and abs(step4["pp1_resumed"] - step4["pp1_uninterrupted"])
          <= BF16_TOL, f"step {PP_STEPS + 1} after the resume: {step4}")
    # the one-rank whole-batch answers of the same checkpoint
    t0 = time.perf_counter()
    tok, model, params = pp_serving_model(base, ck, None)
    whole = pp_requests(model, params, tok, prompts)
    grouped = pp_group_greedy(model, params, tok, prompts)
    del model, params
    free_cuda()
    whole_s = time.perf_counter() - t0
    plan = pp_ring_plan(prompts)
    L = FT_LAYERS // PP_RANKS
    ring_k1 = L * plan["steps"] * plan["groups"]
    score_err = 0.0
    _, lengths = tokenize_prompts(tok, prompts, 0)
    for rank in served:
        check(rank["greedy"]["tokens"] == served[0]["greedy"]["tokens"]
              and rank["score"]["lp"] == served[0]["score"]["lp"],
              "the stages returned different answers")
        check(rank["greedy"]["k1_by_layout"] == {"gtd": 0, "tgd": ring_k1}
              and rank["greedy"]["launches"]["decode_attention"] == ring_k1
              and rank["greedy"]["launches"]["flash_fwd"] == 0,
              f"ring launches {rank['greedy']['launches']} "
              f"{rank['greedy']['k1_by_layout']}: K1 in tgd {ring_k1}")
        check(rank["score"]["launches"]["flash_fwd"] == L,
              f"scorer launches {rank['score']['launches']}")
    for n, a, b in zip(lengths, whole["score"]["lp"],
                       served[0]["score"]["lp"]):
        score_err = max(score_err, float(np.abs(
            np.asarray(a[:n - 1]) - np.asarray(b[:n - 1])).max()))
    agree, ring_err = pp_stream_errs(prompts, grouped, served[0]["greedy"])
    # bf16 noise from the GEMMs' row count: the 4-row route against the
    # ring and against the same route on the ring's 2-row groups
    drift = {name: dict(zip(("token_agreement", "max_abs_logprob_err"),
                            pp_stream_errs(prompts, whole["greedy"], got)))
             for name, got in (("ring", served[0]["greedy"]),
                               ("route_on_ring_rows", grouped))}
    ckpt_bytes = dir_bytes(os.path.join(ck, f"iter_{PP_STEPS:07d}"))
    shutil.rmtree(ck)
    ms = [st["ms"] for st in first[0]["steps"]]
    peak = [run["peak_gb"] for run in first]
    say("pipeline", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {PP_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main, then the API, in each rank)",
        flags=" ".join(PP_FLAGS), layout=f"pp 2 ({FT_LAYERS // PP_RANKS} "
        f"layer(s) a stage), every "
        "rank on cuda:0", backend="gloo",
        collectives_staged_through_host=first[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        microbatches=FT_MICRO,
        losses=[x["loss"] for x in first[0]["stats"]],
        losses_world1=[y["loss"] for y in ref[:PP_STEPS]],
        grad_norms=[x["grad_norm"] for x in first[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ref[:PP_STEPS]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL,
             "resumed_step_pp2_vs_pp1": PP_RESUME_TOL, "serving": PATH_LP_TOL},
        step_ms=ms, step_ms_label="gloo through the host, one card shared "
        "by 2 stages (not comparable with a one-rank step)",
        step_ms_world1=[st["ms"] for st in one["steps"]],
        peak_gb_per_rank=peak, serve_peak_gb_per_rank=[
            rank["peak_gb"] for rank in served],
        launches_per_rank=[run["launches"] for run in first],
        expected_launches_per_rank=pp_expected_launches(PP_STEPS),
        steps_before_save=PP_STEPS,
        checkpoint_leaves_checked=leaves, checkpoint_bytes=ckpt_bytes,
        checkpoint_form="per-rank pieces (model/, optim/, done/ a rank)",
        saves_blocked_ms=first[0]["saves"], commits_s=first[0]["commits"],
        saves_blocked_ms_per_rank=[run["saves"] for run in first],
        commits_s_per_rank=[run["commits"] for run in first],
        save_host_rss_gb_rank0=first[0]["save_rss"],
        save_s_rank0=first[0]["clock_s"].get("saves"),
        commit_wait_s_rank0=first[0]["clock_s"].get("commit_wait"),
        load_s_per_rank=[run["loads"] for run in resumed],
        load_s_world1=ws1["loads"], resumed_step_losses=step4,
        ring=plan, ring_k1_tgd_launches_per_rank=ring_k1,
        score_max_abs_err=score_err, ring_max_abs_logprob_err=ring_err,
        ring_greedy_token_agreement=agree,
        ring_reference="the one-rank greedy route on each ring group's "
        f"{plan['rows']} rows alone", four_row_route_drift=drift,
        serve_s_per_rank=[{k: rank[k]["s"] for k in ("score", "greedy")}
                          for rank in served],
        serve_s_world1={k: whole[k]["s"] for k in ("score", "greedy")},
        ranks_wall_s=ranks_s,
        ranks_wall_includes="the context_parallel and overlap_dropout "
        "phases' rank work",
        world1_resume_wall_s=ws1_s, world1_serve_wall_s=whole_s,
        rank0_run_wall_s=[first[0]["wall_s"], resumed[0]["wall_s"]],
        rank0_clock_s=[first[0]["clock_s"], resumed[0]["clock_s"]],
        rank0_log_tail=log[-1500:])
    check(score_err <= PATH_LP_TOL and ring_err <= PATH_LP_TOL,
          f"pp 2 serving against one rank: score {score_err}, ring "
          f"{ring_err}")
    for row in kernels:
        name = row["name"]
        if name in FLASH_WRAPPERS:
            per = [run["launches"][name] + res["launches"][name]
                   + sv["score"]["launches"][name] + sv["greedy"][
                       "launches"][name]
                   for run, res, sv in zip(first, resumed, served)]
            row["launches_by_path"]["pipeline"] = sum(per)
            row["launches_by_path"]["pipeline_world1"] = \
                ws1["launches"][name] + whole["score"]["launches"][name]
            row.setdefault("launches_per_rank", {})["pipeline"] = per
            row["launches"] = sum(row["launches_by_path"].values())
        if name == "decode_attention":
            per = [sv["greedy"]["k1_by_layout"]["tgd"] for sv in served]
            row["launches_by_path"]["pipeline_ring_tgd"] = sum(per)
            row.setdefault("launches_per_rank", {})[
                "pipeline_ring_tgd"] = per
            row["launches"] = sum(row["launches_by_path"].values())
    return later_ranks


def time_decode_ring(kernels):
    """K1 at the pipeline ring's shape: one layer's "tgd" slice of a
    stage's stacked cache (2 layers, 2 groups, 2 rows a group, max_len
    positions) at Llama-2-7B widths, read in place at the ring's last
    decode length; its error against the plain version, beside SDPA and
    the bound."""
    plan = pp_ring_plan(pp_prompts())
    b, nm, T = plan["rows"], plan["groups"], plan["max_len"]
    g, qpk, d = 32, 1, 128
    length = plan["max_len"] - 1
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    stacked = [torch.randn(FT_LAYERS // PP_RANKS, nm, b, T, g, d,
                           generator=gen, device="cuda").to(bf)
               for _ in range(2)]
    k, v = stacked[0][-1, 1], stacked[1][-1, 1]
    q = torch.randn(b, 1, g, qpk, d, generator=gen, device="cuda").to(bf)
    ref = dec._xla_decode(q, k, v, length, "tgd")
    got = dec.decode_attention(q, k, v, length, layout="tgd")
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(err <= BF16_TOL, f"K1 at the ring's shape: {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kt, vt = k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2)
    bound, by = decode_bound_ms(b, g, qpk, d, length)
    row = {"shape": f"b{b} g{g} qpk{qpk} d{d} length{length}, the tgd "
                    f"slice of a stacked ({FT_LAYERS // PP_RANKS}, {nm}, "
                    f"{b}, {T}, {g}, {d}) bf16 cache",
           "ms": device_ms(lambda: dec.decode_attention(q, k, v, length,
                                                        layout="tgd")),
           "plain_ms": device_ms(lambda: dec._xla_decode(q, k, v, length,
                                                         "tgd"),
                                 per_graph=10, replays=5),
           "library_ms": device_ms(lambda: sdpa(
               q.reshape(b, g, qpk, d), kt, vt)),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "design": dec.decode_design(bf, qpk)}
    say("kernel_time_decode_ring", card=nvidia_smi(), **row)
    for r in kernels:
        if r["name"] == "decode_attention":
            r["pipeline_ring_shape"] = row
    del stacked, k, v, q
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# context parallelism: two cp ranks sharing the card through gloo
# ---------------------------------------------------------------------------

# the recipe's context parallelism flag at cp 2 (examples/finetune.sh:14,
# 60), two ranks on cuda:0 through gloo
CP_FLAGS = ["--context_parallel_size", "2", "--distributed_backend", "gloo"]
CP_RANKS = 2
# steps before the save (3 before the retrieval, zeroshot and msdp phases)
# 1 step before the save (2 before lm_tasks_parallel paid for itself)
CP_STEPS = 1
# the recipe's CodeLlama-7B preset (examples/finetune.sh:39-40): seq
# 16384, 32 heads of 128, no GQA
CP_RING_SEQ = 16384
# a cp 2 rank's shard at the training phase's seq and at the preset's
CP_HOP_SEQS = (FT_SEQ // CP_RANKS, CP_RING_SEQ // CP_RANKS)
CP_RING_COS = 0.98
# the 16k ring's o against the one-rank kernels', max-abs: ~10x what the
# H100 measured (4.9e-4), a third of a typical |o| on cp rank 1's rows
# (~sqrt(e / t) ~ 0.015 with t of 8k-16k random keys)
CP_RING_O_TOL = 5e-3


def cp_expected_launches(rank, steps):
    """K4, K5 and K6 a cp rank launches in `steps` training steps
    (FT_LAYERS layers, FT_MICRO microbatches of 1, FT_SEQ / 2 positions a
    rank), by mask: the recipe's selective recompute keeps every hop's K4
    output, so each hop runs K4 once in the forward and K5 and K6 once in
    the backward; cp rank 0 runs its diagonal block only (causal), rank 1
    its diagonal and rank 0's block (full)."""
    n = FT_LAYERS * FT_MICRO * steps
    return {name: {"causal": n, "full": n * rank} for name in FLASH_WRAPPERS}


def cp_policy_launches(rank, policy):
    """K4, K5 and K6 a cp rank launches by mask for one layer's forward
    and backward at cp 2 under a recompute policy: K4 once a visible hop
    in the forward, and again in the recompute under "full" only (the
    named-save-point policies keep the hops' K4 outputs, "none" has no
    recompute); K5 and K6 once a visible hop."""
    fwd = 2 if policy == "full" else 1
    return {"flash_fwd": {"causal": fwd, "full": fwd * rank},
            "flash_bwd_dq": {"causal": 1, "full": rank},
            "flash_bwd_dkv": {"causal": 1, "full": rank}}


def cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def cp_ring(ring_seq):
    """Rank mode (an entry of the context_parallel phase's run): ring
    attention at the CodeLlama-7B preset's shape (b 1, `ring_seq`
    positions, g 32, qpk 1, d 128, bf16, causal), this rank holding
    ring_seq / cp of them, forward and backward through the ring after a
    warm-up, each rank's shard against the one-rank K4-K6 on the whole
    sequence on the card: o's max-abs error, o, dq, dk and dv cosines; the
    ring's ms beside the one-rank ms; the ring's launches by mask."""
    from megatron_llm_tpu_torch.parallel import mesh
    from megatron_llm_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
    )

    mesh.maybe_initialize_distributed("gloo", "cuda")
    ctx = mesh.initialize_parallel(cp=CP_RANKS, backend="gloo",
                                   device="cuda")
    try:
        shape = (1, ring_seq, ring_seq, 32, 1, 128, True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
        q, k, v, do = flash_inputs(shape, gen)
        n = ring_seq // ctx.cp
        sl = slice(ctx.cp_rank * n, (ctx.cp_rank + 1) * n)
        ql, kl, vl = (x[:, sl].contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dol = do[:, sl].contiguous()

        def ring():
            o = ring_self_attention(ql, kl, vl, causal=True, ctx=ctx)
            return (o,) + torch.autograd.grad(o, (ql, kl, vl), dol)

        ring()  # the kernels' first launches set their smem attribute
        mesh.barrier(ctx)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        got = ring()
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: dict(fn.launches_by_causal)
                    for name, fn in FLASH_WRAPPERS.items()}
        mesh.barrier(ctx)
        t0 = time.perf_counter()
        o, lse = fa._fwd(q, k, v, True)
        ref = (o,) + fa._bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        rec = {"o_max_abs_err": max_err(got[0], ref[0][:, sl]),
               "cosine": {name: cosine(g, r[:, sl]) for name, g, r in zip(
                   ("o", "dq", "dk", "dv"), got, (o,) + ref[1:])},
               "finite": all(bool(torch.isfinite(x).all()) for x in got),
               "ring_fwd_bwd_ms": ring_ms, "one_rank_fwd_bwd_ms": one_ms,
               "launches_by_causal": launches,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del q, k, v, do, ql, kl, vl, dol, got, ref, o, lse
        free_cuda()
        return rec
    finally:
        mesh.destroy_parallel()


def cp_remat(policies):
    """Rank mode (an entry of the context_parallel phase's run): one
    layer of Llama-2-7B widths (seq FT_SEQ, FT_SEQ / 2 a rank, bf16 on
    fp32 params, the same weights on each rank) forward and backward
    at cp 2 under each recompute policy, the loss formed as the train
    step forms it (`loss_terms`, the denominator summed over cp), the
    counters set to 0 before each: K4-K6 launches by mask, the loss, the
    gradient norm and the wall ms of each."""
    from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
    from megatron_llm_tpu_torch.parallel import mesh

    mesh.maybe_initialize_distributed("gloo", "cuda")
    ctx = mesh.initialize_parallel(cp=CP_RANKS, backend="gloo",
                                   device="cuda")
    try:
        rs = np.random.RandomState(SEED + 63)
        text = torch.from_numpy(rs.randint(0, 31999, (1, FT_SEQ + 1)))
        n = FT_SEQ // CP_RANKS
        sl = slice(ctx.cp_rank * n, (ctx.cp_rank + 1) * n)
        tokens = text[:, :-1][:, sl].cuda()
        labels = text[:, 1:][:, sl].cuda()
        pos = torch.arange(sl.start, sl.stop, device="cuda")[None]
        out = {}
        params = None
        for policy in policies:
            model = LlamaModel(llama_config(
                7, num_layers=1, params_dtype=torch.float32,
                compute_dtype=torch.bfloat16, use_flash_attn=True,
                remat_policy=policy))
            if params is None:
                params = model.init(seed=SEED + 64)
                for p in tree_leaves(params):
                    p.requires_grad_(True)
            for p in tree_leaves(params):
                p.grad = None
            mesh.barrier(ctx)
            zero_counts()
            t0 = time.perf_counter()
            num, den = model.loss_terms(params, tokens, labels,
                                        position_ids=pos)
            den = mesh.sum_over_tokens(den.detach().clone(), ctx)
            loss = num / den
            loss.backward()
            loss = mesh.sum_over_tokens(loss.detach().clone(), ctx)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                                   for p in tree_leaves(params)))
            out[policy] = {
                "launches_by_causal": {
                    name: dict(fn.launches_by_causal)
                    for name, fn in FLASH_WRAPPERS.items()},
                "loss": float(loss), "local_grad_norm": float(gnorm),
                "ms": ms}
        del params, model, loss
        free_cuda()
        return out
    finally:
        mesh.destroy_parallel()


def cp_rank_argvs(data):
    """The context_parallel phase's rank-mode entries: CP_STEPS steps and
    a save at cp 2, the resume for one more, the 16k ring, the recompute
    policies."""
    ck = FT_DIR / "cp_ck"
    cp = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4") \
        + CP_FLAGS
    n = str(CP_STEPS)
    return [cp + ["--exit_interval", n, "--save_interval", n, "--save",
                  str(ck)],
            cp + ["--load", str(ck), "--exit_interval", str(CP_STEPS + 1)],
            {"ring_seq": CP_RING_SEQ}, {"policies": list(REMAT_POLICIES)}]


def context_parallel_phase(kernels, data, one, ranks=None):
    """`torchrun --nproc_per_node 2 ... finetune.main` at cp 2 with the
    recipe's flags over gloo, both ranks on cuda:0, at Llama-2-7B widths
    (FT_LAYERS of 32 layers, seq 4096: 2048 positions a rank, global
    batch 4: 4 microbatches of 1): CP_STEPS steps and a save with the
    optimizer state, then the same ranks resume it for one more step, run
    ring attention
    at the recipe's CodeLlama-7B preset (seq 16384, 8192 a rank) against
    the one-rank K4-K6 on the whole sequence, and count K4-K6 launches
    by mask for one layer under each recompute policy; world size 1
    resumes the checkpoint too. Held to `one` (finetune_modes' run (a):
    world size 1, the same flags, weights and batches): losses within
    2e-2, grad norms within 5e-2; that step at cp 2, at world size 1 and
    uninterrupted within 2e-2; every leaf of the checkpoint, Adam
    moments included, equal to what each rank held, bit for bit; the
    16k ring's o within 5e-3 and its o, dq, dk, dv cosines >= 0.98; K4-K6
    launches a rank by mask as the ring's hops and each recompute policy
    imply (`cp_policy_launches`), the policies' losses equal. `ranks`
    (records, log): the records of `cp_rank_argvs`, when the pipeline
    phase's torchrun (the same two ranks, world size 2) ran them, which
    saves the start of two processes; else this phase starts its own."""
    from types import SimpleNamespace

    ck = FT_DIR / "cp_ck"
    base = mode_argv(data, *RECIPE, "--bf16", "--train_iters", "4")
    t0 = time.perf_counter()
    ranks_s = "ran in the pipeline phase's ranks"
    if ranks is None:
        ranks = run_ranks(cp_rank_argvs(data), nproc=CP_RANKS)
        ranks_s = time.perf_counter() - t0
    ranks, log = ranks
    first, resumed, ring, remat = ([r[i] for r in ranks] for i in range(4))
    ref = one["stats"]
    others = ("rmsnorm_fwd", "rmsnorm_bwd", "decode_attention",
              "ragged_paged_attention")
    for r, run in enumerate(first):
        check(run["parallel"] == {"backend": "gloo", "staged": True,
                                  "world": CP_RANKS, "dp": 1, "pp": 1,
                                  "cp": CP_RANKS, "tp": 1, "rank": r,
                                  "sequence_parallel": False},
              f"rank {r}: layout {run.get('parallel')}")
        check(run["stats"] == first[0]["stats"]
              and resumed[r]["stats"] == resumed[0]["stats"],
              f"rank {r} reports another loss or grad norm")
        for name, runs, steps in (("the first steps", run, CP_STEPS),
                                  ("the resumed step", resumed[r], 1)):
            want = cp_expected_launches(r, steps)
            check(runs["by_causal"] == want
                  and all(runs["launches"][k] == 0 for k in others),
                  f"rank {r} {name}: launches {runs['by_causal']} "
                  f"{runs['launches']} != {want}")
        check(resumed[r]["resumed"] == [CP_STEPS, FT_MICRO * CP_STEPS],
              f"rank {r} resumed {resumed[r].get('resumed')}")
        want = {name: {"causal": 1, "full": r} for name in FLASH_WRAPPERS}
        check(ring[r]["launches_by_causal"] == want,
              f"rank {r} 16k ring launches {ring[r]['launches_by_causal']}"
              f" != {want}")
        check(ring[r]["finite"] and ring[r]["o_max_abs_err"] <= CP_RING_O_TOL
              and min(ring[r]["cosine"].values()) >= CP_RING_COS,
              f"rank {r} 16k ring against one rank: {ring[r]}")
        for policy, rec in remat[r].items():
            want = cp_policy_launches(r, policy)
            check(rec["launches_by_causal"] == want,
                  f"rank {r} under {policy}: launches "
                  f"{rec['launches_by_causal']} != {want}")
        check(len({rec["loss"] for rec in remat[r].values()}) == 1
              and remat[r]["none"]["loss"] == remat[0]["none"]["loss"],
              f"the policies' losses differ: {remat}")
    loss_err = [abs(x["loss"] - y["loss"]) for x, y in
                zip(first[0]["stats"], ref)]
    gnorm_err = [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                 for x, y in zip(first[0]["stats"], ref)]
    check(len(loss_err) == CP_STEPS and max(loss_err) <= BF16_TOL
          and max(gnorm_err) <= PATH_LP_TOL,
          f"cp 2 against world size 1: loss err {loss_err}, grad norm rel "
          f"err {gnorm_err}")
    ctxs = [SimpleNamespace(tp=1, dp=1, pp=1, cp=CP_RANKS, tp_rank=0,
                            dp_rank=0, pp_rank=0, cp_rank=r)
            for r in range(CP_RANKS)]
    leaves, iteration = check_parallel_checkpoint(
        ck, [run["fingerprints"] for run in first], ctxs, zero1=False)
    check(iteration == CP_STEPS and any(k.startswith("m.") for k in
                                 first[0]["fingerprints"]),
          f"the save is at iteration {iteration}, with the moments")
    t0 = time.perf_counter()
    ws1 = finetune_run(base + ["--load", str(ck), "--exit_interval",
                               str(CP_STEPS + 1)])
    ws1_s = time.perf_counter() - t0
    step4 = {"cp2_resumed": resumed[0]["stats"][0]["loss"],
             "world1_resumed": ws1["stats"][0]["loss"],
             "world1_uninterrupted": ref[CP_STEPS]["loss"]}
    check(ws1["resumed"] == (CP_STEPS, FT_MICRO * CP_STEPS)
          and abs(step4["cp2_resumed"] - step4["world1_resumed"])
          <= BF16_TOL
          and abs(step4["world1_resumed"] - step4["world1_uninterrupted"])
          <= BF16_TOL, f"step {CP_STEPS + 1} after the resume: {step4}")
    ckpt_bytes = dir_bytes(os.path.join(ck, f"iter_{CP_STEPS:07d}"))
    shutil.rmtree(ck)
    ms = [st["ms"] for st in first[0]["steps"]]
    peak = [run["peak_gb"] for run in first]
    say("context_parallel", card=nvidia_smi(),
        launcher=f"torchrun --nproc_per_node {CP_RANKS} chip_smoke.py "
        f"--finetune-rank (finetune.main, then the 16k ring, in each rank)",
        flags=" ".join(CP_FLAGS), layout=f"cp {CP_RANKS} ({FT_SEQ} "
        f"positions, {FT_SEQ // CP_RANKS} a rank), every rank on cuda:0",
        backend="gloo",
        collectives_staged_through_host=first[0]["parallel"]["staged"],
        layers=FT_LAYERS, seq=FT_SEQ, global_batch=FT_MICRO,
        losses=[x["loss"] for x in first[0]["stats"]],
        losses_world1=[y["loss"] for y in ref[:CP_STEPS]],
        grad_norms=[x["grad_norm"] for x in first[0]["stats"]],
        grad_norms_world1=[y["grad_norm"] for y in ref[:CP_STEPS]],
        loss_abs_err=loss_err, grad_norm_rel_err=gnorm_err,
        tol={"loss": BF16_TOL, "grad_norm_rel": PATH_LP_TOL,
             "resumed_step": BF16_TOL, "ring_o": CP_RING_O_TOL,
             "ring_grad_cosine": CP_RING_COS},
        step_ms=ms, step_ms_label="gloo through the host, one card shared "
        "by 2 ranks (not comparable with a one-rank step)",
        step_ms_world1=[st["ms"] for st in one["steps"]],
        peak_gb_per_rank=peak,
        launches_by_causal_per_rank=[run["by_causal"] for run in first],
        steps_before_save=CP_STEPS,
        expected_by_causal_per_rank=[cp_expected_launches(r, CP_STEPS)
                                     for r in range(CP_RANKS)],
        checkpoint_leaves_checked=leaves, checkpoint_bytes=ckpt_bytes,
        checkpoint_form="per-rank pieces (model/, optim/, done/ a rank)",
        saves_blocked_ms=first[0]["saves"], commits_s=first[0]["commits"],
        saves_blocked_ms_per_rank=[run["saves"] for run in first],
        commits_s_per_rank=[run["commits"] for run in first],
        save_host_rss_gb_rank0=first[0]["save_rss"],
        save_s_rank0=first[0]["clock_s"].get("saves"),
        commit_wait_s_rank0=first[0]["clock_s"].get("commit_wait"),
        load_s_per_rank=[run["loads"] for run in resumed],
        load_s_world1=ws1["loads"], resumed_step_losses=step4,
        ring_16k=ring, ring_16k_shape=f"b1 s{CP_RING_SEQ} g32 qpk1 d128 "
        f"causal bf16 (CodeLlama-7B), {CP_RING_SEQ // CP_RANKS} a rank",
        remat_policies_per_rank=remat,
        remat_policies_expected=[{p: cp_policy_launches(r, p)
                                  for p in REMAT_POLICIES}
                                 for r in range(CP_RANKS)],
        ranks_wall_s=ranks_s, world1_resume_wall_s=ws1_s,
        rank0_run_wall_s=[first[0]["wall_s"], resumed[0]["wall_s"]],
        rank0_clock_s=[first[0]["clock_s"], resumed[0]["clock_s"]],
        rank0_log_tail=log[-1500:])
    for row in kernels:
        name = row["name"]
        if name not in FLASH_WRAPPERS:
            continue
        per = [run["launches"][name] + res["launches"][name]
               for run, res in zip(first, resumed)]
        paths = row["launches_by_path"]
        paths["context_parallel"] = sum(per)
        paths["context_parallel_16k_ring"] = sum(
            sum(rg["launches_by_causal"][name].values()) for rg in ring)
        paths["context_parallel_world1"] = ws1["launches"][name]
        paths["context_parallel_policies"] = sum(
            sum(rec["launches_by_causal"][name].values())
            for rr in remat for rec in rr.values())
        row.setdefault("launches_per_rank", {})["context_parallel"] = per
        # the non-causal launches: the ring's visible blocks
        row["full_launches_by_path"] = {
            "context_parallel": sum(run["by_causal"][name]["full"]
                                    + res["by_causal"][name]["full"]
                                    for run, res in zip(first, resumed)),
            "context_parallel_16k_ring": sum(
                rg["launches_by_causal"][name]["full"] for rg in ring),
            "context_parallel_policies": sum(
                rec["launches_by_causal"][name]["full"]
                for rr in remat for rec in rr.values())}
        row["launches"] = sum(paths.values())


def time_flash_cp_hops(kernels):
    """K4, K5 and K6 at ring attention's hop shapes: a cp 2 rank's shard
    against a K/V block of the same size at Llama-2-7B's and CodeLlama-
    7B's heads (b 1, g 32, qpk 1, d 128, bf16), s = t = 2048 (seq 4096,
    the context_parallel phase) and 8192 (the preset's 16384), causal
    (the diagonal hop) and full (a visible block); errors of o, lse, dq,
    dk and dv against the plain versions at each, run 4 KV groups at a
    time (`flash_errors_by_group`); bounds (a full hop has s t pairs, a
    causal one s (s + 1) / 2), SDPA at the same shape and mask. The
    plain versions are timed at 2048 only (all 32 groups' fp32 (s, t)
    tensors take ~35 GB at 8192)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for s in CP_HOP_SEQS:
        for causal in (True, False):
            shape = (1, s, s, 32, 1, 128, causal)
            q, k, v, do = flash_inputs(shape, gen)
            errs = flash_errors_by_group(q, k, v, do, causal)
            check(errs["lse"] <= BF16_TOL and all(
                errs[n + "_rel"] <= BF16_TOL for n in ("o", "dq", "dk", "dv")),
                f"K4-K6 at the hop shape s {s} causal {causal}: {errs}")
            free_cuda()
            o, lse = fa._fwd(q, k, v, causal)
            qf, kf, vf, dof = (fa._fold_q(q), fa._fold_kv(k),
                               fa._fold_kv(v), fa._fold_q(do))
            delta = fa._delta_rows(o, do).contiguous()
            ms = {
                "fwd": device_ms(lambda: fa.flash_fwd(qf, kf, vf, 1, causal),
                                 per_graph=5, replays=4),
                "dq": device_ms(lambda: fa.flash_bwd_dq(
                    qf, kf, vf, dof, lse, delta, 1, causal),
                    per_graph=5, replays=4),
                "dkv": device_ms(lambda: fa.flash_bwd_dkv(
                    qf, kf, vf, dof, lse, delta, 1, causal),
                    per_graph=5, replays=4)}
            plain = {"fwd": "not measured", "bwd": "not measured"}
            if s <= FT_SEQ // CP_RANKS:
                plain = {
                    "fwd": device_ms(lambda: fa._xla_reference_with_lse(
                        q, k, v, causal), per_graph=2, replays=3),
                    "bwd": device_ms(lambda: fa._plain_bwd(
                        q, k, v, o, lse, do, causal), per_graph=1,
                        replays=3)}
            qs = q.reshape(1, s, 32, 128).transpose(1, 2).detach() \
                .requires_grad_(True)
            ks = k.transpose(1, 2).detach().requires_grad_(True)
            vs = v.transpose(1, 2).detach().requires_grad_(True)
            dos = do.reshape(1, s, 32, 128).transpose(1, 2)
            with torch.no_grad():
                lib_fwd = device_ms(lambda: sdpa(qs, ks, vs,
                                                 is_causal=causal),
                                    per_graph=5, replays=4)
            ys = sdpa(qs, ks, vs, is_causal=causal)
            lib_bwd = profiled_ms(lambda: torch.autograd.grad(
                ys, (qs, ks, vs), dos, retain_graph=True), iters=5)
            bounds = flash_bounds(shape)
            label = (f"b1 s{s} t{s} g32 qpk1 d128 "
                     f"{'causal' if causal else 'full'} bf16")
            rows.append({"shape": label, "ms": ms, "plain_ms": plain,
                         "library_fwd_ms": lib_fwd,
                         "library_bwd_ms": lib_bwd,
                         "bound_ms": {n: bounds[n][0] for n in bounds},
                         "bound_by": {n: bounds[n][1] for n in bounds},
                         "max_abs_err": errs})
            del q, k, v, do, o, lse, qf, kf, vf, dof, delta, qs, ks, vs, \
                dos, ys
            torch.cuda.empty_cache()
    say("kernel_time_flash_cp_hops", card=nvidia_smi(), hops=rows)
    for row in kernels:
        which = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
                 "flash_bwd_dkv": "dkv"}.get(row["name"])
        if which is None:
            continue
        row["cp_hop_shapes"] = [{
            "shape": h["shape"], "ms": h["ms"][which],
            "plain_ms": h["plain_ms"]["fwd" if which == "fwd" else "bwd"],
            "library_ms": h["library_fwd_ms"] if which == "fwd"
            else h["library_bwd_ms"],
            "bound_ms": h["bound_ms"][which],
            "bound_by": h["bound_by"][which],
            "max_abs_err": {n: h["max_abs_err"][n] for n in {
                "fwd": ("o", "lse"), "dq": ("dq",),
                "dkv": ("dk", "dv")}[which]}} for h in rows]


# ---------------------------------------------------------------------------
# phase 23: the encoder family, BERT-large widths (and the inputs of
# phases 24 and 25)
# ---------------------------------------------------------------------------

BERT_DIR = Path(__file__).resolve().parent / "build" / "bert_smoke"
BERT_VOCAB = 30522  # bert-large-uncased's WordPiece entries
BERT_PADDED = 30592  # + [BOS]/[EOS], padded to a multiple of 128
BERT_STEPS = 6
BERT_SEQ, BERT_MICRO, BERT_GLOBAL = 512, 4, 8
BERT_LAYERS, BERT_HIDDEN = 24, 1024
# examples/pretrain_bert.sh's flags (its train_iters, save_interval,
# eval_interval and eval_iters cut to the smoke's few steps)
BERT_RECIPE = ("--num_layers 24 --hidden_size 1024 --num_attention_heads 16 "
               "--micro_batch_size 4 --global_batch_size 8 --seq_length 512 "
               "--max_position_embeddings 512 --lr_decay_iters 990000 "
               "--tokenizer_type BertWordPieceLowerCase --split 949,50,1 "
               "--lr 0.0001 --min_lr 1.0e-5 --lr_decay_style linear "
               "--lr_warmup_fraction .01 --weight_decay 1e-2 --clip_grad 1.0 "
               "--mask_prob 0.15 --bf16")
BERT_LOSS_TOL = 2e-2
BERT_WORDS = 20000


def bert_words(rs):
    """BERT_WORDS distinct lowercase words, then ## pieces to fill the
    vocabulary to BERT_VOCAB entries with the five specials."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def draw(n, lo, hi, seen):
        out = []
        while len(out) < n:
            w = "".join(rs.choice(letters, rs.randint(lo, hi + 1)))
            if w not in seen:
                seen.add(w)
                out.append(w)
        return out

    words = draw(BERT_WORDS, 3, 9, set())
    pieces = draw(BERT_VOCAB - 5 - BERT_WORDS, 2, 5, set())
    return words, pieces


def bert_text(rs, words, pieces, n_words):
    """One sentence: vocabulary words and words that WordPiece splits
    into a word and a ## piece, capitalised, ended by a period."""
    out = []
    for _ in range(n_words):
        w = words[rs.randint(len(words))]
        if rs.rand() < 0.2:
            w += pieces[rs.randint(len(pieces))]
        out.append(w)
    out[0] = out[0].capitalize()
    return " ".join(out) + "."


def write_bert_data(rs):
    """The vocabulary file and a JSONL corpus of 200 documents of 20-60
    sentences (about 130k words), and the MNLI and RACE files in the
    readers' layouts: (vocab path, corpus path, tasks' paths)."""
    words, pieces = bert_words(rs)
    vocab = BERT_DIR / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + words + ["##" + p for p in pieces]) + "\n")
    corpus = BERT_DIR / "corpus.jsonl"
    with open(corpus, "w") as f:
        for _ in range(200):
            sents = [bert_text(rs, words, pieces, rs.randint(8, 25))
                     for _ in range(rs.randint(20, 61))]
            f.write(json.dumps({"text": " ".join(sents)}) + "\n")
    labels = ["contradiction", "entailment", "neutral"]
    tasks = {}
    for name, n in (("mnli_train", 64), ("mnli_dev", 32)):
        rows = ["\t".join(["index", "promptID", "pairID", "genre",
                           "sentence1_binary_parse",
                           "sentence2_binary_parse", "sentence1_parse",
                           "sentence2_parse", "sentence1", "sentence2",
                           "label1", "gold_label"])]
        for i in range(n):
            label = labels[rs.randint(3)]
            rows.append("\t".join([str(i)] + ["-"] * 7 + [
                bert_text(rs, words, pieces, rs.randint(10, 40)),
                bert_text(rs, words, pieces, rs.randint(5, 20)),
                label, label]))
        tasks[name] = BERT_DIR / f"{name}.tsv"
        tasks[name].write_text("\n".join(rows) + "\n")
    for name, n_files in (("race_train", 8), ("race_dev", 4)):
        d = BERT_DIR / name
        d.mkdir()
        for i in range(n_files):
            (d / f"{i}.txt").write_text(json.dumps({
                "article": " ".join(bert_text(rs, words, pieces,
                                              rs.randint(10, 25))
                                    for _ in range(20)),
                "questions": [bert_text(rs, words, pieces, 8)
                              for _ in range(2)],
                "options": [[bert_text(rs, words, pieces, 4)
                             for _ in range(4)] for _ in range(2)],
                "answers": [str("ABCD"[rs.randint(4)]) for _ in range(2)]}))
        tasks[name] = d
    return vocab, corpus, tasks


def bert_flops_per_step(n_params: int) -> float:
    """The model FLOPs of one step: 6 N a token plus attention's 12 L h s
    a token (QK and PV, forward and backward), over the step's tokens."""
    tokens = BERT_GLOBAL * BERT_SEQ
    return (6 * n_params + 12 * BERT_LAYERS * BERT_HIDDEN * BERT_SEQ) \
        * tokens


def assert_no_launches(what):
    counts = kernel_counts()
    check(not any(counts.values()),
          f"{what} launched a kernel: {counts} (the encoder path has none)")


def pretrain_run(entry, argv):
    """`entry.main(argv)` (pretrain_bert, pretrain_t5 or pretrain_ict)
    with the counters set to 0 just before it, which must stay 0;
    returns the trainer, the final state, the first global batch, every
    trained batch, each step's loss and ms, the wall, the peak memory and
    one more step's profile."""
    seen = {}

    def setup(orig):
        def wrapped(self, *a, **kw):
            seen["trainer"] = self
            return orig(self, *a, **kw)
        return wrapped

    def train_step(orig):
        def wrapped(self, state, text, *a, **kw):
            seen.setdefault("first", text)
            seen.setdefault("batches", []).append(text)
            return orig(self, state, text, *a, **kw)
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with patched(Trainer, "setup", setup), \
            patched(Trainer, "train_step", train_step):
        state = entry.main(argv)
    wall = time.perf_counter() - t0
    assert_no_launches(entry.__name__.rsplit(".", 1)[-1])
    trainer = seen["trainer"]
    steps = step_events(trainer)
    return dict(trainer=trainer, state=state, first=seen["first"],
                batches=seen["batches"], losses=[e["loss"] for e in steps],
                ms=[e["ms"] for e in steps], wall_s=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                profile=bert_step_profile(trainer, state, seen["first"]))


def bert_pretrain(vocab, data, save):
    """`pretrain_bert.main` for BERT_STEPS steps and its save."""
    from megatron_llm_tpu_torch import pretrain_bert

    return pretrain_run(pretrain_bert, BERT_RECIPE.split() + [
        "--vocab_file", str(vocab), "--data_path", data,
        "--train_iters", str(BERT_STEPS), "--eval_interval", "3",
        "--eval_iters", "1", "--log_interval", "1", "--seed", str(SEED),
        "--save", str(save), "--no_save_optim"])


def bert_step_profile(trainer, state, text):
    """One more step (after the save) on the first batch with the next
    iteration's dropout masks, under torch.profiler (CUDA activity
    only): its wall ms, the card's busy ms and idle share, GEMM ms and
    the ten largest kernels."""
    from megatron_llm_tpu_torch.models.dropout import fold_in

    rng = fold_in(trainer.tcfg.seed + 1, state.iteration)

    def step():
        float(trainer.train_step(state, text, rng)["loss"])

    _, wall, events = cuda_trace(step)
    kernels = kernel_totals(events)
    busy = busy_ms(events)
    gemm = sum(ms for n, ms in kernels.items()
               if any(g in n.lower() for g in GEMM_NAMES))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3),
            "device_ms": sum(kernels.values()), "gemm_ms": gemm,
            "top10_kernels_ms": [[n[:120], round(ms, 3)] for n, ms in top]}


@torch.no_grad()
def first_step_losses(run, make_model):
    """The first step's loss recomputed from the initial weights on its
    batch with its dropout masks, in bf16 (as trained) and in fp32;
    `make_model(cfg)` builds the run's model class at a config."""
    from megatron_llm_tpu_torch.models.dropout import at, fold_in

    trainer = run["trainer"]
    batch = trainer._built(run["first"])
    rng = fold_in(trainer.tcfg.seed + 1, 0)
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = make_model(dataclasses.replace(trainer.cfg,
                                               compute_dtype=dt))
        params = model.init(seed=trainer.tcfg.seed)
        n = next(iter(batch.values())).shape[0]
        loss = torch.zeros((), dtype=torch.float32, device=trainer.device)
        for i in range(n):
            micro = {k: v[i] for k, v in batch.items()}
            b = next(iter(micro.values())).shape[0]
            loss = loss + model.loss(params, dropout_rng=at(rng, i * b, 0),
                                     deterministic=False, **micro)
        out[name] = float(loss / n)
        del params
    return out


def check_pretraining(what, run, first, steps):
    """Phase 23's checks of a pretraining run: `steps` finite losses, the
    recomputed bf16 step 1 equal to the trained one, fp32 within
    BERT_LOSS_TOL of it."""
    losses = run["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{what} losses {losses}")
    check(abs(first["bf16"] - losses[0]) <= 1e-3,
          f"{what}: the recomputed bf16 step 1 {first['bf16']} != "
          f"{losses[0]}")
    check(abs(first["fp32"] - losses[0]) <= BERT_LOSS_TOL,
          f"{what}: step 1 bf16 {losses[0]} vs fp32 {first['fp32']}")


def pretraining_summary(run, flops, tokens_per_step, keep_keys):
    """The printed numbers of a pretraining run: step ms (median of steps
    2 on), tokens/s with padding and without it (the trained batches'
    mean count of kept positions, the 1s of their `keep_keys` masks),
    model TFLOP/s and share of 989, peak memory."""
    med = float(np.median(run["ms"][1:]))
    kept = float(np.mean([sum(float(torch.as_tensor(b[k]).sum())
                              for k in keep_keys) for b in run["batches"]]))
    return dict(losses=run["losses"], step_ms=run["ms"],
                step_ms_median_2_on=med,
                tokens_per_s_padded=tokens_per_step / (med / 1e3),
                tokens_per_s_nonpad=kept / (med / 1e3),
                nonpad_share=kept / tokens_per_step,
                model_flops_per_step=flops,
                model_tflops=flops / (med / 1e3) / 1e12,
                share_of_989=flops / (med / 1e3) / 989e12,
                peak_memory_gb=run["peak_gb"], pretrain_wall_s=run["wall_s"],
                profiled_step=run["profile"], kernel_launches=0)


def numel(tree) -> int:
    return sum(x.numel() for x in _leaves(tree))


def bert_task(argv, ck):
    """`tasks.main` with the counters set to 0 just before it; the
    encoder leaves it loaded (copied as loaded) held to the
    checkpoint's bit for bit."""
    from megatron_llm_tpu_torch.tasks import main as tasks_main

    got = {}

    def spy(orig):
        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            got.update({k: v.detach().cpu().clone()
                        for k, v in ckpt.flatten(out).items()})
            return out
        return wrapped

    losses = []
    zero_counts()
    t0 = time.perf_counter()
    with patched(tasks_main, "load_pretrained_encoder", spy):
        params, best, final = tasks_main.main(argv, losses=losses)
    wall = time.perf_counter() - t0
    assert_no_launches(argv[argv.index("--task") + 1])
    saved = ckpt.read_leaves(ckpt.tracked_checkpoint(str(ck))[0])
    encoder = [k for k in saved if k.split(".")[0] in
               ("embedding", "layers", "final_norm", "pooler")]
    check(sorted(got) == sorted(saved), "the load read other leaves")
    check(all(torch.equal(got[k], saved[k]) for k in encoder),
          "an encoder leaf was not loaded bit for bit")
    check(losses and all(np.isfinite(losses)), f"task losses {losses}")
    del params
    return dict(losses=losses, best_accuracy=best, final_accuracy=final,
                encoder_leaves_equal=len(encoder), wall_s=wall)


def write_titles(corpus, rs):
    """A title a document of the JSONL corpus, in its order: the
    document's first 2-8 words (the ICT titles corpus)."""
    titles = BERT_DIR / "titles.jsonl"
    with open(corpus) as src, open(titles, "w") as f:
        for line in src:
            words = json.loads(line)["text"].split()
            f.write(json.dumps(
                {"text": " ".join(words[:rs.randint(2, 9)])}) + "\n")
    return titles


def encoder_data():
    """The encoder phases' shared inputs (no real corpus or task data in
    the repository): a synthetic WordPiece vocabulary of 30522 entries,
    a synthetic corpus of 200 documents preprocessed sentence by
    sentence, their titles preprocessed whole, and the MNLI and RACE
    files."""
    from megatron_llm_tpu_torch.tools import preprocess_data

    shutil.rmtree(BERT_DIR, ignore_errors=True)
    BERT_DIR.mkdir(parents=True)
    vocab, corpus, tasks = write_bert_data(np.random.RandomState(SEED + 41))
    titles = write_titles(corpus, np.random.RandomState(SEED + 43))
    common = ["--tokenizer_type", "BertWordPieceLowerCase", "--vocab_file",
              str(vocab), "--workers", "1"]
    t0 = time.perf_counter()
    preprocess_data.main(["--input", str(corpus), "--output_prefix",
                          str(BERT_DIR / "corpus"), "--split_sentences",
                          *common])
    pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess_data.main(["--input", str(titles), "--output_prefix",
                          str(BERT_DIR / "titles"), *common])
    return dict(vocab=vocab, corpus=str(corpus),
                data=str(BERT_DIR / "corpus_text_document"),
                titles=str(BERT_DIR / "titles_text_document"), tasks=tasks,
                preprocess_s=pre_s,
                titles_preprocess_s=time.perf_counter() - t0)


def bert_phase(kernels, enc):
    """BERT pretraining at the recipe's BERT-large widths, then MNLI and
    RACE finetuning from its checkpoint, on `encoder_data()`'s
    vocabulary, corpus and task files."""
    from megatron_llm_tpu_torch.models import BertModel

    vocab, tasks = enc["vocab"], enc["tasks"]
    ck = BERT_DIR / "ck"
    run = bert_pretrain(vocab, enc["data"], ck)
    losses = run["losses"]
    cfg = run["trainer"].cfg
    check((cfg.num_layers, cfg.hidden_size, cfg.num_attention_heads,
           cfg.seq_length, cfg.padded_vocab_size, cfg.compute_dtype) == (
        BERT_LAYERS, BERT_HIDDEN, 16, BERT_SEQ, BERT_PADDED, torch.bfloat16),
        f"BERT config {cfg}")
    first = first_step_losses(run, lambda c: BertModel(c))
    check_pretraining("pretrain_bert", run, first, BERT_STEPS)
    n_params = run["trainer"]._n_params
    summary = pretraining_summary(run, bert_flops_per_step(n_params),
                                  BERT_GLOBAL * BERT_SEQ, ["padding_mask"])
    run.clear()
    free_cuda()
    common = BERT_RECIPE.split()[:6] + [
        "--max_position_embeddings", "512", "--seq_length", "512",
        "--tokenizer_type", "BertWordPieceLowerCase", "--vocab_file",
        str(vocab), "--pretrained_checkpoint", str(ck), "--bf16",
        "--epochs", "1", "--log_interval", "4", "--seed", str(SEED)]
    # the task flags of the reference's GLUE and RACE finetuning recipes
    # (MNLI 5 epochs and RACE 3, cut to 1)
    mnli = bert_task(common + [
        "--task", "MNLI", "--train_data", str(tasks["mnli_train"]),
        "--valid_data", str(tasks["mnli_dev"]), "--micro_batch_size", "8",
        "--lr", "5.0e-5", "--lr_warmup_fraction", "0.065",
        "--weight_decay", "1.0e-1"], ck)
    free_cuda()
    race = bert_task(common + [
        "--task", "RACE", "--train_data", str(tasks["race_train"]),
        "--valid_data", str(tasks["race_dev"]), "--micro_batch_size", "4",
        "--lr", "1.0e-5", "--lr_warmup_fraction", "0.06",
        "--weight_decay", "1.0e-1", "--clip_grad", "1.0"], ck)
    free_cuda()
    say("bert", card=nvidia_smi(),
        config="BERT-large widths (examples/pretrain_bert.sh) via "
               "pretrain_bert.main, synthetic WordPiece vocab and text",
        layers=BERT_LAYERS, hidden=BERT_HIDDEN, heads=16, seq=BERT_SEQ,
        micro_batch=BERT_MICRO, global_batch=BERT_GLOBAL,
        padded_vocab=BERT_PADDED, params=n_params,
        preprocess_s=enc["preprocess_s"], step1_bf16=losses[0],
        step1_bf16_recomputed=first["bf16"], step1_fp32=first["fp32"],
        step1_abs_diff=abs(first["fp32"] - losses[0]),
        mnli=mnli, race=race, **summary)
    for row in kernels:
        row.setdefault("launches_by_path", {})["bert"] = 0
    shutil.rmtree(ck)


# ---------------------------------------------------------------------------
# phases 24 and 25: T5 span corruption and ICT, at T5-base and BERT-base
# widths
# ---------------------------------------------------------------------------

T5_STEPS = 6
T5_LAYERS, T5_HIDDEN, T5_HEADS, T5_FFN = 12, 768, 12, 3072
T5_SEQ, T5_DEC_SEQ, T5_BATCH = 512, 128, 16
# 30522 + [BOS] + [EOS] + 100 sentinels = 30624, padded to a multiple of
# 128
T5_PADDED = 30720
# examples/pretrain_t5.sh's flags (its train_iters, save_interval,
# eval_interval and eval_iters cut to the smoke's few steps)
T5_RECIPE = ("--num_layers 12 --hidden_size 768 --num_attention_heads 12 "
             "--kv_channels 64 --ffn_hidden_size 3072 "
             "--encoder_seq_length 512 --decoder_seq_length 128 "
             "--micro_batch_size 16 --global_batch_size 16 "
             "--max_position_embeddings 512 --lr_decay_iters 1000000 "
             "--vocab_extra_ids 100 --split 949,50,1 --lr 0.0001 "
             "--min_lr 1.0e-5 --lr_decay_style linear "
             "--lr_warmup_fraction .01 --weight_decay 1e-2 --clip_grad 1.0 "
             "--mask_prob 0.15 --tokenizer_type BertWordPieceLowerCase "
             "--bf16")
ICT_STEPS = 6
ICT_LAYERS, ICT_HIDDEN, ICT_HEADS, ICT_SEQ, ICT_BATCH = 12, 768, 12, 256, 32
# examples/pretrain_ict.sh's widths and optimizer flags at batch 32,
# separate towers without the projection head, bf16
ICT_RECIPE = ("--num_layers 12 --hidden_size 768 --num_attention_heads 12 "
              "--seq_length 256 --max_position_embeddings 256 "
              "--micro_batch_size 32 --global_batch_size 32 --lr 0.0001 "
              "--lr_decay_style linear --lr_warmup_fraction .01 "
              "--weight_decay 1e-2 --clip_grad 1.0 "
              "--query_in_block_prob 0.1 --biencoder_projection_dim 0 "
              "--tokenizer_type BertWordPieceLowerCase --bf16")


def t5_flops_per_step(params, cfg) -> float:
    """The model FLOPs of one step: 6 N a token of what runs over each
    token (the encoder's layers and final norm, and the decoder's
    cross-attention K/V projection wkv + bkv, over encoder tokens; the
    rest of the decoder's layers, its final norm and the tied head,
    h x V, over decoder tokens) plus attention's 12 L h t a token for
    each t it attends over (encoder self s_e; decoder self s_d and
    cross s_e)."""
    cross = params["decoder_layers"]["cross_attention"]
    n_kv = sum(cross[k].numel() for k in ("wkv", "bkv") if k in cross)
    n_enc = numel(params["layers"]) + numel(params["final_norm"]) + n_kv
    n_dec = numel(params["decoder_layers"]) - n_kv \
        + numel(params["decoder_final_norm"]) \
        + cfg.hidden_size * cfg.padded_vocab_size
    t_enc, t_dec = T5_BATCH * T5_SEQ, T5_BATCH * T5_DEC_SEQ
    attn = 12 * cfg.num_layers * cfg.hidden_size
    return 6 * (n_enc * t_enc + n_dec * t_dec) \
        + attn * (T5_SEQ * t_enc + (T5_DEC_SEQ + T5_SEQ) * t_dec)


def ict_flops_per_step(params, cfg) -> float:
    """The model FLOPs of one step: each tower's 6 N a token (its layers
    and final norm) plus attention's 12 L h s a token, over the batch's
    query or context tokens, and the (b, b) score product."""
    tokens = ICT_BATCH * ICT_SEQ
    attn = 12 * cfg.num_layers * cfg.hidden_size * ICT_SEQ
    towers = [params["query"], params["context"]]
    return sum((6 * (numel(t["layers"]) + numel(t["final_norm"])) + attn)
               * tokens for t in towers) \
        + 6 * ICT_BATCH * ICT_BATCH * cfg.hidden_size


def t5_phase(kernels, enc):
    """T5 span-corruption pretraining at examples/pretrain_t5.sh's
    T5-base widths on `encoder_data()`'s corpus."""
    from megatron_llm_tpu_torch import pretrain_t5
    from megatron_llm_tpu_torch.models import T5Model

    ck = BERT_DIR / "t5_ck"
    run = pretrain_run(pretrain_t5, T5_RECIPE.split() + [
        "--vocab_file", str(enc["vocab"]), "--data_path", enc["data"],
        "--train_iters", str(T5_STEPS), "--eval_interval", "3",
        "--eval_iters", "1", "--log_interval", "1", "--seed", str(SEED),
        "--save", str(ck), "--no_save_optim"])
    cfg = run["trainer"].cfg
    check((cfg.num_layers, cfg.hidden_size, cfg.num_attention_heads,
           cfg.kv_channels, cfg.ffn_hidden_size, cfg.seq_length,
           cfg.max_position_embeddings, cfg.padded_vocab_size,
           cfg.compute_dtype) == (
        T5_LAYERS, T5_HIDDEN, T5_HEADS, 64, T5_FFN, T5_SEQ, T5_SEQ,
        T5_PADDED, torch.bfloat16), f"T5 config {cfg}")
    first = first_step_losses(run, lambda c: T5Model(c))
    check_pretraining("pretrain_t5", run, first, T5_STEPS)
    batch = run["trainer"]._built(run["first"])
    check(tuple(batch["encoder_input_ids"].shape) == (1, T5_BATCH, T5_SEQ)
          and tuple(batch["decoder_input_ids"].shape)
          == (1, T5_BATCH, T5_DEC_SEQ), "T5 batch shapes")
    params = run["state"].params
    flops = t5_flops_per_step(params, cfg)
    n_params = numel(params)
    summary = pretraining_summary(run, flops,
                                  T5_BATCH * (T5_SEQ + T5_DEC_SEQ),
                                  ["enc_mask", "dec_mask"])
    del params, batch
    run.clear()
    free_cuda()
    say("t5", card=nvidia_smi(),
        config="T5-base widths (examples/pretrain_t5.sh) via "
               "pretrain_t5.main, synthetic WordPiece vocab and text",
        layers_a_side=T5_LAYERS, hidden=T5_HIDDEN, heads=T5_HEADS,
        kv_channels=64, ffn=T5_FFN, seq_encoder=T5_SEQ,
        seq_decoder=T5_DEC_SEQ, micro_batch=T5_BATCH,
        global_batch=T5_BATCH, padded_vocab=T5_PADDED, params=n_params,
        step1_bf16_recomputed=first["bf16"], step1_fp32=first["fp32"],
        step1_abs_diff=abs(first["fp32"] - summary["losses"][0]),
        tokens_counted="encoder + decoder positions a step, padded "
                       "and kept (enc_mask, dec_mask)",
        flops_counted="6 (N_enc + N_wkv) t_enc + 6 (N_dec - N_wkv + h V) "
                      "t_dec + 12 L h (s_e t_enc + (s_d + s_e) t_dec)",
        **summary)
    for row in kernels:
        row.setdefault("launches_by_path", {})["t5"] = 0
    shutil.rmtree(ck)


def ict_phase(kernels, enc):
    """ICT biencoder pretraining at BERT-base widths on `encoder_data()`'s
    corpus and titles; returns its checkpoint's directory (the retrieval
    phase's towers)."""
    from megatron_llm_tpu_torch import pretrain_ict
    from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel

    ck = BERT_DIR / "ict_ck"
    run = pretrain_run(pretrain_ict, ICT_RECIPE.split() + [
        "--vocab_file", str(enc["vocab"]), "--data_path", enc["data"],
        "--titles_data_path", enc["titles"],
        "--train_iters", str(ICT_STEPS), "--log_interval", "1",
        "--seed", str(SEED), "--save", str(ck), "--no_save_optim"])
    cfg = run["trainer"].cfg
    model = run["trainer"].model
    check((cfg.num_layers, cfg.hidden_size, cfg.num_attention_heads,
           cfg.seq_length, cfg.padded_vocab_size, cfg.compute_dtype,
           cfg.add_binary_head, model.shared, model.projection_dim) == (
        ICT_LAYERS, ICT_HIDDEN, ICT_HEADS, ICT_SEQ, BERT_PADDED,
        torch.bfloat16, False, False, 0), f"ICT config {cfg}")
    first = first_step_losses(run, lambda c: BiEncoderModel(c))
    check_pretraining("pretrain_ict", run, first, ICT_STEPS)
    params = run["state"].params
    flops = ict_flops_per_step(params, cfg)
    n_params = numel(params)
    summary = pretraining_summary(run, flops, 2 * ICT_BATCH * ICT_SEQ,
                                  ["query_pad_mask", "context_pad_mask"])
    del params, model
    run.clear()
    free_cuda()
    say("ict", card=nvidia_smi(),
        config="BERT-base towers (examples/pretrain_ict.sh's widths) via "
               "pretrain_ict.main, separate towers, projection 0, "
               "synthetic WordPiece vocab, text and titles",
        layers=ICT_LAYERS, hidden=ICT_HIDDEN, heads=ICT_HEADS, seq=ICT_SEQ,
        micro_batch=ICT_BATCH, global_batch=ICT_BATCH,
        padded_vocab=BERT_PADDED, params=n_params,
        titles_preprocess_s=enc["titles_preprocess_s"],
        step1_bf16_recomputed=first["bf16"], step1_fp32=first["fp32"],
        step1_abs_diff=abs(first["fp32"] - summary["losses"][0]),
        step1_minus_ln_batch=summary["losses"][0] - float(np.log(ICT_BATCH)),
        tokens_counted="query + context positions a step, padded and "
                       "kept (the pad masks)",
        flops_counted="sum over towers (6 N_tower + 12 L h s) b s "
                      "+ 6 b b h", **summary)
    for row in kernels:
        row.setdefault("launches_by_path", {})["ict"] = 0
    return ck


# ---------------------------------------------------------------------------
# phases 26-28: the downstream tasks. ORQA retrieval over the ict phase's
# towers; zero-shot WIKITEXT103 and LAMBADA, and MSDP, at Llama-2-7B widths
# ---------------------------------------------------------------------------

# DPR's evidence is 100-word passages; the corpus's 130k words give this
# many at a stride of 24 words
RET_PASSAGES, RET_PASSAGE_WORDS, RET_STRIDE = 4096, 100, 24
RET_QUESTIONS, RET_BATCH, RET_TOPK = 256, 128, 100
RET_FT_SAMPLES, RET_FT_BATCH = 128, 32
# the ict phase's towers at examples/pretrain_ict.sh's widths
RET_RECIPE = ("--num_layers 12 --hidden_size 768 --num_attention_heads 12 "
              "--seq_length 256 --max_position_embeddings 256 "
              "--retriever_seq_length 256 --data_parallel_size 1 "
              "--tokenizer_type BertWordPieceLowerCase")
# the search at a size retrieval users hold: DPR's Wikipedia index is 21M
# passages of width 768, cut to 2^21 fp32 rows (6.44 GB on the card)
SEARCH_ROWS, SEARCH_DIM, SEARCH_QUERIES = 1 << 21, 768, 1024
SEARCH_CHECK_ROWS, SEARCH_CHECK_CHUNK = 1 << 16, 1 << 14


def write_retrieval_data(corpus, rs):
    """From `encoder_data()`'s corpus: RET_PASSAGES evidence passages of
    RET_PASSAGE_WORDS words at a stride of RET_STRIDE, titled by their
    document's first words; RET_QUESTIONS NQ questions (8 words of a
    passage, one of them the answer) and RET_FT_SAMPLES DPR training
    samples (a question, its passage, two other passages as hard
    negatives): (evidence, nq, dpr) paths."""
    passages = []
    with open(corpus) as f:
        for line in f:
            words = json.loads(line)["text"].split()
            for lo in range(0, len(words) - RET_PASSAGE_WORDS + 1,
                            RET_STRIDE):
                passages.append((" ".join(words[:3]), " ".join(
                    words[lo:lo + RET_PASSAGE_WORDS])))
    check(len(passages) >= RET_PASSAGES, f"{len(passages)} passages")
    passages = passages[:RET_PASSAGES]
    evidence = BERT_DIR / "evidence.tsv"
    evidence.write_text("id\ttext\ttitle\n" + "".join(
        f"{i + 1}\t{text}\t{title}\n" for i, (title, text)
        in enumerate(passages)))

    def question(i):
        words = [w.lower().strip(".") for w in passages[i][1].split()]
        lo = rs.randint(len(words) - 8)
        return " ".join(words[lo:lo + 8]), words[lo + rs.randint(8)]

    nq = BERT_DIR / "nq_dev.tsv"
    nq.write_text("".join(
        "{}\t{}\n".format(*(lambda qa: (qa[0], json.dumps([qa[1]])))(
            question(i)))
        for i in rs.choice(RET_PASSAGES, RET_QUESTIONS, replace=False)))
    samples = []
    for i in rs.choice(RET_PASSAGES, RET_FT_SAMPLES, replace=False):
        q, a = question(i)
        negs = [passages[j] for j in rs.choice(RET_PASSAGES, 2)]
        samples.append({
            "question": q, "answers": [a],
            "positive_ctxs": [{"title": passages[i][0],
                               "text": passages[i][1]}],
            "hard_negative_ctxs": [{"title": t, "text": x}
                                   for t, x in negs]})
    dpr = BERT_DIR / "nq_train.json"
    dpr.write_text(json.dumps(samples))
    return str(evidence), str(nq), str(dpr)


def search_numbers(index, queries):
    """The search over `index` timed (host clock around each call, which
    ends in the results' copy to the host; the median of 5 after one
    warm-up), its two parts on CUDA events (the chunks' products, one
    chunk's top-k), and its bound."""
    from megatron_llm_tpu_torch.data.realm_index import fp32_products

    index.search_mips_index(queries, RET_TOPK)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.search_mips_index(queries, RET_TOPK)
        times.append((time.perf_counter() - t0) * 1e3)
    q = torch.from_numpy(queries).cuda()
    chunk = index.embeds[:index.chunk_rows]
    with fp32_products():
        gemm = time_ms(lambda: q @ chunk.T, iters=5, warmup=1)
        scores = q @ chunk.T
        topk = time_ms(lambda: torch.topk(scores, RET_TOPK, dim=1), iters=5,
                       warmup=1)
    del scores
    n, d, qn = index.embeds.shape[0], SEARCH_DIM, SEARCH_QUERIES
    ops_ms = 2 * qn * d * n / FP32_FLOPS * 1e3
    bytes_ms = ((n + qn) * d * 4 + qn * RET_TOPK * 12) / HBM_BYTES_PER_S * 1e3
    chunks = -(-n // index.chunk_rows)
    return dict(chunk_rows=index.chunk_rows,
                search_ms=float(np.median(times)), search_ms_all=times,
                gemm_ms=gemm * chunks, topk_ms=topk * chunks,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
                over_bound=float(np.median(times)) / max(ops_ms, bytes_ms))


def retrieval_phase(kernels, enc, ck):
    """ORQA retrieval over the ict phase's towers (`ck`): the index built
    by `build_retrieval_index` over passages of `encoder_data()`'s
    corpus, RETRIEVER-EVAL through `tasks.main` from that store against
    ICT-ZEROSHOT-NQ's on-the-fly index, the search timed at 2^21 rows,
    and a few RET-FINETUNE-NQ steps from the checkpoint."""
    from megatron_llm_tpu_torch.data.realm_index import (
        MIPSIndex,
        fp32_products,
    )
    from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel
    from megatron_llm_tpu_torch.tasks import main as tasks_main
    from megatron_llm_tpu_torch.tasks.orqa import supervised
    from megatron_llm_tpu_torch.tools import build_retrieval_index

    vocab = str(enc["vocab"])
    evidence, nq, dpr = write_retrieval_data(
        enc["corpus"], np.random.RandomState(SEED + 47))
    store = BERT_DIR / "evidence_embeds.npz"
    zero_counts()
    t0 = time.perf_counter()
    build_retrieval_index.main([
        "--evidence_data_path", evidence, "--embedding_path", str(store),
        "--load", str(ck), "--tokenizer_type", "BertWordPieceLowerCase",
        "--vocab_file", vocab, "--num_layers", str(ICT_LAYERS),
        "--hidden_size", str(ICT_HIDDEN), "--num_attention_heads",
        str(ICT_HEADS), "--retriever_seq_length", str(ICT_SEQ),
        "--indexer_batch_size", str(RET_BATCH)])
    build_s = time.perf_counter() - t0

    argv = RET_RECIPE.split() + [
        "--vocab_file", vocab, "--load", str(ck), "--evidence_data_path",
        evidence, "--qa_data_dev", nq, "--micro_batch_size", str(RET_BATCH),
        "--retriever_topk", str(RET_TOPK), "--seed", str(SEED)]
    t0 = time.perf_counter()
    prebuilt, res_pre = tasks_main.main(
        argv + ["--task", "RETRIEVER-EVAL", "--embedding_path", str(store)])
    eval_prebuilt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fly, res_fly = tasks_main.main(argv + ["--task", "ICT-ZEROSHOT-NQ"])
    eval_fly_s = time.perf_counter() - t0
    questions = [ln.split("\t")[0] for ln in open(nq)]
    ids_pre = [ids for ids, _ in prebuilt.retrieve(questions, RET_TOPK)]
    ids_fly = [ids for ids, _ in fly.retrieve(questions, RET_TOPK)]
    check(ids_pre == ids_fly, "the prebuilt store's top-k ids differ from "
          "the on-the-fly index's")
    rates = res_pre["DEV"][0]
    check(rates == res_fly["DEV"][0] and len(rates) == RET_TOPK,
          f"hit rates {rates[:5]} vs {res_fly['DEV'][0][:5]}")
    emb_diff = float(np.abs(prebuilt.evidence_emb - fly.evidence_emb).max())
    assert_no_launches("retrieval")
    del prebuilt, fly
    free_cuda()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    index = MIPSIndex(SEARCH_DIM)
    index.add_rows(np.arange(SEARCH_ROWS), torch.randn(
        SEARCH_ROWS, SEARCH_DIM, device="cuda", generator=gen))
    queries = torch.randn(SEARCH_QUERIES, SEARCH_DIM, device="cuda",
                          generator=gen).cpu().numpy()
    search = search_numbers(index, queries)
    # the chunked merge against one top-k over the same scores (the same
    # chunks' products, concatenated) on a 64k-row subset
    sub = MIPSIndex(SEARCH_DIM, chunk_rows=SEARCH_CHECK_CHUNK)
    sub.add_rows(np.arange(SEARCH_CHECK_ROWS),
                 index.embeds[:SEARCH_CHECK_ROWS])
    sub_s, sub_ids = sub.search_mips_index(queries, RET_TOPK)
    q = torch.from_numpy(queries).cuda()
    with fp32_products():
        scores = torch.cat([q @ sub.embeds[lo:lo + SEARCH_CHECK_CHUNK].T
                            for lo in range(0, SEARCH_CHECK_ROWS,
                                            SEARCH_CHECK_CHUNK)], dim=1)
        ref_s, ref_ids = torch.topk(scores, RET_TOPK, dim=1)
        _, whole_ids = torch.topk(q @ sub.embeds.T, RET_TOPK, dim=1)
    check(np.array_equal(sub_ids, ref_ids.cpu().numpy())
          and np.array_equal(sub_s, ref_s.cpu().numpy()),
          "the chunked search's top-k differs from one top-k over the "
          "same scores")
    whole_agree = float((whole_ids.cpu().numpy() == sub_ids).mean())
    del index, sub, scores, q
    free_cuda()

    seen = {}

    def capture(orig):
        def wrapped(model, params, train_ds, *a, **kw):
            seen.update(model=model, params=params)
            return orig(model, params, train_ds, *a, **kw)
        return wrapped

    def first_batch(orig):
        def wrapped(ds, idxs):
            out = orig(ds, idxs)
            seen.setdefault("batch", out)
            return out
        return wrapped

    losses = []
    zero_counts()
    t0 = time.perf_counter()
    with patched(supervised, "finetune_retriever", capture), \
            patched(supervised, "host_batch", first_batch):
        tasks_main.main(RET_RECIPE.split() + [
            "--task", "RET-FINETUNE-NQ", "--vocab_file", vocab,
            "--pretrained_checkpoint", str(ck), "--train_data", dpr,
            "--micro_batch_size", str(RET_FT_BATCH), "--epochs", "1",
            "--lr", "1e-5", "--use_hard_negatives", "--log_interval", "1",
            "--seed", str(SEED)], losses=losses)
    ft_s = time.perf_counter() - t0
    assert_no_launches("RET-FINETUNE-NQ")
    check(len(losses) == RET_FT_SAMPLES // RET_FT_BATCH
          and all(np.isfinite(x) for x, _ in losses),
          f"RET-FINETUNE-NQ losses {losses}")
    model, params = seen["model"], seen["params"]
    batch = supervised.to_device(seen["batch"], model.device)
    step1, scores = {}, {}
    with torch.no_grad():
        for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            m = BiEncoderModel(dataclasses.replace(model.cfg, compute_dtype=dt),
                               projection_dim=model.projection_dim,
                               shared_query_context_model=model.shared)
            step1[name] = float(supervised.make_loss_fn(m, True)(
                params, batch)[0])
            q = m.embed_text(params["query"], batch["query"],
                             batch["query_mask"]).float()
            c = torch.cat([m.embed_text(params["context"], batch[k],
                                        batch[k + "_mask"]).float()
                           for k in ("context", "neg_context")])
            scores[name] = q @ c.T
    score_err = float((scores["bf16"] - scores["fp32"]).abs().max())
    score_max = float(scores["fp32"].abs().max())
    check(abs(step1["bf16"] - losses[0][0]) <= 1e-3,
          f"RET-FINETUNE-NQ: the recomputed bf16 step 1 {step1['bf16']} != "
          f"{losses[0][0]}")
    # the ict phase's 2e-2, of the loss: the trained towers' in-batch
    # scores run to hundreds, and a logsumexp over scores whose bf16
    # error is a few tenths moves by a few hundredths
    check(abs(step1["fp32"] - losses[0][0])
          <= BERT_LOSS_TOL * max(1.0, abs(step1["fp32"])),
          f"RET-FINETUNE-NQ: step 1 bf16 {losses[0][0]} vs fp32 "
          f"{step1['fp32']}")
    seen.clear()
    free_cuda()
    say("retrieval", card=nvidia_smi(),
        config="the ict phase's BERT-base towers (examples/pretrain_ict.sh "
               "widths, seq 256, separate towers) via "
               "tools/build_retrieval_index and tasks.main",
        passages=RET_PASSAGES, passage_words=RET_PASSAGE_WORDS,
        index_build_s=build_s,
        passages_per_s_with_load=RET_PASSAGES / build_s,
        store_mb=store.stat().st_size / 1e6,
        eval_prebuilt_s=eval_prebuilt_s, eval_on_the_fly_s=eval_fly_s,
        questions=RET_QUESTIONS, ids_equal_prebuilt_on_the_fly=True,
        evidence_embeddings_max_abs_diff=emb_diff,
        top_k_accuracy={k: rates[k - 1] for k in (1, 5, 20, 100)
                        if k <= len(rates)},
        search=dict(rows=SEARCH_ROWS, dim=SEARCH_DIM,
                    queries=SEARCH_QUERIES, top_k=RET_TOPK,
                    store_gb=SEARCH_ROWS * SEARCH_DIM * 4 / 1e9,
                    reduced="2^21 rows of DPR's 21M-passage Wikipedia "
                            "index", **search),
        subset_check=dict(rows=SEARCH_CHECK_ROWS,
                          chunk_rows=SEARCH_CHECK_CHUNK, ids_equal=True,
                          agreement_with_one_whole_product=whole_agree),
        finetune=dict(samples=RET_FT_SAMPLES, batch=RET_FT_BATCH,
                      hard_negatives=True, losses=losses, wall_s=ft_s,
                      step1_bf16_recomputed=step1["bf16"],
                      step1_fp32=step1["fp32"],
                      step1_abs_diff=abs(step1["fp32"] - losses[0][0]),
                      step1_scores_fp32_max_abs=score_max,
                      step1_scores_bf16_max_abs_err=score_err),
        kernel_launches=0)
    for row in kernels:
        row.setdefault("launches_by_path", {})["retrieval"] = 0


ZS_DIR = Path(__file__).resolve().parent / "build" / "downstream_smoke"
ZS_SEQ, ZS_MICRO = 4096, 4
# 8 windows of 4096 at --overlapping_eval 2048, and 16 cloze passages
ZS_OVERLAP, ZS_WIKI_TOKENS, ZS_LAMBADA = 2048, 8 * 2048 + 1, 16


def llama_task_argv(init_std, *extra):
    """tasks.main's model flags of the zeroshot and msdp phases: Llama-2-7B
    widths at LLAMA_LAUNCH_LAYERS of 32 layers, seq 4096, random weights
    at the smoke's init std from SEED."""
    return (f"--model_name llama2 --model_size 7 --num_layers "
            f"{LLAMA_LAUNCH_LAYERS} --seq_length {ZS_SEQ} "
            f"--max_position_embeddings {ZS_SEQ} --data_parallel_size 1 "
            f"--init_method_std {init_std} --seed {SEED} "
            f"--log_interval 100").split() + list(extra)


def fp32_plain(orig):
    """args_to_configs building fp32 compute with plain attention."""
    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = orig(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=torch.float32,
                                   use_flash_attn=False,
                                   use_decode_attn=False), p, tc, d
    return wrapped


def task_model(argv, fp32=False):
    """The model and initial weights tasks.main builds for `argv`."""
    from megatron_llm_tpu_torch import arguments, finetune

    args = arguments.build_base_parser().parse_args(argv)
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    to_configs = fp32_plain(arguments.args_to_configs) if fp32 \
        else arguments.args_to_configs
    model = finetune.model_provider(args, to_configs(args, tok.vocab_size)[0])
    return model, model.init(seed=SEED)


@torch.no_grad()
def scored_logits(model, params, data):
    """Each sample's fp32 logits at its one scored position, the batches
    as `tasks.zeroshot.evaluate` forms them."""
    out = []
    for lo in range(0, len(data), ZS_MICRO):
        toks = np.zeros((ZS_MICRO, ZS_SEQ + 1), np.int32)
        chunk = data.tokens[lo:lo + ZS_MICRO]
        toks[:len(chunk)] = chunk
        logits, _ = model.forward(params, torch.from_numpy(
            toks[:, :-1]).cuda())
        for i in range(len(chunk)):
            (pos,) = np.nonzero(data.pad_mask[lo + i])
            out.append(logits[i, int(pos[0])].float())
    return torch.stack(out)


def zeroshot_phase(kernels, init_std):
    """WIKITEXT103 and LAMBADA through `tasks.main` in bf16 with
    `--use_flash_attn` (K4) against the same model in fp32 with plain
    attention; the cloze answers are the fp32 model's own greedy next
    tokens."""
    from megatron_llm_tpu_torch import arguments
    from megatron_llm_tpu_torch.tasks import main as tasks_main
    from megatron_llm_tpu_torch.tasks.zeroshot.datasets import build_dataset

    shutil.rmtree(ZS_DIR, ignore_errors=True)
    ZS_DIR.mkdir(parents=True)
    rs = np.random.RandomState(SEED + 59)
    tok = build_tokenizer("NullTokenizer", null_vocab_size=31999)
    wiki = ZS_DIR / "wiki.test.tokens"
    wiki.write_text(" ".join(map(str, rs.randint(0, 31999, ZS_WIKI_TOKENS))))
    contexts = [rs.randint(0, 31999, n) for n in
                rs.randint(64, ZS_SEQ - 96, ZS_LAMBADA)]
    lambada = ZS_DIR / "lambada.jsonl"
    # the rows the evaluation forms, an answer yet to be chosen (the
    # causal forward's logits before it do not read it)
    lambada.write_text("".join(json.dumps({"text": " ".join(
        map(str, list(c) + [0]))}) + "\n" for c in contexts))
    data = build_dataset("LAMBADA", str(lambada), tok, ZS_SEQ)
    flash = llama_task_argv(init_std, "--use_flash_attn")
    plain = llama_task_argv(init_std)
    t0 = time.perf_counter()
    model, params = task_model(plain, fp32=True)
    ref = scored_logits(model, params, data)
    del model, params
    free_cuda()
    top2 = torch.topk(ref, 2, dim=1).values
    answers = ref.argmax(1).cpu().numpy()
    lambada.write_text("".join(json.dumps({"text": " ".join(
        map(str, list(c) + [int(a)]))}) + "\n"
        for c, a in zip(contexts, answers)))
    targets_s = time.perf_counter() - t0

    runs, launches = {}, 0
    for task, path, extra in (
            ("WIKITEXT103", wiki, ["--overlapping_eval", str(ZS_OVERLAP)]),
            ("LAMBADA", lambada, [])):
        common = ["--task", task, "--valid_data", str(path),
                  "--tokenizer_type", "NullTokenizer", "--null_vocab_size",
                  "31999", "--micro_batch_size", str(ZS_MICRO), *extra]
        zero_counts()
        t0 = time.perf_counter()
        bf16 = tasks_main.main(flash + common)
        bf16_s = time.perf_counter() - t0
        counts = kernel_counts()
        n = -(-(ZS_WIKI_TOKENS - 1 - ZS_OVERLAP) // ZS_OVERLAP) + 1 \
            if task == "WIKITEXT103" else ZS_LAMBADA
        forwards = -(-n // ZS_MICRO)
        check(counts["flash_fwd"] == LLAMA_LAUNCH_LAYERS * forwards
              and sum(counts.values()) == counts["flash_fwd"],
              f"{task}: launches {counts}, expected K4 "
              f"{LLAMA_LAUNCH_LAYERS} x {forwards} forwards")
        launches += counts["flash_fwd"]
        free_cuda()
        zero_counts()
        t0 = time.perf_counter()
        with patched(arguments, "args_to_configs", fp32_plain):
            fp32 = tasks_main.main(plain + common)
        fp32_s = time.perf_counter() - t0
        assert_no_launches(f"{task} in fp32")
        free_cuda()
        runs[task] = dict(bf16=bf16, fp32=fp32, bf16_s=bf16_s, fp32_s=fp32_s,
                          windows_or_samples=n, k4_launches=counts["flash_fwd"])
    wk = runs["WIKITEXT103"]
    check(abs(wk["bf16"]["avg_loss"] - wk["fp32"]["avg_loss"]) <= PATH_LP_TOL,
          f"WIKITEXT103 mean loss bf16 {wk['bf16']['avg_loss']} vs fp32 "
          f"{wk['fp32']['avg_loss']}")
    lb = runs["LAMBADA"]
    check(lb["fp32"]["num_correct"] == ZS_LAMBADA,
          f"LAMBADA fp32 correct {lb['fp32']['num_correct']} of "
          f"{ZS_LAMBADA}: the targets are its own greedy tokens")
    # each bf16 verdict against the fp32 one: a flip counts as inside the
    # bf16 error where the fp32 top-two margin is at most twice the
    # largest |bf16 - fp32| logit at that position
    model, params = task_model(flash)
    got = scored_logits(model, params, build_dataset(
        "LAMBADA", str(lambada), tok, ZS_SEQ))
    del model, params
    free_cuda()
    err = (got - ref).abs().max(1).values
    margin = top2[:, 0] - top2[:, 1]
    flipped = (got.argmax(1).cpu().numpy() != answers)
    inside = flipped & (margin <= 2 * err).cpu().numpy()
    check(int(flipped.sum()) == ZS_LAMBADA - lb["bf16"]["num_correct"],
          f"LAMBADA bf16: {int(flipped.sum())} flips in the smoke's "
          f"forward, {ZS_LAMBADA - lb['bf16']['num_correct']} in tasks.main")
    add_launches(kernels, "zeroshot", {"flash_fwd": launches})
    say("zeroshot", card=nvidia_smi(),
        config="Llama-2-7B widths (hidden 4096, 32 heads, ffn 11008, seq "
               "4096) at 4 of 32 layers via tasks.main, random weights",
        layers=LLAMA_LAUNCH_LAYERS, init_std=init_std, micro_batch=ZS_MICRO,
        wikitext=dict(tokens=ZS_WIKI_TOKENS, overlapping_eval=ZS_OVERLAP,
                      **wk,
                      avg_loss_abs_diff=abs(wk["bf16"]["avg_loss"]
                                            - wk["fp32"]["avg_loss"])),
        lambada=dict(samples=ZS_LAMBADA, targets_s=targets_s,
                     **lb,
                     verdicts_differing=int(flipped.sum()),
                     differing_inside_bf16_error=int(inside.sum()),
                     top2_margin_fp32_min=float(margin.min()),
                     top2_margin_fp32_median=float(margin.median()),
                     logit_err_bf16_max=float(err.max())),
        k4_launches=launches)
    return {"flash_argv": flash, "wiki": str(wiki), "lambada": str(lambada),
            "wiki_avg_loss": wk["bf16"]["avg_loss"],
            "lambada_correct": lb["bf16"]["num_correct"],
            "lambada_hits": (got.argmax(1).cpu().numpy()
                             == answers).tolist(),
            "lambada_logits": got.cpu(),
            "lambada_answer_pos": [int(np.nonzero(m)[0][0]) for m in
                                   data.pad_mask]}


MSDP_GEN, MSDP_SAMPLES, MSDP_PROMPTS = 32, 4, 8
MSDP_VOCAB = 32000  # Llama-2's vocabulary size


def write_bpe(rs):
    """A byte-level GPT-2 BPE tokenizer of MSDP_VOCAB entries made from
    the seed: the 256 bytes, pair merges (printable pairs first, in a
    seeded order) and <|endoftext|> last: (vocab.json, merges.txt)."""
    from megatron_llm_tpu_torch.tokenizer.gpt2_bpe import bytes_to_unicode

    chars = [bytes_to_unicode()[b] for b in range(256)]
    printable = [bytes_to_unicode()[b] for b in range(32, 127)]
    first = [(a, b) for a in printable for b in printable]
    first = [first[i] for i in rs.permutation(len(first))]
    seen = set(first)
    rest = [(a, b) for a in chars for b in chars if (a, b) not in seen]
    rest = [rest[i] for i in rs.permutation(len(rest))]
    pairs = (first + rest)[:MSDP_VOCAB - 257]
    vocab = {c: i for i, c in enumerate(chars)}
    for a, b in pairs:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    check(len(vocab) == MSDP_VOCAB, f"BPE vocabulary {len(vocab)}")
    vf, mf = ZS_DIR / "vocab.json", ZS_DIR / "merges.txt"
    vf.write_text(json.dumps(vocab))
    mf.write_text("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                             for a, b in pairs))
    return str(vf), str(mf)


def write_msdp_data(rs):
    """MSDP's files in preprocessing.py's layouts, from seeded words:
    the test file, its knowledge reference, knowledge prompts (8
    instances a test key) and response prompts."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rs.choice(letters, rs.randint(2, 9)))
             for _ in range(400)]

    def sent(lo, hi):
        return " ".join(rs.choice(words, rs.randint(lo, hi)))

    topics = [sent(1, 3).title() for _ in range(MSDP_SAMPLES)]
    rows = [(t, f"{sent(4, 12)}. [SEP] {sent(4, 12)}.", f"{t} {sent(6, 16)}",
             sent(6, 14) + ".") for t in topics]
    test, ref = ZS_DIR / "msdp_test.txt", ZS_DIR / "msdp_knowledge_ref.txt"
    test.write_text("".join("\t".join(r) + "\n" for r in rows))
    ref.write_text("".join(r[2] + "\n" for r in rows))
    knwl = ZS_DIR / "msdp_knowledge_prompts.jsonl"
    knwl.write_text("".join(json.dumps({
        f"{t} {ctx.split(' [SEP] ')[-1]}": [
            f"( {sent(4, 12)}. ) {t} => {t} {sent(6, 16)}"
            for _ in range(MSDP_PROMPTS)]}) + "\n"
        for t, ctx, _, _ in rows))
    resp = ZS_DIR / "msdp_response_prompts.txt"
    resp.write_text("".join(
        f"Topic: {sent(1, 3)}. User says: {sent(4, 12)} . We know that: "
        f"{sent(6, 16)} . System replies: {sent(6, 14)} .\n"
        for _ in range(2 * MSDP_PROMPTS)))
    return test, ref, knwl, resp


def msdp_phase(kernels, init_std):
    """MSDP-PROMPT (knowledge, then response) and MSDP-EVAL-F1 through
    `tasks.main` at Llama-2-7B widths: K1 counted on the whole-batch
    decode, each greedy stream teacher-forced through the fp32 plain
    model."""
    from megatron_llm_tpu_torch.inference import api
    from megatron_llm_tpu_torch.tasks import main as tasks_main

    ZS_DIR.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(SEED + 61)
    vf, mf = write_bpe(rs)
    test, ref, knwl, resp = write_msdp_data(rs)
    argv = llama_task_argv(init_std, "--tokenizer_type", "GPT2BPETokenizer",
                           "--vocab_file", vf, "--merges_file", mf,
                           "--micro_batch_size", "1", "--out_seq_length",
                           str(MSDP_GEN), "--num_prompt_examples",
                           str(2 * MSDP_PROMPTS))
    out, k1 = {}, 0
    for kind, prompts in (("knowledge", knwl), ("response", resp)):
        seen = []

        def record(orig):
            def wrapped(model, params, tokenizer, prompts, **kw):
                texts, segs, lp, toks = orig(
                    model, params, tokenizer, prompts,
                    **dict(kw, return_output_log_probs=True))
                seen.append((model, params, tokenizer.eod,
                             tokenizer.tokenize(prompts[0]), toks[0], lp[0]))
                return texts, segs, lp, toks
            return wrapped

        guess = ZS_DIR / f"msdp_{kind}_out.txt"
        zero_counts()
        decode_log.clear()
        t0 = time.perf_counter()
        with patched(api, "generate_and_post_process", record):
            tasks_main.main(argv + [
                "--task", "MSDP-PROMPT", "--sample_input_file", str(test),
                "--sample_output_file", str(guess), "--prompt_file",
                str(prompts), "--prompt_type", kind])
        wall = time.perf_counter() - t0
        steps = sum(r["steps"] + r["warmup_steps"] for r in decode_log)
        launches = dec.decode_attention.launches
        check(len(seen) == MSDP_SAMPLES and steps > 0
              and launches == LLAMA_LAUNCH_LAYERS * steps,
              f"MSDP {kind}: K1 {launches} != {LLAMA_LAUNCH_LAYERS} x "
              f"{steps} decode steps over {len(seen)} requests")
        k1 += launches
        model, params = seen[0][:2]
        plain = LlamaModel(dataclasses.replace(
            model.cfg, compute_dtype=torch.float32, use_decode_attn=False,
            use_flash_attn=False, use_fused_rmsnorm=False))
        greedy = []
        for _, _, eod, prompt, toks, lp in seen:
            gen = list(toks[len(prompt):len(prompt) + MSDP_GEN])
            n = len(prompt) + (gen.index(eod) + 1 if eod in gen else MSDP_GEN)
            greedy.append((None, prompt, [int(t) for t in toks[:n]],
                           lp[:n - 1]))
        err, match = teacher_forced(plain, params, greedy)
        check(err <= PATH_LP_TOL, f"MSDP {kind}: the greedy streams' "
              f"log-probs {err} from the fp32 plain model's")
        # one line a sample (a completion may hold other line breaks,
        # which str.splitlines would count)
        lines = guess.read_bytes().split(b"\n")
        check(len(lines) == MSDP_SAMPLES + 1 and not lines[-1],
              f"MSDP {kind} output {lines}")
        out[kind] = dict(wall_s=wall, k1_launches=launches,
                         decode_steps=steps, prompt_tokens=[
                             len(g[1]) for g in greedy],
                         generated=[len(g[2]) - len(g[1]) for g in greedy],
                         logprob_max_abs_err_fp32=err,
                         greedy_match_fp32=match)
        del seen, greedy, model, params, plain
        free_cuda()
    p, r, f1 = tasks_main.main(["--task", "MSDP-EVAL-F1", "--guess_file",
                                str(ZS_DIR / "msdp_knowledge_out.txt"),
                                "--answer_file", str(ref)])
    add_launches(kernels, "msdp", {"decode_attention": k1})
    say("msdp", card=nvidia_smi(),
        config="Llama-2-7B widths at 4 of 32 layers via tasks.main, random "
               "weights, a seeded byte-level BPE of 32000 entries",
        init_std=init_std, samples=MSDP_SAMPLES, out_seq_length=MSDP_GEN,
        **out, eval_f1=dict(precision=p, recall=r, f1=f1), k1_launches=k1)
    # the files stay for lm_tasks_parallel, which deletes ZS_DIR
    return {"argv": argv, "test": str(test), "prompts": {
        "knowledge": str(knwl), "response": str(resp)}}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-std", type=float, default=INIT_STD,
                    help="std of the random 7B weights (default %(default)s)")
    ap.add_argument("--finetune-rank", nargs=2, metavar=("OUT", "ARGVS"),
                    help="rank mode: finetune.main for each argv of the "
                         "JSON list ARGVS, records to OUT (what the "
                         "smoke's torchrun phases start)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.finetune_rank:
        return finetune_rank(*args.finetune_rank)
    become_subreaper()
    try:
        return smoke(args)
    finally:
        # a failed phase's processes (none left after a whole run)
        stop_children()


def smoke(args) -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = nvidia_smi()
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        bytecode_cache=None if sys.dont_write_bytecode
        else sys.pycache_prefix)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernels of the sources nvcc ends first are checked while
    # paged_attention.cu compiles (about 50 s longer on the H100)
    builds = timed("build_start", start_builds)
    timed("build_wait_decode_flash", await_builds, builds,
          "decode_attention.cu", "flash_attention.cu")
    t0 = time.perf_counter()
    decode, norm = check_decode_kernel(), check_rmsnorm_kernel()
    norm_bwd = check_rmsnorm_bwd_kernel(norm)
    flash = check_flash_kernels()
    seconds["kernel_checks_decode_rmsnorm_flash"] = round(
        time.perf_counter() - t0, 1)
    flash += timed("kernel_checks_fp16", check_flash_fp16)
    kernels = [decode, norm, norm_bwd, *flash]
    timed("kernel_time_flash_tp2", time_flash_tp2, kernels)
    timed("kernel_time_decode_ring", time_decode_ring, kernels)
    timed("kernel_time_flash_cp_hops", time_flash_cp_hops, kernels)
    # K4's and K1's downstream paths, while paged_attention.cu compiles
    lm = (timed("zeroshot", zeroshot_phase, kernels, args.init_std),
          timed("msdp", msdp_phase, kernels, args.init_std))
    free_cuda()
    timed("build_wait_paged", await_builds, builds, "paged_attention.cu",
          "paged_attention_tc.cu")
    seconds["build"] = max(v for k, v in builds["seconds"].items()
                           if k.endswith("_cu_s"))
    t0 = time.perf_counter()
    paged = check_paged_kernel()
    check_paged_variants(paged[0])
    seconds["kernel_checks_paged"] = round(time.perf_counter() - t0, 1)
    # the kernels line's order: K1, K2, K7, K3, K4-K6, K4-K6 fp16
    kernels = [decode, norm, *paged, norm_bwd, *flash]
    timed("kernel_time_serving_tp2", time_serving_tp2, kernels)
    timed("kernel_time_paged_fp32", time_paged_fp32, kernels)
    torch.cuda.empty_cache()
    model = timed("model", build_model, args.init_std)
    whole_batch = timed("serving", serve_whole_batch, kernels, *model)
    bf16 = timed("serving_engine", serve_engine, kernels, *model)
    free_cuda()
    cfg, llama, params, _ = model
    timed("graph_capture", graph_capture_phase, kernels, cfg, llama, params,
          whole_batch)
    free_cuda()
    timed("serving_engine_int8", serve_engine_int8, kernels, cfg, llama,
          params, bf16)
    free_cuda()
    timed("serving_engine_window", serve_engine_window, kernels, cfg, llama,
          params)
    free_cuda()
    timed("serving_engine_spec_whole_prompt",
          serve_engine_spec_and_whole_prompt, kernels, cfg, llama, params)
    timed("packed_docs_prefill", packed_docs_prefill, kernels, cfg, llama,
          params)
    timed("serving_engine_fp32", serve_engine_fp32, kernels, args.init_std)
    converted, weights = timed("convert_llama", convert_llama, cfg, params)
    # the 13.5 GB serving model and its engines' pools go before the
    # launchers and training
    del model, llama, params
    free_cuda()
    tp1 = timed("launcher_llama", launcher_llama, kernels, converted,
                weights)
    seconds |= {f"launcher_fleet_{k}": round(v, 1) for k, v in timed(
        "launcher_fleet", launcher_fleet, kernels, tp1, weights).items()}
    del weights
    timed("serving_tp", serving_tp_phase, kernels, tp1)
    timed("launcher_falcon", launcher_falcon, kernels, args.init_std)
    say("memory_before_train",
        allocated_gb=torch.cuda.memory_allocated() / 1e9)
    train_cfg, _, trainer, state, text = timed("train", train_slice,
                                               kernels)
    train_ms = timed("throughput_train", throughput_train, trainer, state,
                     text)
    del trainer, state
    free_cuda()
    timed("train_remat", train_remat, kernels, train_cfg, text)
    data = timed("finetune", finetune_phase, kernels, train_ms)
    one = timed("finetune_modes", finetune_modes, kernels, data)
    # the encoder phases' vocabulary and corpus first: the ranks after
    # finetune_parallel's runs train the encoder entries on them
    enc = timed("encoder_data", encoder_data)
    enc_ranks, lm_ranks = timed("finetune_parallel", finetune_parallel,
                                kernels, data, one, enc, lm)
    timed("encoder_parallel", encoder_parallel, kernels, enc, enc_ranks)
    timed("lm_tasks_parallel", lm_tasks_parallel, kernels, *lm, lm_ranks)
    # the pipeline phase's two ranks run the context_parallel phase's and
    # the overlap_dropout phase's rank work last: pipeline's seconds
    # include theirs, the later phases' only their checks
    cp_ranks, overlap = timed("pipeline", pipeline_phase, kernels, data,
                              one)
    timed("context_parallel", context_parallel_phase, kernels, data, one,
          cp_ranks)
    timed("overlap_dropout", overlap_dropout_phase, kernels, data, overlap)
    shutil.rmtree(FT_DIR)
    timed("bert", bert_phase, kernels, enc)
    timed("t5", t5_phase, kernels, enc)
    ict_ck = timed("ict", ict_phase, kernels, enc)
    timed("retrieval", retrieval_phase, kernels, enc, ict_ck)
    shutil.rmtree(BERT_DIR)
    say("phase_seconds", card=smi, **seconds,
        total_s=round(time.perf_counter() - t_start, 1))
    say("processes_stopped", left_running=stop_children())
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
