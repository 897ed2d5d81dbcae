"""Model, parallel and training configuration (port of
megatron_llm_tpu/config.py).

Only the fields the ported paths read are carried over (serving, the
continuous-batching engine, and single-card training through `Trainer`);
the presets keep the JAX package's values. Dtypes are torch dtypes.

`use_flash_attn` routes the no-cache forward through the flash kernels
(ops/flash_attention.py), as `llama_config` sets it. Not carried over:
`decode_attn_min_cache` (it gated the Pallas decode kernel off below a
cache length because of TPU launch overhead) and `decode_attn_interpret`
(it ran that kernel under the Pallas interpreter). Here the decode kernel
runs on every CUDA single-token step and its plain version serves CPU
tensors. Dropout rates are carried with the JAX defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# Activation-recompute policy names (JAX config.py:39), each defined in
# models/remat.py.
REMAT_POLICIES = ("full", "selective", "save_dots", "offload", "none")

# the reference's --recompute_granularity surface
_GRANULARITY_TO_POLICY = {None: "none", "selective": "selective",
                          "full": "full"}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (JAX: config.py ModelConfig)."""

    num_layers: int = 2
    hidden_size: int = 128
    ffn_hidden_size: Optional[int] = None
    num_attention_heads: int = 4
    num_attention_heads_kv: Optional[int] = None
    kv_channels: Optional[int] = None
    max_position_embeddings: int = 2048
    seq_length: int = 2048
    padded_vocab_size: int = 0
    make_vocab_size_divisible_by: int = 128

    layernorm_epsilon: float = 1e-5
    use_rms_norm: bool = False
    # post-LN (BERT-style) layers instead of the default pre-LN (JAX :71;
    # models/transformer.py)
    use_post_ln: bool = False
    use_bias: bool = True
    glu_activation: Optional[str] = None
    hidden_act: str = "gelu"

    position_embedding_type: str = "absolute"
    rope_scaling_factor: float = 1.0
    rope_theta: float = 10000.0

    # Falcon-style structure (JAX config.py:84-85): attention and MLP read
    # the same normed input and their outputs join the residual once;
    # parallel_layernorm gives the MLP a norm of its own (Falcon-40B)
    parallel_attn: bool = False
    parallel_layernorm: bool = False

    tie_embed_logits: bool = True

    # Regularization (JAX defaults). With `lima_dropout` layer i's hidden
    # dropout is hidden_dropout * i / (num_layers - 1) (JAX :93).
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    lima_dropout: bool = False

    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    init_method_std: float = 0.02
    use_scaled_init_method: bool = True

    # Hand-written RMSNorm forward (ops/rmsnorm.py). Off by default, as in
    # the JAX package.
    use_fused_rmsnorm: bool = False
    # Hand-written attention kernels on CUDA tensors: decode attention
    # (ops/decode_attention.py) on every single-token step of the dense
    # KV cache, ragged paged attention (ops/prefill_attention.py) on every
    # paged forward of the engine. Off, the plain versions run.
    use_decode_attn: bool = True
    # Flash attention forward/backward (ops/flash_attention.py, K4-K6) on
    # the no-cache forward with a causal mask and no attention dropout.
    use_flash_attn: bool = False
    # Sliding-window attention on the paged serving path (JAX
    # config.py:133-139): a token at position p attends [max(0, p - W +
    # 1), p]; None is full causal, and W >= context is bitwise full
    # causal. The engine reclaims pages wholly out of every live window.
    # The no-cache and dense-cache paths ignore it, as in JAX.
    attention_window_size: Optional[int] = None

    # Recompute (JAX config.py:110-119): give remat_policy or the
    # reference's recompute_granularity; they must agree.
    recompute_granularity: Optional[str] = None  # None | selective | full
    remat_policy: Optional[str] = None  # None | one of REMAT_POLICIES
    recompute_method: str = "uniform"  # uniform | block
    recompute_num_layers: int = 1

    # the encoder family (JAX :141-144): segment (tokentype) embeddings
    # and BERT's binary (sentence-order) head
    num_tokentypes: int = 0
    add_binary_head: bool = False

    def __post_init__(self):
        if self.kv_channels is None:
            object.__setattr__(
                self, "kv_channels", self.hidden_size // self.num_attention_heads)
        if self.num_attention_heads_kv is None:
            object.__setattr__(self, "num_attention_heads_kv",
                               self.num_attention_heads)
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        assert self.num_attention_heads % self.num_attention_heads_kv == 0
        if self.attention_window_size is not None \
                and self.attention_window_size < 1:
            raise ValueError(
                "attention_window_size must be >= 1 (or None for full "
                f"causal attention), got {self.attention_window_size}")
        # the JAX package's construction-time checks (config.py:161-210)
        if self.recompute_granularity not in _GRANULARITY_TO_POLICY:
            raise ValueError(
                f"recompute_granularity={self.recompute_granularity!r}: "
                f"expected 'selective', 'full' or None")
        if self.remat_policy is not None \
                and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}: expected "
                             f"one of {REMAT_POLICIES} or None")
        if self.recompute_method not in ("uniform", "block"):
            raise ValueError(f"recompute_method={self.recompute_method!r}: "
                             f"expected 'uniform' or 'block'")
        if (self.remat_policy is not None
                and self.recompute_granularity is not None
                and _GRANULARITY_TO_POLICY[self.recompute_granularity]
                != self.remat_policy):
            raise ValueError(
                f"conflicting recompute flags: recompute_granularity="
                f"{self.recompute_granularity!r} but remat_policy="
                f"{self.remat_policy!r}")
        if self.recompute_method == "block" \
                and self.resolved_remat_policy == "none":
            raise ValueError("recompute_method='block' does nothing without "
                             "an active remat policy")
        if self.recompute_num_layers != 1 \
                and self.recompute_method != "block":
            raise ValueError(f"recompute_num_layers="
                             f"{self.recompute_num_layers} is only read by "
                             f"recompute_method='block'")

    @property
    def resolved_remat_policy(self) -> str:
        """The active policy name: `remat_policy` when given, else the
        mapping of `recompute_granularity`."""
        if self.remat_policy is not None:
            return self.remat_policy
        return _GRANULARITY_TO_POLICY[self.recompute_granularity]

    @property
    def head_dim(self) -> int:
        return self.kv_channels

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads_kv

    @property
    def q_per_kv(self) -> int:
        return self.num_attention_heads // self.num_attention_heads_kv

    @property
    def qkv_projection_size(self) -> int:
        return self.kv_channels * (
            self.num_attention_heads + 2 * self.num_attention_heads_kv)

    def pad_vocab_size(self, vocab_size: int, tp: int = 1) -> int:
        multiple = self.make_vocab_size_divisible_by * tp
        return ((vocab_size + multiple - 1) // multiple) * multiple


_LLAMA_SIZES = {
    # size -> (layers, hidden, heads, n_kv, ffn)
    7: (32, 4096, 32, 32, 11008),
    13: (40, 5120, 40, 40, 13824),
    30: (60, 6656, 52, 52, 17920),
    34: (48, 8192, 64, 8, 22016),
    65: (80, 8192, 64, 64, 22016),
    70: (80, 8192, 64, 8, 28672),
}


def llama_config(size_b: int = 7, version: int = 2, seq_length: int = 4096,
                 vocab_size: int = 32000, tp: int = 1,
                 **overrides) -> ModelConfig:
    """Llama-1/2/CodeLlama preset (JAX: config.py llama_config)."""
    layers, hidden, heads, n_kv, ffn = _LLAMA_SIZES[size_b]
    if version == 1:
        seq_length = min(seq_length, 2048)
    cfg = dict(
        num_layers=layers,
        hidden_size=hidden,
        num_attention_heads=heads,
        num_attention_heads_kv=n_kv,
        ffn_hidden_size=ffn,
        seq_length=seq_length,
        max_position_embeddings=seq_length,
        position_embedding_type="rotary",
        glu_activation="swiglu",
        use_rms_norm=True,
        use_bias=False,
        tie_embed_logits=False,
        layernorm_epsilon=1e-6 if version == 1 else 1e-5,
        hidden_dropout=0.0,
        attention_dropout=0.0,
        init_method_std=0.02,
        # trains through the flash kernels, as the JAX package does (:681)
        use_flash_attn=True,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


_FALCON_SIZES = {
    # size -> (layers, hidden, heads, n_kv, parallel_layernorm)
    7: (32, 4544, 71, 1, False),
    40: (60, 8192, 128, 8, True),
}


def codellama_config(size_b: int = 7, seq_length: int = 16384,
                     **overrides) -> ModelConfig:
    """CodeLlama: Llama-2 with rope_theta 1e6, 16k positions and a 32016
    vocabulary (JAX: config.py codellama_config)."""
    overrides.setdefault("rope_theta", 1e6)
    return llama_config(size_b, version=2, seq_length=seq_length,
                        vocab_size=overrides.pop("vocab_size", 32016),
                        **overrides)


def falcon_config(size_b: int = 7, seq_length: int = 2048,
                  vocab_size: int = 65024, tp: int = 1,
                  **overrides) -> ModelConfig:
    """Falcon preset (JAX: config.py falcon_config): rotary, MQA/GQA,
    parallel attention, LayerNorm, gelu, no linear biases, tied
    embeddings; 40B adds the parallel layernorm."""
    layers, hidden, heads, n_kv, pln = _FALCON_SIZES[size_b]
    cfg = dict(
        num_layers=layers,
        hidden_size=hidden,
        num_attention_heads=heads,
        num_attention_heads_kv=n_kv,
        ffn_hidden_size=4 * hidden,
        seq_length=seq_length,
        max_position_embeddings=seq_length,
        position_embedding_type="rotary",
        glu_activation=None,
        hidden_act="gelu",
        use_rms_norm=False,
        use_bias=False,
        parallel_attn=True,
        parallel_layernorm=pln,
        tie_embed_logits=True,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


def gpt_config(num_layers: int = 12, hidden_size: int = 768,
               num_attention_heads: int = 12, seq_length: int = 1024,
               vocab_size: int = 50257, tp: int = 1,
               **overrides) -> ModelConfig:
    """GPT-2/3-style preset (JAX: config.py gpt_config): learned
    positions, gelu, biases, LayerNorm, tied head."""
    cfg = dict(
        num_layers=num_layers,
        hidden_size=hidden_size,
        num_attention_heads=num_attention_heads,
        seq_length=seq_length,
        max_position_embeddings=seq_length,
        position_embedding_type="absolute",
        hidden_act="gelu",
        tie_embed_logits=True,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


def bert_config(num_layers: int = 12, hidden_size: int = 768,
                num_attention_heads: int = 12, seq_length: int = 512,
                vocab_size: int = 30522, tp: int = 1,
                **overrides) -> ModelConfig:
    """BERT preset (JAX: config.py bert_config): learned positions, two
    tokentypes, gelu, biases, LayerNorm, the binary (SOP) head, the LM
    head tied to the word embeddings."""
    cfg = dict(
        num_layers=num_layers,
        hidden_size=hidden_size,
        num_attention_heads=num_attention_heads,
        seq_length=seq_length,
        max_position_embeddings=seq_length,
        position_embedding_type="absolute",
        hidden_act="gelu",
        use_rms_norm=False,
        use_bias=True,
        tie_embed_logits=True,
        num_tokentypes=2,
        add_binary_head=True,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


def t5_config(num_layers: int = 12, hidden_size: int = 768,
              num_attention_heads: int = 12, seq_length: int = 512,
              decoder_seq_length: int = 128, vocab_size: int = 30522,
              tp: int = 1, **overrides) -> ModelConfig:
    """T5 preset (JAX: config.py t5_config): learned positions on both
    sides (as many as the longer of the encoder's `seq_length` and the
    decoder's length), gelu, biases, LayerNorm, the logits tied to the
    shared word embeddings. `num_layers` is each side's depth."""
    cfg = dict(
        num_layers=num_layers,
        hidden_size=hidden_size,
        num_attention_heads=num_attention_heads,
        seq_length=seq_length,
        max_position_embeddings=max(seq_length, decoder_seq_length),
        position_embedding_type="absolute",
        hidden_act="gelu",
        use_rms_norm=False,
        use_bias=True,
        tie_embed_logits=True,
    )
    cfg.update(overrides)
    mc = ModelConfig(**cfg)
    if mc.padded_vocab_size == 0:
        mc = dataclasses.replace(
            mc, padded_vocab_size=mc.pad_vocab_size(vocab_size, tp))
    return mc


def tiny_config(**overrides) -> ModelConfig:
    """Small config for tests (JAX: config.py tiny_config)."""
    cfg = dict(
        num_layers=2,
        hidden_size=64,
        num_attention_heads=4,
        num_attention_heads_kv=2,
        ffn_hidden_size=128,
        seq_length=64,
        max_position_embeddings=64,
        padded_vocab_size=256,
        position_embedding_type="rotary",
        glu_activation="swiglu",
        use_rms_norm=True,
        use_bias=False,
        tie_embed_logits=False,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    cfg.update(overrides)
    return ModelConfig(**cfg)


@dataclass(frozen=True)
class ParallelConfig:
    """Device layout (JAX: config.py ParallelConfig): data, tensor,
    pipeline and context parallelism with sequence parallelism and the
    ZeRO-1 optimizer and the overlap schedulers, with the JAX package's
    validations (:346-451).
    `num_microbatches` is each rank's gradient-accumulation count, at
    pp > 1 the microbatches the GPipe schedule streams through the
    stages (parallel/pipeline.py)."""

    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    tensor_parallel_size: int = 1
    context_parallel_size: int = 1
    # Korthikanti sequence parallelism over the tp group; forced off at
    # tp = 1 as the reference does
    sequence_parallel: bool = False
    # ZeRO-1 over the dp group (optimizer/zero1.py); at dp = 1 it is the
    # replicated optimizer
    use_distributed_optimizer: bool = False
    # MB of fp32 gradient per reduce-scatter bucket
    grad_rs_bucket_mb: float = 4.0
    # int8 gradient reduction with per-chunk fp32 scales (pure dp only)
    quantized_grad_reduce: bool = False
    overlap_grad_reduce: bool = False
    overlap_param_gather: bool = False
    async_pipeline_dispatch: bool = False
    num_microbatches: int = 1
    # what a pipeline tick keeps for the backward (JAX :328-352), the
    # recompute policies' names plus the aliases "tick" (= "full": only
    # the tick's input boundary) and "dots" (= "save_dots")
    pipeline_remat: str = "tick"

    def __post_init__(self):
        if self.tensor_parallel_size == 1 and self.sequence_parallel:
            object.__setattr__(self, "sequence_parallel", False)
        if self.pipeline_remat not in REMAT_POLICIES + ("tick", "dots"):
            raise ValueError(
                f"pipeline_remat={self.pipeline_remat!r}: expected one of "
                f"{REMAT_POLICIES + ('tick', 'dots')}")
        if min(self.mesh_shape) < 1:
            raise ValueError(f"dp={self.data_parallel_size} "
                             f"pp={self.pipeline_parallel_size} "
                             f"cp={self.context_parallel_size} "
                             f"tp={self.tensor_parallel_size}")
        if self.grad_rs_bucket_mb <= 0:
            raise ValueError(
                f"grad_rs_bucket_mb={self.grad_rs_bucket_mb}: the "
                f"reduce-scatter bucket size target must be positive")
        if self.quantized_grad_reduce:
            if not self.use_distributed_optimizer:
                raise ValueError(
                    "quantized_grad_reduce requires "
                    "use_distributed_optimizer: the int8 reduction is the "
                    "wire format of the ZeRO-1 reduce-scatter")
            if max(self.tensor_parallel_size, self.pipeline_parallel_size,
                   self.context_parallel_size) > 1:
                raise ValueError(
                    "quantized_grad_reduce is only available on pure-dp "
                    "layouts (tp=pp=cp=1), as in the JAX package")
            if self.data_parallel_size <= 1:
                raise ValueError(
                    "quantized_grad_reduce with data_parallel_size=1: "
                    "there is no dp gradient reduction to quantize")
        for flag in ("overlap_grad_reduce", "overlap_param_gather"):
            if not getattr(self, flag):
                continue
            # the JAX gates (JAX :397-427): the overlap schedules reorder
            # ZeRO-1's reduce-scatter and all-gather on a pure-dp layout
            if not self.use_distributed_optimizer:
                raise ValueError(
                    f"{flag} requires use_distributed_optimizer: the "
                    f"overlap scheduling reorders the ZeRO-1 "
                    f"reduce-scatter/all-gather (optimizer/zero1.py); "
                    f"without it there is nothing to schedule")
            if max(self.tensor_parallel_size, self.pipeline_parallel_size,
                   self.context_parallel_size) > 1:
                raise ValueError(
                    f"{flag} is only available on pure-dp layouts "
                    f"(tp=pp=cp=1), as in the JAX package")
            if self.data_parallel_size <= 1:
                raise ValueError(
                    f"{flag} with data_parallel_size=1: there is no dp "
                    f"collective to overlap")
        if self.async_pipeline_dispatch and self.pipeline_parallel_size <= 1:
            raise ValueError(
                "async_pipeline_dispatch requires pipeline_parallel_size "
                "> 1: it reschedules the stage ring's transfers "
                "(parallel/pipeline.py); there is no ring at pp=1")
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches={self.num_microbatches}")

    @property
    def resolved_pipeline_remat(self) -> str:
        """pipeline_remat with the aliases resolved to REMAT_POLICIES
        (tick -> full, dots -> save_dots; JAX :429-435)."""
        return {"tick": "full", "dots": "save_dots"}.get(
            self.pipeline_remat, self.pipeline_remat)

    @property
    def world_size(self) -> int:
        return (self.data_parallel_size * self.pipeline_parallel_size
                * self.tensor_parallel_size * self.context_parallel_size)

    @property
    def mesh_shape(self) -> tuple:
        """(dp, pp, cp, tp), parallel/mesh.py `build_mesh`'s order."""
        return (self.data_parallel_size, self.pipeline_parallel_size,
                self.context_parallel_size, self.tensor_parallel_size)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and run control (JAX: config.py TrainConfig),
    limited to the fields the ported `Trainer` reads. The fields of later
    slices are kept so that setting one raises in `Trainer` with the
    slice's name instead of being ignored."""

    micro_batch_size: int = 1
    global_batch_size: int = 1
    rampup_batch_size: Optional[tuple] = None  # (start, increment, samples)

    train_iters: Optional[int] = None
    train_samples: Optional[int] = None
    exit_interval: Optional[int] = None
    exit_duration_in_mins: Optional[float] = None
    exit_signal_handler: bool = False
    # sentinel-file termination hook (parallel/multihost.AutoResume)
    autoresume_file: Optional[str] = None
    autoresume_interval: int = 50

    optimizer: str = "adam"  # adam | sgd
    lr: float = 1e-4
    min_lr: float = 0.0
    lr_decay_style: str = "linear"  # constant|linear|cosine|inverse-square-root
    lr_decay_iters: Optional[int] = None
    lr_decay_samples: Optional[int] = None
    lr_warmup_iters: int = 0
    lr_warmup_samples: int = 0
    lr_warmup_fraction: Optional[float] = None
    use_checkpoint_opt_param_scheduler: bool = False
    override_opt_param_scheduler: bool = False

    weight_decay: float = 0.01
    start_weight_decay: Optional[float] = None
    end_weight_decay: Optional[float] = None
    weight_decay_incr_style: str = "constant"  # constant|linear|cosine
    clip_grad: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9

    # Mixed precision: fp32 params and state; bf16 compute, or fp16
    # compute (ModelConfig.compute_dtype) with a loss scaler: constant at
    # `loss_scale` when it is set, else dynamic (optimizer/grad_scaler.py)
    fp16: bool = False
    bf16: bool = True
    loss_scale: Optional[float] = None
    initial_loss_scale: float = 2.0 ** 32
    min_loss_scale: float = 1.0
    loss_scale_window: int = 1000
    hysteresis: int = 2

    # Checkpointing (training/checkpointing.py): `load` resumes from the
    # newest complete checkpoint there; `finetune` takes its weights only
    # and starts at iteration 0; interval saves are async unless
    # `async_save` is off; `keep_latest_n` complete checkpoints are kept
    # (None: all).
    save: Optional[str] = None
    load: Optional[str] = None
    save_interval: Optional[int] = None
    finetune: bool = False
    no_save_optim: bool = False
    no_load_optim: bool = False
    no_load_rng: bool = False
    async_save: bool = True
    keep_latest_n: Optional[int] = None

    # Loss watchdog (training/watchdog.py): a non-finite loss or one above
    # median + ksigma * sigma of the window skips its step on the card;
    # `spike_rollback_patience` bad steps in a row reload the last
    # complete checkpoint (0: skip only).
    loss_watchdog_ksigma: float = 0.0
    loss_watchdog_window: int = 64
    spike_rollback_patience: int = 0

    log_interval: int = 100
    eval_interval: int = 1000
    eval_iters: int = 100
    timing_log_level: int = 0
    timing_log_option: str = "minmax"
    log_params_norm: bool = False
    log_num_zeros_in_grad: bool = False

    # The trainer's telemetry (training/trainer.py): tensorboard event
    # files (training/tensorboard.py) on their own cadence, WandB
    # (training/wandb_logger.py), a torch.profiler window over steps
    # [profile_step_start, profile_step_end), the span tracer under
    # trace_dir, the always-on flight recorder (dumps into
    # flight_record_dir, default `save`), the device-cost registry, the
    # chip spec of the MFU and roofline gauges, and the step-latency perf
    # sentinel (armed by perf_sentinel_ksigma > 0).
    tensorboard_dir: Optional[str] = None
    tensorboard_log_interval: int = 1
    tensorboard_queue_size: int = 1000
    log_timers_to_tensorboard: bool = False
    log_validation_ppl_to_tensorboard: bool = False
    log_memory_to_tensorboard: bool = False
    log_world_size_to_tensorboard: bool = False
    wandb_logger: bool = False
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    wandb_id: Optional[str] = None
    wandb_resume: bool = False
    wandb_api_key: Optional[str] = None
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    profile_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    flight_record_dir: Optional[str] = None
    flight_recorder_size: int = 4096
    device_cost_registry: bool = False
    chip_spec: Optional[str] = None
    perf_sentinel_ksigma: float = 0.0
    perf_sentinel_window: int = 64
    perf_sentinel_patience: int = 8

    seed: int = 1234

    def __post_init__(self):
        assert not (self.fp16 and self.bf16)
        if self.train_iters is not None and self.train_samples is not None:
            raise ValueError("specify train_iters or train_samples, not both")
        if self.train_samples is not None:
            if self.lr_decay_iters is not None or self.lr_warmup_iters:
                raise ValueError(
                    "sample-based run (train_samples): use lr_decay_samples"
                    "/lr_warmup_samples, not the *_iters variants")
        elif self.lr_decay_samples is not None or self.lr_warmup_samples:
            raise ValueError("lr_decay_samples/lr_warmup_samples require "
                             "train_samples")
