"""Optimizer and learning-rate schedule (port of megatron_llm_tpu/optimizer)."""

from megatron_llm_tpu_torch.optimizer.optimizer import (  # noqa: F401
    OptimizerState,
    init_optimizer_state,
    optimizer_step,
)
from megatron_llm_tpu_torch.optimizer.scheduler import (  # noqa: F401
    OptimizerParamScheduler,
)
