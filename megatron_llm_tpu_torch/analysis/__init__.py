"""Static analysis of the port (port of analysis/): the compile-contract
registry every mint site records into (analysis/contracts.py), an `ast`
linter of the port's capture and sync discipline (analysis/lint.py),
the audit that runs each contract's reference target on the CPU and
checks what it issued against the declaration (analysis/audit.py), and
the gradient-overlap gauges (analysis/overlap.py).
`megatron_llm_tpu_torch/tools/graft_check.py` is the gate over them.

Importing this package imports neither torch nor JAX: the registry is
bookkeeping and the linter pure `ast`; the audit imports torch when it
runs.
"""

from megatron_llm_tpu_torch.analysis.contracts import (  # noqa: F401
    CompileContract,
    ContractViolation,
    compile_contract,
    get_contract,
    record_variant,
    release_variant,
    register_contract,
    total_live_variants,
    variant_count,
    variants,
)
