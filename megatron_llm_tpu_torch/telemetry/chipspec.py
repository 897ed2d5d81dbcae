"""The card's spec table: the one source of peak FLOP/s and HBM numbers
for the roofline math of the port's runtime (port of
telemetry/chipspec.py, with the H100's row in place of the TPU rows).

The engine's modeled backlog (`modeled_backlog_seconds`, the router's
placement and admission signal) and its dispatch-overhead gauge read
this table, as the JAX engine reads its own.

Detection reads `torch.cuda.get_device_name` of the engine's device
("NVIDIA H100 80GB HBM3"); matching is substring-based, and an explicit
`override` (launcher `--chip_spec`, engine `chip_spec=`, env
`MEGATRON_TPU_CHIPSPEC`) always wins. On a machine without a card the
override (or `default`) is the only way to get a chip at all, as on the
JAX package's CPU harness. The capacity of a detected card is the
device's own `total_memory`, not the table's nominal figure.

Peaks are the published dense per-card figures:
- H100 SXM 80GB: 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32
  (no tensor-core path runs fp32 at the bf16 rate), 3.35 TB/s HBM3.

One divergence from the JAX table: `peak_flops_for("fp32")` returns the
fp32 peak. The TPU's MXU multiplies an fp32 model's matmuls at its bf16
rate, so the JAX table maps fp32 to bf16; the H100 has no such unit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Mapping, Optional, Tuple

__all__ = [
    "ChipSpec",
    "CHIP_SPECS",
    "detect_chip",
    "train_flops_per_token",
    "decode_flops_per_token",
]


@dataclass(frozen=True)
class ChipSpec:
    """Per-card peaks.

    `source` records how this spec was chosen ("detected", "override" or
    "assumed"), so every gauge that cites it states whether the
    denominator was measured at run time or asserted by the operator.
    """

    name: str
    peak_flops: Mapping[str, float]  # dtype family -> per-card FLOP/s
    hbm_bytes_s: float  # per-card HBM bandwidth
    hbm_bytes: int  # per-card HBM capacity
    source: str = "table"

    def peak_flops_for(self, dtype: str = "bf16") -> float:
        """Peak FLOP/s for a compute dtype: int8 the int8 peak, fp32 the
        fp32 peak (the H100 divergence, module doc), else bf16's."""
        d = str(dtype).lower()
        if "int8" in d:
            return self.peak_flops.get("int8", self.peak_flops["bf16"])
        if "fp32" in d or "float32" in d:
            return self.peak_flops.get("fp32", self.peak_flops["bf16"])
        return self.peak_flops["bf16"]

    def label(self) -> str:
        return f"{self.name}:{self.source}"


CHIP_SPECS: Mapping[str, ChipSpec] = {
    "h100": ChipSpec(
        name="h100",
        peak_flops={"bf16": 989e12, "int8": 1979e12, "fp32": 67e12},
        hbm_bytes_s=3.35e12,
        hbm_bytes=80 * 2**30,
    ),
}

# device name substring -> table key, first match wins
_KIND_PATTERNS: Tuple[Tuple[str, str], ...] = (
    ("h100", "h100"),
)

_ENV_OVERRIDE = "MEGATRON_TPU_CHIPSPEC"


def _device_name(device) -> Tuple[str, Optional[int]]:
    """(lower-cased card name, total memory) of a CUDA device, or ("",
    None) without one."""
    import torch

    if not torch.cuda.is_available():
        return "", None
    dev = torch.device(device)
    if dev.type != "cuda":
        return "", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return torch.cuda.get_device_name(index).lower(), int(props.total_memory)


def detect_chip(devices=None, override: Optional[str] = None,
                default: Optional[str] = None) -> Optional[ChipSpec]:
    """Resolve the chip spec: explicit `override` (or the
    MEGATRON_TPU_CHIPSPEC env var) wins, then detection from the card's
    name, then `default` (source "assumed"), then None: no credible
    denominator, so callers drop their roofline gauges rather than
    report against a guessed peak.

    `devices`: the devices the caller computes on (an engine's device);
    None = the current CUDA device. A machine without a card falls
    through to `default`."""
    override = override or os.environ.get(_ENV_OVERRIDE) or None
    if override:
        key = str(override).lower()
        if key not in CHIP_SPECS:
            raise ValueError(
                f"unknown chip spec {override!r} "
                f"(known: {sorted(CHIP_SPECS)}) — extend the table in "
                f"telemetry/chipspec.py for a new card")
        return replace(CHIP_SPECS[key], source="override")
    kind, capacity = "", None
    try:
        if devices is None:
            devices = ["cuda"]
        if devices:
            kind, capacity = _device_name(devices[0])
    except Exception:  # noqa: BLE001: no card or CUDA runtime: fall through
        kind, capacity = "", None
    for pat, key in _KIND_PATTERNS:
        if pat in kind:
            spec = replace(CHIP_SPECS[key], source="detected")
            if capacity:
                spec = replace(spec, hbm_bytes=capacity)
            return spec
    if default is not None:
        return replace(CHIP_SPECS[str(default).lower()], source="assumed")
    return None


def train_flops_per_token(n_params: int, num_layers: int,
                          hidden_size: int, seq_length: int) -> float:
    """fwd+bwd model FLOPs per trained token: 6*N for the matmuls plus
    causal attention (12*L*h*s per token fwd+bwd with the 1/2 causal
    discount = 6*L*h*s)."""
    return 6.0 * n_params + 6.0 * num_layers * hidden_size * seq_length


def decode_flops_per_token(n_params: int, num_layers: int,
                           hidden_size: int, context: int) -> float:
    """fwd-only model FLOPs for one decoded token at cache length
    `context`: 2*N for the matvecs plus attention reading the cache
    (QK^T + PV = 4*L*h*context). The engine's per-request modeled-FLOPs
    record integrates this over the request's context growth."""
    return 2.0 * n_params + 4.0 * num_layers * hidden_size * context
