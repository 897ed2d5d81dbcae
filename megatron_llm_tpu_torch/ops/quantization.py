"""Weight matmul of the projections (port of ops/quantization.py `qdot`).

Only the floating-point branch is ported: `x @ w` in the compute dtype.
The weight-only int8 branch belongs to the engine slice.
"""

from __future__ import annotations

import torch


def qdot(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x @ w.to(dt)
