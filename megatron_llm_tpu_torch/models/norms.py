"""LayerNorm / RMSNorm with fp32 statistics (port of models/norms.py).

`rms_norm` is defined once, in ops/rmsnorm.py, as the plain version of
kernel K2; `apply_norm` routes to the kernel when `cfg.use_fused_rmsnorm`.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.ops.rmsnorm import fused_rms_norm, rms_norm

__all__ = ["rms_norm", "layer_norm", "apply_norm"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Affine LayerNorm with fp32 statistics, cast back before the affine
    (JAX: models/norms.py layer_norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(x: torch.Tensor, norm_params: dict, cfg) -> torch.Tensor:
    if cfg.use_rms_norm:
        if cfg.use_fused_rmsnorm:
            return fused_rms_norm(x, norm_params["scale"],
                                  cfg.layernorm_epsilon)
        return rms_norm(x, norm_params["scale"], cfg.layernorm_epsilon)
    return layer_norm(x, norm_params["scale"], norm_params["bias"],
                      cfg.layernorm_epsilon)
