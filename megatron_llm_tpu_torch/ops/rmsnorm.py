"""RMSNorm forward: the plain version and kernel K2 (port of
ops/rmsnorm.py).

Kernel K2, Triton, replaces the Pallas `_fwd_kernel` (JAX
ops/rmsnorm.py:50, launched by `_pallas_fwd` at :87). On the card eager
PyTorch issues several kernels for one RMSNorm (square, mean, rsqrt,
multiply, cast, multiply), each a pass over the activations; the reference
Megatron fuses them with apex's CUDA kernel for that reason. K2 reads
each row once and writes it once: the work is bound by those bytes
(2 * n * h elements), not by its few operations per element. Design: one
program per row, the whole row in registers (BLOCK_H, a power of two
>= h), fp32 mean of squares, rsqrt(var + eps), cast to x's dtype, then
multiply by the scale cast to x's dtype. It takes any row count: the JAX
gate that sent row counts not divisible by 8 to the plain path
(`_choose_rows`) is a TPU tiling rule and is dropped. The per-row rstd
that the Pallas forward saved feeds only the backward (training slice)
and is not written.

`triton` is imported inside the launching function: a machine without it
can import this module and run the plain version on CPU tensors.
"""

from __future__ import annotations

import torch

tl = None  # triton.language, bound by _kernel() before the first compile
_KERNEL = None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Plain version (JAX: models/norms.py rms_norm): normalise in fp32,
    cast to x's dtype, then multiply by the scale in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * scale.to(x.dtype)


def _rms_norm_fwd_kernel(x_ptr, s_ptr, o_ptr, h, eps, BLOCK_H):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < h
    x = tl.load(x_ptr + row * h + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / h
    normed = (x * tl.rsqrt(var + eps)).to(o_ptr.dtype.element_ty)
    scale = tl.load(s_ptr + cols, mask=mask, other=0.0) \
        .to(o_ptr.dtype.element_ty)
    tl.store(o_ptr + row * h + cols, normed * scale, mask=mask)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _rms_norm_fwd_kernel.__annotations__["BLOCK_H"] = tl.constexpr
        _KERNEL = triton.jit(_rms_norm_fwd_kernel)
    return _KERNEL


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape. On a CUDA tensor it
    launches kernel K2 (or raises); on a CPU tensor it runs `rms_norm`."""
    if x.device.type == "cpu":
        return rms_norm(x, scale, eps)
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rmsnorm kernel takes float x, got {x.dtype}")
    if scale.shape != (h,) or scale.device != x.device:
        raise ValueError(f"scale must be ({h},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    x2 = x.reshape(-1, h).contiguous()
    out = torch.empty_like(x2)
    n = x2.shape[0]
    if n:
        block_h = 1 << (h - 1).bit_length()
        with torch.cuda.device(x.device):
            _kernel()[(n,)](x2, scale.contiguous(), out, h, eps,
                            BLOCK_H=block_h,
                            num_warps=min(max(block_h // 256, 1), 16))
        fused_rms_norm.launches += 1
    return out.reshape(x.shape)


fused_rms_norm.launches = 0
