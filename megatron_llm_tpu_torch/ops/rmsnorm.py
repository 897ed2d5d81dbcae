"""RMSNorm forward and backward: the plain versions and kernels K2 and K3
(port of ops/rmsnorm.py).

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
(`_choose_rows`) is a TPU tiling rule and is dropped. Training also
stores the fp32 per-row rstd the backward reads (a constexpr flag: the
serving call writes no extra bytes).

Kernel K3, Triton, replaces the Pallas `_bwd_kernel` (:59, launched by
`_pallas_bwd` at :110): dx = rstd * (u - x_hat * mean(u * x_hat)) with
u = g * scale and x_hat = x * rstd, and the dscale partial
colsum(g * x_hat cast to g's dtype) (the cast order of :74-75). It is
bound by bytes (x and g read once, dx written once). Design: one program
per block of ROWS rows, each row whole in registers; the program sums its
rows' dscale terms in registers and writes one (h,) fp32 partial to an
(n_programs, h) buffer that torch sums, as the JAX package sums its
(8, h) partial (:129). No atomics.

`_FusedRMSNorm` is the autograd Function (JAX `_fused` custom VJP): it
saves x, scale and rstd. On CUDA tensors its forward runs K2 with rstd
and its backward K3, or they raise; on CPU tensors they run the plain
forward and `_plain_bwd`, the formulas of :59-81.

`triton` is imported inside the launching functions: a machine without it
can import this module and run the plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.telemetry.costs import note_launch

tl = None  # triton.language, bound by _triton() before the first compile
_KERNELS: dict = {}
BWD_ROWS = 8  # rows per K3 program


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Plain version (JAX: models/norms.py rms_norm): normalise in fp32,
    cast to x's dtype, then multiply by the scale in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * scale.to(x.dtype)


def _plain_fwd(x2: torch.Tensor, scale: torch.Tensor, eps: float):
    """`rms_norm` on (n, h) rows, also returning the fp32 rstd (n, 1)."""
    x32 = x2.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rstd).to(x2.dtype) * scale.to(x2.dtype), rstd


def _plain_bwd(x2, scale, rstd, g2):
    """(dx (n, h) in x's dtype, dscale (h,) fp32): JAX :59-81 and :129."""
    x = x2.float()
    g = g2.float()
    x_hat = x * rstd
    u = g * scale.float()[None, :]
    corr = (u * x_hat).mean(dim=-1, keepdim=True)
    dx = (rstd * (u - x_hat * corr)).to(x2.dtype)
    ds = (g * x_hat.to(g2.dtype).float()).sum(0)
    return dx, ds


def _rms_norm_fwd_kernel(x_ptr, s_ptr, o_ptr, rstd_ptr, h, eps, BLOCK_H,
                         WRITE_RSTD):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < h
    x = tl.load(x_ptr + row * h + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / h
    rstd = tl.rsqrt(var + eps)
    normed = (x * rstd).to(o_ptr.dtype.element_ty)
    scale = tl.load(s_ptr + cols, mask=mask, other=0.0) \
        .to(o_ptr.dtype.element_ty)
    tl.store(o_ptr + row * h + cols, normed * scale, mask=mask)
    if WRITE_RSTD:
        tl.store(rstd_ptr + row, rstd)


def _rms_norm_bwd_kernel(x_ptr, s_ptr, rstd_ptr, g_ptr, dx_ptr, ds_ptr, n,
                         h, ROWS, BLOCK_H):
    pid = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_H)
    cmask = cols < h
    s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    ds = tl.zeros((BLOCK_H,), dtype=tl.float32)
    for i in range(ROWS):
        row = pid * ROWS + i
        mask = cmask & (row < n)
        x = tl.load(x_ptr + row * h + cols, mask=mask, other=0.0) \
            .to(tl.float32)
        graw = tl.load(g_ptr + row * h + cols, mask=mask, other=0.0)
        g = graw.to(tl.float32)
        rstd = tl.load(rstd_ptr + row, mask=row < n, other=0.0)
        x_hat = x * rstd
        u = g * s
        corr = tl.sum(u * x_hat, axis=0) / h
        dx = rstd * (u - x_hat * corr)
        tl.store(dx_ptr + row * h + cols, dx.to(dx_ptr.dtype.element_ty),
                 mask=mask)
        ds += g * x_hat.to(graw.dtype).to(tl.float32)
    tl.store(ds_ptr + pid * h + cols, ds, mask=cmask)


def _triton(name: str):
    global tl
    if name not in _KERNELS:
        import triton
        import triton.language

        tl = triton.language
        fn, flags = {
            "fwd": (_rms_norm_fwd_kernel, ("BLOCK_H", "WRITE_RSTD")),
            "bwd": (_rms_norm_bwd_kernel, ("ROWS", "BLOCK_H")),
        }[name]
        for flag in flags:
            fn.__annotations__[flag] = tl.constexpr
        _KERNELS[name] = triton.jit(fn)
    return _KERNELS[name]


def _check(x, scale):
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rmsnorm kernel takes float x, got {x.dtype}")
    if scale.shape != (h,) or scale.device != x.device:
        raise ValueError(f"scale must be ({h},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")


def _num_warps(h: int) -> int:
    return min(max((1 << (h - 1).bit_length()) // 256, 1), 16)


def rms_norm_fwd(x2: torch.Tensor, scale: torch.Tensor, eps: float,
                 with_rstd: bool = False):
    """Kernel K2 on (n, h) rows of a CUDA tensor: (out, rstd (n, 1) fp32
    or None)."""
    _check(x2, scale)
    n, h = x2.shape
    x2 = x2.contiguous()
    out = torch.empty_like(x2)
    rstd = torch.empty(n, 1, dtype=torch.float32, device=x2.device) \
        if with_rstd else None
    if n:
        with torch.cuda.device(x2.device):
            _triton("fwd")[(n,)](
                x2, scale.contiguous(), out, out if rstd is None else rstd,
                h, eps, BLOCK_H=1 << (h - 1).bit_length(),
                WRITE_RSTD=with_rstd, num_warps=_num_warps(h))
        fused_rms_norm.launches += 1
        # the cost registry's count: x read, out written, the scale
        # (and rstd) once; 4 flops an element
        note_launch(4.0 * n * h, (2 * n * h + h) * x2.element_size()
                    + (4 * n if with_rstd else 0))
    return out, rstd


def rms_norm_bwd(x2, scale, rstd, g2):
    """Kernel K3 on (n, h) rows of CUDA tensors: (dx, dscale (h,) fp32)."""
    _check(x2, scale)
    n, h = x2.shape
    x2, g2 = x2.contiguous(), g2.contiguous().to(x2.dtype)
    dx = torch.empty_like(x2)
    progs = -(-n // BWD_ROWS)
    part = torch.empty(max(progs, 1), h, dtype=torch.float32,
                       device=x2.device)
    if n:
        with torch.cuda.device(x2.device):
            _triton("bwd")[(progs,)](
                x2, scale.contiguous(), rstd.contiguous(), g2, dx, part, n,
                h, ROWS=BWD_ROWS, BLOCK_H=1 << (h - 1).bit_length(),
                num_warps=_num_warps(h))
        rms_norm_bwd.launches += 1
        # x and the upstream gradient read, dx written, rstd and the
        # per-block dscale partials; 6 flops an element
        note_launch(6.0 * n * h, 3 * n * h * x2.element_size()
                    + 4 * (n + progs * h))
    else:
        part.zero_()
    return dx, part.sum(0)


rms_norm_bwd.launches = 0


class _FusedRMSNorm(torch.autograd.Function):
    """Differentiable RMSNorm over the last axis (JAX `_fused` custom
    VJP): saves x, scale and rstd; dscale comes back in scale's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        h = x.shape[-1]
        x2 = x.reshape(-1, h)
        if x.device.type == "cpu":
            out, rstd = _plain_fwd(x2, scale, eps)
        else:
            out, rstd = rms_norm_fwd(x2, scale, eps, with_rstd=True)
        ctx.save_for_backward(x2, scale, rstd)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale, rstd = ctx.saved_tensors
        g2 = g.reshape(x2.shape)
        if x2.device.type == "cpu":
            dx, ds = _plain_bwd(x2, scale, rstd, g2)
        else:
            dx, ds = rms_norm_bwd(x2, scale, rstd, g2)
        return dx.reshape(g.shape), ds.to(scale.dtype), None


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape. On a CUDA tensor it
    launches kernel K2 (or raises), on a CPU tensor it runs the plain
    version. Where autograd records (training) it goes through
    `_FusedRMSNorm`, whose forward also writes rstd and whose backward
    is K3."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _FusedRMSNorm.apply(x, scale, eps)
    if x.device.type == "cpu":
        return rms_norm(x, scale, eps)
    h = x.shape[-1]
    out, _ = rms_norm_fwd(x.reshape(-1, h), scale, eps)
    return out.reshape(x.shape)


fused_rms_norm.launches = 0
