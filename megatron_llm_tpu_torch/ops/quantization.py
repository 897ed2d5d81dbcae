"""Int8 quantization for serving (port of ops/quantization.py).

Two schemes share one rounding and scale convention:

- **Int8 KV pages** (`quantize_rows` over the head dim): the engine's
  page pools store K/V as int8 with one fp32 scale per (token, group) in
  parallel scale pools (num_pages, page_size, g). Rows are quantized at
  write time by the one scatter (ops/prefill_attention.scatter_chunk_kv
  and the engine's whole-prompt prefill, both through
  `scatter_quantized_rows`); kernel K7 dequantizes in registers and its
  plain version dequantizes the gathered view.
- **Weight-only int8 decode matmuls** (`quantize_weight` per output
  channel, `qdot` at the call site): `GPTModel.prepare_decode_params(
  quantize_int8=True)` swaps each layer's wqkv, wo, w1 and w2 for
  {"int8_data", "scale"}. Activations stay in the compute dtype.

The convention, bitwise the JAX package's jitted steps: scale = amax /
127 in fp32, computed as amax * fp32(1 / 127) as XLA compiles it, no
zero point; data = clip(round_half_even(x * inv), -127, 127) with the
guarded reciprocal inv = where(scale > 0, 1 / max(scale, 1e-30), 0)
(a multiply, never a divide). An all-zero row gets scale 0 and data 0,
and dequantizes to exact zeros.

The int8 `qdot` is plain torch, as XLA computed it outside any Pallas
kernel: the int8 weight is converted to the compute dtype for one
matmul per call, then the per-channel scale is applied to the output in
fp32. It therefore reads the int8 bytes but materialises a weight in
the compute dtype each call; a fused int8 GEMV is later work.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 over `axis`: returns (int8 data, fp32 scales with
    `axis` removed). All-zero rows get scale 0 and data 0."""
    xf = x.float()
    # amax / 127 as the JAX package computes it: inside its jitted steps
    # XLA turns the division by a constant into a product with the
    # constant's fp32 reciprocal (an eager JAX call divides, and differs
    # by one ulp in a few rows); a Python float operand is taken in fp32
    scale = xf.abs().amax(dim=axis) * (1.0 / INT8_MAX)
    inv = torch.where(scale > 0.0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    data = torch.clamp(torch.round(xf * inv.unsqueeze(axis)), -INT8_MAX,
                       INT8_MAX).to(torch.int8)
    return data, scale


def dequantize_rows(data: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_rows`: data * scale broadcast over `axis`."""
    return (data.float() * scale.unsqueeze(axis)).to(dtype)


def scatter_quantized_rows(data_pool, scale_pool, pages, offs, x):
    """The quantize-at-write point of int8 pools: each (..., g, d) row of
    `x` is quantized over the head dim, and its int8 data and fp32 scale
    land at the same [pages, offs] of the paired pools, in place."""
    data, scale = quantize_rows(x)
    data_pool.index_put_((pages, offs), data)
    scale_pool.index_put_((pages, offs), scale)
    return data_pool, scale_pool


def quantize_weight(w: torch.Tensor) -> dict:
    """Per-output-channel int8 of a (in_dim, out_dim) matmul weight:
    scales over axis 0, so x @ w ~= (x @ int8) * scale."""
    if w.dim() != 2:
        raise ValueError(f"weight-only quantization takes the 2D decode "
                         f"layout (prepare_decode_params flattens GLU "
                         f"first), got {tuple(w.shape)}")
    data, scale = quantize_rows(w, axis=0)
    return {"int8_data": data, "scale": scale}


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and "int8_data" in w


def qdot(x: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """`x @ w` for a floating weight, or for a weight-only int8 dict: the
    int8 operand converted to `dt`, the product scaled per output column
    in fp32 and cast back to `dt`."""
    if is_quantized_weight(w):
        y = x @ w["int8_data"].to(dt)
        return (y.float() * w["scale"]).to(dt)
    return x @ w.to(dt)


QUANTIZED = (("attention", "wqkv"), ("attention", "wo"), ("mlp", "w1"),
             ("mlp", "w2"))


def quantize_decode_layers(layers):
    """Weight-only int8 of the decode layer tuple (the
    `prepare_decode_params` layout: per-layer trees, GLU w1 flattened):
    wqkv, wo, w1 and w2 are quantized; biases, norms, embeddings and the
    head stay floating."""
    out = []
    for layer in layers:
        layer = dict(layer)
        for block, name in QUANTIZED:
            layer[block] = dict(layer[block])
            layer[block][name] = quantize_weight(layer[block][name])
        out.append(layer)
    return tuple(out)
