"""Decode attention: one query token per sequence against a dense KV cache
(port of ops/decode_attention.py).

Kernel K1, CUDA C++ for sm_90a (`csrc/decode_attention.cu`), replaces the
Pallas `_decode_kernel` (JAX ops/decode_attention.py:115, launched by
`_decode_pallas` at :238) in both of its cache layouts: "gtd" (b, g, T,
d), the per-layer caches of the unrolled decode path, and "tgd" (b, T, g,
d), one layer's slice of a stacked (L, b, T, g, d) cache, read in place
through its strides. It serves 1..128 query heads per KV group (the JAX
kernel's `MAX_DECODE_ROWS`), and `length` as a Python int or as a 0-d
int32 tensor on the card, which every block reads there: the grid comes
from shapes alone, so a captured launch replays at any length. It splits
the cache across blocks and merges the splits' partial softmax states in
a fixed order, in two designs that compute the same function:
"tensor_cores" (mma.sync, bf16 at qpk >= 4) and "cuda_cores" (fp32, and
bf16 at fewer heads a group); `decode_design` picks from the dtype and
qpk alone. The source note says how each meets its bound.

`_xla_decode` is its plain version: the dense masked-softmax core of
ops/prefill_attention.py. It serves CPU tensors and every prefill chunk
(s > 1), as in the JAX package. The TPU-only gates of the JAX dispatch
(`decode_attn_min_cache`, a power-of-two block dividing T, d % 128) are
dropped: they exist for Mosaic's tiling and launch overhead, and the
answer is the same without them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from megatron_llm_tpu_torch.ops.prefill_attention import (
    _xla_attend,
    arrival_counters,
)

LOG2E = 1.4426950408889634
MAX_DECODE_ROWS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEADS_PER_BLOCK = 16  # the kernel's head chunk (csrc MAX_HEADS)
_DESIGNS = ("tensor_cores", "cuda_cores")
# the least qpk whose bf16 launches take the tensor-core design
MMA_MIN_QPK = 4
_plans: dict = {}


def _xla_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length, layout: str = "gtd") -> torch.Tensor:
    """Plain version: q (b, s, g, qpk, d) against k/v in `layout` ("gtd"
    (b, g, T, d) or "tgd" (b, T, g, d)); row r of the step attends through
    cache position length - s + r // qpk. `length` is an int or a 0-d
    tensor."""
    if layout not in ("gtd", "tgd"):
        raise ValueError(f"layout must be 'gtd' or 'tgd', got {layout!r}")
    if layout == "tgd":
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
    b, s, g, qpk, d = q.shape
    row_pos = (length - s) + torch.arange(s * qpk, device=q.device) // qpk
    return _xla_attend(q, k, v, row_pos)


def _library(name="fwd"):
    from megatron_llm_tpu_torch.ops._build import load_library

    lib = load_library("decode_attention.cu")
    if name == "plan":
        fn = lib.decode_attention_plan
        if fn.argtypes is None:
            fn.restype = None
            fn.argtypes = ([ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_int)] * 2)
        return fn
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


def decode_design(dtype, qpk: int) -> str:
    """The K1 design a launch runs, from its dtype and qpk alone:
    "tensor_cores" (mma.sync) for bf16 at qpk >= MMA_MIN_QPK, where the
    products of the group's heads outweigh the bytes; "cuda_cores" for
    fp32 (every product in fp32) and for bf16 at fewer heads a group."""
    if dtype == torch.bfloat16 and qpk >= MMA_MIN_QPK:
        return "tensor_cores"
    return "cuda_cores"


def split_plan(b, g, qpk, d, T, dtype, design=None):
    """(nsplit, S): the kernel's split of the cache dimension for this
    launch shape in `design` (`decode_design`'s by default; the rule is in
    the source note), cached per shape."""
    design = design or decode_design(dtype, qpk)
    key = (b, g, qpk, d, T, dtype, design)
    plan = _plans.get(key)
    if plan is None:
        n, s = ctypes.c_int(), ctypes.c_int()
        _library("plan")(b, g, qpk, d, T, _DTYPE_CODE[dtype],
                         int(design == "tensor_cores"),
                         ctypes.byref(n), ctypes.byref(s))
        plan = _plans[key] = (n.value, s.value)
    return plan


def _kv_strides(k, layout):
    """(T, batch, group, position strides) of a cache in `layout`."""
    if layout == "gtd":
        return k.shape[2], k.stride(0), k.stride(1), k.stride(2)
    return k.shape[1], k.stride(0), k.stride(2), k.stride(1)


def _check(q, k, v, length, layout, design):
    b, s, g, qpk, d = q.shape
    if layout not in ("gtd", "tgd"):
        raise ValueError(f"layout must be 'gtd' or 'tgd', got {layout!r}")
    if s != 1:
        raise ValueError(f"decode kernel serves single-token steps, s={s}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"decode kernel needs d % 8 == 0 and d <= 256, d={d}")
    if not 1 <= qpk <= MAX_DECODE_ROWS:
        raise ValueError(f"decode kernel serves 1..{MAX_DECODE_ROWS} query "
                         f"heads per KV group, qpk={qpk}")
    if design not in _DESIGNS or (design == "tensor_cores"
                                  and q.dtype != torch.bfloat16):
        raise ValueError(f"design must be one of {_DESIGNS} (tensor_cores "
                         f"for bfloat16 only), got {design!r} for {q.dtype}")
    if k.dim() != 4 or k.shape != v.shape or (
            k.shape[0], k.shape[1 if layout == "gtd" else 2], k.shape[3]) \
            != (b, g, d):
        raise ValueError(f"cache shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in the {layout} layout")
    T = _kv_strides(k, layout)[0]
    if isinstance(length, torch.Tensor):
        if length.dim() != 0 or length.dtype != torch.int32 \
                or length.device != q.device:
            raise ValueError("a tensor length must be a 0-d int32 tensor on "
                             "q's device")
    elif not 1 <= length <= T:
        raise ValueError(f"length {length} outside [1, {T}]")
    elt = q.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st * elt % 16 for st in x.stride()[:3]):
            raise ValueError(f"{name} cache rows must be 16-byte aligned "
                             f"with d contiguous")
    if k.stride() != v.stride():
        raise ValueError("k and v caches must share their strides")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, layout: str = "gtd", design=None) -> torch.Tensor:
    """KV-cached single-token attention, (b, 1, g, qpk, d) out in q's
    dtype, against caches in `layout` ("gtd" (b, g, T, d) or "tgd" (b, T,
    g, d), possibly a strided view). `length` (valid cache positions) is
    an int or a 0-d int32 tensor. On a CUDA tensor it launches kernel K1
    (or raises on a shape it does not take) in the design `decode_design`
    picks; `design` names one instead, to time the two side by side. On a
    CPU tensor it runs the plain `_xla_decode`. Each launch counts in
    `launches` and in `launches_by_layout[layout]`."""
    if q.device.type == "cpu":
        return _xla_decode(q, k, v, length if isinstance(length, torch.Tensor)
                           else int(length), layout)
    if not isinstance(length, torch.Tensor):
        length = int(length)
    b, _, g, qpk, d = q.shape
    design = design or decode_design(q.dtype, qpk)
    _check(q, k, v, length, layout, design)
    T, sb, sg, st = _kv_strides(k, layout)
    q = q.contiguous()  # q and out are read and written per element
    out = torch.empty_like(q)
    nsplit, _ = split_plan(b, g, qpk, d, T, q.dtype, design)
    ws = counters = None
    if nsplit > 1:
        ws = torch.empty(b * g * qpk * nsplit * (2 + d), dtype=torch.float32,
                         device=q.device)
        counters = arrival_counters(
            q.device, b * g * -(-qpk // _HEADS_PER_BLOCK))
    tensor_len = isinstance(length, torch.Tensor)
    with torch.cuda.device(q.device):
        err = _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            length.data_ptr() if tensor_len else None,
            0 if tensor_len else length, b, g, qpk, d, T, sb, sg, st,
            (1.0 / math.sqrt(d)) * LOG2E, _DTYPE_CODE[q.dtype],
            int(design == "tensor_cores"),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    decode_attention.launches_by_layout[layout] += 1
    return out


decode_attention.launches = 0
# the launches of each cache layout: "gtd" on the unrolled decode path,
# "tgd" on the pipeline's serving ring (stacked-cache slices)
decode_attention.launches_by_layout = {"gtd": 0, "tgd": 0}
