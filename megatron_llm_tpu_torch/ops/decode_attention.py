"""Decode attention: one query token per sequence against a dense KV cache
(port of ops/decode_attention.py).

Kernel K1, CUDA C++ for sm_90a (`csrc/decode_attention.cu`), replaces the
Pallas `_decode_kernel` (JAX ops/decode_attention.py:115, launched by
`_decode_pallas` at :238) on the per-layer "gtd" caches of the unrolled
decode path. It is bound by the bytes of K/V it must stream; the source
note says how its design meets that.

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

from megatron_llm_tpu_torch.ops.prefill_attention import _xla_attend

LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _xla_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: int) -> torch.Tensor:
    """Plain version: q (b, s, g, qpk, d) against k/v (b, g, T, d) (the
    "gtd" layout); row r of the step attends through cache position
    length - s + r // qpk."""
    b, s, g, qpk, d = q.shape
    row_pos = (length - s) + torch.arange(s * qpk, device=q.device) // qpk
    return _xla_attend(q, k, v, row_pos)


def _library():
    from megatron_llm_tpu_torch.ops._build import load_library

    lib = load_library("decode_attention.cu")
    fn = lib.decode_attention_gtd
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(q, k, v, length):
    b, s, g, qpk, d = q.shape
    if s != 1:
        raise ValueError(f"decode kernel serves single-token steps, s={s}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"decode kernel needs d % 8 == 0 and d <= 256, d={d}")
    if not 1 <= qpk <= 16:
        raise ValueError(f"decode kernel serves 1..16 query heads per KV "
                         f"group, qpk={qpk}")
    if k.shape != v.shape or k.shape[:2] != (b, g) or k.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in the gtd layout")
    if not 1 <= length <= k.shape[2]:
        raise ValueError(f"length {length} outside [1, {k.shape[2]}]")
    for name, t in (("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} cache must be contiguous and 16-byte "
                             f"aligned")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """KV-cached single-token attention against "gtd" caches,
    (b, 1, g, qpk, d) out in q's dtype. On a CUDA tensor it launches
    kernel K1 (or raises on a shape it does not take); on a CPU tensor it
    runs the plain `_xla_decode`."""
    length = int(length)
    if q.device.type == "cpu":
        return _xla_decode(q, k, v, length)
    _check(q, k, v, length)
    b, _, g, qpk, d = q.shape
    q = q.contiguous()  # q and out are read and written per element
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, g, qpk, d, k.shape[2], length,
            (1.0 / math.sqrt(d)) * LOG2E, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
