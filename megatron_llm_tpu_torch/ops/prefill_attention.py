"""Ragged paged attention: the continuous-batching engine's one attention
(port of ops/prefill_attention.py).

A launch serves a batch of ragged query CHUNKS over per-layer page pools
(num_pages, page_size, g, d): chunk c is `chunk_lens[c]` tokens of one
slot at positions `starts[c] + t`, causal over everything the slot has
cached through its row of the page table, including the chunk itself. A
decode row is the width-1 chunk at the slot's length, an idle slot is
`chunk_lens == 0`, and rows past a chunk's length (pad rows) are exact
zeros. `ragged_paged_attention` first scatters the chunk's own K/V into
its slot's pages (`scatter_chunk_kv`; pad rows land on the dead null
page 0), then attends.

Kernel K7, CUDA C++ for sm_90a (`csrc/paged_attention.cu`), replaces the
Pallas `_paged_kernel` (JAX ops/prefill_attention.py:135, launched by
`_paged_pallas` at :369) for fp pools. The source note says what bounds
it on the H100 and what its simple design leaves on the table.
`_xla_paged_reference` is its plain version (gather the pages into the
dense view, then the `_xla_attend` core); it serves CPU tensors, and
CUDA tensors when the model's `use_decode_attn` switch is off.

Dropped TPU gate: the JAX dispatch `ragged_paged_block` (:100-127) sent a
launch to the XLA twin unless d % 128 == 0, the page tiled the (16 or 32)
sublanes, the slot's reach met `min_cache`, and a power-of-two q block
divided the chunk width. Those rules exist for Mosaic's tiling and the
TPU's launch overhead. K7 takes any page size, any chunk width >= 1 and
d % 8 == 0 up to 256, so every CUDA launch with the switch on runs it.

Parameters of the JAX entry point that raise NotImplementedError here:
`k_scales`/`v_scales` (int8 pools and their dequantizing epilogue) and
`window_size`/`doc_starts` (the sliding-window and packed-document
clamps). They belong to the quantized-serving and windowed-serving
slices of the engine, which are not ported yet; a silent fp or
full-causal answer would be wrong.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LATER = ("{} is not ported yet: it belongs to the {} slice of the "
          "engine (ROADMAP.md A2)")


def _xla_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                row_pos: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, s, g, qpk, d) against dense k/v (b, g, T, d). `row_pos` is
    the last attendable cache position of each folded (position, head)
    row, head fastest: (rows,) when shared by the batch (dense decode),
    (b, rows) when ragged per sequence (the paged version). `row_valid`
    (b, rows), optional: rows where False are exact zeros. Scores in
    fp32, masked with the fp32 minimum (not -inf), probabilities
    normalised then cast to v's dtype before the PV product. Returns
    (b, s, g, qpk, d) in v's dtype."""
    b, s, g, qpk, d = q.shape
    T = k.shape[2]
    qb = q.permute(0, 2, 1, 3, 4).reshape(b, g, s * qpk, d)
    scores = torch.matmul(qb.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))  # (b, g, rows, T)
    cols = torch.arange(T, device=q.device)
    if row_pos.dim() == 1:
        mask = cols[None, :] > row_pos[:, None]
    else:
        mask = (cols[None, None, :] > row_pos[:, :, None])[:, None]
    scores = scores.masked_fill(mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)  # (b, g, rows, d)
    if row_valid is not None:
        out = out.masked_fill(~row_valid[:, None, :, None], 0)
    return out.reshape(b, g, s, qpk, d).permute(0, 2, 1, 3, 4)


def _xla_paged_reference(q, k_pages, v_pages, page_table, starts,
                         chunk_lens):
    """Plain version of K7: gather each chunk's pages into the dense
    view, then the `_xla_attend` core with ragged per-chunk row
    positions; pad rows (token >= chunk_lens) are exact zeros. Columns
    at or past `starts + chunk_lens` (other slots' pages and the null
    page, through the table's unowned entries) are zeroed after the
    gather: they carry probability 0 anyway, and zeroing them keeps a
    non-finite value there from reaching the output through 0 * NaN."""
    nc, C, g, qpk, d = q.shape
    page_size = k_pages.shape[1]
    T = page_table.shape[1] * page_size
    pt = page_table.long()
    k = k_pages[pt].reshape(nc, T, g, d).transpose(1, 2)
    v = v_pages[pt].reshape(nc, T, g, d).transpose(1, 2)
    dead = (torch.arange(T, device=q.device)[None, :]
            >= (starts + chunk_lens)[:, None])[:, None, :, None]
    k = k.masked_fill(dead, 0)
    v = v.masked_fill(dead, 0)
    tok = torch.arange(C * qpk, device=q.device) // qpk  # (rows,)
    row_pos = starts.long()[:, None] + tok[None, :]
    row_valid = tok[None, :] < chunk_lens[:, None]
    return _xla_attend(q, k, v, row_pos, row_valid)


def scatter_chunk_kv(k_new, v_new, k_pages, v_pages, page_table, starts,
                     chunk_lens):
    """Write a chunk's K/V rows into its slot's pages, IN PLACE: token t
    (valid when t < chunk_lens) lands in pool page page_table[c, (starts
    + t) // page_size] at offset (starts + t) % page_size. Pad rows are
    routed to page 0, the dead null page every table parks unowned
    entries on, so they can never touch a live slot's cache; several pad
    rows may hit one place, and the winner is unspecified, which no
    valid row can observe. The JAX package returned updated pools (its
    step functions donate them); here the preallocated pools are the
    only copy and are returned as they are."""
    nc, C = k_new.shape[:2]
    page_size = k_pages.shape[1]
    max_pages = page_table.shape[1]
    t = torch.arange(C, device=k_new.device)
    pos = starts.long()[:, None] + t[None, :]  # (nc, C)
    valid = t[None, :] < chunk_lens[:, None]
    logical = (pos // page_size).clamp(0, max_pages - 1)
    pages = torch.where(valid, torch.gather(page_table.long(), 1, logical),
                        torch.zeros_like(logical))
    offs = pos % page_size
    k_pages.index_put_((pages, offs), k_new.to(k_pages.dtype))
    v_pages.index_put_((pages, offs), v_new.to(v_pages.dtype))
    return k_pages, v_pages


def _library():
    from megatron_llm_tpu_torch.ops._build import load_library

    lib = load_library("paged_attention.cu")
    fn = lib.ragged_paged_attention_fwd
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(q, k_pages, v_pages, page_table, starts, chunk_lens):
    nc, C, g, qpk, d = q.shape
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged kernel takes float32 or bfloat16 q and "
                         f"pools of q's dtype, got {q.dtype}/"
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"paged kernel needs d % 8 == 0 and d <= 256, "
                         f"d={d}")
    if not 1 <= qpk <= 16:
        raise ValueError(f"paged kernel serves 1..16 query heads per KV "
                         f"group, qpk={qpk}")
    if C < 1:
        raise ValueError(f"chunk width must be >= 1, C={C}")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[2:] != (g, d):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} as (P, page_size, g, d)")
    if page_table.dim() != 2 or page_table.shape[0] != nc \
            or starts.shape != (nc,) or chunk_lens.shape != (nc,):
        raise ValueError("page_table must be (nc, max_pages) and starts / "
                         "chunk_lens (nc,)")
    for name, x in (("page_table", page_table), ("starts", starts),
                    ("chunk_lens", chunk_lens)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    devs = {x.device for x in (q, k_pages, v_pages, page_table, starts,
                               chunk_lens)}
    if len(devs) != 1:
        raise ValueError("all operands must be on one device")


def paged_attention(q, k_pages, v_pages, page_table, starts, chunk_lens):
    """Attention half of the entry point, on pools that already hold the
    chunk's own K/V. On a CUDA tensor it launches kernel K7 (or raises
    on what it does not take); on a CPU tensor it runs the plain
    `_xla_paged_reference`. The grid comes from host shapes only; the
    pages each chunk needs are worked out on the card from `starts` and
    `chunk_lens`, so nothing here waits for the card."""
    if q.device.type == "cpu":
        return _xla_paged_reference(q, k_pages, v_pages, page_table,
                                    starts, chunk_lens)
    _check(q, k_pages, v_pages, page_table, starts, chunk_lens)
    nc, C, g, qpk, d = q.shape
    q = q.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _library()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), page_table.data_ptr(), starts.data_ptr(),
            chunk_lens.data_ptr(),
            nc, C, g, qpk, d, k_pages.shape[1], page_table.shape[1],
            (1.0 / math.sqrt(d)) * LOG2E, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged paged attention kernel launch failed: "
                           f"cudaError {err}")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # (nc, C, g, qpk, d): C = padded chunk width
    k_new: torch.Tensor,  # (nc, C, g, d): this chunk's K (RoPE applied)
    v_new: torch.Tensor,  # (nc, C, g, d)
    k_pages: torch.Tensor,  # (num_pages, page_size, g, d)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (nc, max_pages) int32 pool indices
    starts: torch.Tensor,  # (nc,) int32: chunk start in the slot
    chunk_lens: torch.Tensor,  # (nc,) int32 valid tokens (<= C; 0 = idle)
    use_kernel: bool = True,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    window_size: Optional[int] = None,
    doc_starts: Optional[torch.Tensor] = None,
):
    """The paged attention entry point, one pass for every phase:
    scatter the chunk's own K/V into its slot's pages (in place), then
    causal attention of chunk token t (position starts + t) over cache
    positions 0..starts+t. Returns (out (nc, C, g, qpk, d), k_pages,
    v_pages); pad rows are exact zeros. `use_kernel` (the model's
    `use_decode_attn`) picks K7 on a CUDA tensor; off, or on a CPU
    tensor, the plain version runs."""
    if k_scales is not None or v_scales is not None \
            or k_pages.dtype == torch.int8:
        raise NotImplementedError(_LATER.format(
            "int8 KV pools (k_scales/v_scales)", "quantized-serving"))
    if window_size is not None and window_size > 0:
        raise NotImplementedError(_LATER.format(
            "window_size", "sliding-window serving"))
    if doc_starts is not None:
        raise NotImplementedError(_LATER.format(
            "doc_starts", "sliding-window serving"))
    scatter_chunk_kv(k_new, v_new, k_pages, v_pages, page_table, starts,
                     chunk_lens)
    if use_kernel:
        out = paged_attention(q, k_pages, v_pages, page_table, starts,
                              chunk_lens)
    else:
        out = _xla_paged_reference(q, k_pages, v_pages, page_table, starts,
                                   chunk_lens)
    return out, k_pages, v_pages


ragged_paged_attention.launches = 0
