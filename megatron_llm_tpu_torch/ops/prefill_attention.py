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

Two parameterizations of the same function:
- int8 pools (`k_scales`/`v_scales`, one fp32 scale per (page, row,
  group) in (num_pages, page_size, g) scale pools): the scatter
  quantizes at write (ops/quantization.py) and attention dequantizes;
- lower bounds: `window_size` W limits token t to positions
  [starts + t - W + 1, starts + t], and `doc_starts` (nc,) floors each
  chunk at its packed document's first position (the caller keeps
  doc_starts[c] <= starts[c]). Row r's first attendable position is
  row_lo = max(pos - W + 1, doc_starts[c], 0). W <= 0 means no window.

Kernel K7, CUDA C++ for sm_90a, replaces the Pallas `_paged_kernel` (JAX
ops/prefill_attention.py:135, launched by `_paged_pallas` at :369), fp
and int8 pools, window and doc floors, in two designs that compute the
same function:
- "tc" (`csrc/paged_attention_tc.cu`): tiles of 64 folded rows on the
  tensor cores, pages brought by TMA; bf16 q with bf16 or int8 pools
  whose page size is a multiple of 8, any qpk, decode and mixed rounds
  (int8 rows converted to bf16 panels in shared memory, scales applied
  around the products);
- "present" (`csrc/paged_attention.cu`): CUDA cores, at most 16 folded
  rows a block; fp32 pools, and bf16 or int8 pools of other page sizes.
`paged_design` picks one from dtypes and shapes alone (never because a
launch failed); each source note says what bounds its design on the H100.
`_xla_paged_reference` is their plain version (gather the pages into the
dense view, then the `_xla_attend` core); it serves CPU tensors, and
CUDA tensors when the model's `use_decode_attn` switch is off.

Output dtype with int8 pools: q's, in the kernel and in the plain
version, as the Pallas kernel casts (`_paged_pallas` :382-383). The JAX
XLA twin returns fp32 there (its probabilities take the dequantized v's
dtype), so a bf16 model's JAX int8 fallback feeds `wo` in fp32; in fp32
(the CPU parity tests) the two agree.

Dropped TPU gate: the JAX dispatch `ragged_paged_block` (:100-127) sent a
launch to the XLA twin unless d % 128 == 0, the page tiled the (16 or 32)
sublanes, the slot's reach met `min_cache`, and a power-of-two q block
divided the chunk width. Those rules exist for Mosaic's tiling and the
TPU's launch overhead. K7 takes any page size, any chunk width >= 1 and
d % 8 == 0 up to 256 (d % 16 == 0 for int8 pools, for its 16-byte
copies of int8 rows), so every CUDA launch with the switch on runs it.
qpk > 16 needs the "tc" design (bf16 q, bf16 or int8 pools, page size a
multiple of 8); the present design raises there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from megatron_llm_tpu_torch.ops.quantization import scatter_quantized_rows

LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tc design's split of long walks: at least 8 key tiles of 64
# positions a split, at most 16 splits
TC_TILES_PER_SPLIT, TC_MAX_SPLITS = 8, 16
_counters: dict = {}
_retired_counters: list = []


def arrival_counters(device, n: int) -> torch.Tensor:
    """Zeroed unsigned counters for a kernel whose last block to arrive
    merges its splits (K1, K7's tc design), one buffer for each stream of
    `device`: each launch that completes leaves the ones it used zero, and
    two streams never share one. A buffer too small for `n` is replaced by
    a larger one, and the old one is kept alive, never freed: a CUDA graph
    that captured a launch keeps its address and replays against it. One
    first made inside a capture is zeroed by that graph's replay."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired_counters.append(buf)
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


def tc_split(max_pages: int, page_size: int, rows: int, int8: bool):
    """(nsplit, tiles a split) of the tc design, from dtypes and shapes
    alone: a walk spans at most ceil(max_pages * page_size / 64) + 1 key
    tiles of a `max_pages`-entry page table, cut into splits of
    TC_TILES_PER_SPLIT tiles (more when that would exceed TC_MAX_SPLITS).
    Only where it pays (measured on the H100): launches whose (chunk,
    group) has at most 64 folded `rows` (decode rounds: one row tile,
    whose longest walk sets the time), and int8 pools, whose tiles cost
    more; a wider bf16 launch's row tiles fill the card already, and its
    split blocks that find nothing to do cost more than they save."""
    if rows > 64 and not int8:
        return 1, 1 << 30
    tiles = -(-max_pages * page_size // 64) + 1
    tps = max(TC_TILES_PER_SPLIT, -(-tiles // TC_MAX_SPLITS))
    return -(-tiles // tps), tps


def _xla_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                row_pos: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None,
                row_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, s, g, qpk, d) against dense k/v (b, g, T, d). `row_pos` is
    the last attendable cache position of each folded (position, head)
    row, head fastest: (rows,) when shared by the batch (dense decode),
    (b, rows) when ragged per sequence (the paged version). `row_valid`
    (b, rows), optional: rows where False are exact zeros. `row_lo` (b,
    rows), optional: the first attendable position of each row (the
    window and document floors). Scores in fp32, masked with the fp32
    minimum (not -inf), probabilities normalised then cast to v's dtype
    before the PV product. Returns (b, s, g, qpk, d) in v's dtype."""
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
    if row_lo is not None:
        mask = mask | (cols[None, None, :] < row_lo[:, :, None])[:, None]
    scores = scores.masked_fill(mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)  # (b, g, rows, d)
    if row_valid is not None:
        out = out.masked_fill(~row_valid[:, None, :, None], 0)
    return out.reshape(b, g, s, qpk, d).permute(0, 2, 1, 3, 4)


def _row_floors(starts, C, qpk, window, doc_starts):
    """(nc, rows) first attendable position of each folded row, or None
    when neither lower bound is set."""
    if window is None and doc_starts is None:
        return None
    tok = torch.arange(C * qpk, device=starts.device) // qpk
    row_lo = torch.zeros(starts.shape[0], C * qpk, dtype=torch.long,
                         device=starts.device)
    if window is not None:
        row_lo = torch.maximum(row_lo, starts.long()[:, None] + tok[None, :]
                               - (window - 1))
    if doc_starts is not None:
        row_lo = torch.maximum(row_lo, doc_starts.long()[:, None])
    return row_lo


def _xla_paged_reference(q, k_pages, v_pages, page_table, starts,
                         chunk_lens, k_scales=None, v_scales=None,
                         window=None, doc_starts=None):
    """Plain version of K7: gather each chunk's pages into the dense
    view (dequantized to fp32 for int8 pools), then the `_xla_attend`
    core with ragged per-chunk row positions and floors; pad rows (token
    >= chunk_lens) are exact zeros; the output is in q's dtype. Columns
    no row of a chunk may attend, at or past `starts + chunk_lens` or
    below the chunk's lowest floor (other slots' pages, reclaimed
    entries parked on the null page), are zeroed after the gather: they
    carry probability 0 anyway, and zeroing them keeps a non-finite
    value there from reaching the output through 0 * NaN."""
    nc, C, g, qpk, d = q.shape
    page_size = k_pages.shape[1]
    T = page_table.shape[1] * page_size
    pt = page_table.long()
    k = k_pages[pt]
    v = v_pages[pt]
    if k_scales is not None:
        k = k.float() * k_scales[pt][..., None]
        v = v.float() * v_scales[pt][..., None]
    k = k.reshape(nc, T, g, d).transpose(1, 2)
    v = v.reshape(nc, T, g, d).transpose(1, 2)
    row_lo = _row_floors(starts, C, qpk, window, doc_starts)
    cols = torch.arange(T, device=q.device)[None, :]
    dead = cols >= (starts + chunk_lens)[:, None]
    if row_lo is not None:
        dead = dead | (cols < row_lo[:, :1])  # row 0 has the lowest floor
    dead = dead[:, None, :, None]
    k = k.masked_fill(dead, 0)
    v = v.masked_fill(dead, 0)
    tok = torch.arange(C * qpk, device=q.device) // qpk  # (rows,)
    row_pos = starts.long()[:, None] + tok[None, :]
    row_valid = tok[None, :] < chunk_lens[:, None]
    return _xla_attend(q, k, v, row_pos, row_valid, row_lo).to(q.dtype)


def scatter_chunk_kv(k_new, v_new, k_pages, v_pages, page_table, starts,
                     chunk_lens, k_scales=None, v_scales=None):
    """Write a chunk's K/V rows into its slot's pages, IN PLACE: token t
    (valid when t < chunk_lens) lands in pool page page_table[c, (starts
    + t) // page_size] at offset (starts + t) % page_size. Pad rows are
    routed to page 0, the dead null page every table parks unowned
    entries on, so they can never touch a live slot's cache; several pad
    rows may hit one place, and the winner is unspecified, which no
    valid row can observe. Int8 pools (with their scale pools) quantize
    each (token, group) row over the head dim here and return (k_pages,
    v_pages, k_scales, v_scales); fp pools return (k_pages, v_pages).
    The JAX package returned updated pools (its step functions donate
    them); here the preallocated pools are the only copy and are
    returned as they are."""
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
    if k_pages.dtype == torch.int8:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 KV pools need k_scales and v_scales")
        scatter_quantized_rows(k_pages, k_scales, pages, offs, k_new)
        scatter_quantized_rows(v_pages, v_scales, pages, offs, v_new)
        return k_pages, v_pages, k_scales, v_scales
    k_pages.index_put_((pages, offs), k_new.to(k_pages.dtype))
    v_pages.index_put_((pages, offs), v_new.to(v_pages.dtype))
    return k_pages, v_pages


def paged_design(q_dtype, kv_dtype, page_size: int) -> str:
    """The K7 design a launch runs, from dtypes and shapes alone: "tc" for
    bf16 q with bf16 or int8 pools whose page size is a multiple of 8 (its
    bf16 TMA segments fill whole 8-row swizzle atoms; int8 pools keep the
    same rule), at any qpk and chunk width; "present" for fp32 pools and
    other page sizes."""
    if (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and page_size % 8 == 0):
        return "tc"
    return "present"


def _library(design="present"):
    from megatron_llm_tpu_torch.ops._build import load_library

    if design == "tc":
        lib = load_library("paged_attention_tc.cu")
        fn = lib.ragged_paged_attention_tc_fwd
        if fn.argtypes is None:  # pointers must not pass as 32-bit ints
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
        return fn
    if design == "smem":  # the "tc" kernel's dynamic shared memory
        fn = load_library("paged_attention_tc.cu").paged_attention_tc_smem
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        return fn
    lib = load_library("paged_attention.cu")
    fn = lib.ragged_paged_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _check(q, k_pages, v_pages, page_table, starts, chunk_lens, k_scales,
           v_scales, doc_starts, design):
    """Raise on what `design`'s kernel does not take (shapes and dtypes
    only: it reads no tensor)."""
    nc, C, g, qpk, d = q.shape
    int8 = k_pages.dtype == torch.int8
    kv_ok = v_pages.dtype == k_pages.dtype and (int8
                                                or k_pages.dtype == q.dtype)
    if q.dtype not in _DTYPE_CODE or not kv_ok:
        raise ValueError(f"paged kernel takes float32 or bfloat16 q and "
                         f"pools of q's dtype or int8, got {q.dtype}/"
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"paged kernel needs d % 8 == 0 and d <= 256, "
                         f"d={d}")
    if int8 and d % 16:
        raise ValueError(f"paged kernel copies int8 rows 16 bytes at a "
                         f"time: int8 pools need d % 16 == 0, d={d}")
    if qpk < 1 or (design == "present" and qpk > 16):
        raise ValueError(f"paged kernel serves 1..16 query heads per KV "
                         f"group with {k_pages.dtype} pools of page "
                         f"{k_pages.shape[1]} (any qpk with bf16 q and "
                         f"bf16 or int8 pools of a page that is a multiple "
                         f"of 8), "
                         f"qpk={qpk}")
    if design == "tc" and paged_design(q.dtype, k_pages.dtype,
                                       k_pages.shape[1]) != "tc":
        raise ValueError(f"the tc design takes bf16 q with bf16 or int8 "
                         f"pools and a page size that is a multiple of 8, "
                         f"got {q.dtype}/"
                         f"{k_pages.dtype}, page {k_pages.shape[1]}")
    if C < 1:
        raise ValueError(f"chunk width must be >= 1, C={C}")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[2:] != (g, d):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} as (P, page_size, g, d)")
    if int8:
        for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if x is None or x.dtype != torch.float32 \
                    or x.shape != k_pages.shape[:3] or not x.is_contiguous():
                raise ValueError(f"int8 pools need a contiguous float32 "
                                 f"{name} of shape "
                                 f"{tuple(k_pages.shape[:3])}")
    if page_table.dim() != 2 or page_table.shape[0] != nc \
            or starts.shape != (nc,) or chunk_lens.shape != (nc,) \
            or (doc_starts is not None and doc_starts.shape != (nc,)):
        raise ValueError("page_table must be (nc, max_pages) and starts / "
                         "chunk_lens / doc_starts (nc,)")
    for name, x in (("page_table", page_table), ("starts", starts),
                    ("chunk_lens", chunk_lens), ("doc_starts", doc_starts)):
        if x is not None and (x.dtype != torch.int32
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    devs = {x.device for x in (q, k_pages, v_pages, page_table, starts,
                               chunk_lens, k_scales, v_scales, doc_starts)
            if x is not None}
    if len(devs) != 1:
        raise ValueError("all operands must be on one device")


def _check_doc_starts(doc_starts, starts):
    """doc_starts[c] <= starts[c]: every valid row keeps its own diagonal
    column. One host read, paid only by callers that pack documents (the
    engine passes no doc_starts); not made while a CUDA graph is being
    captured, where the card cannot be read and the values are the
    replays' to set."""
    if doc_starts is None or (doc_starts.is_cuda
                              and torch.cuda.is_current_stream_capturing()):
        return
    if bool((doc_starts > starts).any()):
        raise ValueError("doc_starts must not exceed starts: a chunk's "
                         "document floor lies at or before its first "
                         "position")


def _ptr(x):
    return None if x is None else x.data_ptr()


def paged_attention(q, k_pages, v_pages, page_table, starts, chunk_lens,
                    k_scales=None, v_scales=None, window=None,
                    doc_starts=None, design=None):
    """Attention half of the entry point, on pools that already hold the
    chunk's own K/V. On a CUDA tensor it launches kernel K7 in the design
    `paged_design` picks (or raises on what it does not take); `design`
    names one instead, to hold the two side by side on the same inputs.
    On a CPU tensor it runs the plain `_xla_paged_reference`. The grid
    comes from host shapes only; the pages each chunk needs are worked
    out on the card from `starts`, `chunk_lens` and the floors, so
    nothing here waits for the card (apart from the doc_starts check,
    when doc_starts is given). Each launch adds one to
    `ragged_paged_attention.launches` and to its variants in
    `ragged_paged_attention.variant_launches` ("fp" or "int8", "window"
    and "doc" when those bounds are on, and its design, "tc" or
    "present")."""
    _check_doc_starts(doc_starts, starts)
    if q.device.type == "cpu":
        return _xla_paged_reference(q, k_pages, v_pages, page_table, starts,
                                    chunk_lens, k_scales, v_scales, window,
                                    doc_starts)
    nc, C, g, qpk, d = q.shape
    page_size = k_pages.shape[1]
    if design is None:
        design = paged_design(q.dtype, k_pages.dtype, page_size)
    _check(q, k_pages, v_pages, page_table, starts, chunk_lens, k_scales,
           v_scales, doc_starts, design)
    int8 = k_pages.dtype == torch.int8
    q = q.contiguous()
    if design == "tc" and q.data_ptr() % 16:
        raise ValueError("the tc design reads q 16 bytes at a time: q must "
                         "be 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_log2 = (1.0 / math.sqrt(d)) * LOG2E
    with torch.cuda.device(q.device):
        if design == "tc":
            nsplit, tps = tc_split(page_table.shape[1], page_size, C * qpk,
                                   int8)
            ws = counters = None
            if nsplit > 1:
                ws = torch.empty(nc * g * C * qpk * nsplit * (2 + d),
                                 dtype=torch.float32, device=q.device)
                counters = arrival_counters(q.device,
                                            nc * g * -(-C * qpk // 64))
            err = _library("tc")(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                _ptr(k_scales), _ptr(v_scales),
                out.data_ptr(), page_table.data_ptr(), starts.data_ptr(),
                chunk_lens.data_ptr(), _ptr(doc_starts), _ptr(ws),
                _ptr(counters), nc, C, g, qpk, d,
                k_pages.shape[0], page_size, page_table.shape[1],
                window or 0, scale_log2, nsplit, tps, stream)
        else:
            err = _library()(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                _ptr(k_scales), _ptr(v_scales), out.data_ptr(),
                page_table.data_ptr(), starts.data_ptr(),
                chunk_lens.data_ptr(), _ptr(doc_starts),
                nc, C, g, qpk, d, page_size, page_table.shape[1],
                window or 0, scale_log2, _DTYPE_CODE[q.dtype], int(int8),
                stream)
    if err != 0:
        raise RuntimeError(f"ragged paged attention kernel ({design}) "
                           f"launch failed: cudaError {err}")
    counts = ragged_paged_attention.variant_launches
    ragged_paged_attention.launches += 1
    counts[design] += 1
    counts["int8" if int8 else "fp"] += 1
    if window:
        counts["window"] += 1
    if doc_starts is not None:
        counts["doc"] += 1
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # (nc, C, g, qpk, d): C = padded chunk width
    k_new: torch.Tensor,  # (nc, C, g, d): this chunk's K (RoPE applied)
    v_new: torch.Tensor,  # (nc, C, g, d)
    k_pages: torch.Tensor,  # (num_pages, page_size, g, d); int8 OK
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (nc, max_pages) int32 pool indices
    starts: torch.Tensor,  # (nc,) int32: chunk start in the slot
    chunk_lens: torch.Tensor,  # (nc,) int32 valid tokens (<= C; 0 = idle)
    use_kernel: bool = True,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, page_size, g)
    v_scales: Optional[torch.Tensor] = None,  # fp32; int8 pools only
    window_size: Optional[int] = None,  # None or <= 0: full causal
    doc_starts: Optional[torch.Tensor] = None,  # (nc,) int32 doc floors
):
    """The paged attention entry point, one pass for every phase:
    scatter the chunk's own K/V into its slot's pages (in place,
    quantized for int8 pools), then attention of chunk token t (position
    starts + t) over cache positions max(starts + t - W + 1,
    doc_starts, 0) .. starts + t. Returns (out (nc, C, g, qpk, d),
    k_pages, v_pages), and k_scales, v_scales after them for int8 pools;
    pad rows are exact zeros. W >= starts + chunk_lens is bitwise no
    window. `use_kernel` (the model's `use_decode_attn`) picks K7 on a
    CUDA tensor; off, or on a CPU tensor, the plain version runs."""
    if window_size is not None and window_size <= 0:
        window_size = None
    res = scatter_chunk_kv(k_new, v_new, k_pages, v_pages, page_table,
                           starts, chunk_lens, k_scales, v_scales)
    if use_kernel:
        out = paged_attention(q, k_pages, v_pages, page_table, starts,
                              chunk_lens, k_scales, v_scales, window_size,
                              doc_starts)
    else:
        _check_doc_starts(doc_starts, starts)
        out = _xla_paged_reference(q, k_pages, v_pages, page_table, starts,
                                   chunk_lens, k_scales, v_scales,
                                   window_size, doc_starts)
    return (out, *res)


ragged_paged_attention.launches = 0
ragged_paged_attention.variant_launches = {"fp": 0, "int8": 0, "window": 0,
                                           "doc": 0, "tc": 0, "present": 0}
