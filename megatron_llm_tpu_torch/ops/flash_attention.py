"""Flash attention, forward and backward: the plain versions and kernels
K4, K5 and K6 (port of ops/flash_attention.py).

Kernels K4 (forward), K5 (dq) and K6 (dk, dv), CUDA C++ for sm_90a
(`csrc/flash_attention.cu`), replace the Pallas `_fwd_kernel` (JAX
ops/flash_attention.py:262, launched by `_flash_fwd_pallas` at :352),
`_bwd_dq_kernel` (:388, launched at :566) and `_bwd_dkv_kernel` (:448,
launched at :591). They are bound by their operations and run them on the
tensor cores, all three as warp-specialised wgmma kernels fed by TMA
through an mbarrier ring (`csrc/hopper.cuh` holds the PTX); the source
note says how.

Layout, as in the JAX package: q (b, s, g, qpk, d), k/v (b, t, g, d). The
kernels take the TPU kernels' folded layout, q/o/dO as (b*g, s*qpk, d)
with the (position, head) rows head fastest and k/v as (b*g, t, d), and
the natural-log lse as (b*g, s*qpk, 1) fp32 rows: the ABI between K4 and
K5/K6 and `_lse_rows_to_bsgq`. The wrappers make those copies (one per
operand: `split_qkv` hands strided views of the fused projection) and
map the results back as views.

Plain versions: `_xla_reference` and `_xla_reference_with_lse` (JAX :81,
:96) and `_plain_bwd`, the FlashAttention-2 backward unblocked in torch
(p recomputed from the saved lse). `delta = rowsum(dO * O)` in fp32 and
the lse-cotangent fold are plain torch ops outside the kernels, as the
JAX package leaves them to XLA (:527-537).

`_Flash` and `_FlashLse` are the autograd Functions (JAX `_flash` and
`_flash_lse` custom VJPs): each saves q, k, v, o and lse. On a CUDA
tensor the forward launches K4 and the backward K5 and K6, or raises; on
a CPU tensor they run the plain versions. The forward is the dispatcher
op `megatron_llm_tpu_torch::flash_fwd` (`_flash_fwd_op`), computed under
the "attn_ctx" and "flash_lse" save points (JAX :644-647): a recompute
policy (models/remat.py) keeps its o and lse and answers the recomputed
forward from them, so under "selective" K4 runs once a layer. The TPU
gates (`_pick_blocks`, `_choose_block`: d % 128, power-of-two blocks
dividing s, MAX_ROWS / MAX_CELLS) served Mosaic's tiling and VMEM and are
dropped: the kernels take any s, t and qpk and mask ragged edges
themselves. They take bf16 or fp16 inputs (the Pallas kernels take q's
dtype), d % 8 == 0 and d <= 256; the plain versions compute in q's
dtype with the kernels' casts.

`triton` is not used here; the CUDA library is built and loaded at the
first launch, never at import.
"""

from __future__ import annotations

import ctypes
import math

import torch

from megatron_llm_tpu_torch.analysis.contracts import (
    CompileContract,
    register_contract,
)
from megatron_llm_tpu_torch.telemetry.costs import note_launch

# JAX :39-46: audited on the plain version (the kernel needs the card)
register_contract(CompileContract(
    "ops.flash_attention", collectives={"single": frozenset()},
    tmp_bytes_budget=2 << 20,
    notes="per (shape, statics); the audit runs the plain version"))

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _scores(q, k, causal: bool, neg: float) -> torch.Tensor:
    """(b, g, qpk, s, t) fp32 scores scaled by 1/sqrt(d), causal cells
    (col > row) set to `neg`."""
    d = q.shape[-1]
    sc = torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        s, t = q.shape[1], k.shape[1]
        mask = torch.arange(t, device=q.device)[None, :] \
            > torch.arange(s, device=q.device)[:, None]
        sc = sc.masked_fill(mask, neg)
    return sc


def _xla_reference(q, k, v, causal: bool) -> torch.Tensor:
    """Plain version (JAX :81): fp32 softmax, probabilities cast to v's
    dtype before the PV product."""
    sc = _scores(q, k, causal, torch.finfo(torch.float32).min)
    probs = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bgqst,btgd->bsgqd", probs, v)


def _xla_reference_with_lse(q, k, v, causal: bool):
    """Plain version with the per-row natural-log lse (JAX :96): returns
    (o (b, s, g, qpk, d), lse (b, s, g, qpk) fp32)."""
    sc = _scores(q, k, causal, NEG_INF)
    lse = torch.logsumexp(sc, dim=-1)  # (b, g, qpk, s)
    probs = torch.exp(sc - lse[..., None]).to(v.dtype)
    o = torch.einsum("bgqst,btgd->bsgqd", probs, v)
    return o, lse.permute(0, 3, 1, 2)


def _lse_rows_to_bsgq(lse_rows, b, s, g, qpk):
    """(b*g, s*qpk, 1) rows, head fastest -> (b, s, g, qpk) (JAX :661)."""
    return lse_rows.reshape(b, g, s, qpk).permute(0, 2, 1, 3)


def _lse_bsgq_to_rows(lse, b, s, g, qpk):
    return lse.permute(0, 2, 1, 3).reshape(b * g, s * qpk, 1)


def _delta_rows(o, do, dlse_rows=None) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 as (b*g, s*qpk, 1) rows, less the lse
    cotangent when lse is an output (JAX :527-537: d lse / d score = p,
    so ds = p * (dp - (delta - dlse)))."""
    b, s, g, qpk, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)  # (b, s, g, qpk)
    delta = _lse_bsgq_to_rows(delta, b, s, g, qpk)
    if dlse_rows is not None:
        delta = delta - dlse_rows
    return delta


def _plain_bwd(q, k, v, o, lse_rows, do, causal: bool, dlse_rows=None):
    """Plain FlashAttention-2 backward, unblocked: p recomputed from the
    saved lse, ds = p * (dp - delta), with the kernels' cast points (ds to
    k's dtype for dq, p to dO's dtype for dv, ds to q's dtype for dk)."""
    return _plain_bwd_rows(q, k, v, lse_rows, _delta_rows(o, do, dlse_rows),
                           do, causal)


def _plain_bwd_rows(q, k, v, lse_rows, delta_rows, do, causal: bool,
                    mask=None):
    """`_plain_bwd` given the lse and delta rows ((b*g, s*qpk, 1) fp32),
    which need not be this (q, k, v)'s own: ring attention passes every
    hop the merged rows (parallel/ring_attention.py). `mask` (b, s, t),
    True = masked, is a packed-document hop's block mask."""
    b, s, g, qpk, d = q.shape
    scale = 1.0 / math.sqrt(d)
    sc = _scores(q, k, causal, NEG_INF)
    if mask is not None:
        sc = sc.masked_fill(mask[:, None, None], NEG_INF)
    lse = lse_rows.reshape(b, g, s, qpk).permute(0, 1, 3, 2)  # (b,g,qpk,s)
    p = torch.exp(sc - lse[..., None])
    dp = torch.einsum("bsgqd,btgd->bgqst", do.float(), v.float())
    delta = delta_rows.reshape(b, g, s, qpk).permute(0, 1, 3, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgqst,btgd->bsgqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dv = torch.einsum("bgqst,bsgqd->btgd", p.to(do.dtype).float(),
                      do.float())
    dk = torch.einsum("bgqst,bsgqd->btgd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------

_FNS = {
    "fwd": ("flash_attention_fwd", 5),
    "dq": ("flash_attention_bwd_dq", 7),
    "dkv": ("flash_attention_bwd_dkv", 8),
}


def _library(which: str):
    from megatron_llm_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention.cu")
    if which == "smem":  # K4's / K6's / K5's dynamic shared memory
        fn = lib.flash_attention_smem
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        return fn
    name, n_ptr = _FNS[which]
    fn = getattr(lib, name)
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v):
    b, s, g, qpk, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take bfloat16 or float16 q/k/v, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"flash kernels need d % 8 == 0 and 8 <= d <= 256, "
                         f"d={d}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[2:] != (g, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in the (b, t, g, d) layout")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if min(s, k.shape[1]) < 1:
        raise ValueError("flash kernels need s >= 1 and t >= 1")


# the element types the kernels are instantiated for, as the C ABI's code
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _fold_q(x):
    """(b, s, g, qpk, d) -> contiguous (b*g, s*qpk, d)."""
    b, s, g, qpk, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * g, s * qpk, d).contiguous()


def _fold_kv(x):
    b, t, g, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * g, t, d).contiguous()


def _unfold_q(x, b, s, g, qpk):
    return x.reshape(b, g, s, qpk, -1).permute(0, 2, 1, 3, 4)


def _unfold_kv(x, b, g):
    return x.reshape(b, g, -1, x.shape[-1]).permute(0, 2, 1, 3)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_aligned(*xs):
    # TMA reads each row from its tensor's base address in 16-byte units
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("flash kernels need 16-byte aligned tensors")


def _rows4(x, bg, R):
    """(bg, R, 1) fp32 rows as (bg, R4) with R4 = R rounded up to a
    multiple of 4 (K5 and K6 load each group's lse and delta by TMA, whose
    boxes start on 16-byte boundaries); the same tensor when R % 4 == 0."""
    if R % 4 == 0:
        return x
    out = x.new_zeros(bg, (R + 3) // 4 * 4)
    out[:, :R] = x.reshape(bg, R)
    return out


def _raise_on(err, which):
    if err != 0:
        raise RuntimeError(f"flash attention {which} kernel launch failed: "
                           f"cudaError {err}")


def flash_fwd(qf, kf, vf, qpk: int, causal: bool):
    """Kernel K4 on the folded layout: (o (b*g, s*qpk, d), lse (b*g,
    s*qpk, 1) fp32)."""
    bg, R, d = qf.shape
    of = torch.empty_like(qf)
    lse = torch.empty(bg, R, 1, dtype=torch.float32, device=qf.device)
    _check_aligned(qf, kf, vf)
    with torch.cuda.device(qf.device):
        err = _library("fwd")(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), of.data_ptr(),
            lse.data_ptr(), bg, R, kf.shape[1], d, qpk, int(causal),
            _DTYPES[qf.dtype], 1.0 / math.sqrt(d), _stream(qf))
    _raise_on(err, "forward")
    _count(flash_fwd, qf.dtype, causal)
    _note_cost(qf, kf, causal, 2, (qf, kf, vf, of, lse))
    return of, lse


def _check_rows4(bg, R, *rows):
    if any(x.numel() != bg * ((R + 3) // 4 * 4) or not x.is_contiguous()
           for x in rows):
        raise ValueError("lse and delta must be contiguous fp32 rows padded "
                         "to a multiple of 4 values (`_rows4`)")


def flash_bwd_dq(qf, kf, vf, dof, lse, delta, qpk: int, causal: bool):
    """Kernel K5 on the folded layout: dq (b*g, s*qpk, d). lse and delta
    are `_rows4` rows."""
    bg, R, d = qf.shape
    dq = torch.empty_like(qf)
    _check_rows4(bg, R, lse, delta)
    _check_aligned(qf, kf, vf, dof, lse, delta)
    with torch.cuda.device(qf.device):
        err = _library("dq")(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bg, R,
            kf.shape[1], d, qpk, int(causal), _DTYPES[qf.dtype],
            1.0 / math.sqrt(d), _stream(qf))
    _raise_on(err, "dq")
    _count(flash_bwd_dq, qf.dtype, causal)
    _note_cost(qf, kf, causal, 3, (qf, kf, vf, dof, lse, delta, dq))
    return dq


def flash_bwd_dkv(qf, kf, vf, dof, lse, delta, qpk: int, causal: bool):
    """Kernel K6 on the folded layout: (dk, dv), each (b*g, t, d). lse and
    delta are `_rows4` rows."""
    bg, R, d = qf.shape
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    _check_rows4(bg, R, lse, delta)
    _check_aligned(qf, kf, vf, dof, lse, delta)
    with torch.cuda.device(qf.device):
        err = _library("dkv")(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bg, R, kf.shape[1], d, qpk, int(causal), _DTYPES[qf.dtype],
            1.0 / math.sqrt(d), _stream(qf))
    _raise_on(err, "dk/dv")
    _count(flash_bwd_dkv, qf.dtype, causal)
    _note_cost(qf, kf, causal, 4, (qf, kf, vf, dof, lse, delta, dk, dv))
    return dk, dv


def _note_cost(qf, kf, causal: bool, products: int, tensors) -> None:
    """The launch's own FLOPs and bytes for the cost registry (a ctypes
    launch no dispatcher mode sees): `products` (s x t x d) products a
    row block (forward: S and PV; dq: S, dP and dS K; dk/dv: S, dP, dS^T
    Q and P^T dO), 2 flops each, half of them under the causal mask;
    each tensor read or written once."""
    bg, R, d = qf.shape
    flops = 2.0 * products * bg * R * kf.shape[1] * d
    note_launch(flops * (0.5 if causal else 1.0),
                sum(x.numel() * x.element_size() for x in tensors))


def _count(wrapper, dtype, causal: bool):
    """One launch of `wrapper`'s kernel, in all, for its element type
    (`launches_by_dtype`: the bf16 and fp16 instantiations) and for its
    mask (`launches_by_causal`: "causal", or "full" for the visible
    blocks of ring attention)."""
    wrapper.launches += 1
    name = str(dtype).replace("torch.", "")
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name,
                                                                    0) + 1
    wrapper.launches_by_causal["causal" if causal else "full"] += 1


def reset_counts() -> None:
    """Every count of K4, K5 and K6 back to 0."""
    for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        w.launches = 0
        w.launches_by_dtype = {"bfloat16": 0, "float16": 0}
        w.launches_by_causal = {"causal": 0, "full": 0}


reset_counts()


def _fwd(q, k, v, causal):
    """(o, lse rows): K4 on CUDA tensors (raising on what it does not
    take), the plain version on CPU ones."""
    b, s, g, qpk, _ = q.shape
    if q.device.type == "cpu":
        o, lse = _xla_reference_with_lse(q, k, v, causal)
        return o, _lse_bsgq_to_rows(lse, b, s, g, qpk)
    _check(q, k, v)
    of, lse = flash_fwd(_fold_q(q), _fold_kv(k), _fold_kv(v), qpk, causal)
    return _unfold_q(of, b, s, g, qpk), lse


@torch.library.custom_op("megatron_llm_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """`_fwd` as a dispatcher op, so that a recompute policy can keep its
    outputs (models/remat.py)."""
    o, lse = _fwd(q, k, v, causal)
    return o.contiguous(), lse


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    raise ValueError("flash_fwd takes CUDA tensors (kernel K4) or CPU "
                     "tensors (its plain version); meta and fake tensors "
                     "have neither")


def _tagged_fwd(q, k, v, causal):
    """The forward under its save points: o is "attn_ctx", lse
    "flash_lse" (JAX :644-647, :757-771)."""
    # models/ imports this module: the save points come in at the call
    from megatron_llm_tpu_torch.models.remat import tag

    with tag("attn_ctx", "flash_lse"):
        return _flash_fwd_op(q, k, v, causal)


def _bwd(q, k, v, o, lse, do, causal, dlse_rows=None):
    """(dq, dk, dv): K5 and K6 on CUDA tensors, `_plain_bwd` on CPU ones."""
    if q.device.type == "cpu":
        return _plain_bwd(q, k, v, o, lse, do, causal, dlse_rows)
    return _bwd_rows(q, k, v, lse, _delta_rows(o, do, dlse_rows), do,
                     causal)


def _bwd_rows(q, k, v, lse, delta, do, causal):
    """K5 and K6 given the lse and delta rows ((b*g, s*qpk, 1) fp32), which
    ring attention passes merged over its hops: (dq, dk, dv). CUDA
    tensors only."""
    _check(q, k, v)
    b, s, g, qpk, _ = q.shape
    # the layout copies (timed by chip_smoke.py): q, k, v and dO folded,
    # delta in fp32 rows; lse and delta padded once for both kernels
    bg, R = b * g, s * qpk
    delta = _rows4(delta.contiguous(), bg, R)
    lse = _rows4(lse.contiguous(), bg, R)
    do = do.to(q.dtype)
    qf, kf, vf, dof = _fold_q(q), _fold_kv(k), _fold_kv(v), _fold_q(do)
    dq = flash_bwd_dq(qf, kf, vf, dof, lse, delta, qpk, causal)
    dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, delta, qpk, causal)
    return (_unfold_q(dq, b, s, g, qpk), _unfold_kv(dk, b, g),
            _unfold_kv(dv, b, g))


class _Flash(torch.autograd.Function):
    """Differentiable flash attention (JAX `_flash` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _tagged_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_bwd(q, k, v, o, lse, do, ctx.causal), None)


class _FlashLse(torch.autograd.Function):
    """Flash attention returning (o, lse (b, s, g, qpk) fp32),
    differentiable through both (JAX `_flash_lse`, :670-697): the lse
    cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, s, g, qpk, _ = q.shape
        o, lse = _tagged_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, _lse_rows_to_bsgq(lse, b, s, g, qpk)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        b, s, g, qpk, _ = q.shape
        if do is None:
            do = torch.zeros_like(o)
        dlse_rows = None if dlse is None else _lse_bsgq_to_rows(
            dlse.float(), b, s, g, qpk)
        return (*_bwd(q, k, v, o, lse, do, ctx.causal, dlse_rows), None)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """GQA flash attention, differentiable: (b, s, g, qpk, d) out."""
    return _Flash.apply(q, k, v, causal)


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """Like `flash_attention`, also returning the per-row natural-log lse
    (b, s, g, qpk) fp32, differentiable through both outputs (the
    building block ring attention merges across devices)."""
    return _FlashLse.apply(q, k, v, causal)
