"""Ring attention: context parallelism over the sequence axis (port of
parallel/ring_attention.py).

The sequence is cut over the cp group (parallel/mesh.py) in contiguous
shards: cp rank c holds positions [c s, (c + 1) s) of a sequence of
cp s, its q (b, s, g, qpk, d) and its k/v (b, s, g, d) (GQA folded, K/V
never expanded). Attention, the one op that mixes positions, runs as an
exact ring, the JAX package's schedule written out:

- the resident block first: this rank's own K/V, causal on the diagonal
  (kernel K4 at `causal=True`, or full when the attention is not
  causal);
- then cp - 1 hops: each rotates the K/V block to the next cp rank
  (`mesh.ring_shift`, staged through pinned host buffers under gloo), so
  after t hops a rank holds the block of rank (c - t) mod cp. A block
  whose owner comes after this rank is above the diagonal and skipped
  before any compute; a visible block runs K4 at `causal=False`;
- hops merge by logsumexp in fp32: running max m, denominator l and
  accumulator o (JAX :105-124, :155-165).

Every cp rank sends and receives on every hop, the skipped ones
included, as the JAX scan's `ppermute` does: no participation depends on
data, so the ring cannot deadlock.

Torch has no autograd across processes, so the ring is one
`torch.autograd.Function`. Its forward saves q, k, v, the merged output
and the merged lse rows, nothing per hop. Its backward computes
delta = rowsum(dO * O) once in fp32 and runs the same hops again, each
calling K5 and K6 with the merged lse and delta: p = exp(s - lse) with
the global lse is exactly the hop's share of the softmax, so the hop's
dq, dk and dv are its exact share of the gradient and no lse cotangent
is needed (the gradient of the JAX package's checkpointed scan, which
reaches the same value through the dlse fold of its per-hop
`flash_attention_with_lse`). dq sums locally in fp32; dk and dv travel
around the ring with their K/V block, summed in fp32, and one more
rotation brings them to their owner.

Recompute. Each hop's forward is the dispatcher op
`megatron_llm_tpu_torch::flash_fwd` under the "attn_ctx" and
"flash_lse" save points, as the single-card flash path's is: under
"selective", "save_dots" and "offload" (models/remat.py) the recompute
of a layer answers the hops' K4 from the store and launches none, under
"full" it runs them again. The recompute reruns the ring's rotations
either way: every cp rank recomputes the same layers in the same order,
so the rings pair up.

Packed documents (`doc_start`, the O(s) form of --reset_attention_mask,
utils/masks.py `get_document_starts`, global indices): a hop builds its
block mask from the hop's global key offsets (allowed iff doc_start[i]
<= j <= i) and runs the plain masked hop, the twin of the JAX package's
`_masked_hop_with_lse` (an XLA einsum there, not a Pallas kernel), with
a plain backward from the merged lse; above-diagonal hops stay skipped.

On CPU tensors each hop runs the plain versions of K4-K6
(ops/flash_attention.py `_xla_reference_with_lse`, `_plain_bwd_rows`)
in the same loop; on a CUDA tensor a hop that the kernels refuse
raises, nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_llm_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _bwd_rows,
    _delta_rows,
    _lse_bsgq_to_rows,
    _lse_rows_to_bsgq,
    _plain_bwd_rows,
    _tagged_fwd,
)
from megatron_llm_tpu_torch.parallel.mesh import get_context, ring_shift


def _masked_hop_with_lse(q, k, v, mask):
    """One hop with an explicit (b, s, t) mask, True = masked (JAX :49):
    (o (b, s, g, qpk, d), lse (b, s, g, qpk) fp32). A row masked
    throughout has lse ~ NEG_INF and o = 0, so it weighs 0 in the
    merge."""
    d = q.shape[-1]
    sc = torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    sc = sc.masked_fill(mask[:, None, None], NEG_INF)
    lse = torch.logsumexp(sc, dim=-1)  # (b, g, qpk, s)
    probs = torch.exp(sc - lse.clamp(min=NEG_INF / 2)[..., None])
    o = torch.einsum("bgqst,btgd->bsgqd", probs.to(v.dtype), v)
    return o, lse.permute(0, 3, 1, 2)


def _hop_mask(doc_start, idx: int, owner: int, s: int):
    """(b, s, s) True = masked: key j of the block of `owner` against
    query i of this rank's shard `idx`, in global positions."""
    dev = doc_start.device
    q_pos = idx * s + torch.arange(s, device=dev)
    k_pos = owner * s + torch.arange(s, device=dev)
    return (k_pos[None, None, :] > q_pos[None, :, None]) \
        | (k_pos[None, None, :] < doc_start[:, :, None].long())


def _hops(cp: int, idx: int, causal: bool):
    """(t, owner, diagonal) of every hop, skipped ones as None: after t
    rotations this rank holds the block of rank (idx - t) mod cp."""
    out = []
    for t in range(cp):
        owner = (idx - t) % cp
        visible = not causal or owner <= idx
        out.append((t, owner, causal and t == 0) if visible else None)
    return out


class _Ring(torch.autograd.Function):
    """The ring's forward and backward (module doc)."""

    @staticmethod
    def forward(c, q, k, v, causal, doc_start, ctx):
        cp, idx = ctx.cp, ctx.cp_rank
        b, s, g, qpk, d = q.shape
        m = torch.full((b, s, g, qpk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((b, s, g, qpk, d), dtype=torch.float32,
                          device=q.device)
        kb, vb = k, v
        for t, hop in enumerate(_hops(cp, idx, causal)):
            if t:
                kb, vb = ring_shift([kb, vb], ctx)
            if hop is None:
                continue
            _, owner, diag = hop
            if doc_start is not None:
                o_h, lse_h = _masked_hop_with_lse(
                    q, kb, vb, _hop_mask(doc_start, idx, owner, s))
            else:
                o_h, lse_rows = _tagged_fwd(q, kb, vb, diag)
                lse_h = _lse_rows_to_bsgq(lse_rows, b, s, g, qpk)
            m_new = torch.maximum(m, lse_h)
            m_safe = m_new.clamp(min=NEG_INF / 2)
            corr = torch.exp(m - m_safe)
            w = torch.exp(lse_h - m_safe)
            lsum = lsum * corr + w
            acc = acc * corr[..., None] + o_h.float() * w[..., None]
            m = m_new
        out = (acc / lsum.clamp(min=1e-30)[..., None]).to(q.dtype)
        lse = m.clamp(min=NEG_INF / 2) + torch.log(lsum)
        c.save_for_backward(q, k, v, out,
                            _lse_bsgq_to_rows(lse, b, s, g, qpk),
                            doc_start)
        c.causal, c.ctx = causal, ctx
        return out

    @staticmethod
    def backward(c, do):
        q, k, v, out, lse, doc_start = c.saved_tensors
        ctx = c.ctx
        cp, idx = ctx.cp, ctx.cp_rank
        s = q.shape[1]
        delta = _delta_rows(out, do)
        do = do.to(q.dtype)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kb, vb = k, v
        for t, hop in enumerate(_hops(cp, idx, c.causal)):
            if t:
                kb, vb, dk, dv = ring_shift([kb, vb, dk, dv], ctx)
            if hop is None:
                continue
            _, owner, diag = hop
            if doc_start is not None:
                grads = _plain_bwd_rows(q, kb, vb, lse, delta, do, False,
                                        _hop_mask(doc_start, idx, owner, s))
            elif q.device.type == "cpu":
                grads = _plain_bwd_rows(q, kb, vb, lse, delta, do, diag)
            else:
                grads = _bwd_rows(q, kb, vb, lse, delta, do, diag)
            dq += grads[0].float()
            dk += grads[1].float()
            dv += grads[2].float()
        if cp > 1:
            # the block of rank idx + 1 is here: one more hop takes its
            # gradient home
            dk, dv = ring_shift([dk, dv], ctx)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        doc_start: Optional[torch.Tensor] = None,
                        ctx=None) -> torch.Tensor:
    """Exact attention over the global sequence from this rank's shard
    (JAX :67): q (b, s, g, qpk, d), k/v (b, s, g, d) the positions
    [cp_rank s, (cp_rank + 1) s); returns (b, s, g, qpk, d), this shard's
    rows of the output. `doc_start` (b, s) holds the global index of
    each local query's document start (packed documents, causal only).
    Differentiable; every rank of the cp group calls it together. At
    cp = 1 it is the one-rank flash attention."""
    ctx = ctx or get_context()
    if ctx is None:
        raise ValueError("ring attention needs a parallel context "
                         "(parallel/mesh.py initialize_parallel)")
    if doc_start is not None and not causal:
        raise ValueError("packed-document masks imply causal attention")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention takes equal query and key "
                         f"shards, got s={q.shape[1]} and t={k.shape[1]}")
    return _Ring.apply(q, k, v, causal, doc_start, ctx)
