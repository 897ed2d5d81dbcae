"""PyTorch port, the hand-written kernels on a CUDA card: decode attention
(K1, CUDA C++), RMSNorm forward and backward (K2, K3, Triton), flash
attention forward and backward (K4-K6, CUDA C++) and ragged paged
attention (K7, CUDA C++; fp and int8 pools, window and document floors,
in its two designs: "tc" on the tensor cores and "present"),
each against its plain PyTorch version on the same inputs, and the
decode, paged and training paths with the kernels on against the same
paths with them off.

Every test is marked `cuda` and skips where there is no card. This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs with the test directory's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.ops import decode_attention as dec
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.ops.quantization import quantize_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _qkv(b, g, qpk, d, T, device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in ((b, 1, g, qpk, d), (b, g, T, d),
                               (b, g, T, d)))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("g,qpk,d", [(32, 1, 128), (8, 8, 128), (2, 16, 64),
                                     (3, 3, 256), (2, 5, 8)])
def test_decode_kernel_matches_plain(cuda, g, qpk, d, dtype, tol):
    """bf16 tolerance: the kernel rounds p to bf16 before normalising, the
    plain version after."""
    T = 320
    q, k, v = _qkv(4, g, qpk, d, T, cuda, dtype, seed=qpk)
    before = dec.decode_attention.launches
    for length in (1, 63, 64, 65, T):
        got = dec.decode_attention(q, k, v, length)
        ref = dec._xla_decode(q, k, v, length)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert _max_err(got, ref) <= tol, f"length={length}"
    assert dec.decode_attention.launches == before + 5


def test_decode_kernel_reads_no_position_past_length(cuda):
    """NaN past `length` must not reach the output."""
    q, k, v = _qkv(2, 4, 2, 128, 64, cuda, torch.bfloat16)
    k[:, :, 40:] = float("nan")
    v[:, :, 40:] = float("nan")
    got = dec.decode_attention(q, k, v, 40)
    assert torch.isfinite(got.float()).all()
    assert _max_err(got, dec._xla_decode(q, k[:, :, :40].contiguous(),
                                         v[:, :, :40].contiguous(), 40)) \
        <= 2e-2


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 1, 17, 128, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="qpk"):
        dec.decode_attention(q, k, v, 4)
    q, k, v = _qkv(1, 1, 1, 12, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="d % 8"):
        dec.decode_attention(q, k, v, 4)
    q, k, v = _qkv(1, 1, 1, 8, 8, cuda, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dec.decode_attention(q, k, v, 4)
    q, k, v = _qkv(1, 1, 1, 8, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="length"):
        dec.decode_attention(q, k, v, 9)


@pytest.mark.parametrize("n,h", [(4, 4096), (256, 4096), (7, 4096), (3, 300)])
def test_rmsnorm_kernel_matches_plain(cuda, n, h):
    gen = torch.Generator(device=cuda).manual_seed(n)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        x = torch.randn(n, h, generator=gen, device=cuda).to(dtype)
        scale = (1 + 0.1 * torch.randn(h, generator=gen, device=cuda)) \
            .to(dtype)
        before = rms.fused_rms_norm.launches
        got = rms.fused_rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        assert rms.fused_rms_norm.launches == before + 1
        assert _max_err(got, rms.rms_norm(x, scale, 1e-5)) <= tol


def test_decode_path_kernels_on_matches_off(cuda):
    """Tiny GQA Llama in fp32 on the card: prefill then 8 single-token
    steps with both kernels on, against the same steps with both off
    (plain versions); logits within 1e-4."""
    cfg = tiny_config(hidden_size=512, num_attention_heads=4,
                      num_attention_heads_kv=2, kv_channels=128,
                      ffn_hidden_size=256, compute_dtype=torch.float32,
                      use_fused_rmsnorm=True, use_decode_attn=True)
    on = LlamaModel(cfg)
    off = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                         use_decode_attn=False))
    params = on.init(seed=3)
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 14))).to(cuda)
    dp = on.prepare_decode_params(params)
    c_on, c_off = on.init_kv_caches(2, 64), off.init_kv_caches(2, 64)
    k1 = dec.decode_attention.launches
    with torch.inference_mode():
        for lo, hi in [(0, 6)] + [(i, i + 1) for i in range(6, 14)]:
            a, c_on = on.forward(dp, toks[:, lo:hi], kv_caches=c_on)
            b, c_off = off.forward(dp, toks[:, lo:hi], kv_caches=c_off)
            assert _max_err(a, b) <= 1e-4, (lo, hi)
    assert dec.decode_attention.launches - k1 == 8 * cfg.num_layers


PAGED_BATCHES = {
    # (chunk width, [(start, chunk_len) per slot]) at page 64, 32 pages a
    # slot: decode rows whose caches end on both sides of page
    # boundaries, an idle slot, the longest slot; a mixed round's first
    # prefill chunk, a chunk starting mid-page, decode rows padded to it
    "decode": (1, [(0, 1), (62, 1), (63, 1), (64, 1), (699, 1),
                   (2046, 1), (0, 0), (1499, 1)]),
    "mixed": (256, [(0, 256), (700, 100), (1, 1), (64, 1), (130, 1),
                    (1000, 1), (2046, 1), (511, 1)]),
}


def paged_batch(name, g, qpk, d, dtype, device, seed=0, page=64,
                max_pages=32):
    """Inputs of one paged launch, K/V of the chunks already scattered;
    table entries past each slot's reach are the null page."""
    C, spans = PAGED_BATCHES[name]
    nc = len(spans)
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    P = 1 + nc * max_pages
    k_pages, v_pages = rnd(P, page, g, d), rnd(P, page, g, d)
    perm = torch.randperm(P - 1, generator=gen, device=device) + 1
    pt = torch.zeros(nc, max_pages, dtype=torch.int32, device=device)
    for c, (start, ln) in enumerate(spans):
        owned = -(-max(start + ln, 1) // page)
        pt[c, :owned] = perm[c * max_pages:c * max_pages + owned].int()
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32,
                          device=device)
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32,
                        device=device)
    q = rnd(nc, C, g, qpk, d)
    pa.scatter_chunk_kv(rnd(nc, C, g, d), rnd(nc, C, g, d), k_pages,
                        v_pages, pt, starts, lens)
    return q, k_pages, v_pages, pt, starts, lens


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("g,qpk,d", [(32, 1, 128), (8, 8, 128), (2, 16, 64),
                                     (3, 3, 256), (2, 5, 8)])
@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_kernel_matches_plain(cuda, batch, g, qpk, d, dtype, tol):
    """bf16 tolerance: the kernel rounds p to bf16 before normalising,
    the plain version after. Pad rows are exact zeros."""
    args = paged_batch(batch, g, qpk, d, dtype, cuda, seed=qpk)
    before = pa.ragged_paged_attention.launches
    got = pa.paged_attention(*args)
    ref = pa._xla_paged_reference(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert _max_err(got, ref) <= tol
    C = args[0].shape[1]
    pad = torch.arange(C, device=cuda)[None, :] >= args[5][:, None]
    assert (got[pad] == 0).all()


@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_kernel_reads_only_what_each_chunk_needs(cuda, batch):
    """NaNs in the null page, in unowned pages and past each chunk's end
    do not reach any output: the output is bitwise the clean one."""
    q, kp, vp, pt, starts, lens = paged_batch(batch, 8, 8, 128,
                                              torch.bfloat16, cuda)
    clean = pa.paged_attention(q, kp, vp, pt, starts, lens)
    owned = torch.zeros(kp.shape[0], dtype=torch.bool, device=cuda)
    owned[pt.long().flatten()] = True
    owned[0] = False
    kp[~owned] = float("nan")
    vp[~owned] = float("nan")
    page = kp.shape[1]
    for c in range(pt.shape[0]):
        end = int(starts[c] + lens[c])
        for pos in range(end, pt.shape[1] * page):
            pg = int(pt[c, pos // page])
            if pg:
                kp[pg, pos % page] = float("nan")
                vp[pg, pos % page] = float("nan")
    dirty = pa.paged_attention(q, kp, vp, pt, starts, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(dirty, clean)


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, pt, st, ln = paged_batch("decode", 1, 17, 128, torch.float32,
                                        cuda, max_pages=32)
    with pytest.raises(ValueError, match="qpk"):
        pa.paged_attention(q, kp, vp, pt, st, ln)
    q, kp, vp, pt, st, ln = paged_batch("decode", 1, 1, 12, torch.float32,
                                        cuda)
    with pytest.raises(ValueError, match="d % 8"):
        pa.paged_attention(q, kp, vp, pt, st, ln)
    q, kp, vp, pt, st, ln = paged_batch("decode", 1, 1, 8, torch.float16,
                                        cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_attention(q, kp, vp, pt, st, ln)
    with pytest.raises(ValueError, match="int32"):
        q, kp, vp, pt, st, ln = paged_batch("decode", 1, 1, 8,
                                            torch.float32, cuda)
        pa.paged_attention(q, kp, vp, pt.long(), st, ln)


def test_paged_path_kernels_on_matches_off(cuda):
    """Tiny GQA Llama in fp32 on the card through the paged layout: a
    ragged prefill chunk then 8 single-token steps with K7 and K2 on,
    against the same steps with both off; logits within 1e-4."""
    cfg = tiny_config(hidden_size=512, num_attention_heads=4,
                      num_attention_heads_kv=2, kv_channels=128,
                      ffn_hidden_size=256, compute_dtype=torch.float32,
                      use_fused_rmsnorm=True, use_decode_attn=True)
    on = LlamaModel(cfg)
    off = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                         use_decode_attn=False))
    params = on.init(seed=3)
    dp = on.prepare_decode_params(params)
    pt = (torch.arange(8, device=cuda, dtype=torch.int32) + 1).view(2, 4)
    caches = []
    for m in (on, off):
        c = m.init_paged_kv_caches(2, 9, 16, 4)
        c["page_table"] = pt
        caches.append(c)
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 28))).to(cuda)
    lens = torch.tensor([20, 13], dtype=torch.int32, device=cuda)
    k7 = pa.ragged_paged_attention.launches
    with torch.inference_mode():
        outs = [m.forward(dp, toks[:, :20], kv_caches=dict(c, chunk_lens=lens))
                for m, c in zip((on, off), caches)]
        valid = torch.arange(20, device=cuda)[None, :] < lens[:, None]
        assert _max_err(outs[0][0][valid], outs[1][0][valid]) <= 1e-4
        caches = [dict(c, lengths=lens) for c in caches]
        for i in range(20, 28):
            (a, caches[0]), (b, caches[1]) = (
                m.forward(dp, toks[:, i:i + 1], kv_caches=c)
                for m, c in zip((on, off), caches))
            assert _max_err(a, b) <= 1e-4, i
    assert pa.ragged_paged_attention.launches - k7 == 9 * cfg.num_layers


def int8_batch(name, g, qpk, d, dtype, device, seed=0):
    """`paged_batch` with int8 pools: the random pools quantized, then
    the chunks' K/V scattered through the quantizing scatter. Returns
    (q, k_pages, v_pages, pt, starts, lens, k_scales, v_scales)."""
    C, spans = PAGED_BATCHES[name]
    q, kp, vp, pt, starts, lens = paged_batch(name, g, qpk, d, dtype,
                                              device, seed=seed)
    (kq, ks), (vq, vs) = quantize_rows(kp), quantize_rows(vp)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    new = [torch.randn(len(spans), C, g, d, generator=gen,
                       device=device).to(dtype) for _ in range(2)]
    pa.scatter_chunk_kv(*new, kq, vq, pt, starts, lens, ks, vs)
    return q, kq, vq, pt, starts, lens, ks, vs


# the variants of K7 beside fp pools: (int8 pools, window, doc_starts)
K7_VARIANTS = {
    "int8": (True, None, False),
    "window": (False, 300, False),
    "int8_window": (True, 300, False),
    "doc": (False, None, True),
    "int8_window_doc": (True, 300, True),
}


def _variant_args(batch, variant, g, qpk, d, dtype, device, seed=0):
    int8, window, doc = K7_VARIANTS[variant]
    if int8:
        q, kp, vp, pt, st, ln, ks, vs = int8_batch(batch, g, qpk, d, dtype,
                                                   device, seed)
    else:
        q, kp, vp, pt, st, ln = paged_batch(batch, g, qpk, d, dtype, device,
                                            seed=seed)
        ks = vs = None
    # document floors somewhere at or below each start
    doc_starts = (st - st // 3).contiguous() if doc else None
    return (q, kp, vp, pt, st, ln), dict(k_scales=ks, v_scales=vs,
                                         window=window,
                                         doc_starts=doc_starts)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("g,qpk,d", [(32, 1, 128), (8, 8, 128), (2, 5, 16)])
@pytest.mark.parametrize("variant", sorted(K7_VARIANTS))
@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_kernel_variants_match_plain(cuda, batch, variant, g, qpk, d,
                                           dtype, tol):
    """int8 pools, a binding window of 300 and document floors, alone
    and together, against the plain version on the same inputs; output
    in q's dtype, pad rows exact zeros, each launch counted under its
    variants."""
    args, kw = _variant_args(batch, variant, g, qpk, d, dtype, cuda,
                             seed=qpk)
    before = dict(pa.ragged_paged_attention.variant_launches)
    got = pa.paged_attention(*args, **kw)
    ref = pa._xla_paged_reference(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == args[0].shape
    assert _max_err(got, ref) <= tol
    pad = torch.arange(args[0].shape[1], device=cuda)[None, :] \
        >= args[5][:, None]
    assert (got[pad] == 0).all()
    after = pa.ragged_paged_attention.variant_launches
    int8, window, doc = K7_VARIANTS[variant]
    assert after["int8" if int8 else "fp"] == before[
        "int8" if int8 else "fp"] + 1
    assert after["window"] - before["window"] == int(window is not None)
    assert after["doc"] - before["doc"] == int(doc)


@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_kernel_covering_window_is_bitwise_no_window(cuda, batch):
    """W at or past every chunk's reach launches bitwise the fp kernel
    with no window, and so does doc_starts all 0."""
    args = paged_batch(batch, 8, 8, 128, torch.bfloat16, cuda)
    base = pa.paged_attention(*args)
    zeros = torch.zeros_like(args[4])
    for kw in ({"window": 2048}, {"window": 1 << 20},
               {"doc_starts": zeros}):
        assert torch.equal(pa.paged_attention(*args, **kw), base), kw


@pytest.mark.parametrize("variant", ["window", "int8_window", "doc"])
@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_kernel_reads_nothing_below_the_floor(cuda, batch, variant):
    """Below each chunk's floor: table entries reclaimed to the null page
    and NaN at every position (and in the null page); the output is
    bitwise the clean one."""
    args, kw = _variant_args(batch, variant, 8, 8, 128, torch.bfloat16,
                             cuda)
    clean = pa.paged_attention(*args, **kw)
    q, kp, vp, pt, st, ln = args
    targets = (kw["k_scales"], kw["v_scales"]) if kw["k_scales"] is not None \
        else (kp, vp)
    page = kp.shape[1]
    for c in range(pt.shape[0]):
        lo = int(st[c])
        lo = max(lo - kw["window"] + 1, 0) if kw["window"] else 0
        if kw["doc_starts"] is not None:
            lo = max(lo, int(kw["doc_starts"][c]))
        for pos in range(lo):
            for x in targets:
                x[int(pt[c, pos // page]), pos % page] = float("nan")
        pt[c, :lo // page] = 0
    for x in targets:
        x[0] = float("nan")
    dirty = pa.paged_attention(q, kp, vp, pt, st, ln, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(dirty, clean)


def test_paged_kernel_refuses_int8_it_does_not_take(cuda):
    q, kp, vp, pt, st, ln, ks, vs = int8_batch("decode", 2, 2, 16,
                                               torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="d % 16"):
        pa.paged_attention(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                           vp[..., :8].contiguous(), pt, st, ln, ks, vs)
    with pytest.raises(ValueError, match="k_scales"):
        pa.paged_attention(q, kp, vp, pt, st, ln)
    with pytest.raises(ValueError, match="doc_starts"):
        pa.paged_attention(q, kp, vp, pt, st, ln, ks, vs,
                           doc_starts=st + 1)


@pytest.mark.parametrize("mode", ["int8", "window", "int8_window"])
def test_paged_path_variants_kernels_on_matches_off(cuda, mode):
    """The tiny fp32 Llama through the paged layout with int8 pools, a
    window of 12, or both: a ragged prefill chunk then 8 single-token
    steps with K7 and K2 on, against the same steps with both off;
    logits within 1e-4."""
    cfg = tiny_config(hidden_size=512, num_attention_heads=4,
                      num_attention_heads_kv=2, kv_channels=128,
                      ffn_hidden_size=256, compute_dtype=torch.float32,
                      use_fused_rmsnorm=True, use_decode_attn=True,
                      attention_window_size=12 if "window" in mode
                      else None)
    on = LlamaModel(cfg)
    off = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                         use_decode_attn=False))
    params = on.init(seed=3)
    dp = on.prepare_decode_params(params, quantize_int8="int8" in mode)
    kv = torch.int8 if "int8" in mode else None
    pt = (torch.arange(8, device=cuda, dtype=torch.int32) + 1).view(2, 4)
    caches = []
    for m in (on, off):
        c = m.init_paged_kv_caches(2, 9, 16, 4, kv_dtype=kv)
        c["page_table"] = pt
        caches.append(c)
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 28))).to(cuda)
    lens = torch.tensor([20, 13], dtype=torch.int32, device=cuda)
    k7 = pa.ragged_paged_attention.launches
    with torch.inference_mode():
        outs = [m.forward(dp, toks[:, :20], kv_caches=dict(c, chunk_lens=lens))
                for m, c in zip((on, off), caches)]
        valid = torch.arange(20, device=cuda)[None, :] < lens[:, None]
        assert _max_err(outs[0][0][valid], outs[1][0][valid]) <= 1e-4
        caches = [dict(c, lengths=lens) for c in caches]
        for i in range(20, 28):
            (a, caches[0]), (b, caches[1]) = (
                m.forward(dp, toks[:, i:i + 1], kv_caches=c)
                for m, c in zip((on, off), caches))
            assert _max_err(a, b) <= 1e-4, i
    assert pa.ragged_paged_attention.launches - k7 == 9 * cfg.num_layers


# ---------------------------------------------------------------------------
# K7's "tc" design: bf16 pools, tiles of 64 folded rows, pages by TMA
# ---------------------------------------------------------------------------

# (g, qpk, d, page): qpk 24 and 71 cut 64-row tiles across tokens; page 16
# brings four pages a 64-position key tile, page 64 one, page 24 eight
# segments of 8 positions, page 128 half a page
TC_CASES = [(2, 1, 128, 64), (2, 8, 128, 16), (1, 24, 64, 16),
            (2, 24, 128, 64), (1, 71, 64, 64), (1, 71, 128, 16),
            (2, 8, 64, 24), (2, 1, 128, 128)]
# floors that fall inside tiles: a window of 300 (mid-page at both page
# sizes), document floors at two thirds of each start
TC_FLOORS = {"none": {}, "window": {"window": 300}, "doc": {"doc": True}}


def _tc_args(batch, g, qpk, d, page, floors, device, seed=0):
    args = paged_batch(batch, g, qpk, d, torch.bfloat16, device, seed=seed,
                       page=page, max_pages=-(-2048 // page))
    st = args[4]
    kw = {"window": floors.get("window"),
          "doc_starts": (st - st // 3).contiguous() if floors.get("doc")
          else None}
    return args, kw


@pytest.mark.parametrize("floors", sorted(TC_FLOORS))
@pytest.mark.parametrize("g,qpk,d,page", TC_CASES)
@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_tc_matches_plain(cuda, batch, g, qpk, d, page, floors):
    """The tc design against the plain version on decode and mixed rounds
    (bf16 tolerance as for the present design: both round p to bf16
    before the PV product, the plain version after normalising); pad rows
    exact zeros; the launch counted under "tc"."""
    args, kw = _tc_args(batch, g, qpk, d, page, TC_FLOORS[floors], cuda,
                        seed=qpk + page)
    before = pa.ragged_paged_attention.variant_launches["tc"]
    got = pa.paged_attention(*args, **kw, design="tc")
    ref = pa._xla_paged_reference(*args, **kw)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.variant_launches["tc"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert torch.isfinite(got.float()).all()
    assert _max_err(got, ref) <= 2e-2
    pad = torch.arange(args[0].shape[1], device=cuda)[None, :] \
        >= args[5][:, None]
    assert (got[pad] == 0).all()


@pytest.mark.parametrize("floors", ["window", "doc"])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_tc_reads_nothing_outside_each_chunks_reach(cuda, batch, page,
                                                          floors):
    """NaN at every position below each chunk's floor (table entries of
    pages wholly below it reclaimed to the null page), at every owned
    position at or past the chunk's end, in every page no chunk owns and
    in the null page: the tc output is bitwise the clean one."""
    args, kw = _tc_args(batch, 2, 24, 128, page, TC_FLOORS[floors], cuda)
    clean = pa.paged_attention(*args, **kw, design="tc")
    q, kp, vp, pt, st, ln = args
    owned = torch.zeros(kp.shape[0], dtype=torch.bool, device=cuda)
    owned[pt.long().flatten()] = True
    owned[0] = False
    kp[~owned] = float("nan")
    vp[~owned] = float("nan")
    for c in range(pt.shape[0]):
        lo = max(int(st[c]) - kw["window"] + 1, 0) if kw["window"] else 0
        if kw["doc_starts"] is not None:
            lo = max(lo, int(kw["doc_starts"][c]))
        end = int(st[c] + ln[c])
        for pos in list(range(lo)) + list(range(end, pt.shape[1] * page)):
            pg = int(pt[c, pos // page])
            kp[pg, pos % page] = float("nan")
            vp[pg, pos % page] = float("nan")
        pt[c, :lo // page] = 0
    kp[0] = float("nan")
    vp[0] = float("nan")
    dirty = pa.paged_attention(q, kp, vp, pt, st, ln, **kw, design="tc")
    torch.cuda.synchronize()
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(dirty, clean)


@pytest.mark.parametrize("batch", sorted(PAGED_BATCHES))
def test_paged_tc_covering_window_is_bitwise_no_window(cuda, batch):
    """On the tc design, W at or past every chunk's reach and doc_starts
    all 0 launch bitwise the no-window kernel; two runs agree bitwise."""
    args = paged_batch(batch, 2, 24, 128, torch.bfloat16, cuda)
    base = pa.paged_attention(*args, design="tc")
    assert torch.equal(pa.paged_attention(*args, design="tc"), base)
    zeros = torch.zeros_like(args[4])
    for kw in ({"window": 2048}, {"window": 1 << 20},
               {"doc_starts": zeros}):
        assert torch.equal(pa.paged_attention(*args, **kw, design="tc"),
                           base), kw


# (q dtype, pool dtype, batch, qpk, page) -> the design `paged_design` names
DESIGN_RULES = [
    (torch.bfloat16, torch.bfloat16, "mixed", 1, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, "mixed", 8, 16, "tc"),
    (torch.bfloat16, torch.bfloat16, "decode", 1, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, "decode", 24, 128, "tc"),
    (torch.bfloat16, torch.bfloat16, "mixed", 2, 24, "tc"),
    (torch.bfloat16, torch.bfloat16, "mixed", 2, 12, "present"),
    (torch.float32, torch.float32, "mixed", 2, 64, "present"),
    (torch.bfloat16, torch.int8, "mixed", 2, 64, "present"),
]


@pytest.mark.parametrize("qd,kvd,batch,qpk,page,design", DESIGN_RULES)
def test_paged_dispatch_runs_the_design_its_rule_names(cuda, qd, kvd, batch,
                                                       qpk, page, design):
    """Each launch runs, and is counted under, the design `paged_design`
    names for its dtypes and shapes; the output holds the plain version."""
    assert pa.paged_design(qd, kvd, page) == design
    args = paged_batch(batch, 2, qpk, 64, qd, cuda, page=page,
                       max_pages=-(-2048 // page))
    kw = {}
    if kvd == torch.int8:
        q, kp, vp, pt, st, ln = args
        (kp, ks), (vp, vs) = quantize_rows(kp), quantize_rows(vp)
        args, kw = (q, kp, vp, pt, st, ln), dict(k_scales=ks, v_scales=vs)
    before = dict(pa.ragged_paged_attention.variant_launches)
    got = pa.paged_attention(*args, **kw)
    ref = pa._xla_paged_reference(*args, **kw)
    torch.cuda.synchronize()
    after = pa.ragged_paged_attention.variant_launches
    other = "present" if design == "tc" else "tc"
    assert after[design] == before[design] + 1
    assert after[other] == before[other]
    assert _max_err(got, ref) <= (2e-2 if qd == torch.bfloat16 else 2e-5)


def test_paged_kernel_takes_qpk_above_16_only_on_the_tc_design(cuda):
    """bf16 pools at qpk 24 run; fp32 and int8 pools, bf16 pools of a
    page the tc design does not take, and the present design named
    outright, still raise above 16."""
    args = paged_batch("decode", 1, 24, 64, torch.bfloat16, cuda)
    pa.paged_attention(*args)
    with pytest.raises(ValueError, match="qpk"):
        pa.paged_attention(*args, design="present")
    fp = paged_batch("decode", 1, 24, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="qpk"):
        pa.paged_attention(*fp)
    odd = paged_batch("decode", 1, 24, 64, torch.bfloat16, cuda, page=12,
                      max_pages=171)
    with pytest.raises(ValueError, match="qpk"):
        pa.paged_attention(*odd)
    q, kp, vp, pt, st, ln = args
    (kq, ks), (vq, vs) = quantize_rows(kp), quantize_rows(vp)
    with pytest.raises(ValueError, match="qpk"):
        pa.paged_attention(q, kq, vq, pt, st, ln, ks, vs)


# ---------------------------------------------------------------------------
# K4-K6: flash attention forward and backward (bf16 only: fp32 raises)
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (g, qpk, d, s, t, causal)
    (2, 1, 128, 256, 256, True),     # Llama-2-7B heads, whole tiles
    (2, 8, 128, 128, 128, True),     # Llama-2-70B GQA
    (1, 3, 64, 100, 100, True),      # ragged s, odd qpk
    (2, 2, 256, 130, 130, True),     # d 256: two output-column chunks
    (3, 5, 40, 77, 77, True),        # d not a power of two
    (2, 1, 8, 33, 33, True),         # smallest d
    (2, 4, 128, 100, 70, False),     # full attention, t != s
    (1, 2, 64, 64, 96, True),        # causal with t > s
    (2, 1, 128, 1000, 1000, True),   # several 128-row blocks, ragged tail
    (2, 3, 128, 300, 300, True),     # qpk 3: rows straddle 128-row blocks
    (1, 8, 128, 512, 512, True),     # Llama-2-70B's qpk over several tiles
    (1, 2, 256, 200, 320, True),     # d 256 with t > s
]


def _flash_inputs(g, qpk, d, s, t, device, seed=0, b=2):
    gen = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(b, s, g, qpk, d, generator=gen, device=device).to(bf)
    k = torch.randn(b, t, g, d, generator=gen, device=device).to(bf)
    v = torch.randn(b, t, g, d, generator=gen, device=device).to(bf)
    do = torch.randn(b, s, g, qpk, d, generator=gen, device=device).to(bf)
    return q, k, v, do


def _rel_err(a, ref):
    return _max_err(a, ref) / max(ref.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("g,qpk,d,s,t,causal", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, g, qpk, d, s, t, causal):
    """K4 (o and lse) against `_xla_reference_with_lse`, K5 and K6 against
    `_plain_bwd` from the plain forward's o and lse: o within 2e-2
    max-abs, lse within 1e-3, each gradient within 2e-2 of its
    reference's max-abs (the kernels round p and ds to bf16 before their
    products, the plain version rounds the same tensors but sums in
    another order)."""
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(g, qpk, d, s, t, cuda, seed=d + s)
    b = q.shape[0]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa._fwd(q, k, v, causal)
    o_ref, lse_ref = fa._xla_reference_with_lse(q, k, v, causal)
    lse_ref = fa._lse_bsgq_to_rows(lse_ref, b, s, g, qpk)
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == q.dtype
    assert torch.isfinite(o.float()).all()
    assert _max_err(o, o_ref) <= 2e-2
    assert _max_err(lse, lse_ref) <= 1e-3
    grads = fa._bwd(q, k, v, o, lse, do, causal)
    refs = fa._plain_bwd(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        assert _rel_err(got, ref) <= 2e-2, (name, _rel_err(got, ref))
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(x + 1 for x in before)


def test_flash_lse_cotangent_folds_into_delta(cuda):
    """A nonzero dlse through `flash_attention_with_lse` on the card
    against the plain backward with the same fold."""
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    g, qpk, d, s = 2, 4, 128, 96
    q, k, v, do = _flash_inputs(g, qpk, d, s, s, cuda, seed=11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    dlse = torch.randn(2, s, g, qpk, generator=gen, device=cuda)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    o, lse = fa.flash_attention_with_lse(qr, kr, vr, True)
    torch.autograd.backward((o, lse), (do, dlse))
    o_ref, lse_ref = fa._xla_reference_with_lse(q, k, v, True)
    rows = fa._lse_bsgq_to_rows(lse_ref, 2, s, g, qpk)
    refs = fa._plain_bwd(q, k, v, o_ref, rows, do, True,
                         fa._lse_bsgq_to_rows(dlse, 2, s, g, qpk))
    for name, got, ref in zip("qkv", (qr.grad, kr.grad, vr.grad), refs):
        assert _rel_err(got, ref) <= 2e-2, name


def test_flash_backward_is_deterministic(cuda):
    """No atomics: two backward runs agree bitwise."""
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(4, 2, 128, 384, 384, cuda, seed=5)
    o, lse = fa._fwd(q, k, v, True)
    a = fa._bwd(q, k, v, o, lse, do, True)
    b = fa._bwd(q, k, v, o, lse, do, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("g,qpk,d,s,t,causal", FLASH_SHAPES)
def test_flash_backward_is_bitwise_repeatable_on_every_shape(
        cuda, g, qpk, d, s, t, causal):
    """K5 and K6 write each gradient row once, from registers: two
    backward runs agree bitwise on every shape."""
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(g, qpk, d, s, t, cuda, seed=d + s + 1)
    o, lse = fa._fwd(q, k, v, causal)
    a = fa._bwd(q, k, v, o, lse, do, causal)
    b = fa._bwd(q, k, v, o, lse, do, causal)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_inputs(1, 1, 128, 16, 16, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    q, k, v, _ = _flash_inputs(1, 1, 12, 16, 16, cuda)
    with pytest.raises(ValueError, match="d % 8"):
        fa.flash_attention(q, k, v)
    q, k, v, _ = _flash_inputs(1, 1, 264, 16, 16, cuda)
    with pytest.raises(ValueError, match="d <= 256"):
        fa.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# K2 with rstd and K3: the RMSNorm the training path runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h", [(4096, 4096), (1000, 4096), (7, 4096),
                                 (3, 300), (33, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)],
                         ids=["bf16", "fp32"])
def test_rmsnorm_rstd_and_backward_kernels_match_plain(cuda, n, h, dtype,
                                                       tol):
    """K2 writing rstd against `_plain_fwd`, K3 against `_plain_bwd`, with
    the training path's fp32 scale parameter: out, dx and dscale within
    tol of max(1, their reference's max-abs), rstd within 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(n + h)
    x = torch.randn(n, h, generator=gen, device=cuda).to(dtype)
    g = torch.randn(n, h, generator=gen, device=cuda).to(dtype)
    scale = 1 + 0.1 * torch.randn(h, generator=gen, device=cuda)
    before = (rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches)
    out, rstd = rms.rms_norm_fwd(x, scale, 1e-5, with_rstd=True)
    ref_out, ref_rstd = rms._plain_fwd(x, scale, 1e-5)
    dx, ds = rms.rms_norm_bwd(x, scale, rstd, g)
    ref_dx, ref_ds = rms._plain_bwd(x, scale, ref_rstd, g)
    torch.cuda.synchronize()
    assert (rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and dx.dtype == dtype
    assert ds.dtype == torch.float32 and rstd.shape == (n, 1)
    # relative to the largest output: normalised rows times a scale reach
    # |out| ~ 5, where one bf16 ulp is 0.03
    for got, ref in ((out, ref_out), (dx, ref_dx), (ds, ref_ds)):
        assert _max_err(got, ref) <= tol * max(1.0, ref.abs().max().item())
    assert _max_err(rstd, ref_rstd) <= 1e-5 * ref_rstd.abs().max().item()


def test_rmsnorm_autograd_launches_k2_and_k3(cuda):
    x = torch.randn(64, 256, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    scale = torch.ones(256, device=cuda, requires_grad=True)
    before = (rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches)
    rms.fused_rms_norm(x, scale, 1e-5).float().sum().backward()
    assert (rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and scale.grad.dtype == torch.float32


def test_train_path_kernels_on_matches_off(cuda):
    """Tiny GQA Llama (d 128) in bf16 on the card: one microbatch's loss
    and gradients with flash and the fused RMSNorm on, full recompute,
    against the same with both off; per microbatch the kernels launch
    as the training path implies."""
    from megatron_llm_tpu_torch.ops import flash_attention as fa

    cfg = tiny_config(hidden_size=512, num_attention_heads=4,
                      num_attention_heads_kv=2, kv_channels=128,
                      ffn_hidden_size=256, seq_length=256,
                      max_position_embeddings=256, use_fused_rmsnorm=True,
                      use_flash_attn=True, remat_policy="full")
    on = LlamaModel(cfg)
    off = LlamaModel(dataclasses.replace(cfg, use_fused_rmsnorm=False,
                                         use_flash_attn=False))
    params = on.init(seed=3)
    leaves = [params["lm_head"], params["layers"]["attention"]["wqkv"],
              params["layers"]["input_norm"]["scale"],
              params["embedding"]["word_embeddings"]]
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 257))).to(cuda)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches, rms.fused_rms_norm.launches,
              rms.rms_norm_bwd.launches)
    results = []
    for m in (on, off):
        loss = m.loss(params, toks[:, :-1], toks[:, 1:])
        results.append((loss.item(), torch.autograd.grad(loss, leaves)))
    L = cfg.num_layers
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches, rms.fused_rms_norm.launches,
            rms.rms_norm_bwd.launches) == (
        before[0] + 2 * L, before[1] + L, before[2] + L,
        before[3] + 4 * L + 1, before[4] + 2 * L + 1)
    (l_on, g_on), (l_off, g_off) = results
    assert abs(l_on - l_off) <= 2e-2
    for a, b in zip(g_on, g_off):
        cos = torch.nn.functional.cosine_similarity(
            a.double().flatten(), b.double().flatten(), dim=0).item()
        assert cos >= 0.99
