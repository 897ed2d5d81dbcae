"""PyTorch port, the hand-written kernels on a CUDA card: decode attention
(K1, CUDA C++), RMSNorm forward (K2, Triton) and ragged paged attention
(K7, CUDA C++), each against its plain PyTorch version on the same
inputs, and the decode and paged paths with the kernels on against the
same paths with them off.

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
