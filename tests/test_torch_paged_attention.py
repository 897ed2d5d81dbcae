"""PyTorch port, ragged paged attention (ops/prefill_attention.py, the
module of kernel K7) against the JAX package on the CPU in fp32: the
port's plain version against JAX `ragged_paged_attention` run two ways,
the real Pallas kernel under the interpreter and its XLA twin, on mixed
batches of decode rows, prefill chunks, idle chunks, a chunk whose start
is not page-aligned and one that crosses pages; `scatter_chunk_kv` on its
own; the null-page contract; the parameters that raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops.prefill_attention import (
    _xla_attend as jax_xla_attend,
    ragged_paged_attention as jax_rpa,
    scatter_chunk_kv as jax_scatter,
)
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from torch_parity import close, t

PAGE = 16
G, D = 2, 128
MAX_PAGES = 4

# (start, chunk_len) per chunk, at chunk width C
BATCHES = {
    # a first prefill chunk, a decode row inside a wider chunk, an idle
    # chunk, a chunk starting mid-page and crossing into the next page,
    # a short chunk deep in the slot
    "mixed": (8, [(0, 8), (21, 1), (5, 0), (13, 6), (40, 3)]),
    # the decode layout: C == 1, one idle slot
    "decode": (1, [(0, 1), (30, 1), (7, 0), (47, 1), (16, 1)]),
}


def _case(name, qpk, seed):
    C, spans = BATCHES[name]
    nc = len(spans)
    rs = np.random.RandomState(seed)
    P = 1 + nc * MAX_PAGES
    k_pages = rs.randn(P, PAGE, G, D).astype(np.float32)
    v_pages = rs.randn(P, PAGE, G, D).astype(np.float32)
    perm = rs.permutation(np.arange(1, P))
    pt = np.zeros((nc, MAX_PAGES), np.int32)
    for c, (start, ln) in enumerate(spans):
        owned = -(-max(start + ln, 1) // PAGE)  # entries past the need: 0
        pt[c, :owned] = perm[c * MAX_PAGES:c * MAX_PAGES + owned]
    starts = np.asarray([s for s, _ in spans], np.int32)
    lens = np.asarray([n for _, n in spans], np.int32)
    q = rs.randn(nc, C, G, qpk, D).astype(np.float32)
    k_new = rs.randn(nc, C, G, D).astype(np.float32)
    v_new = rs.randn(nc, C, G, D).astype(np.float32)
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages, page_table=pt, starts=starts,
                chunk_lens=lens)


def _port(case, **kw):
    a = {k: t(v.copy()) for k, v in case.items()}  # the scatter is in place
    return pa.ragged_paged_attention(
        a["q"], a["k_new"], a["v_new"], a["k_pages"], a["v_pages"],
        a["page_table"], a["starts"], a["chunk_lens"], **kw)


def _jax(case, use_pallas):
    a = {k: jnp.asarray(v) for k, v in case.items()}
    return jax_rpa(a["q"], a["k_new"], a["v_new"], a["k_pages"],
                   a["v_pages"], a["page_table"], a["starts"],
                   a["chunk_lens"], use_pallas=use_pallas,
                   interpret=use_pallas)


def _pad_rows(case):
    C = case["q"].shape[1]
    return np.arange(C)[None, :] >= case["chunk_lens"][:, None]  # (nc, C)


@pytest.mark.parametrize("qpk", [1, 2, 8])
@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla_twin"])
def test_matches_jax(batch, qpk, jax_path):
    case = _case(batch, qpk, seed=qpk)
    out, kp, vp = _port(case)
    ref, jkp, jvp = _jax(case, use_pallas=jax_path == "pallas_interpret")
    close(out, ref, 1e-5, f"{batch} qpk={qpk} vs {jax_path}")
    pad = _pad_rows(case)
    assert (out.numpy()[pad] == 0).all(), "pad rows must be exact zeros"
    # the pools after the scatter equal JAX's exactly, null page aside
    np.testing.assert_array_equal(kp.numpy()[1:], np.asarray(jkp)[1:])
    np.testing.assert_array_equal(vp.numpy()[1:], np.asarray(jvp)[1:])


def test_pools_are_updated_in_place():
    case = _case("mixed", 2, seed=3)
    a = {k: t(v) for k, v in case.items()}
    out, kp, vp = pa.ragged_paged_attention(
        a["q"], a["k_new"], a["v_new"], a["k_pages"], a["v_pages"],
        a["page_table"], a["starts"], a["chunk_lens"])
    assert kp is a["k_pages"] and vp is a["v_pages"]


def test_scatter_chunk_kv_matches_jax_exactly():
    case = _case("mixed", 1, seed=11)
    a = {k: t(v) for k, v in case.items()}
    pa.scatter_chunk_kv(a["k_new"], a["v_new"], a["k_pages"], a["v_pages"],
                        a["page_table"], a["starts"], a["chunk_lens"])
    jk, jv = jax_scatter(*(jnp.asarray(case[k]) for k in (
        "k_new", "v_new", "k_pages", "v_pages", "page_table", "starts",
        "chunk_lens")))
    np.testing.assert_array_equal(a["k_pages"].numpy()[1:],
                                  np.asarray(jk)[1:])
    np.testing.assert_array_equal(a["v_pages"].numpy()[1:],
                                  np.asarray(jv)[1:])
    # every valid token landed where the page table says
    for c, (start, ln) in enumerate(BATCHES["mixed"][1]):
        for tok in range(ln):
            pos = start + tok
            page = case["page_table"][c, pos // PAGE]
            np.testing.assert_array_equal(
                a["k_pages"].numpy()[page, pos % PAGE], case["k_new"][c, tok])


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_nan_outside_the_chunks_reach_never_reaches_the_output(batch):
    """NaNs in the null page, in every page no chunk owns and at the
    positions past each chunk's end leave every output as it was."""
    case = _case(batch, 2, seed=5)
    clean, _, _ = _port(dict(case))
    dirty = dict(case)
    kp, vp = case["k_pages"].copy(), case["v_pages"].copy()
    owned = set(case["page_table"][case["page_table"] > 0].tolist())
    for page in range(kp.shape[0]):
        if page not in owned:
            kp[page] = vp[page] = np.nan
    for c, (start, ln) in enumerate(BATCHES[batch][1]):
        for pos in range(start + ln, MAX_PAGES * PAGE):
            page = case["page_table"][c, pos // PAGE]
            if page:
                kp[page, pos % PAGE] = vp[page, pos % PAGE] = np.nan
    dirty["k_pages"], dirty["v_pages"] = kp, vp
    out, _, _ = _port(dirty)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


@pytest.mark.parametrize("kw,what", [
    ({"k_scales": torch.zeros(1), "v_scales": torch.zeros(1)}, "int8"),
    ({"window_size": 8}, "window_size"),
    ({"doc_starts": torch.zeros(5, dtype=torch.int32)}, "doc_starts"),
])
def test_later_slice_parameters_raise(kw, what):
    case = _case("mixed", 1, seed=0)
    with pytest.raises(NotImplementedError, match=what):
        _port(case, **kw)


def test_use_kernel_off_is_the_plain_version():
    case = _case("mixed", 8, seed=9)
    on, _, _ = _port(dict(case))
    off, _, _ = _port(dict(case), use_kernel=False)
    np.testing.assert_array_equal(on.numpy(), off.numpy())


def test_dense_core_keeps_the_shared_row_positions():
    """`_xla_attend` with (rows,) positions is the dense decode core."""
    rs = np.random.RandomState(2)
    q = rs.randn(2, 3, G, 2, D).astype(np.float32)
    k = rs.randn(2, G, 10, D).astype(np.float32)
    v = rs.randn(2, G, 10, D).astype(np.float32)
    pos = np.repeat(np.arange(7, 10), 2)
    shared = pa._xla_attend(t(q), t(k), t(v), t(pos))
    ragged = pa._xla_attend(t(q), t(k), t(v), t(np.stack([pos, pos])))
    np.testing.assert_array_equal(shared.numpy(), ragged.numpy())
    jax_ref = jax_xla_attend(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(pos))
    close(shared, jax_ref, 1e-5)
