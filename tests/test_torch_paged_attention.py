"""PyTorch port, ragged paged attention (ops/prefill_attention.py, the
module of kernel K7) against the JAX package on the CPU in fp32: the
port's plain version against JAX `ragged_paged_attention` run two ways,
the real Pallas kernel under the interpreter and its XLA twin, on mixed
batches of decode rows, prefill chunks, idle chunks, a chunk whose start
is not page-aligned and one that crosses pages, with fp and int8 pools
and with the window (off, binding, covering) and document floors, and at
qpk above 16 (24, and Falcon-7B's 71); `scatter_chunk_kv` on its own
(int8: bitwise); the null-page contract and the columns below each
chunk's floor; the refusals; the rule that picks K7's design from
dtypes and page size, and the qpk limit that follows from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops.prefill_attention import (
    _xla_attend as jax_xla_attend,
    ragged_paged_attention as jax_rpa,
    scatter_chunk_kv as jax_scatter,
)
from megatron_llm_tpu.ops.quantization import quantize_rows as jax_quantize
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


def _case(name, qpk, seed, int8=False):
    """One launch's inputs. int8 pools use pages of 32 (the int8 Pallas
    kernel's sublane tile, so the interpreter runs the kernel and not
    the XLA twin) over the same 64 positions a slot."""
    C, spans = BATCHES[name]
    page, max_pages = (2 * PAGE, MAX_PAGES // 2) if int8 \
        else (PAGE, MAX_PAGES)
    nc = len(spans)
    rs = np.random.RandomState(seed)
    P = 1 + nc * max_pages
    k_pages = rs.randn(P, page, G, D).astype(np.float32)
    v_pages = rs.randn(P, page, G, D).astype(np.float32)
    perm = rs.permutation(np.arange(1, P))
    pt = np.zeros((nc, max_pages), np.int32)
    for c, (start, ln) in enumerate(spans):
        owned = -(-max(start + ln, 1) // page)  # entries past the need: 0
        pt[c, :owned] = perm[c * max_pages:c * max_pages + owned]
    starts = np.asarray([s for s, _ in spans], np.int32)
    lens = np.asarray([n for _, n in spans], np.int32)
    q = rs.randn(nc, C, G, qpk, D).astype(np.float32)
    k_new = rs.randn(nc, C, G, D).astype(np.float32)
    v_new = rs.randn(nc, C, G, D).astype(np.float32)
    case = dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages, page_table=pt, starts=starts,
                chunk_lens=lens)
    if int8:
        for name in ("k", "v"):
            data, scale = jax_quantize(jnp.asarray(case[name + "_pages"]))
            case[name + "_pages"] = np.asarray(data)
            case[name + "_scales"] = np.asarray(scale)
    return case


_ARGS = ("q", "k_new", "v_new", "k_pages", "v_pages", "page_table",
         "starts", "chunk_lens")


def _port(case, **kw):
    a = {k: t(v.copy()) for k, v in case.items()}  # the scatter is in place
    for name in ("k_scales", "v_scales"):
        if name in a:
            kw[name] = a[name]
    return pa.ragged_paged_attention(*(a[k] for k in _ARGS), **kw)


_JAX_RPA = jax.jit(jax_rpa, static_argnames=("use_pallas", "interpret",
                                              "window_size"))


def _jax(case, use_pallas, **kw):
    """JAX `ragged_paged_attention` jitted, as its engine runs it (an
    eager call quantizes with a division, one ulp off in a few scales)."""
    a = {k: jnp.asarray(v) for k, v in case.items()}
    for name in ("k_scales", "v_scales"):
        if name in a:
            kw[name] = a[name]
    if "doc_starts" in kw:
        kw["doc_starts"] = jnp.asarray(kw["doc_starts"])
    return _JAX_RPA(*(a[k] for k in _ARGS), use_pallas=use_pallas,
                    interpret=use_pallas, **kw)


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


@pytest.mark.parametrize("qpk", [1, 4])
@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla_twin"])
def test_int8_pools_match_jax(batch, qpk, jax_path):
    """int8 pools with their scale pools: the port's plain version (the
    dequantized gathered view) within 1e-5 of the JAX kernel under the
    interpreter and of its XLA twin; the pools and scale pools after
    the quantizing scatter are bitwise JAX's, null page aside."""
    case = _case(batch, qpk, seed=20 + qpk, int8=True)
    out, kp, vp, ks, vs = _port(case)
    ref, jkp, jvp, jks, jvs = _jax(case, jax_path == "pallas_interpret")
    assert out.dtype == torch.float32
    close(out, ref, 1e-5, f"{batch} qpk={qpk} vs {jax_path}")
    assert (out.numpy()[_pad_rows(case)] == 0).all()
    for got, want in ((kp, jkp), (vp, jvp), (ks, jks), (vs, jvs)):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_window_off_binding_covering(batch, int8):
    """The three window regimes against the JAX kernel under the
    interpreter: W = 8 binds (and changes the output), W >= context is
    bitwise W = None, W <= 0 is no window."""
    case = _case(batch, 2, seed=30, int8=int8)
    base = _port(case)[0]
    for w in (0, -1, 4 * MAX_PAGES * PAGE):
        np.testing.assert_array_equal(_port(case, window_size=w)[0].numpy(),
                                      base.numpy())
    got = _port(case, window_size=8)[0]
    ref = _jax(case, True, window_size=8)[0]
    close(got, ref, 1e-5, f"{batch} window 8")
    assert not np.array_equal(got.numpy(), base.numpy()), "window never bound"
    twin = _jax(case, False, window_size=8)[0]
    close(got, twin, 1e-5, f"{batch} window 8 vs the XLA twin")


DOC = np.asarray([0, 16, 5, 12, 33], np.int32)  # <= the mixed starts


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_doc_starts_match_jax(int8):
    """Per-chunk document floors, alone and with a window, against the
    JAX kernel under the interpreter."""
    case = _case("mixed", 2, seed=31, int8=int8)
    for kw in ({}, {"window_size": 12}):
        got = _port(case, doc_starts=t(DOC), **kw)[0]
        ref = _jax(case, True, doc_starts=DOC, **kw)[0]
        close(got, ref, 1e-5, f"doc_starts {kw}")


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("floor", ["window", "doc"])
def test_nan_below_the_floor_never_reaches_the_output(floor, int8):
    """NaN at every position below each chunk's floor (window 12, or the
    document floors), pages wholly below it reclaimed (table entry on
    the null page) and NaN in the null page: the output is bitwise the
    clean one."""
    case = _case("mixed", 2, seed=33, int8=int8)
    kw = {"window_size": 12} if floor == "window" else {"doc_starts": t(DOC)}
    clean = _port(case, **kw)[0]
    dirty = {k: v.copy() for k, v in case.items()}
    data = ("k_scales", "v_scales") if int8 else ("k_pages", "v_pages")
    page = dirty["k_pages"].shape[1]
    for c, (start, ln) in enumerate(BATCHES["mixed"][1]):
        lo = max(start - 11, 0) if floor == "window" else int(DOC[c])
        for pos in range(lo):
            for name in data:
                dirty[name][dirty["page_table"][c, pos // page],
                            pos % page] = np.nan
        dirty["page_table"][c, :lo // page] = 0  # reclaimed
    for name in data:
        dirty[name][0] = np.nan
    out = _port(dirty, **kw)[0]
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


def test_refusals():
    case = _case("mixed", 1, seed=0)
    with pytest.raises(ValueError, match="doc_starts"):
        _port(case, doc_starts=t(DOC + 1))  # chunk 0: floor 1 > start 0
    int8 = _case("mixed", 1, seed=0, int8=True)
    del int8["k_scales"], int8["v_scales"]
    with pytest.raises(ValueError, match="k_scales"):
        _port(int8)


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


@pytest.mark.parametrize("qpk", [24, 71])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_matches_jax_above_16_heads_per_group(batch, qpk):
    """Past the present design's 16 folded rows a token group (qpk 71 is
    Falcon-7B's): the port's plain version within 1e-5 of the JAX kernel
    under the interpreter, which folds up to 2048 rows a block."""
    case = _case(batch, qpk, seed=40 + qpk)
    out, _, _ = _port(case)
    ref, _, _ = _jax(case, use_pallas=True)
    close(out, ref, 1e-5, f"{batch} qpk={qpk}")
    assert (out.numpy()[_pad_rows(case)] == 0).all()


@pytest.mark.parametrize("q_dtype,kv_dtype,page,design", [
    (torch.bfloat16, torch.bfloat16, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, 16, "tc"),
    (torch.bfloat16, torch.bfloat16, 24, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, "tc"),
    (torch.bfloat16, torch.bfloat16, 12, "present"),
    (torch.bfloat16, torch.bfloat16, 1, "present"),
    (torch.float32, torch.float32, 64, "present"),
    (torch.bfloat16, torch.int8, 64, "present"),
    (torch.float32, torch.int8, 16, "present"),
])
def test_design_choice_reads_dtypes_and_page_size(q_dtype, kv_dtype, page,
                                                  design):
    """K7's tensor-core design takes bf16 q with bf16 pools whose page is
    a multiple of 8; everything else runs the present design."""
    assert pa.paged_design(q_dtype, kv_dtype, page) == design


_KINDS = {"bf16": (torch.bfloat16, torch.bfloat16, 16),
          "fp32": (torch.float32, torch.float32, 16),
          "int8": (torch.bfloat16, torch.int8, 16),
          "bf16_page12": (torch.bfloat16, torch.bfloat16, 12)}


def _check_args(kind, C, qpk):
    """The operands `_check` inspects, on the CPU (it reads shapes and
    dtypes only)."""
    q_dtype, kv_dtype, page = _KINDS[kind]
    nc, g, d = 2, 1, 16
    q = torch.zeros(nc, C, g, qpk, d, dtype=q_dtype)
    kp = torch.zeros(3, page, g, d, dtype=kv_dtype)
    vp = torch.zeros(3, page, g, d, dtype=kv_dtype)
    pt = torch.zeros(nc, 2, dtype=torch.int32)
    st = torch.zeros(nc, dtype=torch.int32)
    ln = torch.ones(nc, dtype=torch.int32)
    ks = vs = torch.ones(3, page, g) if kv_dtype == torch.int8 else None
    return (q, kp, vp, pt, st, ln, ks, vs, None)


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("qpk", [1, 16, 17, 71])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_qpk_limit_follows_the_design(kind, qpk, C):
    """bf16 pools of a page the tc design takes serve any qpk at any
    chunk width; fp32 and int8 pools and other pages (the present
    design) raise above 16, and naming the tc design for them raises."""
    q, kp = _check_args(kind, C, qpk)[:2]
    design = pa.paged_design(q.dtype, kp.dtype, kp.shape[1])
    assert design == ("tc" if kind == "bf16" else "present")
    args = _check_args(kind, C, qpk)
    if design == "present" and qpk > 16:
        with pytest.raises(ValueError, match="qpk"):
            pa._check(*args, design)
    else:
        pa._check(*args, design)
    if design == "present":
        with pytest.raises(ValueError, match="tc design"):
            pa._check(*_check_args(kind, C, min(qpk, 16)), "tc")
