"""PyTorch port, model modules against the JAX package on shared weights
(fp32, CPU): rope, swiglu, split_qkv, attention_block (no-cache and
per-layer KV-cache branches), one transformer layer, the whole forward,
and prefill plus cached decode steps whose JAX side runs the real Pallas
decode kernel under the interpreter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import gpt_config as jax_gpt_config
from megatron_llm_tpu.models import GPTModel as JaxGPT
from megatron_llm_tpu.models import activations as jax_act
from megatron_llm_tpu.models import attention as jax_attn
from megatron_llm_tpu.models import rope as jax_rope
from megatron_llm_tpu.models import transformer as jax_tf
from megatron_llm_tpu_torch.config import ModelConfig
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import GPTModel
from megatron_llm_tpu_torch.models import activations as pt_act
from megatron_llm_tpu_torch.models import attention as pt_attn
from megatron_llm_tpu_torch.models import rope as pt_rope
from megatron_llm_tpu_torch.models import transformer as pt_tf
from megatron_llm_tpu_torch.models.transformer import layer_slice
from torch_parity import close, t, tiny_pair


def _layer0(tp):
    return layer_slice(tp["layers"], 0)


def _jax_layer0(jp):
    return jax.tree.map(lambda x: x[0], jp["layers"])


def test_rope_interleaved_pairs():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3, 4, 16).astype(np.float32)
    pos = rs.randint(0, 40, (2, 5))
    tab_j = jax_rope.precompute_rope(16, 64, 10000.0, 2.0)
    tab_t = pt_rope.precompute_rope(16, 64, 10000.0, 2.0, "cpu")
    close(tab_t, tab_j, 1e-6)
    for p in (None, pos):
        got = pt_rope.apply_rope(t(x), tab_t, None if p is None else t(p))
        ref = jax_rope.apply_rope(jnp.asarray(x), tab_j,
                                  None if p is None else jnp.asarray(p))
        close(got, ref, 1e-5)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "reglu", "liglu"])
def test_glu_activations(name):
    rs = np.random.RandomState(1)
    g, u = rs.randn(2, 3, 16).astype(np.float32), rs.randn(2, 3, 16) \
        .astype(np.float32)
    got = pt_act.GLU_ACTIVATIONS[name](t(g), t(u))
    ref = jax_act.GLU_ACTIVATIONS[name](jnp.asarray(g), jnp.asarray(u))
    close(got, ref, 1e-6)


def test_split_qkv_grouped_layout():
    jm, _, tm, _ = tiny_pair()
    rs = np.random.RandomState(2)
    mixed = rs.randn(2, 3, tm.cfg.qkv_projection_size).astype(np.float32)
    for got, ref in zip(pt_attn.split_qkv(t(mixed), tm.cfg),
                        jax_attn.split_qkv(jnp.asarray(mixed), jm.cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_attention_block_no_cache():
    jm, jp, tm, tp = tiny_pair()
    x = np.random.RandomState(3).randn(2, 7, 512).astype(np.float32)
    got, cache = pt_attn.attention_block(
        _layer0(tp)["attention"], tm.cfg, t(x),
        pt_rope.precompute_rope(128, 64, device="cpu"), None, None)
    ref, _ = jax_attn.attention_block(
        _jax_layer0(jp)["attention"], jm.cfg, jnp.asarray(x),
        jax_rope.precompute_rope(128, 64), None, None)
    assert cache is None
    close(got, ref, 1e-4)


def test_attention_block_kv_cache_branch():
    """Per-layer "k_gtd" caches: a 5-token prefill chunk, then two
    single-token steps; the columns land in the preallocated cache in
    place and the outputs match the JAX branch."""
    jm, jp, tm, tp = tiny_pair()
    rs = np.random.RandomState(4)
    rope_t = pt_rope.precompute_rope(128, 64, device="cpu")
    rope_j = jax_rope.precompute_rope(128, 64)
    kc = torch.zeros(2, 2, 16, 128)
    vc = torch.zeros(2, 2, 16, 128)
    cache_t = {"k_gtd": kc, "v_gtd": vc, "offset": 0}
    cache_j = {"k_gtd": jnp.zeros((2, 2, 16, 128)),
               "v_gtd": jnp.zeros((2, 2, 16, 128)), "offset": jnp.int32(0)}
    for s in (5, 1, 1):
        x = rs.randn(2, s, 512).astype(np.float32)
        got, cache_t = pt_attn.attention_block(
            _layer0(tp)["attention"], tm.cfg, t(x), rope_t, None, None,
            cache_t)
        ref, cache_j = jax_attn.attention_block(
            _jax_layer0(jp)["attention"], jm.cfg, jnp.asarray(x), rope_j,
            None, None, kv_cache=cache_j)
        close(got, ref, 1e-4, f"s={s}")
        assert cache_t["k_gtd"] is kc and cache_t["v_gtd"] is vc
        close(kc, cache_j["k_gtd"], 1e-5)
        close(vc, cache_j["v_gtd"], 1e-5)
    assert cache_t["offset"] == 7


def test_transformer_layer():
    jm, jp, tm, tp = tiny_pair()
    x = np.random.RandomState(5).randn(2, 6, 512).astype(np.float32)
    got, _ = pt_tf.transformer_layer(
        _layer0(tp), tm.cfg, t(x),
        pt_rope.precompute_rope(128, 64, device="cpu"), None, None)
    ref, _ = jax_tf.transformer_layer(
        _jax_layer0(jp), jm.cfg, jnp.asarray(x),
        jax_rope.precompute_rope(128, 64), None, None)
    close(got, ref, 1e-4)


def test_whole_forward_logits():
    jm, jp, tm, tp = tiny_pair()
    toks = np.random.RandomState(6).randint(0, 256, (2, 11)).astype(np.int32)
    got, _ = tm.forward(tp, t(toks).long())
    ref, _ = jm.forward(jp, jnp.asarray(toks))
    close(got, ref, 1e-4)


def test_prefill_then_cached_decode_steps():
    """Prefill 6 tokens, then 8 single-token steps through the decode
    layout (per-layer params and caches). The JAX side runs the real
    Pallas decode kernel under the interpreter at every step."""
    jm, jp, tm, tp = tiny_pair(jax_kernel=True)
    toks = np.random.RandomState(7).randint(0, 256, (2, 14)).astype(np.int32)
    jdp = jm.prepare_decode_params(jp)
    jc = jm.init_kv_caches(2, 64, layout="layers")
    tdp = tm.prepare_decode_params(tp)
    tc = tm.init_kv_caches(2, 64)
    step = jax.jit(lambda p, x, c: jm.forward(p, x, kv_caches=c))
    spans = [(0, 6)] + [(i, i + 1) for i in range(6, 14)]
    for lo, hi in spans:
        ref, jc = step(jdp, jnp.asarray(toks[:, lo:hi]), jc)
        got, tc = tm.forward(tdp, t(toks[:, lo:hi]).long(), kv_caches=tc)
        close(got, ref, 1e-4, f"positions {lo}:{hi}")
    assert tc["offset"] == 14


def test_gpt_variant_forward():
    """The GPT branches the Llama path does not take: learned absolute
    positions, LayerNorm, biases, gelu MLP, tied head."""
    jcfg = jax_gpt_config(num_layers=2, hidden_size=64, num_attention_heads=4,
                          seq_length=32, vocab_size=100,
                          compute_dtype=jnp.float32, hidden_dropout=0.0,
                          attention_dropout=0.0)
    jm = JaxGPT(jcfg)
    jp = jm.init(jax.random.key(3))
    jp = jax.tree.map(lambda x: x + 0.01 if x.ndim <= 2 else x, jp)
    tcfg = ModelConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                       seq_length=32, max_position_embeddings=32,
                       padded_vocab_size=jcfg.padded_vocab_size,
                       compute_dtype=torch.float32)
    tm = GPTModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.RandomState(8).randint(0, 100, (2, 9)).astype(np.int32)
    got, _ = tm.forward(tp, t(toks).long())
    ref, _ = jm.forward(jp, jnp.asarray(toks))
    close(got, ref, 1e-4)


def test_paged_prefill_chunk_then_decode_steps():
    """The paged layout of the engine: per-layer page pools, one page
    table, ragged chunk lengths. One prefill chunk of width 20 (slot 0
    20 tokens, slot 1 13), then 8 single-token paged steps, through
    `LlamaModel.forward` on both sides (the JAX side runs its Pallas
    paged kernel under the interpreter); logits within 1e-4 and the
    pools equal to 1e-5, null page aside."""
    jm, jp, tm, tp = tiny_pair(jax_kernel=True)
    rs = np.random.RandomState(10)
    slots, page, max_pages = 2, 16, 4
    num_pages = 1 + slots * max_pages
    pt = np.zeros((slots, max_pages), np.int32)
    pt[:] = rs.permutation(np.arange(1, num_pages)).reshape(slots, -1)
    jc = dict(jm.init_paged_kv_caches(slots, num_pages, page, max_pages),
              page_table=jnp.asarray(pt))
    tc = dict(tm.init_paged_kv_caches(slots, num_pages, page, max_pages),
              page_table=t(pt))
    jdp, tdp = jm.prepare_decode_params(jp), tm.prepare_decode_params(tp)
    step = jax.jit(lambda p, x, c: jm.forward(p, x, kv_caches=c))
    toks = rs.randint(0, 256, (slots, 20)).astype(np.int32)
    lens = np.asarray([20, 13], np.int32)
    ref, jc = step(jdp, jnp.asarray(toks),
                   dict(jc, chunk_lens=jnp.asarray(lens)))
    got, tc = tm.forward(tdp, t(toks).long(),
                         kv_caches=dict(tc, chunk_lens=t(lens)))
    valid = np.arange(20)[None, :] < lens[:, None]
    close(got.numpy()[valid], np.asarray(ref)[valid], 1e-4, "prefill")
    jc.pop("chunk_lens")
    tc.pop("chunk_lens")
    np.testing.assert_array_equal(tc["lengths"].numpy(), lens)
    for i in range(8):
        x = rs.randint(0, 256, (slots, 1)).astype(np.int32)
        ref, jc = step(jdp, jnp.asarray(x), jc)
        got, tc = tm.forward(tdp, t(x).long(), kv_caches=tc)
        close(got, ref, 1e-4, f"decode step {i}")
    np.testing.assert_array_equal(tc["lengths"].numpy(), lens + 8)
    for name in ("k_pages_layers", "v_pages_layers"):
        for a, b in zip(tc[name], jc[name]):
            close(a.numpy()[1:], np.asarray(b)[1:], 1e-5, name)
