"""PyTorch port, serving a pipeline-parallel (stage-sharded) model against
the JAX package.

The same tiny Llama weights (fp32, 4 layers, h 64, 2 KV groups, seq 64)
serve from the port's gloo CPU ranks (utils/virtual_mesh.spawn_cpu_group)
and the JAX package's virtual CPU mesh at the same layouts:

- the pipelined scorer at pp 2 and pp 2 x tp 2 within rtol 1e-4 / atol
  1e-5 of the JAX `make_pipelined_score_fn`;
- the stage ring at pp 2 with num_micro 2 and 4, with and without EOD
  termination: tokens and generated lengths equal to the JAX
  `make_pipelined_decode_fn`'s, log-probs within 1e-5; without EOD the
  tokens equal the port's single-rank `generate_tokens` (with EOD the
  ring stops a group by the JAX ring's schedule, which the lengths
  match);
- the API on a pp 2 layout, every rank the same request: a score; a
  greedy request through the ring (reshard limit 0) equal to the
  single-rank call; sampled and beam requests under the limit gather the
  layers and equal the single-rank call of the same seed, and above it
  raise; every rank returns the same answer;
- ring decode at tp > 1 raises, naming ROADMAP.md A4 item 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_pp_ranks as R
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.pipeline import (
    make_pipelined_decode_fn,
    make_pipelined_score_fn,
    pipeline_param_specs,
)
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.inference import api
from megatron_llm_tpu_torch.inference.generation import generate_tokens
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

SEQ, PREFILL, MAX_LEN = 64, 8, 24
SCORE_LAYOUTS = [(1, 2, 1, False), (1, 2, 2, False)]
# (pp, tp, num_micro, termination: None or the token to stop at, the
# rows of the ring's inputs: every row the first one's prompt stops every
# row at once, early termination)
ALL, FIRST = [0, 1, 2, 3], [0, 0, 0, 0]
RING = [(2, 1, 2, None, ALL), (2, 1, 4, None, ALL), (2, 1, 2, "eod", ALL),
        (2, 1, 4, "eod", ALL), (2, 1, 4, "eod", FIRST), (2, 2, 2, None, ALL)]
RING_IDS = ["nm2", "nm4", "nm2-eod", "nm4-eod", "nm4-eod-early"]
N_RING2 = len(RING_IDS)
PROMPTS = ["5 6 7 8 9 10 11 12 13", "40 41 42 43 44 45 46 47",
           "100 101 102 103 104 105 106 107 108 109 110",
           "3 1 4 1 5 9 2 6"]


def _jax_cfg():
    return jax_tiny_config(
        num_layers=4, hidden_size=64, num_attention_heads=8,
        num_attention_heads_kv=2, ffn_hidden_size=128, seq_length=SEQ,
        max_position_embeddings=SEQ, padded_vocab_size=256,
        compute_dtype=jnp.float32, params_dtype=jnp.float32)


def _stage_sharded(ctx, cfg, params):
    specs = pipeline_param_specs(cfg, params)
    sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(params, sh)


def _ring_inputs():
    rs = np.random.RandomState(0)
    tokens = np.zeros((4, MAX_LEN), np.int32)
    lengths = np.array([8, 10, 8, 12], np.int32)
    for i in range(4):
        tokens[i, :lengths[i]] = rs.randint(1, 255, lengths[i])
    return tokens, lengths


@pytest.fixture(scope="module")
def results():
    cfg = _jax_cfg()
    model = JaxLlama(cfg)
    params = model.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    port_model = LlamaModel(R.serve_cfg(), device="cpu")
    port_params = params_from_jax(params_np, port_model.cfg, device="cpu")
    score_toks = np.random.RandomState(1).randint(0, 256, (2, 3, SEQ))
    tokens, lengths = _ring_inputs()
    # the single-rank greedy stream: its first generated token is the EOD
    # of the "eod" cases, so every row stops at once there
    single = generate_tokens(port_model, port_params, tokens, lengths,
                             prefill_len=PREFILL, return_log_probs=True)
    eod = int(single.tokens[0, lengths[0] + 1])
    ring = [(pp, tp, nm, eod if term else None, rows)
            for pp, tp, nm, term, rows in RING]

    jax_score = []
    for dp, pp, tp, sp in SCORE_LAYOUTS:
        ctx = jax_initialize(dp=dp, pp=pp, tp=tp,
                             devices=jax.devices()[:pp * tp])
        try:
            pcfg = JaxParallelConfig(pipeline_parallel_size=pp,
                                     tensor_parallel_size=tp,
                                     num_microbatches=2)
            jax_score.append(np.asarray(jax.jit(make_pipelined_score_fn(
                model, pcfg, ctx))(_stage_sharded(ctx, cfg, params),
                                   jnp.asarray(score_toks, jnp.int32))))
        finally:
            jax_destroy()
    jax_ring = []
    ctx = jax_initialize(dp=1, pp=2, tp=1, devices=jax.devices()[:2])
    try:
        sharded = _stage_sharded(ctx, cfg, params)
        for pp, tp, nm, term, rows in ring[:N_RING2]:
            dec = jax.jit(make_pipelined_decode_fn(
                model, JaxParallelConfig(pipeline_parallel_size=pp), ctx,
                prefill_len=PREFILL, max_len=MAX_LEN, num_micro=nm,
                greedy=True, termination_id=term, return_log_probs=True))
            out = dec(sharded, jnp.asarray(tokens[rows]),
                      jnp.asarray(lengths[rows]))
            jax_ring.append(tuple(np.asarray(x) for x in out))
    finally:
        jax_destroy()

    port2 = spawn_cpu_group(2, R.suite, [
        ("scores", (SCORE_LAYOUTS[:1], params_np, score_toks)),
        ("ring_decodes", (ring[:N_RING2], params_np, tokens, lengths,
                          PREFILL)),
        ("api_requests", (params_np, PROMPTS, [0, 1 << 40]))],
        timeout_s=240)
    port4 = spawn_cpu_group(4, R.suite, [
        ("scores", (SCORE_LAYOUTS[1:], params_np, score_toks)),
        ("ring_decodes", (ring[N_RING2:], params_np, tokens, lengths,
                          PREFILL))],
        timeout_s=240)
    # the single-rank API answers to hold the pp 2 layout's against
    tok = R.ByteTokenizer()
    api.PP_DECODE_RESHARD_LIMIT_BYTES = 2 << 30
    one = {
        "score": api.generate_and_post_process(port_model, port_params, tok,
                                               PROMPTS, 0),
        "greedy": api.generate_and_post_process(
            port_model, port_params, tok, PROMPTS, 12,
            return_output_log_probs=True, top_k_sampling=1),
        "sampled": api.generate_and_post_process(
            port_model, port_params, tok, PROMPTS, 12, top_k_sampling=4,
            random_seed=7),
        "beam": api.beam_search_and_post_process(
            port_model, port_params, tok, PROMPTS[:1], 6, beam_size=2)}
    return {"jax_score": jax_score, "jax_ring": jax_ring, "port2": port2,
            "port4": port4, "single": single, "one": one, "eod": eod}


@pytest.mark.parametrize("i", range(len(SCORE_LAYOUTS)),
                         ids=["pp2", "pp2-tp2"])
def test_pipelined_scorer_matches_jax(results, i):
    group = results["port2"] if i == 0 else results["port4"]
    got = [r[0][0] for r in group]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], results["jax_score"][i], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("i", range(N_RING2), ids=RING_IDS)
def test_stage_ring_matches_the_jax_ring(results, i):
    got = [r[1][i] for r in results["port2"]]
    toks, lens, lps = got[0]
    for g in got[1:]:
        for a, b in zip(g, got[0]):
            np.testing.assert_array_equal(a, b)
    want = results["jax_ring"][i]
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_array_equal(lens, want[1])
    np.testing.assert_allclose(lps, want[2], rtol=0, atol=1e-5)
    single = results["single"]
    rows = RING[i][4]
    if RING[i][3] is None:
        np.testing.assert_array_equal(lens, single.lengths.numpy()[rows])
        np.testing.assert_array_equal(toks, single.tokens.numpy()[rows])
        np.testing.assert_allclose(lps, single.log_probs.numpy()[rows],
                                   rtol=0, atol=1e-5)
    elif rows == FIRST:
        # every row ends at its second generated token, and the ring
        # stops: nothing is written past the round that finished them
        assert (lens == 10).all()
        assert (toks[:, 12:] == 0).all()
    else:
        # the first row ends at its second generated token
        assert lens[0] == 10 and (lens[1:] == MAX_LEN).all()


def test_ring_decode_at_tp2_raises_naming_tp_serving(results):
    got = [r[1][0] for r in results["port4"]]
    assert all(isinstance(g, str) and "tensor-parallel serving" in g
               and "item 3" in g for g in got)


def _api(results, limit):
    ranks = [r[2][limit] for r in results["port2"]]
    return ranks[0], ranks


def _same(a, b):
    assert a[0] == b[0]
    if a[1] is None:
        assert b[1] is None
    else:
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a[2], b[2])


def test_api_scores_and_rides_the_ring_above_the_limit(results):
    got, ranks = _api(results, 0)
    for r in ranks[1:]:
        assert repr(r) == repr(got)
    one = results["one"]
    assert got["score"][0] == one["score"][0]
    np.testing.assert_allclose(got["score"][1], one["score"][2], rtol=1e-4,
                               atol=1e-5)
    g = one["greedy"]
    _same(got["greedy"], (g[0], g[2], g[3]))


def test_api_refuses_sampled_and_beam_requests_above_the_limit(results):
    got, _ = _api(results, 0)
    assert "only plain greedy requests" in got["sampled"]
    assert "MEGATRON_TPU_PP_RESHARD_LIMIT_BYTES" in got["sampled"]
    assert "no stage-ring beam path" in got["beam"]


def test_api_reshards_sampled_and_beam_requests_under_the_limit(results):
    got, ranks = _api(results, 1 << 40)
    one = results["one"]
    for r in ranks[1:]:
        assert repr(r) == repr(got)
    for name in ("sampled", "greedy"):
        _same(got[name], (one[name][0], one[name][2], one[name][3]))
    assert got["beam"][0] == one["beam"][0]
    np.testing.assert_allclose(got["beam"][1], one["beam"][2], rtol=1e-5)


def test_k1_counts_no_launch_on_the_cpu(results):
    """The CPU runs K1's plain version: the wrapper counts launches of
    the kernel only (the card's counts are chip_smoke.py's)."""
    assert results["port2"][0][2]["k1"] == {"gtd": 0, "tgd": 0}
