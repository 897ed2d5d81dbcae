"""PyTorch port, the weight converters against the JAX package's:

- every function of the port's `convert/hf.py` and
  `convert/megatron_torch.py` gives arrays bitwise equal to the JAX
  package's numpy function on the same seeded inputs (fp32);
- tiny HF Llama (MHA, GQA) and Falcon (multi_query,
  new_decoder_architecture) models built by `transformers` give the
  port's logits after `hf2native` within 1e-4, through a vocabulary that
  is padded (1000 -> 1024);
- native -> HF -> native and native -> reference .pt -> native
  round-trip bit-exactly, in memory and through the CLI's files, and
  `transformers` loads what the port's `native2hf` writes;
- the port's safetensors writer and reader against the `safetensors`
  library, single files and shards;
- the CLI's `hf2native` writes the leaves the JAX tool writes from the
  same HF directory; `--model gpt` with an HF direction refuses as the
  JAX tool does.
"""

import argparse
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import falcon_config as jax_falcon_config
from megatron_llm_tpu.config import gpt_config as jax_gpt_config
from megatron_llm_tpu.config import llama_config as jax_llama_config
from megatron_llm_tpu.convert import hf as jhf
from megatron_llm_tpu.convert import megatron_torch as jmt
from megatron_llm_tpu.models import FalconModel as JaxFalcon
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch.config import (
    falcon_config,
    gpt_config,
    llama_config,
)
from megatron_llm_tpu_torch.convert import hf as thf
from megatron_llm_tpu_torch.convert import megatron_torch as tmt
from megatron_llm_tpu_torch.convert import safetensors_io as sio
from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
from megatron_llm_tpu_torch.tools import convert_weights as cw
from megatron_llm_tpu_torch.training.checkpointing import (
    flatten,
    read_tracker,
    save_checkpoint,
    unflatten,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF_VOCAB, PADDED = 1000, 1024


def _np(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _assert_trees_equal(a, b, msg=""):
    fa, fb = flatten(_np(a)), flatten(_np(b))
    assert sorted(fa) == sorted(fb), (msg, sorted(fa), sorted(fb))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{msg} {k}")


def _llama_cfgs(n_kv, **kw):
    base = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=n_kv, ffn_hidden_size=112,
                seq_length=48, max_position_embeddings=48,
                vocab_size=HF_VOCAB, **kw)
    return (jax_llama_config(7, **base),
            llama_config(7, compute_dtype=torch.float32, **base))


def _falcon_cfgs(new_arch, **kw):
    base = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=2 if new_arch else 1,
                ffn_hidden_size=256, seq_length=48,
                max_position_embeddings=48, vocab_size=HF_VOCAB,
                parallel_layernorm=new_arch, **kw)
    return (jax_falcon_config(7, **base),
            falcon_config(7, compute_dtype=torch.float32, **base))


def _hf_llama(n_kv, vocab=HF_VOCAB):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=n_kv,
        max_position_embeddings=48, rms_norm_eps=1e-5,
        tie_word_embeddings=False)).float().eval()


def _hf_falcon(new_arch, vocab=HF_VOCAB):
    from transformers import FalconConfig, FalconForCausalLM

    torch.manual_seed(1)
    return FalconForCausalLM(FalconConfig(
        vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=8, num_kv_heads=2 if new_arch else 1,
        new_decoder_architecture=new_arch, multi_query=not new_arch,
        parallel_attn=True, bias=False, alibi=False)).float().eval()


def _sd(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# bitwise parity with the JAX package's numpy functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("revert", [False, True])
@pytest.mark.parametrize("shape", [(4 * 16, 24), (2 * 8,)])
def test_permute_rope_rows_equals_jax(shape, revert):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    d = 16 if shape[0] == 64 else 8
    np.testing.assert_array_equal(
        thf.permute_rope_rows(w, d, revert).numpy(),
        jhf.permute_rope_rows(w, d, revert))


@pytest.mark.parametrize("n_heads,n_kv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("permute", [True, False])
def test_grouped_qkv_equals_jax(n_heads, n_kv, permute):
    rs = np.random.RandomState(1)
    d, h = 16, 32
    wq = rs.randn(n_heads * d, h).astype(np.float32)
    wk, wv = (rs.randn(n_kv * d, h).astype(np.float32) for _ in range(2))
    ours = thf.build_grouped_qkv(wq, wk, wv, d, n_heads, n_kv, permute)
    ref = jhf.build_grouped_qkv(wq, wk, wv, d, n_heads, n_kv, permute)
    np.testing.assert_array_equal(ours.numpy(), ref)
    for a, b in zip(thf.split_grouped_qkv(ref, d, n_heads, n_kv, permute),
                    jhf.split_grouped_qkv(ref, d, n_heads, n_kv, permute)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("new_arch", [False, True])
@pytest.mark.parametrize("revert", [False, True])
def test_permute_falcon_qkv_equals_jax(new_arch, revert):
    jc, tc = _falcon_cfgs(new_arch)
    w = np.random.RandomState(2).randn(tc.qkv_projection_size, 64) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        thf._permute_falcon_qkv(w, tc, revert).numpy(),
        jhf._permute_falcon_qkv(w, jc, revert))


@pytest.mark.parametrize("n_kv", [8, 2])
def test_llama_converters_equal_jax(n_kv):
    """HF -> native into a padded table (1000 -> 1024) and back with the
    vocabulary sliced."""
    jc, tc = _llama_cfgs(n_kv, padded_vocab_size=PADDED)
    sd = {k: v.numpy() for k, v in _sd(_hf_llama(n_kv)).items()}
    ours = thf.hf_llama_to_native(sd, tc)
    _assert_trees_equal(ours, jhf.hf_llama_to_native(sd, jc), "to native")
    assert ours["embedding"]["word_embeddings"].shape[0] == PADDED
    back = thf.native_to_hf_llama(ours, tc, vocab_size=HF_VOCAB)
    ref = jhf.native_to_hf_llama(_np(ours), jc, vocab_size=HF_VOCAB)
    _assert_trees_equal(back, ref, "to HF")
    _assert_trees_equal(back, sd, "round trip")


@pytest.mark.parametrize("new_arch", [False, True])
def test_falcon_converters_equal_jax(new_arch):
    jc, tc = _falcon_cfgs(new_arch, padded_vocab_size=PADDED)
    sd = {k: v.numpy() for k, v in _sd(_hf_falcon(new_arch)).items()}
    ours = thf.hf_falcon_to_native(sd, tc)
    _assert_trees_equal(ours, jhf.hf_falcon_to_native(sd, jc), "to native")
    back = thf.native_to_hf_falcon(ours, tc, vocab_size=HF_VOCAB)
    ref = jhf.native_to_hf_falcon(_np(ours), jc, vocab_size=HF_VOCAB)
    _assert_trees_equal(back, ref, "to HF")
    _assert_trees_equal(back, sd, "round trip")


@pytest.mark.parametrize("version", [0, 1.0, 3.0])
@pytest.mark.parametrize("n_kv", [4, 1])
def test_fix_qkv_ordering_equals_jax(version, n_kv):
    w = np.random.RandomState(3).randn(3 * 4 * 8, 16).astype(np.float32)
    np.testing.assert_array_equal(
        tmt.fix_qkv_ordering(w, version, 4, n_kv, 8).numpy(),
        jmt.fix_qkv_ordering(w, version, 4, n_kv, 8))


def _reference_cases():
    """(name, JAX cfg, port cfg, JAX model) of the three families."""
    jl, tl = _llama_cfgs(2, padded_vocab_size=PADDED)
    jf, tf = _falcon_cfgs(True, padded_vocab_size=PADDED)
    gkw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
               seq_length=32, vocab_size=HF_VOCAB)
    jg, tg = jax_gpt_config(**gkw), gpt_config(**gkw)
    from megatron_llm_tpu.models import GPTModel as JaxGPT

    return {"llama": (jl, tl, JaxLlama), "falcon": (jf, tf, JaxFalcon),
            "gpt": (jg, tg, JaxGPT)}


@pytest.mark.parametrize("family", ["llama", "falcon", "gpt"])
def test_reference_converters_equal_jax(family, tmp_path):
    """native -> reference names -> native, the args and the config read
    back from them, and the .pt container written by each package and
    read by the other: all equal the JAX package's, and the round trip
    is bit-exact."""
    jc, tc, jmodel = _reference_cases()[family]
    params = _np(jax.tree.map(np.asarray,
                              jmodel(jc).init(jax.random.key(4))))
    lm = tmt.native_to_reference(params, tc)
    _assert_trees_equal(lm, jmt.native_to_reference(params, jc), "to ref")
    back = tmt.reference_to_native(lm, tc)
    _assert_trees_equal(back, jmt.reference_to_native(_np(lm), jc), "native")
    _assert_trees_equal(back, params, "round trip")
    args = tmt.reference_args_for_cfg(tc)
    assert args == jmt.reference_args_for_cfg(jc)

    ours_dir, jax_dir = str(tmp_path / "ours"), str(tmp_path / "jax")
    tmt.save_reference_checkpoint(ours_dir, lm, args)
    jmt.save_reference_checkpoint(jax_dir, _np(lm), args, iteration=7)
    for d in (ours_dir, jax_dir):
        a_lm, a_args, a_v = tmt.load_reference_checkpoint(d)
        b_lm, b_args, b_v = jmt.load_reference_checkpoint(d)
        _assert_trees_equal(a_lm, b_lm, d)
        assert vars(a_args) == vars(b_args) and a_v == b_v == 3.0
        tcfg = tmt.config_from_reference_args(a_args, language_model=a_lm)
        jcfg = jmt.config_from_reference_args(b_args, language_model=b_lm)
        for f in ("num_layers", "hidden_size", "num_attention_heads_kv",
                  "ffn_hidden_size", "padded_vocab_size", "glu_activation",
                  "use_rms_norm", "use_bias", "tie_embed_logits",
                  "parallel_attn", "parallel_layernorm",
                  "position_embedding_type", "rope_theta"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        _assert_trees_equal(tmt.reference_to_native(a_lm, tcfg), params, d)


# ---------------------------------------------------------------------------
# logits of transformers' models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,variant", [
    ("llama", 8), ("llama", 2), ("falcon", False), ("falcon", True)])
def test_hf_logits_equal_the_ports(family, variant):
    if family == "llama":
        hf, (_, cfg) = _hf_llama(variant), _llama_cfgs(
            variant, padded_vocab_size=PADDED)
        convert, model = thf.hf_llama_to_native, LlamaModel(cfg, device="cpu")
    else:
        hf, (_, cfg) = _hf_falcon(variant), _falcon_cfgs(
            variant, padded_vocab_size=PADDED)
        convert, model = thf.hf_falcon_to_native, FalconModel(cfg,
                                                              device="cpu")
    params = convert(_sd(hf), cfg)
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, HF_VOCAB, (2, 24)))
    with torch.no_grad():
        ref = hf(tokens).logits.numpy()
        ours, _ = model.forward(params, tokens)
    np.testing.assert_allclose(ours.numpy()[..., :HF_VOCAB], ref, rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# safetensors and the CLI
# ---------------------------------------------------------------------------


def _mixed_tensors():
    rs = np.random.RandomState(6)
    return {
        "a.bf16": torch.from_numpy(rs.randn(5, 7).astype(np.float32))
        .to(torch.bfloat16),
        "b.f16": torch.from_numpy(rs.randn(3, 2, 4).astype(np.float16)),
        "c.f32": torch.from_numpy(rs.randn(9).astype(np.float32)),
        "d.i64": torch.arange(6).reshape(2, 3),
        "e.scalar": torch.tensor(2.5),
        "f.strided": torch.from_numpy(rs.randn(4, 6).astype(np.float32)).T,
    }


@pytest.mark.parametrize("shard_bytes", [10**9, 64])
def test_safetensors_writer_reads_back_in_the_library(tmp_path, shard_bytes):
    from safetensors import safe_open

    tensors = _mixed_tensors()
    sio.save_sharded(tensors, str(tmp_path), max_shard_bytes=shard_bytes)
    index = tmp_path / sio.INDEX_NAME
    if shard_bytes == 64:
        files = json.loads(index.read_text())["weight_map"]
        assert len(set(files.values())) > 1
    else:
        assert not index.exists()
        files = dict.fromkeys(tensors, sio.SINGLE_NAME)
    for name, t in tensors.items():
        with safe_open(str(tmp_path / files[name]), framework="pt") as f:
            got = f.get_tensor(name)
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got, t.contiguous()), name
    lazy = sio.LazySafetensorsDict(str(tmp_path))
    assert sorted(lazy) == sorted(tensors)
    for name, t in tensors.items():
        assert torch.equal(lazy[name], t), name


@pytest.mark.parametrize("sharded", [False, True])
def test_reader_reads_library_written_files(tmp_path, sharded):
    """transformers' save_pretrained (the safetensors library underneath),
    one file or shards with an index: the port's reader gives every
    tensor of the state dict."""
    hf = _hf_llama(2)
    hf.save_pretrained(str(tmp_path), safe_serialization=True,
                       max_shard_size="200KB" if sharded else "5GB")
    assert (tmp_path / sio.INDEX_NAME).exists() == sharded
    lazy = sio.LazySafetensorsDict(str(tmp_path))
    sd = _sd(hf)
    assert sorted(lazy) == sorted(sd)
    for name, t in sd.items():
        assert torch.equal(lazy[name], t), name
    cfg = sio.read_hf_config(str(tmp_path))
    assert (cfg.num_key_value_heads, cfg.rms_norm_eps, cfg.rope_theta,
            cfg.vocab_size) == (2, 1e-5, 10000.0, HF_VOCAB)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", os.path.join(REPO, "tools",
                                            "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _release_leaves(ckpt_dir):
    assert read_tracker(ckpt_dir) == (None, True)
    return torch.load(os.path.join(ckpt_dir, "release", "model"),
                      weights_only=True)


@pytest.mark.parametrize("family,variant", [("llama", 2), ("falcon", True),
                                            ("falcon", False)])
def test_cli_hf2native_equals_the_jax_tool(tmp_path, family, variant):
    hf = _hf_llama(variant) if family == "llama" else _hf_falcon(variant)
    hf_dir = str(tmp_path / "hf")
    hf.save_pretrained(hf_dir, safe_serialization=True)
    ours = str(tmp_path / "ours")
    cw.main(["--model", family, "--direction", "hf2native", "--input",
             hf_dir, "--output", ours])
    jt = _jax_tool()
    jax_dir = str(tmp_path / "jax")
    jt.hf2native(argparse.Namespace(model=family, input=hf_dir,
                                    output=jax_dir, dtype="float32"))
    from transformers import AutoConfig

    jcfg = jt._model_cfg_from_hf(family, AutoConfig.from_pretrained(hf_dir),
                                 "float32")
    jmodel = (JaxLlama if family == "llama" else JaxFalcon)(jcfg)
    tmpl = jax.eval_shape(jmodel.init, jax.random.key(0))
    loaded = jax_ckpt.load_checkpoint(jax_dir, tmpl)
    assert loaded is not None and loaded[3] == 0
    ref = flatten(jax.tree.map(np.asarray, loaded[0]))
    leaves = _release_leaves(ours)
    assert sorted(leaves) == sorted(ref)
    for k, v in leaves.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    with open(os.path.join(ours, "release", "meta.json")) as f:
        meta = json.load(f)
    assert meta["iteration"] == 0 and meta["source"] == f"hf:{hf_dir}"
    assert meta["config"]["num_attention_heads_kv"] == jcfg.num_query_groups


@pytest.mark.parametrize("family,dtype", [("llama", "float32"),
                                          ("llama", "bfloat16"),
                                          ("falcon", "bfloat16")])
def test_cli_round_trips_bit_exactly(tmp_path, family, dtype):
    """A native release -> native2hf (HF files transformers loads, with
    the port's logits) -> hf2native: the same leaves; and -> reference
    .pt -> native likewise."""
    tdt = cw.DTYPES[dtype]
    if family == "llama":
        cfg = _llama_cfgs(2)[1]
        model = LlamaModel(cfg, device="cpu")
    else:
        cfg = _falcon_cfgs(False)[1]
        model = FalconModel(cfg, device="cpu")
    params = unflatten({k: v.to(tdt) for k, v in
                        flatten(model.init(seed=3)).items()})
    src = str(tmp_path / "src")
    save_checkpoint(src, 0, params, model_cfg=cfg, release=True)
    hf_dir, back = str(tmp_path / "hf"), str(tmp_path / "back")
    common = ["--model", family, "--dtype", dtype]
    cw.main(["--model", family, "--direction", "native2hf", "--input", src,
             "--output", hf_dir])
    cw.main(common + ["--direction", "hf2native", "--input", hf_dir,
                      "--output", back])
    orig = flatten(params)
    got = _release_leaves(back)
    assert sorted(got) == sorted(orig)
    for k in orig:
        assert got[k].dtype == tdt and torch.equal(got[k], orig[k]), k

    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(hf_dir,
                                              torch_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, HF_VOCAB, (1, 16)))
    with torch.no_grad():
        ref = hf(tokens).logits
        fp32 = {k: v.float() for k, v in flatten(params).items()}
        ours, _ = model.forward(unflatten(fp32), tokens)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-4)

    ref_dir, back2 = str(tmp_path / "ref"), str(tmp_path / "back2")
    cw.main(common + ["--direction", "native2megatron", "--input", src,
                      "--output", ref_dir])
    cw.main(common + ["--direction", "megatron2native", "--input", ref_dir,
                      "--output", back2])
    got = _release_leaves(back2)
    for k in orig:
        assert torch.equal(got[k], orig[k]), k


def test_gpt_with_an_hf_direction_refuses_as_jax_does(monkeypatch):
    argv = ["--model", "gpt", "--direction", "hf2native", "--input", "a",
            "--output", "b"]
    with pytest.raises(SystemExit) as ours:
        cw.main(argv)
    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + argv)
    with pytest.raises(SystemExit) as ref:
        _jax_tool().main()
    assert str(ours.value) == str(ref.value) and "gpt" in str(ours.value)


def test_bin_only_directory_needs_transformers(tmp_path, monkeypatch):
    """Without safetensors the converter loads .bin weights through
    transformers, and says so by name where it is missing."""
    hf = _hf_llama(2)
    hf.save_pretrained(str(tmp_path / "hf"), safe_serialization=False)
    out = str(tmp_path / "out")
    cw.main(["--model", "llama", "--direction", "hf2native", "--input",
             str(tmp_path / "hf"), "--output", out])
    ref = thf.hf_llama_to_native(
        _sd(hf), _llama_cfgs(2, padded_vocab_size=HF_VOCAB)[1])
    got = _release_leaves(out)
    for k, v in flatten(ref).items():
        assert torch.equal(got[k], v), k
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        cw.main(["--model", "llama", "--direction", "hf2native", "--input",
                 str(tmp_path / "hf"), "--output", str(tmp_path / "x")])
