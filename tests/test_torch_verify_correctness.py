"""PyTorch port, the golden-logit gate `megatron_llm_tpu_torch/
verify_correctness.py` against HuggingFace and against the root JAX
script's path, on the CPU in fp32 at 2 layers:

- the CLI (`python -m ... --device cpu`) exits 0 and prints OK for the
  hermetic Llama; `main(argv)` does for Falcon in its multi-query (7B)
  and grouped (40B) layouts, and with --dump_layer_errors;
- one seeded HF Llama and one Falcon, converted by both packages' own
  converters: the port's logits within 1e-4 of the JAX script's path
  (the JAX model at the highest matmul precision) and within 1e-3 of
  HF's;
- a tolerance the errors exceed exits 1 with FAIL.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu_torch import verify_correctness as vc

pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num_layers", "2", "--iters", "1", "--seq_length", "32",
         "--device", "cpu"]


def test_cli_exits_0_with_ok_for_llama():
    # transformers imports TensorFlow too unless told not to (twice the
    # time)
    env = dict(os.environ, PYTHONPATH=REPO, USE_TF="0", USE_FLAX="0")
    proc = subprocess.run(
        [sys.executable, "-m", "megatron_llm_tpu_torch.verify_correctness",
         *SMALL], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert "(OK, tolerance 0.001)" in last, last
    assert "iteration 0: max abs logit error" in proc.stdout


@pytest.mark.parametrize("kv,dump", [(1, False), (2, True)],
                         ids=["falcon-mqa", "falcon-grouped"])
def test_main_passes_for_both_falcon_layouts(kv, dump, capsys):
    argv = SMALL + ["--model", "falcon", "--num_kv_heads", str(kv)] + (
        ["--dump_layer_errors"] if dump else [])
    assert vc.main(argv) == 0
    out = capsys.readouterr().out
    assert "OK" in out.strip().splitlines()[-1]
    if dump:
        assert "layer 1 (+final norm): max abs hidden error" in out


def test_a_tolerance_below_the_errors_fails(capsys):
    assert vc.main(SMALL + ["--tolerance", "0"]) == 1
    assert "FAIL" in capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("model,kv", [("llama", 4), ("falcon", 1)])
def test_logits_equal_the_jax_scripts_path(model, kv):
    from megatron_llm_tpu.convert import (
        hf_falcon_to_native as jax_falcon,
        hf_llama_to_native as jax_llama,
    )
    from megatron_llm_tpu.models import FalconModel as JaxFalcon
    from megatron_llm_tpu.models import LlamaModel as JaxLlama

    sys.path.insert(0, REPO)
    from tools.convert_weights import _model_cfg_from_hf as jax_cfg_from_hf

    args = vc.parse_args(SMALL + ["--model", model, "--num_kv_heads",
                                  str(kv)])
    torch.manual_seed(0)
    hf = vc.hf_model(args)
    cfg, port_model, params = vc.native_model(args, hf, "cpu")
    tokens = np.random.RandomState(1).randint(0, 512, (2, 32))
    with torch.no_grad():
        ref = hf(torch.as_tensor(tokens)).logits.numpy()
        ours = port_model.forward(params, torch.as_tensor(tokens))[0]
    ours = ours.numpy()[..., :ref.shape[-1]]
    jcfg = dataclasses.replace(jax_cfg_from_hf(model, hf.config, "float32"),
                               compute_dtype=jnp.float32)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    convert = jax_llama if model == "llama" else jax_falcon
    jparams = jax.tree.map(jnp.asarray, convert(sd, jcfg))
    jmodel = (JaxLlama if model == "llama" else JaxFalcon)(jcfg)
    with jax.default_matmul_precision("highest"):
        jax_logits = np.asarray(jax.jit(
            lambda p, t: jmodel.forward(p, t)[0])(jparams,
                                                  jnp.asarray(tokens)))
    jax_logits = jax_logits[..., :ref.shape[-1]]
    np.testing.assert_allclose(ours, jax_logits, rtol=0, atol=1e-4)
    assert np.abs(ours - ref).max() <= 1e-3


def test_the_flags_are_the_jax_scripts_plus_device():
    """Every flag of the root script, same defaults, and --device."""
    src = open(os.path.join(REPO, "verify_correctness.py")).read()
    jax_flags = {ln.split('"')[1] for ln in src.splitlines()
                 if "p.add_argument(" in ln}
    ours = vc.parse_args(["--device", "cpu"])
    assert {f"--{k}" for k in vars(ours)} == jax_flags | {"--device"}
    assert isinstance(ours, argparse.Namespace)
    assert (ours.iters, ours.batch_size, ours.seq_length, ours.tolerance,
            ours.num_layers, ours.hidden_size, ours.num_heads,
            ours.num_kv_heads, ours.vocab_size) == (4, 2, 64, 1e-3, 4, 128,
                                                    8, 4, 512)
    assert vc.parse_args([]).device == "cuda"
