"""PyTorch port isolation: the port and chip_smoke.py never import JAX or
the JAX package (nor, at module level, `safetensors`, `transformers` or
`ml_dtypes`, which the card's machine lacks), their model, kernel,
training and serving entry points default to the card, and the weight
converters touch no device."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import megatron_llm_tpu_torch
from megatron_llm_tpu_torch import finetune
from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.convert.from_jax import (
    params_from_jax,
    rank_params_from_jax,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.models import FalconModel, GPTModel, LlamaModel
from megatron_llm_tpu_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.models.transformer import init_layer_params
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from megatron_llm_tpu_torch.parallel import pipeline, ring_attention
from megatron_llm_tpu_torch.parallel.mesh import (
    ParallelContext,
    initialize_parallel,
)
from megatron_llm_tpu_torch.tools import (
    pipeline_memory_table,
    run_text_generation_server,
)
from megatron_llm_tpu_torch.training.trainer import Trainer, get_batch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "megatron_llm_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        megatron_llm_tpu_torch.__path__, "megatron_llm_tpu_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where `jax` and `megatron_llm_tpu` cannot be
    imported, every module of the port and chip_smoke.py's imports load."""
    smoke_imports = [
        ast.unparse(n) for n in ast.parse(
            (REPO / "chip_smoke.py").read_text()).body
        if isinstance(n, (ast.Import, ast.ImportFrom))]
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "megatron_llm_tpu", "safetensors",
                     "transformers", "ml_dtypes"):
            sys.modules[name] = None
        for m in {_modules()!r}:
            importlib.import_module(m)
        sys.path.insert(0, {str(REPO)!r})
        for line in {smoke_imports!r}:
            exec(line)
        assert not any(k == "jax" or k.startswith(("jax.", "megatron_llm_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(_modules()) >= 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name != "jax" and not name.startswith("jax."), (path, name)
            assert not name.startswith("megatron_llm_tpu.") \
                and name != "megatron_llm_tpu", (path, name)
    # the card's machine has none of these: never at module level
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "safetensors", "transformers", "ml_dtypes"), (path, name)


@pytest.mark.parametrize("fn,arg", [
    (GPTModel.__init__, "device"),
    (LlamaModel.__init__, "device"),
    (init_language_model_params, "device"),
    (init_layer_params, "device"),
    (precompute_rope, "device"),
    (params_from_jax, "device"),
    (rank_params_from_jax, "device"),
    (get_batch, "device"),
    (finetune.main, "device"),
    (finetune.model_provider, "device"),
    (FalconModel.__init__, "device"),
    (run_text_generation_server.main, "device"),
    (initialize_parallel, "device"),
])
def test_entry_points_default_to_cuda(fn, arg):
    fn = getattr(fn, "__wrapped__", fn)
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_finetune_main_without_a_card_raises():
    """`finetune.main` on its default device needs a card: here (no
    CUDA) it raises before it parses or builds anything."""
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(["--model_name", "llama2", "--num_layers", "2"])


def test_pipeline_functions_take_the_contexts_device():
    """The pipelined loss, train step, scorer and ring have no device of
    their own: they run on the parallel context's (cuda by default, as
    above); the memory table tool needs a card unless asked for the
    CPU."""
    for fn in (pipeline.make_pipelined_loss_fn,
               pipeline.make_pipelined_score_fn,
               pipeline.make_pipelined_decode_fn,
               pipeline.reshard_params_for_inference):
        assert "device" not in inspect.signature(fn).parameters
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_memory_table.main([])


def test_engine_and_paged_caches_take_the_models_device():
    """`DecodeEngine` and `init_paged_kv_caches` take no device of their
    own: the engine serves on its model's device (cuda by default, as
    above) and allocates every pool, table and carry there."""
    for fn in (DecodeEngine.__init__, GPTModel.init_paged_kv_caches):
        assert "device" not in inspect.signature(fn).parameters
    model = LlamaModel(tiny_config(), device="cpu")
    caches = model.init_paged_kv_caches(2, 5, 16, 2)
    assert {x.device.type for x in (*caches["k_pages_layers"],
                                    caches["page_table"],
                                    caches["lengths"])} == {"cpu"}
    eng = DecodeEngine(model, model.init(seed=0), slots=2, page_size=16,
                       max_context=32)
    assert eng.device == model.device
    assert eng._last_logits.device == model.device


def test_trainer_takes_the_models_device():
    """`Trainer` has no device of its own: it trains on its model's
    (cuda by default, as above) and builds its batches there."""
    import numpy as np

    from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig

    assert "device" not in inspect.signature(Trainer.__init__).parameters
    model = LlamaModel(tiny_config(), device="cpu")
    tr = Trainer(model, TrainConfig(), ParallelConfig())
    assert tr.device == model.device
    state = tr.setup()
    assert {p.device.type for p in (
        state.params["lm_head"], state.opt_state.m["lm_head"],
        state.opt_state.step)} == {"cpu"}
    text = np.zeros((1, 1, 9), np.int32)
    assert get_batch(text, device=tr.device)["tokens"].device.type == "cpu"


@pytest.mark.parametrize("call", ["flash_fwd", "flash_bwd", "rmsnorm_fwd",
                                  "rmsnorm_train", "ring"])
def test_kernel_wrappers_do_not_fall_back_off_the_cpu(call):
    """Only a CPU tensor takes a plain version: a tensor on any other
    device goes to the kernel, which here (no nvcc, no triton) raises."""
    import torch

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    q, k = meta(1, 8, 1, 1, 16), meta(1, 8, 1, 16)
    calls = {
        "flash_fwd": lambda: fa.flash_attention(q, k, k),
        # ring attention's hops are K4-K6 (a one-rank ring here)
        "ring": lambda: ring_attention.ring_self_attention(
            q, k, k, ctx=ParallelContext()),
        "flash_bwd": lambda: fa._bwd(q, k, k, q, meta(1, 8, 1).float(), q,
                                     True),
        "rmsnorm_fwd": lambda: rms.fused_rms_norm(meta(4, 16), meta(16)),
        "rmsnorm_train": lambda: rms.fused_rms_norm(
            meta(4, 16).requires_grad_(True), meta(16)),
    }
    # the kernel route (its device guard, the build, or triton's import)
    # raises; the wrappers' own shape checks pass at these shapes
    with pytest.raises((RuntimeError, ImportError, ValueError),
                       match="(?i)cuda|nvcc|triton"):
        calls[call]()


CONVERTERS = [PKG / "convert" / "hf.py", PKG / "convert" / "megatron_torch.py",
              PKG / "convert" / "safetensors_io.py",
              PKG / "tools" / "convert_weights.py"]


@pytest.mark.parametrize("path", CONVERTERS, ids=lambda p: p.name)
def test_converters_touch_no_device(path):
    """The weight converters compute on the host: no device argument, no
    CUDA call, no `.to(<device>)` anywhere in their sources."""
    src = path.read_text()
    for word in ("cuda", "device="):
        assert word not in src, (path.name, word)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.arg):
            assert node.arg != "device", path.name


def test_spawned_cpu_ranks_import_no_jax():
    """A rank that `spawn_cpu_group` starts imports every module of the
    port and no JAX."""
    import torch_ranks
    from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

    out = spawn_cpu_group(2, torch_ranks.rank_modules, timeout_s=120)
    assert out == [{"world": 2, "jax": []}] * 2


TORCHRUN_RANK = """
import sys
import torch
from megatron_llm_tpu_torch.parallel import mesh, multihost
world = mesh.maybe_initialize_distributed(device="cpu")
ctx = mesh.initialize_parallel(dp=2, device="cpu")
anyone = multihost.all_hosts_any(ctx.rank == 1)
multihost.host_barrier("done")
jax = [k for k in sys.modules if k == "jax" or k.startswith("jax.")]
with open(f"{sys.argv[1]}/rank{ctx.rank}", "w") as f:
    f.write(f"RANK {ctx.rank} {world} {ctx.backend} {anyone} {jax}")
mesh.destroy_parallel()
torch.distributed.destroy_process_group()
"""


def test_torchrun_ranks_join_the_group_and_import_no_jax(tmp_path):
    """Under torchrun (on the CPU, gloo) each rank joins the group
    torchrun describes, agrees with the others and imports no JAX."""
    script = tmp_path / "rank.py"
    script.write_text(TORCHRUN_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(script), str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [(tmp_path / f"rank{r}").read_text() for r in range(2)]
    assert lines == ["RANK 0 2 gloo True []", "RANK 1 2 gloo True []"]
