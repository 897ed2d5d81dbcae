"""PyTorch port isolation: the port and chip_smoke.py never import JAX or
the JAX package, and their model and kernel entry points default to the
card."""

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
from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.models import GPTModel, LlamaModel
from megatron_llm_tpu_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.models.transformer import init_layer_params

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
        for name in ("jax", "jaxlib", "megatron_llm_tpu"):
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


@pytest.mark.parametrize("fn,arg", [
    (GPTModel.__init__, "device"),
    (LlamaModel.__init__, "device"),
    (init_language_model_params, "device"),
    (init_layer_params, "device"),
    (precompute_rope, "device"),
    (params_from_jax, "device"),
])
def test_entry_points_default_to_cuda(fn, arg):
    fn = getattr(fn, "__wrapped__", fn)
    assert inspect.signature(fn).parameters[arg].default == "cuda"


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
