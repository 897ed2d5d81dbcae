"""Rank programs of tests/test_torch_lm_tasks_parallel.py: WIKITEXT103,
LAMBADA and MSDP-PROMPT through the port's `tasks.main` in gloo CPU
ranks (utils/virtual_mesh.spawn_cpu_group), one layout after another in
the same process group.

This module imports torch and the port only: a rank never imports JAX.
Inputs and results are numpy arrays and plain Python values.
"""

import contextlib
import dataclasses
import io
import sys

import torch

from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models.gpt import GPTModel
from megatron_llm_tpu_torch.tasks import main as tasks_main


def _fp32(inner):
    def wrapped(*a, **kw):
        m, p, t, d = inner(*a, **kw)
        return dataclasses.replace(m, compute_dtype=torch.float32), p, t, d
    return wrapped


def run_jobs(jobs):
    """Each job (name, argv, numpy tree or None): `tasks.main.main(argv,
    device="cpu")` in fp32, the model's init returning the tree where
    one is given (else the argv's `--load`). Returns per job what
    `main` returned and what this rank printed."""
    out = []
    for name, argv, tree in jobs:
        inner_cfg, inner_init = arguments.args_to_configs, GPTModel.init
        arguments.args_to_configs = _fp32(inner_cfg)
        if tree is not None:
            def init(self, seed=0, _tree=tree):
                return params_from_jax(_tree, self.cfg, device=self.device)

            GPTModel.init = init
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                res = tasks_main.main(argv, device="cpu")
        finally:
            arguments.args_to_configs, GPTModel.init = inner_cfg, inner_init
        out.append({"name": name, "result": res, "printed": buf.getvalue(),
                    "jax_modules": sorted(
                        k for k in sys.modules
                        if k == "jax" or k.startswith(("jax.",
                                                       "megatron_llm_tpu.")))})
    return out
