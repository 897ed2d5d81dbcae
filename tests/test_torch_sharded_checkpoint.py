"""PyTorch port, per-rank checkpoint files (training/checkpointing.py,
training/trainer.py `StateLayout`).

A save across ranks writes each rank's pieces (its tp and pp slices of
the params, its ZeRO-1 blocks of the moments, one writer per distinct
piece) and a marker per rank; rank 0 commits once every marker is
there. On a 4-layer Llama in gloo CPU ranks:

- saves at tp 2 x dp 2 with sequence parallelism and ZeRO-1, at pp 2 x
  dp 2 with ZeRO-1 and under the overlap layout (dp 4,
  `--overlap_grad_reduce`): every leaf reassembled from the pieces is
  bit for bit the saving run's state, and the same as a whole-tensor
  save of it; no rank writes a piece another rank writes;
- each loads at world size 1, at tp 1 x dp 2 with ZeRO-1 and at pp 2,
  every leaf bit for bit;
- a whole-tensor checkpoint (a world size 1 save, the form every
  earlier version wrote) and a JAX checkpoint through
  `checkpoint_from_jax` load at those layouts too;
- a save with one rank's marker and COMPLETE removed is skipped by the
  backward scan, and a writer whose other ranks never mark raises at
  the next wait and leaves no COMPLETE;
- the serving launcher's `restore_params` and
  tools/reshard_checkpoint.py read the per-rank form.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_overlap_ranks as R
from megatron_llm_tpu.optimizer import (
    init_optimizer_state as jax_init_optimizer_state,
)
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.training import checkpointing as ckpt
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

SAVES = {"tp2-dp2": dict(tp=2, dp=2, sp=True),
         "pp2-dp2": dict(pp=2, dp=2),
         "overlap-dp4": dict(dp=4, grads=True, gather=True)}
LOADS = {"dp2": dict(dp=2), "pp2": dict(pp=2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    params = R.params_np()
    dirs = {n: str(tmp / n) for n in list(SAVES) + ["whole", "jax"]}
    data = {n: R.batches(2, 2, 8 if n == "overlap-dp4" else 4)
            for n in SAVES}
    saved = spawn_cpu_group(4, R.suite, [
        ("train", (dict(kw, steps=2, save=dirs[n], save_interval=1),
                   params, data[n])) for n, kw in SAVES.items()],
        timeout_s=600)
    whole = R.train(dict(steps=2, save=dirs["whole"]), params,
                    R.batches(2, 2, 4))
    # a JAX checkpoint's trees, through the converter
    jparams = jax.tree.map(np.asarray, R.params_np(seed=1))
    jopt = jax.tree.map(np.asarray, jax_init_optimizer_state(
        jax.tree.map(np.asarray, jparams),
        __import__("megatron_llm_tpu.config", fromlist=["x"]).TrainConfig()))
    meta = {"iteration": 7, "consumed_train_samples": 28,
            "config": {"kv_channels": 8, "num_attention_heads": 8,
                       "num_attention_heads_kv": 2}}
    checkpoint_from_jax(jparams, jopt, meta, dirs["jax"])
    sources = list(SAVES) + ["whole", "jax"]
    loaded = spawn_cpu_group(2, R.suite, [
        ("load_state", (LOADS[lay], dirs[src]))
        for src in sources for lay in LOADS], timeout_s=600)
    one = {src: R.load_state({}, dirs[src]) for src in sources}
    return {"dirs": dirs, "saved": {n: saved[0][i]
                                    for i, n in enumerate(SAVES)},
            "whole": whole, "jax": jparams,
            "loaded": {(src, lay): loaded[0][i * len(LOADS) + j]
                       for i, src in enumerate(sources)
                       for j, lay in enumerate(LOADS)},
            "one": one, "tmp": tmp}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _state_leaves(st):
    out = _flat(st["params"])
    out.update(_flat(st["m"], "m."))
    out.update(_flat(st["v"], "v."))
    return out


def _file_leaves(path):
    out = {k: v.numpy() for k, v in ckpt.read_leaves(path, "model").items()}
    out.update({k: v.numpy() for k, v in ckpt.read_leaves(path, "optim")
                .items() if k.startswith(("m.", "v."))})
    return out


def _assert_leaves_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(SAVES))
def test_pieces_reassemble_to_the_saved_state(runs, name, tmp_path):
    path, meta = ckpt.tracked_checkpoint(runs["dirs"][name])
    assert meta["iteration"] == 2
    assert os.path.isdir(os.path.join(path, "model"))
    got = _file_leaves(path)
    _assert_leaves_equal(got, _state_leaves(runs["saved"][name]))
    # the same leaves as a whole-tensor save of that state
    st = runs["saved"][name]
    from megatron_llm_tpu_torch.optimizer.optimizer import OptimizerState

    t = R._t
    out = ckpt.save_checkpoint(str(tmp_path / "whole"), 2, t(st["params"]),
                               OptimizerState(step=torch.tensor(st["step"]),
                                              m=t(st["m"]), v=t(st["v"])))
    _assert_leaves_equal(got, _file_leaves(out))


def test_one_writer_per_piece(runs):
    path, _ = ckpt.tracked_checkpoint(runs["dirs"]["tp2-dp2"])
    ranks = {kind: sorted(os.listdir(os.path.join(path, kind)))
             for kind in ("model", "optim")}
    # the params: the two tp ranks of dp rank 0; the moments: all four
    assert ranks["model"] == ["rank00000.pt", "rank00001.pt"]
    assert len(ranks["optim"]) == 4
    assert sorted(os.listdir(os.path.join(path, ckpt.DONE_DIR))) == [
        f"rank{r:05d}" for r in range(4)]
    for kind in ("model", "optim"):
        pieces = ckpt.Pieces(path, kind)
        for name, parts in pieces.pieces.items():
            n = sum(t.numel() for _, t in parts)
            assert n == int(np.prod(pieces.shapes[name])), name


@pytest.mark.parametrize("src", list(SAVES) + ["whole", "jax"])
@pytest.mark.parametrize("lay", ["one"] + list(LOADS))
def test_loads_at_another_layout_bitwise(runs, src, lay):
    path, meta = ckpt.tracked_checkpoint(runs["dirs"][src])
    got = runs["one"][src] if lay == "one" else runs["loaded"][(src, lay)]
    assert got["iteration"] == meta["iteration"]
    _assert_leaves_equal(_state_leaves(got), _file_leaves(path))
    if src == "jax":
        _assert_leaves_equal(_flat(got["params"]), _flat(runs["jax"]))


def test_a_torn_save_is_skipped(runs, tmp_path):
    d = str(tmp_path / "torn")
    shutil.copytree(runs["dirs"]["tp2-dp2"], d)
    it2 = ckpt.checkpoint_dir(d, 2)
    os.remove(ckpt.marker_file(it2, 3))
    os.remove(os.path.join(it2, ckpt.COMPLETE_FILENAME))
    assert R.load_state({}, d)["iteration"] == 1
    assert R.load_state({}, runs["dirs"]["tp2-dp2"])["iteration"] == 2


def test_missing_markers_raise_and_leave_no_complete(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    mgr.marker_timeout_s = 0.3
    x = torch.arange(6.0).reshape(2, 3)
    mgr.save_pieces(5, {"w": (x, (0, 0), (4, 3))}, None, rank=0, world=2)
    with pytest.raises(RuntimeError, match="no marker from rank"):
        mgr.wait_until_finished()
    path = ckpt.checkpoint_dir(str(tmp_path), 5)
    assert not ckpt.is_checkpoint_complete(path)
    assert os.path.exists(ckpt.marker_file(path, 0))
    assert ckpt.read_tracker(str(tmp_path)) == (None, False)


def test_launcher_and_reshard_tool_read_the_pieces(runs, tmp_path):
    from megatron_llm_tpu_torch.tools import reshard_checkpoint

    src = runs["dirs"]["tp2-dp2"]
    path, _ = ckpt.tracked_checkpoint(src)
    want = _flat(runs["saved"]["tp2-dp2"]["params"])
    tmpl = LlamaModel(R.model_cfg(), device="cpu").abstract_params()
    got = _flat({k: v for k, v in ckpt.restore_params(
        path, tmpl, "cpu").items()})
    _assert_leaves_equal({k: v.numpy() if hasattr(v, "numpy") else v
                          for k, v in got.items()}, want)
    out = reshard_checkpoint.main([
        "--model_name", "llama2", "--num_layers", "4", "--hidden_size", "64",
        "--num_attention_heads", "8", "--num_attention_heads_kv", "2",
        "--ffn_hidden_size", "128", "--seq_length", str(R.SEQ),
        "--max_position_embeddings", str(R.SEQ), "--load", src,
        "--save", str(tmp_path / "release"), "--release"])
    _assert_leaves_equal({k: v.numpy() for k, v in
                          ckpt.read_leaves(out, "model").items()}, want)
