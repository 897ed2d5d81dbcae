"""PyTorch port, the checkpoint protocol (training/checkpointing.py).

The cases of tests/test_fault_tolerance.py's layout, torn-save, manager
and GC classes, on the port's torch.save format: the tracker is atomic
and COMPLETE certifies a save; `load_checkpoint` scans back past missing
sentinels, torn meta.json and truncated leaf files, prefers a newer
complete checkpoint over a stale tracker, raises on an architecture
mismatch, and loads an explicit iteration or raises; the async manager
restores bitwise, keeps one save in flight, and its retention never
deletes a protected checkpoint. Then the port's meta.json keys against
the JAX package's `_build_meta`, the architecture overlay of
--use_checkpoint_args, and the trainer's rollback with --no_save_optim.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.training.checkpointing import _build_meta as jax_meta
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer import init_optimizer_state
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training.checkpointing import (
    COMPLETE_FILENAME,
    TRACKER_FILENAME,
    CheckpointManager,
    checkpoint_dir,
    gc_checkpoints,
    is_checkpoint_complete,
    list_iteration_checkpoints,
    load_checkpoint,
    load_model_config_from_checkpoint,
    read_tracker,
    save_checkpoint,
)

torch.set_num_threads(1)


def _tiny(**kw):
    return tiny_config(seq_length=16, max_position_embeddings=16, **kw)


@pytest.fixture(scope="module")
def tiny_state():
    cfg = _tiny()
    params = LlamaModel(cfg, device="cpu").init(seed=0)
    opt = init_optimizer_state(params, TrainConfig())
    # non-trivial moments and step, so a mix-up of m and v shows
    for i, (m, v) in enumerate(zip(tree_leaves(opt.m), tree_leaves(opt.v))):
        m.normal_(generator=torch.Generator().manual_seed(i))
        v.uniform_(generator=torch.Generator().manual_seed(100 + i))
    opt.step.fill_(5)
    return cfg, params, opt


def _save3(d, cfg, params, opt):
    for it in (1, 2, 3):
        save_checkpoint(d, it, params, opt, cfg,
                        consumed_train_samples=10 * it)
    return d


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestCrashSafeLayout:
    def test_save_writes_sentinel_and_tracker(self, tmp_path, tiny_state):
        d = _save3(str(tmp_path), *tiny_state)
        assert read_tracker(d) == (3, False)
        for it in (1, 2, 3):
            path = checkpoint_dir(d, it)
            assert is_checkpoint_complete(path)
            assert sorted(os.listdir(path)) == [
                COMPLETE_FILENAME, "meta.json", "model", "optim"]

    def test_tracker_write_is_atomic(self, tmp_path, tiny_state):
        cfg, params, _ = tiny_state
        d = str(tmp_path)
        save_checkpoint(d, 5, params, None, cfg)
        assert read_tracker(d) == (5, False)
        assert not [f for f in os.listdir(d) if ".tmp." in f]
        with open(os.path.join(d, TRACKER_FILENAME + ".tmp.999"), "w") as f:
            f.write("99")
        assert read_tracker(d) == (5, False)
        assert "optim" not in os.listdir(checkpoint_dir(d, 5))

    def test_list_iteration_checkpoints_newest_first(self, tmp_path,
                                                     tiny_state):
        d = _save3(str(tmp_path), *tiny_state)
        os.makedirs(os.path.join(d, "iter_12"))  # not 7 digits: ignored
        assert [it for it, _ in list_iteration_checkpoints(d)] == [3, 2, 1]

    def test_leaf_files_are_flat_torch_dicts(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        path = save_checkpoint(str(tmp_path), 4, params, opt, cfg)
        model = torch.load(os.path.join(path, "model"), weights_only=True)
        optim = torch.load(os.path.join(path, "optim"), weights_only=True)
        assert "layers.attention.wqkv" in model and "lm_head" in model
        assert set(optim) == {"step"} | {f"{k}.{n}" for k in ("m", "v")
                                         for n in model}
        assert int(optim["step"]) == 5


class TestTornSaveRecovery:
    @pytest.fixture()
    def saved(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        return cfg, params, opt, _save3(str(tmp_path / "ck"), *tiny_state)

    def test_restores_bitwise(self, saved):
        cfg, params, opt, d = saved
        p2, o2, meta, it = load_checkpoint(d, params, opt, cfg)
        assert it == 3 and meta["consumed_train_samples"] == 30
        assert meta["loaded_path"] == checkpoint_dir(d, 3)
        _equal_trees(params, p2)
        _equal_trees(opt.m, o2.m)
        _equal_trees(opt.v, o2.v)
        assert int(o2.step) == 5
        # new tensors: the templates are untouched by later updates
        assert all(a.data_ptr() != b.data_ptr() for a, b in
                   zip(tree_leaves(params), tree_leaves(p2)))

    def test_missing_sentinel_falls_back(self, saved, capsys):
        cfg, params, opt, d = saved
        os.remove(os.path.join(checkpoint_dir(d, 3), COMPLETE_FILENAME))
        out = load_checkpoint(d, params, opt, cfg)
        assert out is not None and out[3] == 2
        cap = capsys.readouterr().out
        assert "skipping incomplete checkpoint" in cap
        assert "OLDER checkpoint" in cap

    def test_torn_meta_falls_back(self, saved, capsys):
        cfg, params, opt, d = saved
        os.remove(os.path.join(checkpoint_dir(d, 3), "meta.json"))
        out = load_checkpoint(d, params, opt, cfg)
        assert out is not None and out[3] == 2
        assert out[2]["consumed_train_samples"] == 20
        assert "unreadable" in capsys.readouterr().out

    @pytest.mark.parametrize("leaf_file", ["model", "optim"])
    def test_torn_leaves_fall_back(self, saved, capsys, leaf_file):
        cfg, params, opt, d = saved
        path = os.path.join(checkpoint_dir(d, 3), leaf_file)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        out = load_checkpoint(d, params, opt, cfg)
        assert out is not None and out[3] == 2
        assert "unreadable" in capsys.readouterr().out

    def test_wrong_leaf_shape_is_unreadable(self, saved, capsys):
        cfg, params, opt, d = saved
        path = os.path.join(checkpoint_dir(d, 3), "model")
        flat = torch.load(path, weights_only=True)
        flat["lm_head"] = flat["lm_head"][:, :7]
        torch.save(flat, path)
        out = load_checkpoint(d, params, opt, cfg)
        assert out[3] == 2
        assert "lm_head" in capsys.readouterr().out

    def test_stale_tracker_does_not_hide_newer_complete(self, saved,
                                                        capsys):
        cfg, params, opt, d = saved
        with open(os.path.join(d, TRACKER_FILENAME), "w") as f:
            f.write("2")
        out = load_checkpoint(d, params, opt, cfg)
        assert out is not None and out[3] == 3
        assert "OLDER" not in capsys.readouterr().out

    def test_tracker_names_missing_dir(self, saved):
        cfg, params, opt, d = saved
        with open(os.path.join(d, TRACKER_FILENAME), "w") as f:
            f.write("99")
        out = load_checkpoint(d, params, opt, cfg)
        assert out is not None and out[3] == 3

    def test_all_torn_returns_none_with_warning(self, saved, capsys):
        cfg, params, opt, d = saved
        for it in (1, 2, 3):
            os.remove(os.path.join(checkpoint_dir(d, it), "meta.json"))
        assert load_checkpoint(d, params, opt, cfg) is None
        assert "starting from scratch" in capsys.readouterr().out

    def test_no_checkpoint_returns_none(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        assert load_checkpoint(str(tmp_path / "empty"), params, opt,
                               cfg) is None

    def test_arch_mismatch_still_raises(self, saved):
        cfg, params, opt, d = saved
        with pytest.raises(ValueError, match="num_layers"):
            load_checkpoint(d, params, opt, _tiny(num_layers=3))

    def test_explicit_iteration_is_exempt_from_scan(self, saved):
        cfg, params, opt, d = saved
        os.remove(os.path.join(checkpoint_dir(d, 2), "meta.json"))
        with pytest.raises(FileNotFoundError):
            load_checkpoint(d, params, opt, cfg, iteration=2)
        assert load_checkpoint(d, params, opt, cfg, iteration=1)[3] == 1

    def test_finetune_and_no_load_optim(self, saved):
        cfg, params, opt, d = saved
        p2, o2, meta, it = load_checkpoint(d, params, opt, cfg,
                                           finetune=True)
        assert it == 0 and o2 is None and meta["rng_key"] is None
        _equal_trees(params, p2)
        p3, o3, _, it3 = load_checkpoint(d, params, opt, cfg,
                                         no_load_optim=True)
        assert it3 == 3 and o3 is None


class TestCheckpointManager:
    def test_async_save_restores_bitwise(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        d = str(tmp_path / "async")
        mgr = CheckpointManager(d)
        mgr.save(7, params, opt, cfg, consumed_train_samples=42)
        assert mgr.saves == 1 and mgr.last_blocked_ms >= 0.0
        mgr.wait_until_finished()
        assert mgr.last_commit_s > 0.0
        assert is_checkpoint_complete(checkpoint_dir(d, 7))
        assert read_tracker(d) == (7, False)
        p2, o2, meta, it = load_checkpoint(d, params, opt, cfg)
        assert it == 7 and meta["consumed_train_samples"] == 42
        _equal_trees(params, p2)
        _equal_trees(opt.m, o2.m)
        _equal_trees(opt.v, o2.v)

    def test_save_copies_before_returning(self, tmp_path, tiny_state):
        """The optimizer updates params in place right after save()
        returns: the checkpoint holds the values at the call."""
        cfg, params, _ = tiny_state
        live = {k: v.clone() if not isinstance(v, dict) else
                {kk: vv.clone() if not isinstance(vv, dict) else
                 {k3: v3.clone() for k3, v3 in vv.items()}
                 for kk, vv in v.items()} for k, v in params.items()}
        mgr = CheckpointManager(str(tmp_path / "c"))
        mgr.save(1, live, None, cfg)
        for leaf in tree_leaves(live):
            leaf.add_(1.0)
        mgr.wait_until_finished()
        p2 = load_checkpoint(str(tmp_path / "c"), params, None, cfg)[0]
        _equal_trees(params, p2)

    def test_single_inflight_back_to_back(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        d = str(tmp_path / "seq")
        mgr = CheckpointManager(d)
        mgr.save(1, params, opt, cfg)
        mgr.save(2, params, opt, cfg)  # waits for save 1 first
        assert is_checkpoint_complete(checkpoint_dir(d, 1))
        mgr.wait_until_finished()
        assert is_checkpoint_complete(checkpoint_dir(d, 2))
        assert read_tracker(d) == (2, False)

    def test_manager_gc_keep_latest_n(self, tmp_path, tiny_state):
        cfg, params, _ = tiny_state
        d = str(tmp_path / "gc")
        mgr = CheckpointManager(d, keep_latest_n=2)
        for it in (1, 2, 3, 4):
            mgr.save(it, params, None, cfg)
        mgr.wait_until_finished()
        assert [it for it, _ in list_iteration_checkpoints(d)] == [4, 3]
        assert read_tracker(d) == (4, False)

    def test_manager_gc_protects_read_checkpoint(self, tmp_path,
                                                 tiny_state):
        cfg, params, _ = tiny_state
        d = str(tmp_path / "prot")
        mgr = CheckpointManager(d, keep_latest_n=1)
        mgr.protect(checkpoint_dir(d, 1))
        for it in (1, 2, 3):
            mgr.save(it, params, None, cfg)
        mgr.wait_until_finished()
        assert [it for it, _ in list_iteration_checkpoints(d)] == [3, 1]

    def test_sync_mode_still_crash_safe(self, tmp_path, tiny_state):
        cfg, params, opt = tiny_state
        d = str(tmp_path / "sync")
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(9, params, opt, cfg)
        assert is_checkpoint_complete(checkpoint_dir(d, 9))
        assert read_tracker(d) == (9, False)

    def test_sync_mode_runs_retention_gc(self, tmp_path, tiny_state):
        cfg, params, _ = tiny_state
        d = str(tmp_path / "syncgc")
        mgr = CheckpointManager(d, keep_latest_n=2, async_save=False)
        for it in (1, 2, 3, 4):
            mgr.save(it, params, None, cfg)
        assert [it for it, _ in list_iteration_checkpoints(d)] == [4, 3]

    def test_failed_async_save_raises_at_wait(self, tmp_path, tiny_state):
        """The writer thread's failure surfaces at the next wait."""
        cfg, params, _ = tiny_state
        d = tmp_path / "fail"
        d.mkdir()
        (d / "iter_0000001").write_text("a file where the directory goes")
        mgr = CheckpointManager(str(d))
        mgr.save(1, params, None, cfg)
        with pytest.raises(RuntimeError, match="async checkpoint save "
                                               "failed"):
            mgr.wait_until_finished()
        assert read_tracker(str(d)) == (None, False)

    def test_resaving_an_iteration_rewrites_it(self, tmp_path, tiny_state):
        cfg, params, _ = tiny_state
        d = str(tmp_path / "again")
        save_checkpoint(d, 2, params, None, cfg, consumed_train_samples=1)
        save_checkpoint(d, 2, params, None, cfg, consumed_train_samples=9)
        assert is_checkpoint_complete(checkpoint_dir(d, 2))
        assert load_checkpoint(d, params, None, cfg)[2][
            "consumed_train_samples"] == 9


def test_gc_semantics(tmp_path, tiny_state):
    cfg, params, _ = tiny_state
    d = str(tmp_path / "g")
    for it in (1, 2, 3, 4):
        save_checkpoint(d, it, params, None, cfg)
    os.makedirs(checkpoint_dir(d, 5))  # an in-flight save, newer
    deleted = gc_checkpoints(d, 2, protect=[checkpoint_dir(d, 1)])
    assert sorted(deleted) == [checkpoint_dir(d, 2)]
    assert {it for it, _ in list_iteration_checkpoints(d)} == {1, 3, 4, 5}
    assert gc_checkpoints(d, 0) == [] and gc_checkpoints(d, None) == []


def test_meta_keys_equal_jax_build_meta(tmp_path, tiny_state):
    cfg, params, opt = tiny_state
    path = save_checkpoint(str(tmp_path), 3, params, opt, cfg,
                           scheduler_state={"num_steps": 3},
                           consumed_train_samples=12)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ref = jax_meta(3, jax_tiny_config(seq_length=16,
                                      max_position_embeddings=16,
                                      compute_dtype=jnp.float32),
                   {"num_steps": 3}, 12, None, None)
    assert set(meta) == set(ref)
    for k in ("iteration", "consumed_train_samples", "scheduler", "rng_key",
              "checkpoint_version"):
        assert meta[k] == ref[k], k
    shared = set(meta["config"]) & set(ref["config"])
    assert {"num_layers", "hidden_size", "padded_vocab_size"} <= shared
    for k in shared:
        if "dtype" not in k:
            assert meta["config"][k] == ref["config"][k], k


def test_use_checkpoint_args_overlays_architecture(tmp_path, tiny_state):
    cfg, params, _ = tiny_state
    save_checkpoint(str(tmp_path), 1, params, None, cfg)
    other = _tiny(num_layers=5, hidden_size=32, rope_theta=5.0)
    got = load_model_config_from_checkpoint(str(tmp_path), other)
    assert (got.num_layers, got.hidden_size, got.rope_theta) == (
        cfg.num_layers, cfg.hidden_size, cfg.rope_theta)
    assert load_model_config_from_checkpoint(str(tmp_path / "none"),
                                             other) is other


def test_rollback_with_no_save_optim(tmp_path, capsys):
    """--no_save_optim checkpoints have no optim file: a rollback
    restores params only and keeps the live optimizer state."""
    from megatron_llm_tpu_torch.training.trainer import Trainer, TrainState

    model = LlamaModel(_tiny(), device="cpu")
    tcfg = TrainConfig(micro_batch_size=2, global_batch_size=2, lr=1e-3,
                       no_save_optim=True, save=str(tmp_path / "ck"),
                       spike_rollback_patience=1)
    trainer = Trainer(model, tcfg, ParallelConfig())
    params = model.init(seed=0)
    opt = init_optimizer_state(params, tcfg)
    state = TrainState(params=params, opt_state=opt, iteration=7,
                       consumed_train_samples=14)
    trainer._save(state, blocking=True)
    state.iteration = 9
    assert trainer._rollback(state) is True
    assert state.iteration == 7 and state.consumed_train_samples == 14
    assert state.opt_state is opt
    assert all(p.requires_grad for p in tree_leaves(state.params))
    assert "unreadable" not in capsys.readouterr().out
    assert np.isfinite(trainer.timers.gauges()["ckpt_blocked_ms"])
