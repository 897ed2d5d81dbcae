"""Checkpoint save and load (port of training/checkpointing.py).

The JAX package writes each tree with orbax, which imports JAX; the port
writes `torch.save` files of flat leaf dicts instead (leaf name, dotted
as in "layers.attention.wqkv", to tensor) inside the same directory
protocol:

    <save>/iter_0000100/{model,optim,meta.json,COMPLETE}
    <save>/latest_checkpointed_iteration.txt

A converter's output is the "release" layout (JAX :56-60, :216-238):
`<save>/release/{model,meta.json,COMPLETE}` with the tracker naming
"release", weights only. `load_checkpoint` reads it as `--finetune` does
(no optimizer state, iteration 0), restoring each leaf in the
template's dtype as orbax does in the JAX package.

- `model` holds the params; `optim` the optimizer's "step", its
  "m.<leaf>" and "v.<leaf>" moments and, under fp16 with the dynamic
  scaler, "scaler.scale", "scaler.growth_tracker" and
  "scaler.hysteresis_tracker" (JAX :202-203; no file under
  `--no_save_optim`); `meta.json` has the JAX package's keys, `rng_key`
  the trainer's dropout base seed (an integer; null without dropout,
  and null on a load under `--no_load_rng` or `--finetune`).
- The tracker is written atomically (a temporary file in the same
  directory, fsync, rename), and `COMPLETE` is written last, after every
  other file is fsynced: a torn save is a directory without it.
- `load_checkpoint` scans back past torn and unreadable directories to
  the newest complete one, warning for each; an architecture mismatch
  raises instead (a user error, not a torn save).
- `CheckpointManager.save` returns once the leaves are copied to host
  memory; a writer thread writes the files, `COMPLETE`, the tracker and
  runs the retention GC. One save is in flight at a time: a new save, and
  `wait_until_finished`, wait for it.
- `keep_latest_n` retention never deletes the checkpoint being written
  nor one a resume read (`protect`), nor `release`.
- The files hold whole tensors whatever the layout that wrote them, as
  the JAX package's orbax checkpoints do (tools/reshard_checkpoint.py
  :4-8): across ranks the trainer gathers every leaf, rank 0 writes, and
  a load gives each rank its slice (`shard`), so a tp2 x dp2 save
  resumes at tp1 x dp1 and the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Iterable, List, Optional, Tuple

import torch

from megatron_llm_tpu_torch.optimizer.optimizer import OptimizerState

TRACKER_FILENAME = "latest_checkpointed_iteration.txt"
COMPLETE_FILENAME = "COMPLETE"
_ITER_DIR_RE = re.compile(r"^iter_(\d{7})$")


def checkpoint_dir(save_dir: str, iteration: int,
                   release: bool = False) -> str:
    name = "release" if release else f"iter_{iteration:07d}"
    return os.path.join(save_dir, name)


def read_tracker(load_dir: str) -> Tuple[Optional[int], bool]:
    """(iteration, release) the tracker names; (None, False) without
    one, (None, True) for the converters' "release" layout."""
    path = os.path.join(load_dir, TRACKER_FILENAME)
    if not os.path.isfile(path):
        return None, False
    with open(path) as f:
        raw = f.read().strip()
    if raw == "release":
        return None, True
    return int(raw), False


def _atomic_write(path: str, data: str) -> None:
    """A temporary file in the same directory, fsync, rename: the file
    is the old one or the new one, never torn."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _write_tracker(save_dir: str, iteration: int,
                   release: bool = False) -> None:
    _atomic_write(os.path.join(save_dir, TRACKER_FILENAME),
                  "release" if release else str(iteration))


def _mark_complete(path: str) -> None:
    _atomic_write(os.path.join(path, COMPLETE_FILENAME), "1")


def is_checkpoint_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMPLETE_FILENAME))


def list_iteration_checkpoints(load_dir: str) -> List[Tuple[int, str]]:
    """(iteration, path) for every iter_* directory, newest first."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    out = []
    for name in names:
        m = _ITER_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(load_dir, name)):
            out.append((int(m.group(1)), os.path.join(load_dir, name)))
    out.sort(reverse=True)
    return out


def gc_checkpoints(save_dir: str, keep_latest_n: int,
                   protect: Iterable[str] = ()) -> List[str]:
    """Keep the newest `keep_latest_n` complete iteration checkpoints and
    delete every older iter_* directory, torn ones below that horizon
    included. Never touches `release`, the tracker, a directory newer
    than the horizon (a save in flight) or any path in `protect`.
    Returns the deleted paths."""
    if keep_latest_n is None or keep_latest_n < 1:
        return []
    protect = {os.path.abspath(p) for p in protect}
    complete = [(it, p) for it, p in list_iteration_checkpoints(save_dir)
                if is_checkpoint_complete(p)]
    if not complete:
        return []
    keep = {os.path.abspath(p) for _, p in complete[:keep_latest_n]}
    horizon = complete[min(keep_latest_n, len(complete)) - 1][0]
    deleted = []
    for it, p in list_iteration_checkpoints(save_dir):
        ap = os.path.abspath(p)
        if ap in keep or ap in protect or it >= horizon:
            continue
        try:
            shutil.rmtree(p)
            deleted.append(p)
        except OSError as e:
            print(f"WARNING: checkpoint GC could not delete {p}: {e}",
                  flush=True)
    return deleted


def _config_meta(model_cfg) -> dict:
    d = dataclasses.asdict(model_cfg)
    return {k: (v if isinstance(v, (int, float, bool, str, type(None),
                                    list, tuple)) else str(v))
            for k, v in d.items()}


class CheckpointArchMismatch(ValueError):
    """The checkpoint's architecture is not the config's. A type of its
    own so that the backward scan raises it instead of falling back."""


# the architecture fields a checkpoint must agree on with the config
_CRITICAL = (
    "num_layers", "hidden_size", "num_attention_heads",
    "num_attention_heads_kv", "ffn_hidden_size", "padded_vocab_size",
    "position_embedding_type", "glu_activation", "use_rms_norm",
    "use_bias", "tie_embed_logits", "parallel_attn", "parallel_layernorm",
)


def check_checkpoint_args(saved: dict, model_cfg) -> None:
    """Raise CheckpointArchMismatch where a critical field both the
    checkpoint and the config carry differs."""
    current = _config_meta(model_cfg)
    for k in _CRITICAL:
        if k in saved and k in current and saved[k] != current[k]:
            raise CheckpointArchMismatch(
                f"checkpoint/config mismatch for {k}: checkpoint has "
                f"{saved[k]!r}, config has {current[k]!r}")


def _build_meta(iteration, model_cfg, scheduler_state,
                consumed_train_samples, rng_key, extra_meta) -> dict:
    meta = {
        "iteration": iteration,
        "consumed_train_samples": consumed_train_samples,
        "scheduler": scheduler_state or {},
        "config": _config_meta(model_cfg) if model_cfg is not None else {},
        "rng_key": rng_key,
        "checkpoint_version": 3.0,
    }
    meta.update(extra_meta or {})
    return meta


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {dotted leaf name: leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """{dotted leaf name: leaf} -> nested dicts (the inverse of
    `flatten`)."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def unflatten_like(flat: dict, template: dict, prefix: str = "") -> dict:
    """The nested tree of `template`'s shape with `flat`'s leaves."""
    return {k: unflatten_like(flat, v, f"{prefix}{k}.")
            if isinstance(v, dict) else flat[f"{prefix}{k}"]
            for k, v in template.items()}


def _optim_flat(opt_state: OptimizerState) -> dict:
    flat = {"step": opt_state.step}
    flat.update(flatten(opt_state.m, "m."))
    if opt_state.v is not None:
        flat.update(flatten(opt_state.v, "v."))
    if opt_state.scaler:
        flat.update(flatten(opt_state.scaler, "scaler."))
    return flat


def _host_copy(flat: dict, buffers: dict, clone_cpu: bool = True) -> dict:
    """Copies of the leaves in host memory (reused pinned buffers for
    CUDA leaves), complete when this returns: the optimizer updates the
    live leaves in place. A blocking save passes `clone_cpu=False`: it
    writes CPU leaves before anything can update them."""
    out, on_card = {}, False
    for k, t in flat.items():
        t = t.detach()
        if t.device.type == "cpu":
            out[k] = t.clone() if clone_cpu else t
            continue
        buf = buffers.get(k)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buffers[k] = buf
        buf.copy_(t, non_blocking=True)
        out[k] = buf
        on_card = True
    if on_card:
        torch.cuda.synchronize()
    return out


def _save_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _write(path: str, model: dict, optim: Optional[dict],
           meta: dict) -> None:
    """Write one checkpoint directory from host leaves, COMPLETE last. A
    directory being written again loses its COMPLETE first."""
    os.makedirs(path, exist_ok=True)
    try:
        os.remove(os.path.join(path, COMPLETE_FILENAME))
    except FileNotFoundError:
        pass
    _save_file(model, os.path.join(path, "model"))
    if optim is not None:
        _save_file(optim, os.path.join(path, "optim"))
    _atomic_write(os.path.join(path, "meta.json"), json.dumps(meta, indent=1))
    _mark_complete(path)


def save_checkpoint(save_dir: str, iteration: int, params: dict,
                    opt_state: Optional[OptimizerState] = None,
                    model_cfg=None, scheduler_state: Optional[dict] = None,
                    consumed_train_samples: int = 0, rng_key=None,
                    extra_meta: Optional[dict] = None,
                    release: bool = False) -> str:
    """Blocking save: returns once the checkpoint is complete and the
    tracker names it. `release=True` writes the converters' layout:
    `release/`, named by the tracker, with the params only."""
    save_dir = os.path.abspath(save_dir)
    if release and opt_state is not None:
        raise ValueError("a release checkpoint holds weights only")
    path = checkpoint_dir(save_dir, iteration, release=release)
    buffers: dict = {}
    model = _host_copy(flatten(params), buffers, clone_cpu=False)
    optim = _host_copy(_optim_flat(opt_state), buffers, clone_cpu=False) \
        if opt_state is not None else None
    _write(path, model, optim,
           _build_meta(iteration, model_cfg, scheduler_state,
                       consumed_train_samples, rng_key, extra_meta))
    _write_tracker(save_dir, iteration, release=release)
    return path


class CheckpointManager:
    """Crash-safe checkpoint writer for one save directory.

    `save()` waits for the previous save, copies the leaves to host
    memory and returns; a writer thread writes the checkpoint, COMPLETE,
    the tracker and runs the retention GC. With `async_save=False` the
    same work runs before `save()` returns. `last_blocked_ms` is how
    long the last `save()` held its caller, `last_commit_s` how long the
    last save took from its call to COMPLETE. Call
    `wait_until_finished()` before the process exits."""

    def __init__(self, save_dir: str, keep_latest_n: Optional[int] = None,
                 async_save: bool = True):
        self.save_dir = os.path.abspath(save_dir)
        self.keep_latest_n = keep_latest_n
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._protected: set = set()
        self._buffers: dict = {}  # leaf name -> pinned host buffer
        self.last_blocked_ms: float = 0.0
        self.last_commit_s: float = 0.0
        self.saves: int = 0

    def protect(self, path: Optional[str]) -> None:
        if path:
            self._protected.add(os.path.abspath(path))

    def wait_until_finished(self) -> None:
        """Wait for the save in flight; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"previous async checkpoint save failed: {err!r}") from err

    def _commit(self, path, iteration, model, optim, meta, t0) -> None:
        _write(path, model, optim, meta)
        _write_tracker(self.save_dir, iteration)
        if self.keep_latest_n:
            gc_checkpoints(self.save_dir, self.keep_latest_n,
                           protect=self._protected | {path})
        self.last_commit_s = time.perf_counter() - t0

    def _commit_in_thread(self, *args) -> None:
        try:
            self._commit(*args)
        except Exception as e:  # noqa: BLE001 - raised by the next wait
            self._error = e

    def save(self, iteration: int, params: dict,
             opt_state: Optional[OptimizerState] = None, model_cfg=None,
             scheduler_state: Optional[dict] = None,
             consumed_train_samples: int = 0, rng_key=None,
             extra_meta: Optional[dict] = None, fresh: bool = False) -> str:
        """`fresh`: the leaves are host tensors nothing else holds (a
        gathered copy), written as they are."""
        t0 = time.perf_counter()
        self.wait_until_finished()
        os.makedirs(self.save_dir, exist_ok=True)
        path = checkpoint_dir(self.save_dir, iteration)
        model = _host_copy(flatten(params), self._buffers,
                           clone_cpu=not fresh)
        optim = _host_copy(_optim_flat(opt_state), self._buffers,
                           clone_cpu=not fresh) \
            if opt_state is not None else None
        meta = _build_meta(iteration, model_cfg, scheduler_state,
                           consumed_train_samples, rng_key, extra_meta)
        args = (path, iteration, model, optim, meta, t0)
        if self.async_save:
            self._writer = threading.Thread(
                target=self._commit_in_thread, args=args,
                name=f"ckpt-write-{iteration}")
            self._writer.start()
        else:
            self._commit(*args)
        self.last_blocked_ms = (time.perf_counter() - t0) * 1e3
        self.saves += 1
        return path


# the architecture fields --use_checkpoint_args takes from a checkpoint
_CHECKPOINT_ARCH_FIELDS = (
    "num_layers", "hidden_size", "num_attention_heads",
    "num_attention_heads_kv", "kv_channels", "ffn_hidden_size",
    "padded_vocab_size", "position_embedding_type", "glu_activation",
    "hidden_act", "use_rms_norm", "use_bias", "tie_embed_logits",
    "parallel_attn", "parallel_layernorm", "use_post_ln",
    "layernorm_epsilon", "rope_theta", "rope_scaling_factor",
    "max_position_embeddings", "num_tokentypes", "add_binary_head",
)


def load_model_config_from_checkpoint(load_dir: str, mcfg):
    """`mcfg` with the architecture fields of the checkpoint the tracker
    names (those the port's config has); unchanged without one."""
    iteration, release = read_tracker(load_dir)
    if iteration is None and not release:
        return mcfg
    meta_path = os.path.join(
        checkpoint_dir(load_dir, iteration or 0, release=release),
        "meta.json")
    if not os.path.exists(meta_path):
        return mcfg
    with open(meta_path) as f:
        saved = json.load(f).get("config", {})
    updates = {}
    for name in _CHECKPOINT_ARCH_FIELDS:
        if name not in saved or not hasattr(mcfg, name):
            continue
        val, cur = saved[name], getattr(mcfg, name)
        if not isinstance(val, (int, float, bool, str, type(None))):
            continue
        if val is None or cur is None:
            if val != cur:
                updates[name] = val
        elif val != cur:
            updates[name] = type(cur)(val)
    if updates:
        print(f" > using checkpoint args from {meta_path}: "
              f"{sorted(updates)}", flush=True)
        mcfg = dataclasses.replace(mcfg, **updates)
    return mcfg


def _load_candidates(load_dir: str):
    """(candidates newest first, the iteration a healthy directory would
    resume). Ordered by iteration, not tracker first: a crash between
    COMPLETE and the tracker write leaves the tracker one save behind.
    Directories without COMPLETE are skipped, unless none has one (a
    layout from before the sentinel). A tracker naming "release" puts
    the release directory first (JAX :452-457)."""
    tracker_iter, release = read_tracker(load_dir)
    iters = list_iteration_checkpoints(load_dir)
    any_sentinel = any(is_checkpoint_complete(p) for _, p in iters)
    out: List[Tuple[Optional[int], str, bool]] = []
    if release:
        out.append((None, checkpoint_dir(load_dir, 0, release=True), True))
    for it, path in iters:
        if any_sentinel and not is_checkpoint_complete(path):
            print(f"WARNING: skipping incomplete checkpoint {path} (no "
                  f"{COMPLETE_FILENAME} sentinel - torn save)", flush=True)
            continue
        out.append((it, path, False))
    newest = iters[0][0] if iters else None
    intended = max((x for x in (tracker_iter, newest) if x is not None),
                   default=None)
    return out, intended


def _restore_flat(path: str, template: dict, device,
                  cast: bool = False, shard=None) -> dict:
    """The leaves of the torch.save file `path`, checked against
    `template`'s names, shapes and dtypes, on `device`; with `cast` a
    leaf of another dtype is converted to the template's. `shard(name,
    leaf)` cuts each whole leaf to this rank's slice before it moves."""
    flat = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    if set(flat) != set(template):
        missing = sorted(set(template) - set(flat))[:4]
        extra = sorted(set(flat) - set(template))[:4]
        raise ValueError(f"{path}: leaves differ from the template "
                         f"(missing {missing}, unexpected {extra})")
    for k, t in template.items():
        if flat[k].shape != t.shape or (flat[k].dtype != t.dtype
                                        and not cast):
            raise ValueError(f"{path}: {k} is {flat[k].dtype} "
                             f"{tuple(flat[k].shape)}, the template "
                             f"{t.dtype} {tuple(t.shape)}")
    if shard is not None:
        flat = {k: shard(k, v).contiguous() for k, v in flat.items()}
    # one leaf at a time: an mmap-ed leaf is read, moved and cast alone
    return {k: v.to(device).to(template[k].dtype) for k, v in flat.items()}


def tracked_checkpoint(load_dir: str) -> Tuple[str, dict]:
    """(directory, meta) of the checkpoint the tracker in `load_dir`
    names, an iteration or a release, with no scan (the serving
    launcher's and the converters' read, JAX
    tools/run_text_generation_server.py:283-287)."""
    iteration, release = read_tracker(load_dir)
    if iteration is None and not release:
        raise FileNotFoundError(f"no {TRACKER_FILENAME} in {load_dir}")
    path = checkpoint_dir(os.path.abspath(load_dir), iteration or 0,
                          release=release)
    with open(os.path.join(path, "meta.json")) as f:
        return path, json.load(f)


def restore_params(path: str, params_template: dict, device) -> dict:
    """The params of checkpoint directory `path` on `device`, each leaf
    in the template's dtype; the template may be meta tensors
    (`GPTModel.abstract_params`). No optimizer state."""
    return unflatten_like(
        _restore_flat(os.path.join(path, "model"),
                      flatten(params_template), device, cast=True),
        params_template)


def _restore_one(path, release, params_template, opt_state_template,
                 model_cfg, finetune, no_load_optim, no_load_rng,
                 device=None, shard=None):
    """Restore one directory; raises on torn or unreadable files, and
    CheckpointArchMismatch past the caller's scan. A release holds the
    weights only, restored in the template's dtypes, and loads as
    `finetune` does (JAX :501-524)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if model_cfg is not None and meta.get("config"):
        check_checkpoint_args(meta["config"], model_cfg)
    flat_p = flatten(params_template)
    if device is None:
        device = next(iter(flat_p.values())).device
    params = unflatten_like(
        _restore_flat(os.path.join(path, "model"), flat_p, device,
                      cast=release, shard=shard),
        params_template)
    opt_state = None
    if opt_state_template is not None and not finetune \
            and not no_load_optim and not release:
        o = _restore_flat(os.path.join(path, "optim"),
                          _optim_flat(opt_state_template), device,
                          shard=shard)
        opt_state = OptimizerState(
            step=o["step"],
            m=unflatten_like(o, opt_state_template.m, "m."),
            v=unflatten_like(o, opt_state_template.v, "v.")
            if opt_state_template.v is not None else None,
            scaler=unflatten_like(o, opt_state_template.scaler, "scaler.")
            if opt_state_template.scaler else opt_state_template.scaler)
    # --finetune takes the weights only and starts at iteration 0
    out_iteration = 0 if (finetune or release) else meta["iteration"]
    if finetune or no_load_rng or release:
        meta = dict(meta)
        meta["rng_key"] = None
    return params, opt_state, meta, out_iteration


def load_checkpoint(load_dir: str, params_template: dict,
                    opt_state_template: Optional[OptimizerState] = None,
                    model_cfg=None, finetune: bool = False,
                    no_load_optim: bool = False, no_load_rng: bool = False,
                    iteration: Optional[int] = None, device=None,
                    shard=None):
    """(params, opt_state or None, meta, iteration) of the newest complete
    checkpoint in `load_dir`, on `device` (by default the templates';
    new tensors, the templates unchanged), `meta["loaded_path"]` naming
    the directory; None where there is none. Torn or unreadable
    directories are skipped with a warning; an explicit `iteration` is
    loaded or raises. The templates have the files' whole shapes (meta
    tensors will do); `shard(name, leaf)` gives a rank its slice of
    each leaf (leaf names as in the files: "layers.attention.wqkv",
    "m.<leaf>", "step")."""
    load_dir = os.path.abspath(load_dir)
    args = (params_template, opt_state_template, model_cfg, finetune,
            no_load_optim, no_load_rng, device, shard)
    if iteration is not None:
        path = checkpoint_dir(load_dir, iteration)
        out = _restore_one(path, False, *args)
        out[2]["loaded_path"] = path
        return out

    candidates, intended = _load_candidates(load_dir)
    if not candidates:
        return None
    for it, path, release in candidates:
        try:
            out = _restore_one(path, release, *args)
        except CheckpointArchMismatch:
            raise
        except Exception as e:  # noqa: BLE001 - any torn artifact
            print(f"WARNING: checkpoint at {path} is unreadable "
                  f"({type(e).__name__}: {e}); falling back to the "
                  f"previous complete checkpoint", flush=True)
            continue
        if it is not None and intended is not None and it < intended:
            print(f"WARNING: resumed from OLDER checkpoint {path} - the "
                  f"newer one(s) were torn or corrupt (a preemption "
                  f"mid-save?); training replays from iteration "
                  f"{out[3]}", flush=True)
        out[2]["loaded_path"] = path
        return out
    print(f"WARNING: no loadable checkpoint in {load_dir} "
          f"({len(candidates)} candidate(s), all torn/corrupt); starting "
          f"from scratch", flush=True)
    return None
