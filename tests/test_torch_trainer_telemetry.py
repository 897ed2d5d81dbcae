"""PyTorch port, the trainer's telemetry against the JAX package's on the
CPU.

Both packages' `Trainer`s run the tiny fp32 GQA Llama of
tests/torch_parity.py (the port on the JAX init, carried across by
`params_from_jax`) on the same seeded numpy batches for 6 steps of 2
microbatches, with an interval save at step 3 and an eval every 3 steps;
each package once with every telemetry flag off and once with every one
on (tensorboard with every log_* flag, WandB against a stub `wandb`
module, the profile window over step 5, the span tracer, flight records,
the cost registry, a chip spec and the perf sentinel armed):

(a) each package's telemetry-on run is bitwise its own telemetry-off run:
    losses and every parameter;
(b) the JAX trainer's `torch.utils.tensorboard` event file and the
    port's own hold the same (tag, step) pairs, read by the `tensorboard`
    package's EventAccumulator, except the memory gauges (the port logs
    the card's allocator and nothing on the CPU, where JAX logs the
    compiled step's bytes); loss scalars within 1e-5, wall-time scalars
    only present;
(c) both span traces hold the same span names, and the recorders' step
    events the same keys;
(d) a scripted rollback and a scripted SIGTERM each write their dump,
    which loads as JSON with the goodput snapshot;
(e) both ledgers classify the steps into the same sequence of buckets;
(f) an injected sustained stall trips the port's perf sentinel, which
    writes a perf-regression dump;
(g) the WandB shim logs every step to the stub `wandb` and the run facts
    into its config;
(h) the CPU profile window writes a Chrome trace file;
(i) the port's `train.step` FLOPs are held against the JAX registry's
    at one layer and one microbatch (see the test for what XLA counts and
    the port does not).
Plus a round trip of the port's own event writer through `read_events`
(CRCs checked, scalars and text) and `finetune.main` with the recipe's
tensorboard flags.
"""

import glob
import json
import os
import signal
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training import tensorboard as tb
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import jax_cfg, torch_cfg

SEQ = 32
STEPS = 6
MODEL = dict(use_flash_attn=True, use_fused_rmsnorm=True,
             remat_policy="full", seq_length=SEQ,
             max_position_embeddings=SEQ)
TRAIN = dict(micro_batch_size=2, global_batch_size=4, lr=1e-3,
             train_iters=STEPS, log_interval=1, eval_interval=3,
             eval_iters=1, save_interval=3, clip_grad=1.0,
             weight_decay=0.1, adam_beta2=0.95, adam_eps=1e-5,
             lr_warmup_iters=1, lr_decay_style="cosine", min_lr=1e-4,
             seed=11)
# every telemetry flag; the chip spec is each package's own row
TELEMETRY = dict(tensorboard_log_interval=1, tensorboard_queue_size=5,
                 log_timers_to_tensorboard=True,
                 log_validation_ppl_to_tensorboard=True,
                 log_memory_to_tensorboard=True,
                 log_world_size_to_tensorboard=True, wandb_logger=True,
                 wandb_project="telemetry-test", profile=True,
                 profile_step_start=4, profile_step_end=5,
                 flight_recorder_size=256, device_cost_registry=True,
                 perf_sentinel_ksigma=8.0, perf_sentinel_window=4,
                 perf_sentinel_patience=2)
# what each package logs of its memory under --log_memory_to_tensorboard:
# JAX the compiled step's bytes and the device's bytes in use, the port
# the card's allocator only (nothing on the CPU)
MEMORY_TAGS = {"compiled-temp-bytes", "compiled-args-bytes",
               "mem-bytes-in-use", "max-memory-allocated-bytes",
               "max-memory-reserved-bytes"}
# scalars that measure wall time: present in both, values not compared
WALL_TAGS = {"iteration-time", "goodput-fraction", "ckpt-blocked-ms"}


class _WandbRun:
    def __init__(self, **kw):
        self.init_kw = kw
        self.logged = []
        self.config = types.SimpleNamespace(updates=[])
        self.config.update = lambda d, allow_val_change=False: \
            self.config.updates.append(dict(d))

    def log(self, values, step=None):
        self.logged.append((step, dict(values)))


def _stub_wandb():
    mod = types.ModuleType("wandb")
    mod.runs = []

    def init(**kw):
        mod.runs.append(_WandbRun(**kw))
        return mod.runs[-1]
    mod.init = init
    return mod


def _batches():
    rs = np.random.RandomState(21)
    return [rs.randint(0, 256, (2, 2, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _valid():
    rs = np.random.RandomState(22)
    return [rs.randint(0, 256, (1, 2, SEQ + 1)).astype(np.int32)]


def _steps(trainer):
    return [e for e in trainer.recorder.snapshot()["events"]
            if e["kind"] == "step"]


def _run(package, tmp, on, init=None):
    """One 6-step run; `tmp` its own directory (saves, and with `on` its
    tensorboard, trace, flight-record and profile directories)."""
    kw = dict(TRAIN, save=os.path.join(tmp, "ckpt"))
    if on:
        kw.update(TELEMETRY, tensorboard_dir=os.path.join(tmp, "tb"),
                  trace_dir=os.path.join(tmp, "trace"),
                  flight_record_dir=os.path.join(tmp, "records"),
                  profile_dir=os.path.join(tmp, "profile"),
                  chip_spec="v5e" if package == "jax" else "h100")
    wandb = _stub_wandb()
    prev = sys.modules.get("wandb")
    sys.modules["wandb"] = wandb
    try:
        if package == "jax":
            trainer = JaxTrainer(
                JaxLlama(jax_cfg(**MODEL)), JaxTrainConfig(**kw),
                JaxParallelConfig(num_microbatches=2),
                train_data_iterator=iter(_batches()),
                valid_data_iterator=_valid())
            state = trainer.setup()
            init = jax.tree.map(np.asarray, state.params)
        else:
            model = LlamaModel(torch_cfg(**MODEL), device="cpu")
            trainer = Trainer(model, TrainConfig(**kw),
                              ParallelConfig(num_microbatches=2),
                              train_data_iterator=iter(_batches()),
                              valid_data_iterator=_valid())
            state = trainer.setup(params=params_from_jax(init, model.cfg,
                                                         device="cpu"))
        state = trainer.train(state)
    finally:
        if prev is None:
            sys.modules.pop("wandb")
        else:
            sys.modules["wandb"] = prev
    if package == "jax":
        params = [np.asarray(x) for x in jax.tree.leaves(state.params)]
    else:
        params = [x.detach().numpy().copy() for x in tree_leaves(state.params)]
    return dict(trainer=trainer, params=params, init=init, wandb=wandb,
                losses=[e["loss"] for e in _steps(trainer)], dir=tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for on in (False, True):
        tag = "on" if on else "off"
        j = _run("jax", str(tmp_path_factory.mktemp(f"jax_{tag}")), on)
        out["jax", on] = j
        out["port", on] = _run("port",
                               str(tmp_path_factory.mktemp(f"port_{tag}")),
                               on, init=j["init"])
    yield out
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_telemetry_on_is_bitwise_off(runs, package):
    off, on = runs[package, False], runs[package, True]
    assert len(on["losses"]) == STEPS
    assert on["losses"] == off["losses"]
    assert len(on["params"]) == len(off["params"]) >= 9
    for a, b in zip(on["params"], off["params"]):
        np.testing.assert_array_equal(a, b)


def test_a_port_losses_follow_jax(runs):
    """The two packages' runs themselves agree (fp32): 1e-5 relative."""
    for on in (False, True):
        np.testing.assert_allclose(runs["port", on]["losses"],
                                   runs["jax", on]["losses"], rtol=1e-5)


def _accumulate(path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    ea = EventAccumulator(path, size_guidance={"scalars": 0, "tensors": 0})
    ea.Reload()
    scalars = {t: {e.step: e.value for e in ea.Scalars(t)}
               for t in ea.Tags()["scalars"]}
    tensors = {t: {e.step for e in ea.Tensors(t)}
               for t in ea.Tags()["tensors"]}
    return scalars, tensors


def test_b_event_files_hold_the_jax_tags_and_losses(runs):
    js, jt = _accumulate(os.path.join(runs["jax", True]["dir"], "tb"))
    ps, pt = _accumulate(os.path.join(runs["port", True]["dir"], "tb"))

    def pairs(scalars, tensors):
        return ({(t, s) for t, v in scalars.items() for s in v}
                | {(t, s) for t, v in tensors.items() for s in v})

    jp, pp = pairs(js, jt), pairs(ps, pt)
    # the memory gauges are the one divergence: JAX logs them on its
    # CPU, the port only on a card
    assert {t for t, _ in jp} & MEMORY_TAGS
    assert not {t for t, _ in pp} & MEMORY_TAGS
    assert {(t, s) for t, s in jp if t not in MEMORY_TAGS} == pp
    assert {s for t, s in pp if t == "lm-loss"} == set(range(1, STEPS + 1))
    for tag in ("lm-loss", "lm-loss-validation", "lm-loss-validation-ppl",
                "learning-rate", "grad-norm", "batch-size"):
        for step, v in js[tag].items():
            assert ps[tag][step] == pytest.approx(v, rel=1e-5), (tag, step)
    assert [ps["lm-loss"][s] for s in range(1, STEPS + 1)] == \
        pytest.approx(runs["port", True]["losses"], rel=1e-7)
    for tag in WALL_TAGS:
        assert ps[tag] and js[tag]
    assert "remat-policy/text_summary" in pt


def test_c_same_span_names_and_step_event_keys(runs):
    def names(run):
        files = glob.glob(os.path.join(run["dir"], "trace",
                                       "trace_train_*.json"))
        assert len(files) == 1
        with open(files[0]) as f:
            doc = json.load(f)
        return doc, {e["name"] for e in doc["traceEvents"]
                     if e.get("ph") != "M"}

    jdoc, jnames = names(runs["jax", True])
    pdoc, pnames = names(runs["port", True])
    assert pnames == jnames
    assert {"train-step", "batch-generator", "save-checkpoint",
            "ckpt_blocked"} <= pnames
    steps = [e["args"]["step"] for e in pdoc["traceEvents"]
             if e["name"] == "train-step"]
    assert steps == list(range(1, STEPS + 1))
    for on in (False, True):
        jk = [set(e) for e in _steps(runs["jax", on]["trainer"])]
        pk = [set(e) for e in _steps(runs["port", on]["trainer"])]
        assert pk == jk and pk[0] == {"t", "kind", "step", "loss", "ms",
                                      "bucket"}
    # the tracer is opt-in; the recorder and the histogram are not
    off = runs["port", False]["trainer"]
    assert off.tracer.events() == [] and off._step_ms_hist.count == STEPS


def test_e_same_goodput_buckets(runs):
    for on in (False, True):
        jb = [e["bucket"] for e in _steps(runs["jax", on]["trainer"])]
        pb = [e["bucket"] for e in _steps(runs["port", on]["trainer"])]
        assert pb == jb == ["compile"] + ["productive"] * (STEPS - 1)
        snap = runs["port", on]["trainer"].ledger.snapshot()
        assert snap["overcount_s"] == 0.0
        assert abs(sum(snap["buckets"].values()) - snap["wall_s"]) < 1e-5
        assert snap["buckets"]["checkpoint"] > 0
        assert snap["productive_steps"] == STEPS - 1


def _merged(logged):
    """{step: every value logged at it} of a stub run's log calls (a
    validation flush logs its step a second time)."""
    out = {}
    for step, values in logged:
        out.setdefault(step, {}).update(values)
    return out


def test_g_wandb_shim_logs_to_the_stub(runs):
    for package in ("jax", "port"):
        wandb = runs[package, True]["wandb"]
        assert len(wandb.runs) == 1
        run = wandb.runs[0]
        assert run.init_kw["project"] == "telemetry-test"
        logged = _merged(run.logged)
        assert sorted(logged) == list(range(0, STEPS + 1))
        assert all("lm-loss" in logged[s] for s in range(1, STEPS + 1))
        assert "lm-loss-validation" in logged[3]
        assert run.config.updates[0]["remat-policy"] == "full"
        assert runs[package, False]["wandb"].runs == []
    pl = _merged(runs["port", True]["wandb"].runs[0].logged)
    jl = _merged(runs["jax", True]["wandb"].runs[0].logged)
    assert [pl[s]["lm-loss"] for s in range(1, STEPS + 1)] == \
        pytest.approx([jl[s]["lm-loss"] for s in range(1, STEPS + 1)],
                      rel=1e-5)


def test_h_cpu_profile_window_writes_a_trace(runs):
    trainer = runs["port", True]["trainer"]
    path = trainer.profile_path
    assert path and path.startswith(os.path.join(runs["port", True]["dir"],
                                                  "profile"))
    with open(path) as f:
        doc = json.load(f)
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::mm" for e in ops)
    kinds = [e["kind"] for e in trainer.recorder.snapshot()["events"]]
    # the window [4, 5) holds the 5th step alone
    i, j = kinds.index("profile_start"), kinds.index("profile_done")
    assert kinds[i:j].count("step") == 1


@pytest.mark.parametrize("remat", ["full", "none"])
def test_i_train_step_flops_against_the_jax_registry(runs, remat):
    """One step of each package with the registry on, at one layer and
    one microbatch. XLA's cost analysis counts a while loop's body once,
    and the JAX stack scans its layers and its microbatches: at the
    fixture's 2 layers x 2 microbatches its record is a quarter of the
    step's products (the port's count is 3.5x it there), so the two are
    held where nothing is looped. There XLA counts every operation of
    the compiled step: besides the products (and the remat recompute),
    the elementwise and reduction work (RMSNorm, SwiGLU, the softmax,
    the cross entropy, the clipping norm, Adam's update). The port counts
    torch.utils.flop_counter's formulas, products and attention library
    calls only, plus each kernel wrapper's own count for its launch on a
    card (none on the CPU, where the plain versions' products are
    counted as matmuls). So the port's count is below XLA's by the
    elementwise work: within [0.9, 1.0] of it (observed 0.942 under full
    recompute, 0.936 without)."""
    model_kw = dict(MODEL, remat_policy=remat, num_layers=1)
    tkw = dict(micro_batch_size=2, global_batch_size=2, lr=1e-3,
               train_iters=1, log_interval=100, eval_interval=0,
               device_cost_registry=True)
    batch = [np.random.RandomState(1).randint(0, 256, (1, 2, SEQ + 1))
             .astype(np.int32)]
    jt = JaxTrainer(JaxLlama(jax_cfg(**model_kw)),
                    JaxTrainConfig(**tkw, chip_spec="v5e"),
                    JaxParallelConfig(num_microbatches=1),
                    train_data_iterator=iter(batch))
    state = jt.setup()
    init = jax.tree.map(np.asarray, state.params)
    jt.train(state)
    model = LlamaModel(torch_cfg(**model_kw), device="cpu")
    pt = Trainer(model, TrainConfig(**tkw, chip_spec="h100"),
                 ParallelConfig(num_microbatches=1),
                 train_data_iterator=iter(batch))
    pt.train(pt.setup(params=params_from_jax(init, model.cfg,
                                             device="cpu")))
    ours = pt.costs.record("train.step", 1)
    ref = jt.costs.record("train.step", 1)
    assert 0.9 <= ours.flops / ref.flops <= 1.0, (ours.flops, ref.flops)
    assert ours.bytes_accessed > 0 and ours.arg_bytes > 0
    assert ours.launches == 0  # no kernel launch on the CPU
    # the fixture's run: the registry feeds the MFU and roofline gauges
    trainer = runs["port", True]["trainer"]
    assert trainer.costs.record("train.step", 2).flops > 3 * ours.flops
    gauges = trainer.timers.gauges()
    assert gauges["train_mfu_source"] == "registry"
    assert gauges["chip_spec"] == "h100:override"
    assert "train_step_hbm_frac" in gauges and "train_mfu_effective" in gauges
    assert "train_mfu" not in runs["port", False]["trainer"].timers.gauges()


# ---------------------------------------------------------------------------
# the dumps and the sentinel: the port alone
# ---------------------------------------------------------------------------


class _PoisonLossModel:
    """A microbatch whose tokens[0, 0] == 255 gets NaN added to its
    loss."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def loss(self, params, **kw):
        base = self._inner.loss(params, **kw)
        poison = kw["tokens"][0, 0] == 255
        return base + torch.where(poison, float("nan"), 0.0)


def _small_run(tmp_path, steps, wrap=None, model=None, batches=None, **kw):
    model = model or LlamaModel(tiny_config(
        seq_length=16, max_position_embeddings=16), device="cpu")
    rs = np.random.RandomState(0)
    batches = batches or [rs.randint(0, 200, (1, 2, 17)).astype(np.int32)
                          for _ in range(steps)]
    tcfg = TrainConfig(micro_batch_size=2, global_batch_size=2, lr=1e-3,
                       train_iters=steps, log_interval=100,
                       eval_interval=0, save=str(tmp_path / "ck"), **kw)
    trainer = Trainer(model, tcfg, ParallelConfig(),
                      train_data_iterator=batches)
    if wrap is not None:
        inner = trainer.train_step
        trainer.train_step = lambda state, text, *a: wrap(inner, state,
                                                           text, *a)
    state = trainer.train(trainer.setup())
    return trainer, state


def _dump(directory, reason):
    files = glob.glob(os.path.join(directory,
                                   f"flight_record_{reason}_*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)


def test_d_rollback_and_sigterm_dumps(tmp_path):
    rs = np.random.RandomState(0)
    batches = []
    for i in range(12):
        t = rs.randint(0, 200, size=(1, 2, 17))
        if i in (6, 7):  # iterations 7 and 8
            t[0, 0, 0] = 255
        batches.append(t.astype(np.int32))
    model = _PoisonLossModel(LlamaModel(tiny_config(
        seq_length=16, max_position_embeddings=16), device="cpu"))
    rec = tmp_path / "records"
    trainer, _ = _small_run(tmp_path / "roll", 10, model=model,
                            batches=batches, save_interval=5,
                            spike_rollback_patience=2,
                            flight_record_dir=str(rec))
    assert trainer.watchdog.rollbacks == 1
    doc = _dump(rec, "watchdog-rollback")
    assert doc["reason"] == "watchdog-rollback"
    assert doc["extra"]["restored_step"] == 5
    assert doc["extra"]["poison_window"] == 3
    assert set(doc["extra"]["goodput"]["buckets"]) >= {"productive",
                                                       "watchdog"}
    assert doc["extra"]["goodput"]["buckets"]["watchdog"] > 0
    assert [e["step"] for e in doc["events"]
            if e["kind"] == "watchdog_bad"] == [7, 8]

    def kill_at_3(inner, state, text, *a):
        stats = inner(state, text, *a)
        if state.iteration == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return stats

    prev = signal.getsignal(signal.SIGTERM)
    try:
        trainer, state = _small_run(tmp_path / "kill", 8, wrap=kill_at_3,
                                    exit_signal_handler=True,
                                    device_cost_registry=True)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert state.iteration == 3
    # no --flight_record_dir: the dump lands in the --save dir
    doc = _dump(tmp_path / "kill" / "ck", "sigterm")
    assert doc["extra"]["step"] == 3
    assert doc["extra"]["consumed_train_samples"] == 6
    assert doc["extra"]["goodput"]["productive_steps"] == 2
    assert doc["extra"]["costs"]["records"][0]["contract"] == "train.step"
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds.index("sigterm") < kinds.index("ckpt_certified")


def test_f_sustained_stall_trips_the_sentinel(tmp_path, monkeypatch):
    """The loop's step clock (`time.time` in the trainer) reads 5 ms a
    step, so the sentinel's baseline is flat whatever the machine's
    load; from step 14 on each step also stalls 0.4 s (slept, and on
    that clock)."""
    from megatron_llm_tpu_torch.training import trainer as trainer_mod

    stall_from = 14
    clock = [1000.0]

    def step_clock():
        clock[0] += 0.005
        return clock[0]

    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        time=step_clock, perf_counter=time.perf_counter))

    def stall(inner, state, text, *a):
        stats = inner(state, text, *a)
        if state.iteration >= stall_from:
            time.sleep(0.4)
            clock[0] += 0.4
        return stats

    trainer, _ = _small_run(tmp_path, 18, wrap=stall,
                            perf_sentinel_ksigma=8.0,
                            perf_sentinel_window=8,
                            perf_sentinel_patience=2,
                            flight_record_dir=str(tmp_path / "records"))
    assert trainer.sentinel.trips == 1
    doc = _dump(tmp_path / "records", "perf-regression")
    # patience 2: the second stalled step trips it
    assert doc["extra"]["step"] == stall_from + 1
    assert doc["extra"]["step_ms"] > doc["extra"]["threshold_ms"]
    assert doc["extra"]["goodput"]["productive_steps"] >= stall_from
    assert any(e["kind"] == "perf_regression.train_step_ms"
               for e in doc["events"])
    assert trainer.timers.gauges()["perf_sentinel_trips"] == \
        trainer.sentinel.trips


# ---------------------------------------------------------------------------
# the event writer, and the recipe's flags through finetune.main
# ---------------------------------------------------------------------------


def test_event_writer_round_trip_and_crc(tmp_path):
    w = tb.SummaryWriter(str(tmp_path), max_queue=2)
    w.add_scalar("lm-loss", 2.5, 1)
    w.add_scalar("lm-loss", -0.125, 2)
    w.add_text("remat-policy", "full × selective", 0)
    w.add_scalar("big-step", 7.0, 2 ** 40)
    w.close()
    events = tb.read_events(w.path)
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], e["values"][0]) for e in events[1:]]
    assert got[0] == (1, {"tag": "lm-loss", "simple_value": 2.5})
    assert got[1] == (2, {"tag": "lm-loss", "simple_value": -0.125})
    assert got[2][0] == 0 and got[2][1]["text"] == "full × selective"
    assert got[2][1]["tag"] == "remat-policy/text_summary"
    assert got[2][1]["plugin_name"] == "text"
    assert got[3] == (2 ** 40, {"tag": "big-step", "simple_value": 7.0})
    assert tb.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value
    # the tensorboard package reads the same file
    scalars, tensors = _accumulate(str(tmp_path))
    assert scalars["lm-loss"] == {1: 2.5, 2: -0.125}
    assert tensors == {"remat-policy/text_summary": {0}}
    # one flipped bit in a payload, then in a length: both refused
    data = bytearray(open(w.path, "rb").read())
    for at in (len(data) - 6, 2):
        bad = bytearray(data)
        bad[at] ^= 0x10
        p = tmp_path / f"bad_{at}"
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match="CRC mismatch"):
            tb.read_events(str(p))


def _corpus(tmp_path, seed=2):
    from megatron_llm_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )

    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / "corpus")
    b = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(200):
        b.add_item(np.append(rs.randint(0, 255, rs.randint(4, 60)), 255))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


TINY_ARGV = ("--model_name llama2 --num_layers 2 --hidden_size 64 "
             "--num_attention_heads 4 --num_attention_heads_kv 2 "
             "--ffn_hidden_size 128 --seq_length 32 --micro_batch_size 2 "
             "--global_batch_size 4 --lr 1e-3 --tokenizer_type "
             "NullTokenizer --null_vocab_size 255 --split 98,2,0 "
             "--train_iters 4 --eval_interval 1000 --log_interval 1")


def test_ranks_rank0_writes_events_each_rank_its_trace(tmp_path):
    """`finetune.main` in two gloo CPU ranks (dp 2, ZeRO-1): one event
    file, rank 0's, with every step's loss and the ZeRO-1 run facts at
    step 0; one span trace per rank, the rank in its name."""
    import torch_ranks
    from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

    tbdir, trdir = tmp_path / "tb", tmp_path / "trace"
    argv = (f"{TINY_ARGV} --micro_batch_size 1 --data_parallel_size 2 "
            f"--use_distributed_optimizer --data_path {_corpus(tmp_path)} "
            f"--tensorboard_dir {tbdir} --trace_dir {trdir}").split()
    ranks = spawn_cpu_group(2, torch_ranks.finetune_runs, [argv],
                            timeout_s=240)
    assert [r["runs"][0]["iteration"] for r in ranks] == [4, 4]
    assert len(list(tbdir.iterdir())) == 1
    scalars, tensors = _accumulate(str(tbdir))
    losses = {it: loss for it, loss, *_ in ranks[0]["runs"][0]["steps"]}
    assert scalars["lm-loss"] == pytest.approx(losses, rel=1e-7)
    # the run facts: this rank's moments (half of each 2-D leaf's) and
    # the gradient buckets of the step's plan
    assert scalars["opt-state-bytes-device"][0] > 0
    assert scalars["grad-rs-buckets"][0] >= 1
    assert scalars["grad-comm-bytes-step"][0] > 0
    assert {"zero1-path/text_summary", "remat-policy/text_summary",
            "grad-rs-bucket-bytes/text_summary"} <= set(tensors)
    for r in (0, 1):
        files = glob.glob(str(trdir / f"trace_train_rank{r}_*.json"))
        assert len(files) == 1
        with open(files[0]) as f:
            doc = json.load(f)
        assert [e["args"]["step"] for e in doc["traceEvents"]
                if e["name"] == "train-step"] == [1, 2, 3, 4]
    assert len(list(trdir.iterdir())) == 2


def test_finetune_takes_the_recipes_tensorboard_flags(tmp_path):
    """`finetune.main` on the CPU with examples/finetune.sh's
    `--tensorboard_dir ... --log_timers_to_tensorboard` (tiny widths):
    an event file with lm-loss and iteration-time at every step."""
    from megatron_llm_tpu_torch import finetune

    tbdir = str(tmp_path / "tb")
    argv = (f"{TINY_ARGV} --use_flash_attn --recompute_granularity "
            f"selective --bf16 --data_path {_corpus(tmp_path)} "
            f"--tensorboard_dir {tbdir} --log_timers_to_tensorboard").split()
    state = finetune.main(argv, device="cpu")
    assert state.iteration == 4
    scalars, _ = _accumulate(tbdir)
    assert sorted(scalars["lm-loss"]) == [1, 2, 3, 4]
    assert sorted(scalars["iteration-time"]) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in scalars["lm-loss"].values())
