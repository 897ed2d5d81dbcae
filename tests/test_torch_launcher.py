"""PyTorch port, the serving entry path: the release checkpoint layout and
`tools/run_text_generation_server.py`, on the CPU in fp32.

- release save and load: the tracker and directory names of the JAX
  layout, weights only (no optimizer state, iteration 0, leaves in the
  template's dtype), retention never deletes `release`, and `finetune`
  loads one as `--finetune` does;
- the launcher's `main(..., device="cpu")` in a thread on a tiny release
  answers greedy, sampled, beam, score-only and SSE requests, and its
  greedy streams, beam scores and score log-probs equal those of the JAX
  `MegatronServer` + `DecodeEngine` built as the JAX launcher builds
  them (:296-361, :491-494) on the same weights (the JAX launcher itself
  cannot start: it passes `merge_file=` to a `build_tokenizer` that
  takes `merges_file`);
- every flag of a later slice raises naming its item; `main()` on its
  default device raises without a card;
- the CLI, started as a subprocess, answers a request.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import textwrap
import threading
from http.client import HTTPConnection

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama_config as jax_llama_config
from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.server import MegatronServer as JaxServer
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.optimizer.optimizer import init_optimizer_state
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs
from megatron_llm_tpu_torch.training import checkpointing as ck
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import tiny_pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_FLAGS = ["--serving_slots", "2", "--page_size", "16",
                "--max_context", "64", "--prefill_chunk_tokens", "8"]
TOKENIZER = ["--tokenizer_type", "NullTokenizer", "--null_vocab_size", "255"]


# ---------------------------------------------------------------------------
# the release layout
# ---------------------------------------------------------------------------


def _tiny_release(tmp_path, name="release_ckpt", dtype=None):
    _, _, tm, tp = tiny_pair()
    if dtype is not None:
        tp = ck.unflatten({k: v.to(dtype)
                           for k, v in ck.flatten(tp).items()})
    path = ck.save_checkpoint(str(tmp_path / name), 0, tp, model_cfg=tm.cfg,
                              release=True, extra_meta={"source": "test"})
    return str(tmp_path / name), path, tm, tp


def test_release_layout_equals_jax(tmp_path):
    save_dir, path, tm, tp = _tiny_release(tmp_path)
    jm, jp, _, _ = tiny_pair()
    jdir = str(tmp_path / "jax")
    jpath = jax_ckpt.save_checkpoint(jdir, 0, jp, release=True)
    assert os.path.basename(path) == os.path.basename(jpath) == "release"
    for d in (save_dir, jdir):
        with open(os.path.join(d, ck.TRACKER_FILENAME)) as f:
            assert f.read() == "release"
        assert ck.read_tracker(d) == jax_ckpt.read_tracker(d) == (None, True)
    assert sorted(os.listdir(save_dir)) == sorted(os.listdir(jdir))
    ours = set(os.listdir(path))
    assert ours == {"model", "meta.json", ck.COMPLETE_FILENAME}
    assert ours <= set(os.listdir(jpath))  # no optimizer state either way
    assert ck.checkpoint_dir(save_dir, 5, release=True) == \
        jax_ckpt.checkpoint_dir(save_dir, 5, release=True)


def test_release_loads_weights_only(tmp_path):
    """A bf16 release into an fp32 template with an optimizer template:
    the params cast exactly, no optimizer state, iteration 0, no rng."""
    save_dir, path, tm, tp = _tiny_release(tmp_path, dtype=torch.bfloat16)
    params = tm.init(seed=1)
    opt = init_optimizer_state(params, TrainConfig())
    got, opt_state, meta, it = ck.load_checkpoint(save_dir, params, opt,
                                                  tm.cfg)
    assert opt_state is None and it == 0 and meta["rng_key"] is None
    assert meta["loaded_path"] == path and meta["source"] == "test"
    for k, v in ck.flatten(got).items():
        assert v.dtype == torch.float32
        assert torch.equal(v, ck.flatten(tp)[k].to(torch.bfloat16).float())
    restored = ck.restore_params(path, tm.abstract_params(), "cpu")
    for k, v in ck.flatten(restored).items():
        assert torch.equal(v, ck.flatten(got)[k]), k
    assert ck.load_model_config_from_checkpoint(save_dir, tm.cfg) == tm.cfg


def test_retention_leaves_release_alone(tmp_path):
    save_dir, path, tm, tp = _tiny_release(tmp_path)
    for it in (1, 2, 3):
        ck.save_checkpoint(save_dir, it, tp)
    deleted = ck.gc_checkpoints(save_dir, 1)
    assert sorted(os.path.basename(p) for p in deleted) == [
        "iter_0000001", "iter_0000002"]
    assert os.path.isdir(path) and ck.is_checkpoint_complete(path)
    # the tracker now names iteration 3; a release tracker is rewritten
    # by a later release save
    assert ck.read_tracker(save_dir) == (3, False)


def test_trainer_takes_a_release_as_finetune_does(tmp_path):
    save_dir, _, tm, tp = _tiny_release(tmp_path)
    tr = Trainer(tm, TrainConfig(load=save_dir, train_iters=1),
                 ParallelConfig())
    state = tr.setup()
    assert state.iteration == 0 and state.consumed_train_samples == 0
    for k, v in ck.flatten(state.params).items():
        assert torch.equal(v.detach(), ck.flatten(tp)[k]), k


# ---------------------------------------------------------------------------
# the launcher against the JAX server and engine
# ---------------------------------------------------------------------------


def _fp32_llama_config(monkeypatch):
    inner = rtgs.llama_config
    monkeypatch.setattr(rtgs, "llama_config", lambda *a, **kw: inner(
        *a, compute_dtype=torch.float32, **kw))


class Launched:
    """The port's launcher running `main(argv, device="cpu")` in a
    thread."""

    def __init__(self, argv):
        box = queue.Queue()
        self.error = None

        def run():
            try:
                rtgs.main(argv, device="cpu", ready=box.put)
            except BaseException as e:  # noqa: BLE001 - reported below
                self.error = e
                box.put(None)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        self.launch = box.get(timeout=300)
        assert self.launch is not None, self.error
        self.port = self.launch.port

    def stop(self):
        self.launch.stop()
        self.thread.join(timeout=120)
        assert not self.thread.is_alive() and self.error is None


def _put(port, payload, timeout=300):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    if payload.get("stream"):
        return resp.status, [json.loads(line[6:]) for line in
                             data.splitlines() if line.startswith("data: ")]
    return resp.status, json.loads(data)


def _jax_server(save_dir):
    """The JAX server and engine as the JAX launcher builds them from the
    same checkpoint's meta (its tokenizer built with the keyword its
    `build_tokenizer` takes)."""
    jm, jp, _, _ = tiny_pair()
    with open(os.path.join(save_dir, "release", "meta.json")) as f:
        saved = json.load(f)["config"]
    common = {k: saved[k] for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "num_attention_heads_kv", "ffn_hidden_size", "seq_length",
        "max_position_embeddings", "padded_vocab_size", "rope_theta",
        "rope_scaling_factor", "layernorm_epsilon")}
    model = JaxLlama(jax_llama_config(7, vocab_size=saved["padded_vocab_size"],
                                      compute_dtype=jnp.float32, **common))
    tok = jax_tokenizer("NullTokenizer", null_vocab_size=255)
    engine = JaxEngine(
        model, jp, slots=2, page_size=16, max_context=64, page_budget=None,
        max_queue=64, step_horizon=8, prefill_chunk_tokens=8,
        warmup_compile=False, prefix_cache=True, spec_decode_k=0,
        kv_dtype="bf16", quantize_weights=False, serving_tp=1, devices=None,
        replica_id=None, termination_id=tok.eod, vocab_size=tok.vocab_size,
        trace_dir=None, record_dir=".", flight_recorder_size=4096,
        cost_registry=False, chip_spec=None, perf_sentinel_ksigma=0.0,
        perf_sentinel_window=64, perf_sentinel_patience=8)
    server = JaxServer(model, jp, tok, engine=engine,
                       request_deadline_s=None, stream_enabled=True)
    httpd = server.run("127.0.0.1", 0, block=False)
    return server, httpd.server_address[1]


def _prompts():
    rs = np.random.RandomState(21)
    return [" ".join(map(str, rs.randint(2, 255, n))) for n in (5, 13, 9)]


def _requests():
    p = _prompts()
    greedy = [{"prompts": [x], "tokens_to_generate": 7, "top_k": 1,
               "logprobs": True} for x in p]
    return greedy, {"prompts": p[:1], "tokens_to_generate": 6,
                    "beam_width": 2}, {"prompts": p[1:],
                                       "tokens_to_generate": 0,
                                       "logprobs": True}


def _serve_all(port):
    """The requests one at a time: (greedy answers, beam, score)."""
    greedy, beam, score = _requests()
    out = []
    for payload in greedy:
        status, body = _put(port, payload)
        assert status == 200, body
        out.append(body)
    status, b = _put(port, beam)
    assert status == 200, b
    status, s = _put(port, score)
    assert status == 200, s
    return out, b, s


def test_launcher_answers_as_the_jax_server(tmp_path, monkeypatch):
    save_dir, _, _, _ = _tiny_release(tmp_path)
    _fp32_llama_config(monkeypatch)
    launched = Launched(["--load", save_dir, "--host", "127.0.0.1",
                         "--port", "0", *TOKENIZER, *ENGINE_FLAGS])
    try:
        ours = _serve_all(launched.port)
        # a sampled request: status and shape only
        p = _prompts()[2]
        status, body = _put(launched.port, {
            "prompts": [p], "tokens_to_generate": 5, "top_p": 0.9,
            "random_seed": 3})
        assert status == 200 and len(body["text"]) == 1
        assert 9 < len(body["text"][0].split()) <= 14
        # SSE: one event per token, then the final text
        status, events = _put(launched.port, {
            "prompts": [p], "tokens_to_generate": 7, "top_k": 1,
            "stream": True})
        assert status == 200 and events[-1]["done"]
        toks = [e["token"] for e in events[:-1]]
        assert len(toks) == 7
        assert events[-1]["text"] == " ".join([p] + list(map(str, toks)))
        engine = launched.launch.server.engine
        assert engine.counters()["serve_admitted"] >= 5
    finally:
        launched.stop()
    # main returned and stopped its engine
    assert engine._thread is None

    jserver, jport = _jax_server(save_dir)
    try:
        ref = _serve_all(jport)
    finally:
        jserver.stop()
    for a, b in zip(ours[0], ref[0]):
        assert a["text"] == b["text"]
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], rtol=0,
                                   atol=1e-5)
    assert ours[1]["text"] == ref[1]["text"]
    np.testing.assert_allclose(ours[1]["scores"], ref[1]["scores"], rtol=0,
                               atol=1e-5)
    assert ours[2]["text"] == ref[2]["text"]
    np.testing.assert_allclose(ours[2]["logprobs"], ref[2]["logprobs"],
                               rtol=0, atol=1e-5)


def test_whole_batch_launcher_serves_a_finetune_checkpoint(tmp_path,
                                                           monkeypatch):
    """`--serving_slots 0` (no engine) on an iteration checkpoint with
    optimizer state, as `finetune` writes one: the greedy answer equals
    the engine launcher's on the same weights."""
    _, _, tm, tp = tiny_pair()
    save_dir = str(tmp_path / "trained")
    ck.save_checkpoint(save_dir, 4, tp, init_optimizer_state(
        tp, TrainConfig()), model_cfg=tm.cfg)
    _fp32_llama_config(monkeypatch)
    greedy = _requests()[0][0]
    answers = []
    for flags in (["--serving_slots", "0"], ENGINE_FLAGS):
        launched = Launched(["--load", save_dir, "--host", "127.0.0.1",
                             "--port", "0", *TOKENIZER, *flags])
        try:
            status, body = _put(launched.port, greedy)
            assert status == 200, body
            answers.append(body)
        finally:
            launched.stop()
    assert answers[0]["text"] == answers[1]["text"]
    # the whole-batch route pads its log-probs to the call's length
    n = len(answers[1]["text"][0].split()) - 1
    np.testing.assert_allclose(np.asarray(answers[0]["logprobs"])[:, :n],
                               answers[1]["logprobs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("flags,item", [
    ("--serving_tp 2", "A4"),
    ("--router_replicas 2", "A5"),
    ("--no-affinity_routing", "A5"),
    ("--prefill_replicas 1", "A5"),
    ("--ttft_slo_s 1.5", "A5"),
    ("--chaos kill=1@8", "A5"),
    ("--fleet_controller", "A5"),
    ("--recover_requests", "A5"),
    ("--scale_up_backlog_s 2", "A5"),
    ("--scale_down_backlog_s 1", "A5"),
    ("--scale_patience 5", "A5"),
    ("--trace_dir traces", "A5"),
    ("--cost_registry", "A5"),
    ("--chip_spec v5e", "A5"),
    ("--perf_sentinel_ksigma 6", "A5"),
    ("--perf_sentinel_window 32", "A5"),
    ("--perf_sentinel_patience 4", "A5"),
    ("--record_dir records", "A5"),
    ("--flight_recorder_size 128", "A5"),
])
def test_later_slice_flags_raise_by_item(flags, item):
    dest = flags.split()[0][2:].replace("no-", "")
    with pytest.raises(ValueError, match=rf"--{dest} .*ROADMAP\.md {item}"):
        rtgs.main(["--load", "no_such_dir", *flags.split()], device="cpu")


def test_main_on_its_default_device_needs_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rtgs.main(["--load", "no_such_dir"])


def test_cli_subprocess_answers(tmp_path):
    save_dir, _, _, _ = _tiny_release(tmp_path)
    script = textwrap.dedent("""
        import sys, torch
        torch.set_num_threads(1)
        from megatron_llm_tpu_torch.tools import run_text_generation_server
        run_text_generation_server.main(sys.argv[1:], device="cpu")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-c", script, "--load", save_dir, "--host",
         "127.0.0.1", "--port", "0", *TOKENIZER, *ENGINE_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving llama from"):
                break
        banner = lines[-1]
        assert "continuous batching: 2 slots" in banner, "".join(lines)
        port = int(banner.split("http://127.0.0.1:")[1].split("/")[0])
        status, body = _put(port, {"prompts": ["3 4 5"],
                                   "tokens_to_generate": 4, "top_k": 1})
        assert status == 200 and len(body["text"][0].split()) == 7
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, proc.stdout.read()
