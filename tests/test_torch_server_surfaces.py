"""PyTorch port, the server's telemetry and fleet surfaces against the JAX
server's, over real HTTP on the CPU (inference/server.py, the launcher's
fleet flags):

- GET / serves the JAX page's bytes; the Prometheus /metrics of the same
  engine traffic has the JAX exposition's metric names, labels, bucket
  bounds and counts, and parses back through `histograms_from_prometheus`;
  GET /flight_record has the JAX schema (keys, event kinds and each
  kind's fields); POST /profile validates as JAX's does and writes a
  trace here on the CPU;
- a `ReplicaRouter` behind the server: aggregated /metrics, /health, the
  "replica-rid" SSE id, /memory listing each replica's device;
- the launcher at `--router_replicas 2 --prefill_replicas 1` on a tiny
  release answers as the single-engine launcher does.
"""

import json
import time
from http.client import HTTPConnection

import numpy as np
import pytest

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.server import MegatronServer as JaxServer
from megatron_llm_tpu.telemetry import parse_prometheus as jax_parse
from megatron_llm_tpu.tokenizer.tokenizer import _NullTokenizer as JaxNull
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.inference.router import (
    EngineReplica,
    ReplicaRouter,
)
from megatron_llm_tpu_torch.inference.server import MegatronServer
from megatron_llm_tpu_torch.telemetry import (
    histograms_from_prometheus,
    parse_prometheus,
)
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from test_torch_launcher import (
    ENGINE_FLAGS,
    TOKENIZER,
    Launched,
    _fp32_llama_config,
    _tiny_release,
)
from torch_parity import tiny_pair

KW = dict(slots=2, page_size=16, max_context=64, max_queue=8,
          prefill_chunk_tokens=8, prefix_cache=True, termination_id=255,
          vocab_size=256)
PROMPTS = ["5 9 13 200 7", "100 3 4 5 6 7 8 9 10 11 12 13 14 15 16 17 18",
           "8 8 8 1 2 3 4 250"]


def _request(port, method, path, payload=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    body = None if payload is None else (
        payload if isinstance(payload, str) else json.dumps(payload))
    conn.request(method, path, body, {"Content-Type": "application/json",
                                      **(headers or {})})
    resp = conn.getresponse()
    data = resp.read().decode()
    ctype = resp.getheader("Content-Type")
    conn.close()
    return resp.status, data, ctype


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port server, each with its engine on shared weights,
    after the same traffic (one request at a time)."""
    jm, jp, tm, tp = tiny_pair()
    servers = [
        JaxServer(jm, jp, JaxNull(255), engine=JaxEngine(jm, jp, **KW)),
        MegatronServer(tm, tp, build_tokenizer("NullTokenizer",
                                               null_vocab_size=255),
                       engine=DecodeEngine(tm, tp, **KW))]
    ports = []
    for srv in servers:
        srv.run("127.0.0.1", 0, block=False)
        ports.append(srv._httpd.server_address[1])
    for p in PROMPTS:
        for port in ports:
            assert _request(port, "PUT", "/api", {
                "prompts": [p], "tokens_to_generate": 5,
                "top_k": 1})[0] == 200
    yield ports
    for srv in servers:
        srv.stop()


def test_index_page_equals_jax(pair):
    (js, jbody, jtype), (ps, pbody, ptype) = (
        _request(port, "GET", "/index.html") for port in pair)
    assert js == ps == 200 and pbody == jbody and ptype == jtype


# the counters whose values depend on wall time
TIMED = ("serve_tok_s", "serve_ttft_p50_ms", "serve_ttft_p95_ms",
         "serve_decode_p95_ms")


@pytest.mark.parametrize("how", [
    ("/metrics?format=prometheus", {}),
    ("/metrics", {"Accept": "text/plain"}),
    ("/metrics", {"Accept": "application/openmetrics-text, */*"}),
])
def test_prometheus_exposition_equals_jax(pair, how):
    path, headers = how
    (js, jtext, jtype), (ps, ptext, ptype) = (
        _request(port, "GET", path, headers=headers) for port in pair)
    assert js == ps == 200 and ptype == jtype
    ref, got = jax_parse(jtext), parse_prometheus(ptext)
    assert got.keys() == ref.keys()
    for name in got:
        assert got[name].keys() == ref[name].keys(), name
        timed = name.startswith(TIMED) or "_ms_" in name
        if not timed:
            assert got[name] == ref[name], name
    hists = histograms_from_prometheus(ptext)
    assert [(h.name, h.bounds) for h in hists] == [
        ("serve_ttft_ms", h.bounds) for h in hists[:1]] + [
        (h.name, h.bounds) for h in hists[1:]]
    counts = {h.name: h.count for h in hists}
    assert counts["serve_ttft_ms"] == counts["serve_queue_wait_ms"] \
        == len(PROMPTS)
    # the JSON default stays the counters
    (_, jbody, _), (_, pbody, _) = (_request(port, "GET", "/metrics")
                                    for port in pair)
    assert list(json.loads(pbody)) == list(json.loads(jbody))


def test_flight_record_schema_equals_jax(pair):
    (js, jbody, _), (ps, pbody, _) = (
        _request(port, "GET", "/flight_record") for port in pair)
    assert js == ps == 200
    ref, got = json.loads(jbody), json.loads(pbody)
    assert got.keys() == ref.keys()
    assert got["reason"] == ref["reason"] == "on-demand"
    assert list(got["counters"]) == list(ref["counters"])
    kinds = [e["kind"] for e in got["events"]]
    assert kinds == [e["kind"] for e in ref["events"]]
    for a, b in zip(got["events"], ref["events"]):
        assert a.keys() == b.keys(), a["kind"]
        assert a.get("rid") == b.get("rid")


@pytest.mark.parametrize("body,status", [
    ("not json", 400), ("[1]", 400), ({"rounds": 0}, 400),
    ({"rounds": "2"}, 400)])
def test_profile_validation_equals_jax(pair, body, status):
    (js, jbody, _), (ps, pbody, _) = (
        _request(port, "POST", "/profile", body) for port in pair)
    assert js == ps == status and json.loads(pbody) == json.loads(jbody)


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    """POST /profile {"rounds": 2}: the next two rounds that do work run
    under torch.profiler and its Chrome trace is written; a second
    request while one is armed is a 409."""
    _, _, tm, tp = tiny_pair()
    srv = MegatronServer(tm, tp, build_tokenizer(
        "NullTokenizer", null_vocab_size=255),
        engine=DecodeEngine(tm, tp, **KW))
    srv.run("127.0.0.1", 0, block=False)
    port = srv._httpd.server_address[1]
    try:
        status, body, _ = _request(port, "POST", "/profile", {
            "rounds": 2, "trace_dir": str(tmp_path)})
        assert status == 200 and json.loads(body) == {
            "ok": True, "rounds": 2, "trace_dir": str(tmp_path)}
        assert _request(port, "POST", "/profile", {"rounds": 1})[0] == 409
        assert _request(port, "PUT", "/api", {
            "prompts": [PROMPTS[1]], "tokens_to_generate": 4})[0] == 200
        deadline = time.monotonic() + 30
        while not list(tmp_path.glob("profile_engine_*.json")):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        (path,) = tmp_path.glob("profile_engine_*.json")
        trace = json.loads(path.read_text())
        assert any("aten::" in e.get("name", "")
                   for e in trace["traceEvents"])
        kinds = [e["kind"] for e in srv.engine.flight_record()["events"]]
        assert {"profile_armed", "profile_start", "profile_done"} <= set(
            kinds)
    finally:
        srv.stop()


def test_router_behind_the_server(tmp_path):
    """`MegatronServer(engine=router)`: the fleet's aggregated /metrics
    (and its Prometheus form), /health, /memory per replica, /profile
    on replica 0, and SSE ids tagged "replica-rid"."""
    _, _, tm, tp = tiny_pair()
    router = ReplicaRouter([EngineReplica(DecodeEngine(
        tm, tp, replica_id=i, **KW)) for i in range(2)])
    srv = MegatronServer(tm, tp, build_tokenizer(
        "NullTokenizer", null_vocab_size=255), engine=router)
    srv.run("127.0.0.1", 0, block=False)
    port = srv._httpd.server_address[1]
    try:
        conn = HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("PUT", "/api", json.dumps({
            "prompts": [PROMPTS[0]], "tokens_to_generate": 3,
            "stream": True}), {"Content-Type": "application/json"})
        data = conn.getresponse().read().decode()
        conn.close()
        ids = [ln[4:] for ln in data.splitlines() if ln.startswith("id: ")]
        assert ids and len(set(ids)) == 1 and ids[0] == "0-0"
        status, body, _ = _request(port, "GET", "/metrics")
        c = json.loads(body)
        assert status == 200 and c["router_replicas"] == 2
        assert c["serve_admitted"] == 1 and set(c["replicas"]) == {"0",
                                                                   "1"}
        status, text, _ = _request(port, "GET",
                                   "/metrics?format=prometheus")
        assert status == 200
        assert {h.name: h.count for h in histograms_from_prometheus(text)}[
            "serve_ttft_ms"] == 1
        status, body, _ = _request(port, "GET", "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body, _ = _request(port, "GET", "/memory")
        assert status == 200 and [d["device"] for d in json.loads(body)[
            "devices"]] == ["cpu"]
        status, body, _ = _request(port, "POST", "/profile", {
            "rounds": 1, "trace_dir": str(tmp_path)})
        assert status == 200 and json.loads(body)["ok"]
    finally:
        srv.stop()


def _long_prompts():
    rs = np.random.RandomState(8)
    shared = " ".join(str(x) for x in rs.randint(2, 250, 36))
    return [shared + " " + " ".join(str(x) for x in rs.randint(2, 250, n))
            for n in (2, 5)] + [PROMPTS[0]]


def test_disaggregated_launcher_answers_as_one_engine(tmp_path, monkeypatch):
    """The launcher at `--router_replicas 2 --prefill_replicas 1` on a
    tiny release (fp32): greedy answers and log-probs equal to the
    single-engine launcher's; the long prompts (two full pages) take the
    two-stage route and hand their pages off."""
    save_dir, _, _, _ = _tiny_release(tmp_path)
    _fp32_llama_config(monkeypatch)
    payloads = [{"prompts": [p], "tokens_to_generate": 6, "top_k": 1}
                for p in _long_prompts()]
    answers, stats = [], None
    for flags in ([], ["--router_replicas", "2", "--prefill_replicas", "1",
                       "--cost_registry", "--chip_spec", "h100"]):
        launched = Launched(["--load", save_dir, "--host", "127.0.0.1",
                             "--port", "0", *TOKENIZER, *ENGINE_FLAGS,
                             *flags])
        try:
            got = []
            for p in payloads:
                status, body, _ = _request(launched.port, "PUT", "/api", p)
                assert status == 200, body
                got.append(json.loads(body)["text"])
            answers.append(got)
            if flags:
                stats = json.loads(_request(launched.port, "GET",
                                            "/metrics")[1])
        finally:
            launched.stop()
    assert answers[0] == answers[1]
    assert stats["router_prefill_replicas"] == 1
    assert stats["serve_prefill_replica"] == 2
    assert stats["serve_transfer_pages"] == 4
    assert stats["replicas"]["1"]["serve_transfers_in"] == 2


def test_unavailable_fleet_is_a_503_with_the_modeled_retry_after():
    """Every replica broken: the router's FleetUnavailable (a QueueFull)
    answers 503 with the fleet's Retry-After (the soonest replica's
    modeled drain, clamped to [1, 60] s), as the JAX server answers over
    the JAX router and the same scripted replicas."""
    from megatron_llm_tpu.inference.router import (
        ReplicaRouter as JaxRouter,
    )
    from test_torch_router import JAX, PORT

    answers = []
    for pkg, server_cls, router_cls, tok in (
            (PORT, MegatronServer, ReplicaRouter,
             build_tokenizer("NullTokenizer", null_vocab_size=255)),
            (JAX, JaxServer, JaxRouter, JaxNull(255))):
        reps = [pkg.Fake(i, retry_after=v) for i, v in ((0, 7.4), (1, 90.0))]
        for rep in reps:
            rep._broken = "engine step failed: gone"
        srv = server_cls(None, None, tok, engine=router_cls(reps))
        srv.run("127.0.0.1", 0, block=False)
        port = srv._httpd.server_address[1]
        try:
            conn = HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("PUT", "/api", json.dumps(
                {"prompts": ["3 4 5"], "tokens_to_generate": 2}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers.append((resp.status, resp.getheader("Retry-After"),
                            json.loads(resp.read().decode())))
            conn.close()
        finally:
            srv.stop()
    assert answers[0] == answers[1] == (
        503, "7", {"message": "generation queue is full"})
