"""PyTorch port, HTTP serving: the port's `MegatronServer` and the JAX
package's `MegatronServer(engine=None)`, both on the CPU over real HTTP
on ephemeral ports and on the same weights, answer the same JSON —
greedy, score-only, beam, the request-validation errors (the cases of
tests/test_server.py) and the engine-only surfaces. With a CPU
`DecodeEngine` attached: engine PUTs answer the engine's own tokens, SSE
streams equal the buffered answer, validation answers match the JAX
server given an engine, and /metrics keys are the JAX engine's."""

import json
from http.client import HTTPConnection

import numpy as np
import pytest

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.server import (
    MegatronGenerate as JaxGenerate,
    MegatronServer as JaxServer,
)
from megatron_llm_tpu.tokenizer.tokenizer import _NullTokenizer as JaxNull
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.inference.server import (
    MegatronGenerate,
    MegatronServer,
)
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from test_server import VALIDATION_CASES, _NoModel
from torch_parity import close, tiny_pair


@pytest.fixture(scope="module")
def servers():
    jm, jp, tm, tp = tiny_pair()
    jax_srv = JaxServer(jm, jp, JaxNull(255))
    pt_srv = MegatronServer(tm, tp, build_tokenizer("NullTokenizer",
                                                    null_vocab_size=255))
    ports = []
    for srv in (jax_srv, pt_srv):
        srv.run("127.0.0.1", 0, block=False)
        ports.append(srv._httpd.server_address[1])
    yield ports
    jax_srv.stop()
    pt_srv.stop()


def _request(port, method, path, payload=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    body = None if payload is None else json.dumps(payload)
    conn.request(method, path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


PROMPTS = ["5 9 13 200 7", "100 3", "8 8 8 1 2 3 4 250"]


@pytest.mark.parametrize("payload", [
    {"prompts": PROMPTS, "tokens_to_generate": 6, "top_k": 1,
     "logprobs": True},
    {"prompts": PROMPTS, "tokens_to_generate": 0, "logprobs": True},
    {"prompts": PROMPTS[:1], "tokens_to_generate": 5, "beam_width": 2},
], ids=["greedy", "score_only", "beam"])
def test_same_json_as_jax_server(servers, payload):
    jax_port, pt_port = servers
    js, jbody = _request(jax_port, "PUT", "/api", payload)
    ps, pbody = _request(pt_port, "PUT", "/api", payload)
    assert js == ps == 200
    ref, got = json.loads(jbody), json.loads(pbody)
    assert got.keys() == ref.keys()
    assert got["text"] == ref["text"] and got["segments"] == ref["segments"]
    key = "scores" if "scores" in ref else "logprobs"
    close(got[key], ref[key], 1e-5)


@pytest.mark.parametrize(
    "payload,message", VALIDATION_CASES,
    ids=[m[:40].replace(" ", "_") for _, m in VALIDATION_CASES])
def test_validation_messages_match_jax(payload, message):
    got = MegatronGenerate(_NoModel(), None, build_tokenizer(
        "NullTokenizer", null_vocab_size=255)).put(payload)
    ref = JaxGenerate(_NoModel(), None, JaxNull(255)).put(payload)
    assert got == ref == (message, 400)


@pytest.mark.parametrize("method,path,payload", [
    ("PUT", "/api", {"prompts": ["1 2"], "max_len": 4}),
    ("PUT", "/api", {"prompts": ["1 2"], "stream": True,
                     "tokens_to_generate": 2}),
    ("GET", "/health", None),
    ("GET", "/metrics", None),
    ("GET", "/flight_record", None),
    ("POST", "/profile", {"rounds": 2}),
    ("PUT", "/nowhere", {}),
], ids=["invalid", "stream", "health", "metrics", "flight_record", "profile",
        "unknown_path"])
def test_same_status_over_http(servers, method, path, payload):
    """The same status everywhere; the same JSON body where the JAX
    server answers JSON (error pages are the stdlib's HTML)."""
    jax_port, pt_port = servers
    js, jbody = _request(jax_port, method, path, payload)
    ps, pbody = _request(pt_port, method, path, payload)
    assert js == ps
    if js != 404:
        assert json.loads(pbody) == json.loads(jbody)


def test_unported_surfaces_name_their_slice(servers):
    _, pt_port = servers
    for path in ("/", "/memory"):
        status, body = _request(pt_port, "GET", path)
        assert status == 404 and "observability slice" in body


def test_engine_is_refused():
    """Only the port's DecodeEngine (or None) serves; an engine-shaped
    object such as a replica router is refused by name."""
    with pytest.raises(TypeError, match="fleet slice"):
        MegatronServer(None, None, None, engine=object())


def test_sampled_request_is_seed_stable(servers):
    _, pt_port = servers
    payload = {"prompts": PROMPTS, "tokens_to_generate": 6, "top_p": 0.9,
               "random_seed": 1234}
    a = _request(pt_port, "PUT", "/api", payload)
    b = _request(pt_port, "PUT", "/api", payload)
    assert a[0] == 200 and a == b
    texts = json.loads(a[1])["text"]
    assert [len(s.split()) for s in texts] == \
        [len(p.split()) + 6 for p in PROMPTS]
    assert np.all([t.startswith(p) for t, p in zip(texts, PROMPTS)])


ENGINE_KW = dict(slots=2, page_size=16, max_context=64, max_queue=8,
                 prefill_chunk_tokens=8, prefix_cache=True,
                 termination_id=255, vocab_size=256)


def _tok():
    return build_tokenizer("NullTokenizer", null_vocab_size=255)


@pytest.fixture(scope="module")
def engine_server():
    _, _, tm, tp = tiny_pair()
    eng = DecodeEngine(tm, tp, **ENGINE_KW)
    srv = MegatronServer(tm, tp, _tok(), engine=eng)
    srv.run("127.0.0.1", 0, block=False)
    yield srv
    srv.stop()


def _port_of(srv):
    return srv._httpd.server_address[1]


def test_engine_put_answers_the_engines_tokens(engine_server):
    _, _, tm, tp = tiny_pair()
    payload = {"prompts": PROMPTS, "tokens_to_generate": 6, "top_k": 1,
               "logprobs": True}
    status, body = _request(_port_of(engine_server), "PUT", "/api", payload)
    assert status == 200
    got = json.loads(body)
    direct = DecodeEngine(tm, tp, **ENGINE_KW)
    reqs = [direct.submit([int(x) for x in p.split()], 6, top_k=1,
                          return_log_probs=True) for p in PROMPTS]
    direct.drain()
    for text, lp, r in zip(got["text"], got["logprobs"], reqs):
        toks, ref_lp = r.result(timeout=5)
        assert list(map(int, text.split())) == toks
        close(lp, ref_lp, 1e-6)


def _sse(port, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("PUT", "/api", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "text/event-stream"
    events, ids = [], []
    for line in resp.read().decode().splitlines():
        if line.startswith("data: "):
            events.append(json.loads(line[6:]))
        elif line.startswith("id: "):
            ids.append(line[4:])
    conn.close()
    return events, ids


def test_stream_equals_the_buffered_answer(engine_server):
    port = _port_of(engine_server)
    payload = {"prompts": PROMPTS[2:], "tokens_to_generate": 7, "top_k": 1}
    events, ids = _sse(port, dict(payload, stream=True))
    _, body = _request(port, "PUT", "/api", payload)
    buffered = list(map(int, json.loads(body)["text"][0].split()))
    prompt = list(map(int, PROMPTS[2].split()))
    tokens = [e["token"] for e in events[:-1]]
    assert prompt + tokens == buffered
    final = events[-1]
    assert final["done"] and final["tokens"] == tokens
    assert final["text"] == " ".join(map(str, buffered))
    assert len(set(ids)) == 1 and ids[0] == str(final["rid"])
    assert len(ids) == len(events)


def test_engine_surfaces(engine_server):
    port = _port_of(engine_server)
    status, body = _request(port, "GET", "/health")
    assert status == 200 and json.loads(body)["engine"]["alive"]
    status, body = _request(port, "GET", "/metrics")
    assert status == 200
    jm, jp, _, _ = tiny_pair()
    jax_keys = set(JaxEngine(jm, jp, **ENGINE_KW).counters())
    assert set(json.loads(body)) <= jax_keys
    for method, path in (("GET", "/metrics?format=prometheus"),
                         ("GET", "/flight_record"), ("POST", "/profile")):
        status, body = _request(port, method, path, {} if method == "POST"
                                else None)
        assert 400 <= status < 500, path
        assert "observability slice" in json.loads(body)["message"], path


def test_engine_validation_matches_jax_server_with_engine():
    jm, jp, tm, tp = tiny_pair()
    jax_gen = JaxGenerate(_NoModel(), None, JaxNull(255),
                          engine=JaxEngine(jm, jp, **ENGINE_KW))
    port_gen = MegatronGenerate(_NoModel(), None, _tok(),
                                engine=DecodeEngine(tm, tp, **ENGINE_KW))
    for payload, message in VALIDATION_CASES:
        assert port_gen.put(payload) == jax_gen.put(payload) \
            == (message, 400)
    never = []
    for raw in ({"prompts": ["1", "2"], "tokens_to_generate": 2},
                {"prompts": ["1"], "tokens_to_generate": 0,
                 "logprobs": True},
                {"prompts": ["1"], "tokens_to_generate": 2,
                 "beam_width": 2},
                {"prompts": ["1"], "tokens_to_generate": 2,
                 "logprobs": True},
                {"prompts": ["1"], "tokens_to_generate": 2,
                 "top_p_decay": 0.5}):
        got = port_gen.put_stream(raw, never.append, never.append)
        ref = jax_gen.put_stream(raw, never.append, never.append)
        assert got == ref and got[1] == 400, raw
    assert never == []


def test_queue_full_and_deadline_answers():
    _, _, tm, tp = tiny_pair()
    # an engine that is not serving: the second prompt finds the queue
    # full and the PUT answers 503 at once
    idle = DecodeEngine(tm, tp, **dict(ENGINE_KW, max_queue=1))
    gen = MegatronGenerate(tm, tp, _tok(), engine=idle)
    assert gen.put({"prompts": ["1 2", "3 4"], "tokens_to_generate": 2,
                    "top_k": 1}) == ({"message": "generation queue is "
                                                 "full"}, 503)
    eng = DecodeEngine(tm, tp, **ENGINE_KW)
    srv = MegatronServer(tm, tp, _tok(), engine=eng,
                         request_deadline_s=1e-6)
    srv.run("127.0.0.1", 0, block=False)
    try:
        status, body = _request(_port_of(srv), "PUT", "/api",
                                {"prompts": ["1 2"], "tokens_to_generate": 4,
                                 "top_k": 1})
    finally:
        srv.stop()
    assert status == 504 and "deadline" in json.loads(body)["message"]
