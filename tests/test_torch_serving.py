"""PyTorch port, HTTP serving: the port's `MegatronServer` and the JAX
package's `MegatronServer(engine=None)`, both on the CPU over real HTTP
on ephemeral ports and on the same weights, answer the same JSON —
greedy, score-only, beam, the request-validation errors (the cases of
tests/test_server.py) and the engine-only surfaces."""

import json
from http.client import HTTPConnection

import numpy as np
import pytest

from megatron_llm_tpu.inference.server import (
    MegatronGenerate as JaxGenerate,
    MegatronServer as JaxServer,
)
from megatron_llm_tpu.tokenizer.tokenizer import _NullTokenizer as JaxNull
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
    with pytest.raises(ValueError, match="engine slice"):
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
