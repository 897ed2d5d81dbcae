"""REST text-generation server, whole-batch route (port of
inference/server.py with `engine=None`).

PUT /api validates exactly as the JAX server does (every message byte for
byte) and serves each request through `generate_and_post_process` or
`beam_search_and_post_process`, one at a time under a non-blocking lock:
a concurrent request gets 503 + Retry-After. GET /health answers 200.

The continuous-batching engine is the next slice. The engine-only
surfaces answer what the JAX server answers when no engine is attached:
a streaming PUT gets its 400, GET /metrics, GET /flight_record and
POST /profile get 404. The static UI (GET /) and GET /memory, which the
JAX server serves without an engine, answer 404 naming the slice that
ports them.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from megatron_llm_tpu_torch.inference import api

LOCK = threading.Lock()
BUSY_MSG = "server is busy processing another request"
_NOT_PORTED = {
    "/": "the static generation UI is not ported yet (observability slice)",
    "/index.html": "the static generation UI is not ported yet "
                   "(observability slice)",
    "/memory": "GET /memory is not ported yet (observability slice)",
}


class MegatronGenerate:
    """Request validation + whole-batch dispatch."""

    def __init__(self, model, params, tokenizer, stream_enabled=True):
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.stream_enabled = stream_enabled

    def _validate(self, raw: dict):
        """Parsed fields, or an (error_message, 400) tuple."""
        if "prompts" not in raw:
            return "prompts argument required", 400
        if "max_len" in raw:
            return "max_len is no longer used.  Replace with tokens_to_generate", 400
        if "sentences" in raw:
            return "sentences is no longer used.  Replace with prompts", 400
        prompts = raw["prompts"]
        if not isinstance(prompts, list):
            return "prompts is not a list of strings", 400
        if len(prompts) == 0:
            return "prompts is empty", 400
        if len(prompts) > 128:
            return "Maximum number of prompts is 128", 400

        tokens_to_generate = raw.get("tokens_to_generate", 64)
        if not isinstance(tokens_to_generate, int):
            return "tokens_to_generate must be an integer greater than 0", 400
        if tokens_to_generate < 0:
            return ("tokens_to_generate must be an integer greater than or "
                    "equal to 0"), 400

        logprobs = raw.get("logprobs", False)
        if not isinstance(logprobs, bool):
            return "logprobs must be a boolean value", 400
        if tokens_to_generate == 0 and not logprobs:
            return "tokens_to_generate=0 implies logprobs should be True", 400

        temperature = raw.get("temperature", 1.0)
        if not isinstance(temperature, (int, float)) or not (
                0.0 < temperature <= 100.0):
            return ("temperature must be a positive number less than or "
                    "equal to 100.0"), 400

        top_k = raw.get("top_k", 0)
        if not isinstance(top_k, int) or not (0 <= top_k <= 1000):
            return "top_k must be an integer equal to or greater than 0 and less than or equal to 1000", 400

        top_p = raw.get("top_p", 0.0)
        if not isinstance(top_p, (int, float)) or not (0.0 <= top_p <= 1.0):
            return "top_p must be less than or equal to 1 and greater than or equal to 0", 400
        if top_p > 0.0 and top_k > 0:
            return "cannot set both top-k and top-p samplings.", 400

        add_BOS = raw.get("add_BOS", False)
        if not isinstance(add_BOS, bool):
            return "add_BOS must be a boolean value", 400
        if any(len(p) == 0 for p in prompts) and not add_BOS:
            return "Empty prompts require add_BOS=true", 400

        beam_width = raw.get("beam_width", None)
        if beam_width is not None:
            if not isinstance(beam_width, int) or beam_width < 1:
                return "beam_width must be integer > 0", 400
            if len(prompts) > 1:
                return "When doing beam_search, batch size must be 1", 400

        return {
            "prompts": prompts,
            "tokens_to_generate": tokens_to_generate,
            "logprobs": logprobs,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "top_p_decay": raw.get("top_p_decay", 0.0),
            "top_p_bound": raw.get("top_p_bound", 0.0),
            "add_BOS": add_BOS,
            "stop_on_eol": raw.get("stop_on_eol", False),
            "stop_on_double_eol": raw.get("stop_on_double_eol", False),
            "prevent_newline_after_colon": raw.get(
                "prevent_newline_after_colon", False),
            "random_seed": raw.get("random_seed", -1),
            "beam_width": beam_width,
            "stop_token": raw.get("stop_token", None),
            "length_penalty": raw.get("length_penalty", 1.0),
        }

    def put(self, raw: dict):
        """Returns (payload, http_status)."""
        v = self._validate(raw)
        if not isinstance(v, dict):
            return v
        # one whole-batch generation at a time, without blocking: a
        # concurrent request is overload and gets 503 + Retry-After
        if not LOCK.acquire(blocking=False):
            return {"message": BUSY_MSG}, 503
        try:
            if v["beam_width"] is not None:
                texts, segments, scores, _ = api.beam_search_and_post_process(
                    self.model, self.params, self.tokenizer, v["prompts"],
                    tokens_to_generate=v["tokens_to_generate"],
                    beam_size=v["beam_width"],
                    add_BOS=v["add_BOS"],
                    stop_token=v["stop_token"],
                    num_return_gen=v["beam_width"],
                    length_penalty=v["length_penalty"],
                    prevent_newline_after_colon=v["prevent_newline_after_colon"],
                )
                return {"text": texts, "segments": segments,
                        "scores": scores.tolist()}, 200
            texts, segments, lp, _ = api.generate_and_post_process(
                self.model, self.params, self.tokenizer, v["prompts"],
                tokens_to_generate=v["tokens_to_generate"],
                return_output_log_probs=v["logprobs"],
                top_k_sampling=v["top_k"],
                top_p_sampling=v["top_p"],
                top_p_decay=v["top_p_decay"],
                top_p_bound=v["top_p_bound"],
                temperature=v["temperature"],
                add_BOS=v["add_BOS"],
                stop_on_eol=v["stop_on_eol"],
                stop_on_double_eol=v["stop_on_double_eol"],
                prevent_newline_after_colon=v["prevent_newline_after_colon"],
                random_seed=v["random_seed"],
            )
            return {"text": texts, "segments": segments,
                    "logprobs": lp.tolist() if lp is not None else None}, 200
        except Exception as e:  # the reference returns the error as JSON
            return {"message": repr(e)}, 500
        finally:
            LOCK.release()

    def put_stream(self, raw: dict):
        """Token streaming needs the continuous-batching engine: the same
        answers the JAX server gives without one."""
        if not self.stream_enabled:
            return {"message": "token streaming is disabled "
                               "(--no_stream)"}, 400
        return {"message": "token streaming requires the "
                           "continuous-batching engine "
                           "(--serving_slots > 0)"}, 400


class _Handler(BaseHTTPRequestHandler):
    generator: Optional[MegatronGenerate] = None

    def do_GET(self):
        path = self.path.partition("?")[0]
        if path.rstrip("/") == "/health":
            self._respond({"status": "ok", "engine": None}, 200)
        elif path in _NOT_PORTED:
            self._respond({"message": _NOT_PORTED[path]}, 404)
        else:  # /metrics, /flight_record: engine-only, as without one
            self.send_error(404)

    def do_POST(self):  # POST /profile is engine-only
        self.send_error(404)

    def do_PUT(self):
        if self.path.rstrip("/") != "/api":
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._respond("invalid json", 400)
            return
        if raw.get("stream"):
            self._respond(*self.generator.put_stream(raw))
            return
        self._respond(*self.generator.put(raw))

    def _respond(self, payload, status):
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if status == 503:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # quiet by default
        pass


class MegatronServer:
    """HTTP front of the whole-batch route. `engine` must be None until
    the continuous-batching engine is ported."""

    def __init__(self, model, params, tokenizer, engine=None,
                 stream_enabled=True):
        if engine is not None:
            raise ValueError("the continuous-batching engine is not ported "
                             "yet (engine slice); serve with engine=None")
        self.engine = None
        self.generator = MegatronGenerate(model, params, tokenizer,
                                          stream_enabled=stream_enabled)
        self._httpd = None

    def run(self, host: str = "0.0.0.0", port: int = 5000,
            block: bool = True):
        handler = type("Handler", (_Handler,), {"generator": self.generator})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        if block:
            self._httpd.serve_forever()
        else:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        return self._httpd

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
