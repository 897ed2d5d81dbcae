"""REST text-generation server (port of inference/server.py).

PUT /api validates exactly as the JAX server does (every message byte for
byte). With a `DecodeEngine` attached (inference/engine.py), generate
requests are queued on the engine: each prompt becomes one engine
request, admitted into a free slot mid-flight, so concurrent PUTs batch
together; a full queue answers 503 + Retry-After and a request past the
server's deadline 504. Beam search, score-only requests, the knobs the
engine does not speak (`prevent_newline_after_colon`, `top_p_decay`) and
requests past the engine's max_context or pool take the whole-batch path
(`generate_and_post_process`, `beam_search_and_post_process`), one at a
time under a non-blocking lock: a concurrent one gets 503 + Retry-After.

A PUT with `{"stream": true}` (engine only, one prompt) answers
`text/event-stream`: one `data:` event per booked token with `id:` the
engine request id, a final `{"done": ...}` event, then the connection
closes. A client that disconnects mid-stream cancels its request (the
slot retires and its pages come back).

GET /health answers the engine's liveness (503 once its serve loop
died); GET /metrics the engine's `counters()` as JSON, or, when the
client prefers it (`?format=prometheus`, or a text/plain or openmetrics
Accept ahead of JSON), its Prometheus text exposition with the latency
histograms; GET /flight_record the flight recorder's snapshot; POST
/profile {"rounds": N, "trace_dir": ...} arms a torch.profiler trace of
the next N rounds (409 while one runs); GET /memory the allocator's
statistics of every card the engine (or each replica of a router) uses,
in the JAX schema's shape ({"devices": [{"device", "platform", ...}]},
with the JAX key names); GET / and /index.html the generation page
(inference/static_ui.py). A 503 or 504 carries a Retry-After of the
engine's (or router's) `retry_after_s()`: the modeled drain time with
the cost registry on, else 1 s.

`engine=` takes a `DecodeEngine` or a `ReplicaRouter` (inference/
router.py), which serves a fleet through the same handlers, as the JAX
server takes its router; the SSE `id:` is then "replica-rid".

With a tensor-parallel engine (`serving_tp` > 1) the server runs on tp
rank 0 only, the engine's leader: engine requests reach every rank
through its rounds, and the requests the engine does not take run on
this rank's whole tree, as the JAX server runs them on the launcher's
`model, params` (JAX :255-257). A follower that dies fails the
leader's next round with it (the leader sends an idle round every
second), so GET /health answers 503 once any rank's loop died. Engineless
servers answer as the JAX server does without an engine: 200 on
/health, 404 on the engine-only surfaces, 400 on a streaming PUT.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from megatron_llm_tpu_torch.inference import api
from megatron_llm_tpu_torch.inference.engine import DecodeEngine, QueueFull
from megatron_llm_tpu_torch.inference.router import ReplicaRouter
from megatron_llm_tpu_torch.inference.static_ui import INDEX_HTML
from megatron_llm_tpu_torch.inference.tokenization import (
    detokenize_generations,
)
from megatron_llm_tpu_torch.telemetry import PROMETHEUS_CONTENT_TYPE

_logger = logging.getLogger(__name__)

LOCK = threading.Lock()
BUSY_MSG = "server is busy processing another request"
QUEUE_FULL_MSG = "generation queue is full"


def _wants_prometheus(accept: str, query: str) -> bool:
    """/metrics content negotiation as the JAX server does it: the text
    exposition only when the client prefers it (`?format=prometheus`, or
    a text/openmetrics type ahead of JSON in the Accept header)."""
    if "format=prometheus" in query:
        return True
    for part in accept.split(","):
        mtype = part.split(";", 1)[0].strip().lower()
        if mtype in ("application/json", "*/*", "application/*"):
            return False
        if mtype in ("text/plain", "application/openmetrics-text",
                     "text/*"):
            return True
    return False


def _memory_devices(generator) -> list:
    """The devices GET /memory reports: the engine's, each in-process
    replica's of a router (in replica order, once each), or the model's
    without an engine."""
    eng = generator.engine
    if eng is None:
        engines = []
        dev = getattr(generator.model, "device", None)
        devices = [] if dev is None else [torch.device(dev)]
    else:
        engines = [r.engine for r in getattr(eng, "replicas", ())
                   if hasattr(r, "engine")] or [eng]
        devices = [e.device for e in engines]
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def _memory_stats(device) -> dict:
    """One device's entry of GET /memory: the JAX keys (`bytes_in_use`,
    `peak_bytes_in_use`, `bytes_reserved`, `bytes_limit`, `num_allocs`)
    from `torch.cuda.memory_stats`; a CPU device has none ({} in JAX)."""
    entry = {"device": str(device), "platform": device.type}
    if device.type != "cuda":
        return entry
    try:
        st = torch.cuda.memory_stats(device)
        entry |= {
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(device).total_memory),
            "num_allocs": int(st.get("allocation.all.allocated", 0)),
        }
    except Exception:  # noqa: BLE001: stats are optional, as in JAX
        pass
    return entry


class MegatronGenerate:
    """Request validation, then dispatch to the engine or the whole-batch
    path."""

    def __init__(self, model, params, tokenizer, engine=None,
                 request_deadline_s=None, stream_enabled=True):
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.engine = engine
        # wall-clock budget of every engine request; None = no deadline
        self.request_deadline_s = request_deadline_s
        self.stream_enabled = stream_enabled
        # incremental detokenization window of the SSE path
        self.stream_flush_tokens = 64

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
        # the engine serves what it speaks; the residue and requests past
        # its limits take the whole-batch path below
        if (self.engine is not None and v["beam_width"] is None
                and v["tokens_to_generate"] > 0
                and not v["prevent_newline_after_colon"]
                and v["top_p_decay"] == 0.0):
            resp = self._put_engine(v)
            if resp is not None:
                return resp
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

    def _prompt_ids(self, prompt, add_BOS):
        """Prompt ids of the engine paths (buffered and streaming)."""
        ids = self.tokenizer.tokenize(prompt)
        if add_BOS:
            ids = [self.tokenizer.bos] + ids
        return ids

    @staticmethod
    def _request_seed(random_seed, index=0):
        """A non-negative random_seed is deterministic, decorrelated per
        prompt by its index (engine draws are per request); otherwise
        fresh OS entropy per request."""
        if random_seed >= 0:
            return random_seed + index
        return int.from_bytes(os.urandom(4), "little")

    def _put_engine(self, v: dict):
        """Queue each prompt as one engine request and wait for all of
        them; the answer has the whole-batch path's shape (log-probs one
        list per prompt). Returns None, for the whole-batch path, when a
        prompt exceeds the engine's max_context or pool."""
        tok = self.tokenizer
        eng = self.engine
        ttg = v["tokens_to_generate"]
        prompt_ids = [self._prompt_ids(p, v["add_BOS"]) for p in v["prompts"]]
        pool_tokens = (eng.num_pages - 1) * eng.page_size
        if any(len(ids) + ttg > min(eng.max_context, pool_tokens)
               for ids in prompt_ids):
            return None
        reqs = []
        try:
            for i, ids in enumerate(prompt_ids):
                try:
                    reqs.append(eng.submit(
                        ids, ttg, top_k=v["top_k"], top_p=v["top_p"],
                        temperature=v["temperature"],
                        seed=self._request_seed(v["random_seed"], i),
                        return_log_probs=v["logprobs"],
                        use_eod_for_early_termination=True,
                        deadline_s=self.request_deadline_s))
                except QueueFull:
                    # the prompts already queued still complete; the
                    # client retries the whole request after Retry-After
                    return {"message": QUEUE_FULL_MSG}, 503
            rows, lps = [], []
            for r in reqs:
                try:
                    toks, lp = r.result(timeout=600.0)
                except TimeoutError as e:
                    # deadline expiry is overload shed, not a fault
                    _logger.warning("engine request rid=%d timed out",
                                    r.rid)
                    return {"message": repr(e)}, 504
                rows.append(toks)
                lps.append(lp)
            buf = np.full((len(rows), max(len(x) for x in rows)), tok.eod,
                          np.int32)
            for i, x in enumerate(rows):
                buf[i, :len(x)] = x
            lengths = np.asarray([len(x) for x in rows], np.int32)
            texts, segments = detokenize_generations(
                tok, buf, lengths, return_segments=True)
            return {"text": texts, "segments": segments,
                    "logprobs": ([list(map(float, x)) for x in lps]
                                 if v["logprobs"] else None)}, 200
        except Exception as e:  # the reference returns the error as JSON
            _logger.error("engine generate PUT failed (rids=%s): %r",
                          [r.rid for r in reqs], e)
            return {"message": repr(e)}, 500

    def put_stream(self, raw: dict, start_response, write_event):
        """SSE token streaming of one engine request. Returns an
        (error_payload, status) tuple while nothing has been sent;
        otherwise calls `start_response()`, then `write_event(dict,
        rid=...)` for every booked token and a final `{"done": ...}`
        event, and returns None. A failing write (the client went away)
        cancels the engine request and re-raises."""
        if not self.stream_enabled:
            return {"message": "token streaming is disabled "
                               "(--no_stream)"}, 400
        if self.engine is None:
            return {"message": "token streaming requires the "
                               "continuous-batching engine "
                               "(--serving_slots > 0)"}, 400
        v = self._validate(raw)
        if not isinstance(v, dict):
            return v
        if len(v["prompts"]) != 1:
            return {"message": "streaming serves exactly one prompt "
                               "per request"}, 400
        if v["tokens_to_generate"] < 1:
            return {"message": "streaming requires tokens_to_generate "
                               ">= 1"}, 400
        if (v["beam_width"] is not None
                or v["prevent_newline_after_colon"]
                or v["top_p_decay"] != 0.0):
            return {"message": "streaming supports only engine-path "
                               "requests (no beam_width / "
                               "prevent_newline_after_colon / "
                               "top_p_decay)"}, 400
        if v["logprobs"]:
            return {"message": "streaming does not return logprobs; "
                               "drop logprobs or use the buffered "
                               "path"}, 400
        tok = self.tokenizer
        try:
            ids = self._prompt_ids(v["prompts"][0], v["add_BOS"])
            req = self.engine.submit(
                ids, v["tokens_to_generate"], top_k=v["top_k"],
                top_p=v["top_p"], temperature=v["temperature"],
                seed=self._request_seed(v["random_seed"]),
                use_eod_for_early_termination=True,
                deadline_s=self.request_deadline_s, stream=True)
        except QueueFull:
            return {"message": QUEUE_FULL_MSG}, 503
        except ValueError as e:
            # past the engine's limits: the whole-batch path cannot stream
            return {"message": repr(e)}, 400
        except Exception as e:  # the same JSON error contract as put()
            return {"message": repr(e)}, 500

        def sse_id():
            # rid alone on an untagged engine; "replica-rid" behind the
            # router. Resolved per event: a two-stage hand-off proxy has
            # no replica until the decode replica attaches
            return (req.rid if getattr(req, "replica_id", None) is None
                    else f"{req.replica_id}-{req.rid}")

        # incremental detokenization over a bounded tail window: decode
        # the pending tokens and emit the new suffix; a trailing U+FFFD
        # (an unfinished byte sequence) is held back until it completes
        out_ids, pending, win_emitted = [], [], ""
        flush_at = self.stream_flush_tokens
        try:
            start_response()
            while True:
                t = req.stream_q.get(timeout=600.0)
                if t is None:
                    break
                out_ids.append(int(t))
                pending.append(int(t))
                cur = tok.detokenize(pending)
                stable = cur
                while stable.endswith("\ufffd"):
                    stable = stable[:-1]
                delta = ""
                if stable.startswith(win_emitted):
                    delta = stable[len(win_emitted):]
                    win_emitted = stable
                if len(pending) >= flush_at:
                    if stable == cur:
                        pending = pending[-1:]
                        win_emitted = tok.detokenize(pending)
                    elif len(pending) >= 4 * flush_at:
                        pending = pending[-flush_at:]
                        win_emitted = tok.detokenize(pending)
                        while win_emitted.endswith("\ufffd"):
                            win_emitted = win_emitted[:-1]
                write_event({"token": int(t), "text": delta}, rid=sse_id())
        except queue_mod.Empty:
            _logger.error("stream rid=%d stalled waiting for the engine; "
                          "cancelling", req.rid)
            self.engine.cancel(req)
            try:
                write_event({"done": True, "rid": req.rid,
                             "error": "timed out waiting for the engine; "
                                      "request cancelled"}, rid=sse_id())
            except OSError:
                pass
            return None
        except Exception:
            # the client went away mid-stream: reclaim the slot now
            _logger.info("stream rid=%d aborted mid-flight; cancelling",
                         req.rid)
            self.engine.cancel(req)
            raise
        if req.error is not None:
            final = {"done": True, "rid": req.rid, "error": req.error}
        else:
            final = {"done": True, "rid": req.rid, "tokens": out_ids,
                     "text": tok.detokenize(ids + out_ids)}
        write_event(final, rid=sse_id())
        return None


class _Handler(BaseHTTPRequestHandler):
    generator: Optional[MegatronGenerate] = None

    def do_GET(self):
        path, _, query = self.path.partition("?")
        eng = self.generator.engine
        if self.path in ("/", "/index.html"):
            data = INDEX_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if path.rstrip("/") == "/memory":
            self._respond({"devices": [
                _memory_stats(d) for d in _memory_devices(self.generator)]},
                200)
            return
        if path.rstrip("/") == "/health":
            if eng is None:
                self._respond({"status": "ok", "engine": None}, 200)
                return
            h = eng.health()
            healthy = h["broken"] is None and h["alive"]
            self._respond({"status": "ok" if healthy else "unhealthy",
                           "engine": h}, 200 if healthy else 503)
        elif eng is None:  # /metrics, /flight_record: engine-only
            self.send_error(404)
        elif path.rstrip("/") == "/metrics":
            if _wants_prometheus(self.headers.get("Accept", ""), query):
                data = eng.prometheus_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._respond(eng.counters(), 200)
        elif path.rstrip("/") == "/flight_record":
            self._respond(eng.flight_record(), 200)
        else:
            self.send_error(404)

    def do_POST(self):
        """POST /profile (JAX :670-705): arm a profiler trace of the next
        N engine rounds; one at a time (409 while one is armed)."""
        if self.path.partition("?")[0].rstrip("/") != "/profile" \
                or self.generator.engine is None:
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = json.loads(self.rfile.read(length) or b"{}")
        except (json.JSONDecodeError, ValueError):
            self._respond("invalid json", 400)
            return
        if not isinstance(raw, dict):
            self._respond({"message": "body must be a JSON object"}, 400)
            return
        rounds = raw.get("rounds", 16)
        if not isinstance(rounds, int) or rounds < 1:
            self._respond({"message": "rounds must be an integer >= 1"},
                          400)
            return
        try:
            res = self.generator.engine.request_profile(
                rounds, trace_dir=raw.get("trace_dir"))
        except Exception as e:  # noqa: BLE001: the JSON error contract
            self._respond({"message": repr(e)}, 500)
            return
        self._respond(res, 200 if res.get("ok") else 409)

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
            self._stream_put(raw)
            return
        self._respond(*self.generator.put(raw))

    def _stream_put(self, raw):
        """SSE dispatch: headers go out once the request is queued
        (validation errors stay plain JSON); EOF after the final event is
        the end of the stream."""

        def start_response():
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def write_event(obj, rid=None):
            prefix = f"id: {rid}\n" if rid is not None else ""
            self.wfile.write((prefix + f"data: {json.dumps(obj)}\n\n")
                             .encode())
            self.wfile.flush()

        try:
            err = self.generator.put_stream(raw, start_response,
                                            write_event)
        except ConnectionError:
            # the client went away; put_stream cancelled the request
            self.close_connection = True
            return
        except Exception:
            _logger.exception("streaming PUT failed mid-stream")
            self.close_connection = True
            return
        if err is not None:
            self._respond(*err)
        else:
            self.close_connection = True

    def _respond(self, payload, status):
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if status in (503, 504):
            self.send_header("Retry-After", self._retry_after())
        self.end_headers()
        self.wfile.write(data)

    def _retry_after(self) -> str:
        """The engine's (or router's) modeled drain time in whole
        seconds, at least 1; 1 when it has none or the model fails."""
        try:
            fn = getattr(self.generator.engine, "retry_after_s", None)
            if fn is not None:
                return str(max(int(round(float(fn()))), 1))
        except Exception:  # noqa: BLE001: the header is advisory
            pass
        return "1"

    def log_message(self, fmt, *args):  # quiet by default
        pass


class MegatronServer:
    """HTTP front. Pass a `DecodeEngine` (or a `ReplicaRouter` over
    replicas) to serve generate requests through the continuous-batching
    queue: `run` starts its serve thread (the router: every replica's)
    and `stop` drains it."""

    def __init__(self, model, params, tokenizer, engine=None,
                 request_deadline_s=None, stream_enabled=True):
        if engine is not None and not isinstance(
                engine, (DecodeEngine, ReplicaRouter)):
            raise TypeError(f"engine must be a DecodeEngine, a "
                            f"ReplicaRouter or None, got "
                            f"{type(engine).__name__}")
        self.engine = engine
        self.generator = MegatronGenerate(
            model, params, tokenizer, engine=engine,
            request_deadline_s=request_deadline_s,
            stream_enabled=stream_enabled)
        self._httpd = None

    def run(self, host: str = "0.0.0.0", port: int = 5000,
            block: bool = True):
        if self.engine is not None and self.engine._thread is None:
            self.engine.start()
        handler = type("Handler", (_Handler,), {"generator": self.generator})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        if block:
            self._httpd.serve_forever()
        else:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        return self._httpd

    def stop(self):
        """Stop accepting requests, then drain the engine: every admitted
        and queued request finishes before this returns."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self.engine is not None:
            self.engine.stop(drain=True)
