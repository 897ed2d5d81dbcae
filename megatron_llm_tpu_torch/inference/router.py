"""Prefix-affinity replica router: one front end over N decode-engine
replicas (port of inference/router.py, host only: a copy that reads the
port's engine and telemetry).

A single engine — even tp-sharded — caps out at one mesh's throughput;
the next scaling axis is N independent replicas behind a dispatcher.
The interesting routing decision is CACHE-AWARE: production traffic is
dominated by shared system prompts (the `extra.serving.prefix` bench
mix), and each replica's `PrefixCache` (inference/prefix_cache.py)
holds the shared pages of exactly the prompts IT has served. Random or
round-robin dispatch scatters a shared prefix across every replica —
each one pays the full prefill once and caches a private copy; routing
by prefix affinity sends a prompt to the replica that already holds its
longest page-aligned prefix, so the fleet prefills each shared prefix
roughly once and TTFT on shared traffic collapses toward the cache-hit
floor (bench `extra.serving.scaleout` measures affinity-vs-random p95
TTFT on the 80%-shared mix).

Design (each rule is load-bearing):

- **The router's index is ADVISORY, never authoritative.** It is a
  page-aligned prefix -> replica map maintained router-side from the
  router's own dispatch history (full pages only, capped at
  len(prompt) - 1 — exactly the prefixes a replica's PrefixCache can
  register). The replica's cache may have evicted an entry under pool
  pressure, a hash chain may collide, a replica may have restarted: a
  stale or wrong hit only routes a request to a colder replica that
  re-prefills — a perf miss, never a correctness hazard. That is what
  licenses the O(len(prompt)) rolling-hash walk instead of storing
  token tuples.
- **Health feeds routing, not the other way round.** Liveness comes
  from the replica's existing `/health` surface (`DecodeEngine.health`
  in process, GET /health over the wire): a poisoned serve loop
  (`broken`) or dead thread takes the replica out of rotation, its
  index entries drop (the pages died with its pools), and a cooldown
  re-probe brings a recovered replica back cold. A submit-time failure
  (engine stopped/poisoned mid-dispatch) marks the replica down and
  FAILS OVER to the next candidate in policy order; `QueueFull` on one
  replica tries the others before surfacing (the fleet is full only
  when every queue is).
- **Fallback is least-queue-depth.** On an affinity miss (or with
  `affinity=False`) the request goes to the healthy replica with the
  smallest queue_depth + slots_busy — the same load signal `/metrics`
  exports. `fallback="random"` (seeded) exists as the control arm the
  scaleout bench compares affinity against.
- **Drain on stop.** `stop(drain=True)` drains every replica's queue
  and slots before returning — the server's graceful-shutdown contract,
  fleet-wide.

The router deliberately duck-types the slice of the `DecodeEngine`
surface the HTTP layer uses (`submit`/`cancel`/`counters`/`health`/
`prometheus_metrics`/`flight_record`/`start`/`stop` + the
max_context/page_size/num_pages admission limits), so
`MegatronServer(engine=router)` serves a fleet through the same
handler code that serves one engine. Aggregation rules: additive
counters sum (`serve_kv_pool_bytes_fleet` scales each replica's
per-chip gauge by its tp), latency histograms merge by bucket (they
are cumulative by design — telemetry/prometheus.Histogram.merged) —
remote replicas' distributions included: HTTPReplica scrapes each
remote's Prometheus /metrics text and rebuilds its histograms via
`Histogram.from_cumulative` — per-replica
detail rides under `"replicas"`, and `router_*` counters expose the
dispatch decisions themselves.

`EngineReplica` wraps an in-process engine (tests, bench emulation,
the `--router_replicas` serving tool); `HTTPReplica` speaks the same
protocol to a remote replica over its existing HTTP surface for
cross-host fleets (prompt keys are the request's token ids there too —
the router sits behind tokenization).
"""

from __future__ import annotations

import collections
import logging
import queue as queue_mod
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_logger = logging.getLogger(__name__)

__all__ = ["BacklogExceeded", "EngineReplica", "FleetUnavailable",
           "HTTPReplica", "PrefixAffinityIndex", "ReplicaRouter"]


def _queue_full_base():
    from megatron_llm_tpu_torch.inference.engine import QueueFull

    return QueueFull


class FleetUnavailable(_queue_full_base()):
    """Every replica is poisoned/stopped/cooling down. Subclasses the
    engine's QueueFull ON PURPOSE: both mean "the fleet cannot take
    this request right now, retry later", and the HTTP layer already
    maps QueueFull to 503 + Retry-After — a bare RuntimeError would
    surface as a 500, which load balancers treat as a hard server
    fault and eject, exactly when the fleet is one cooldown away from
    recovering (GET /health reports the same transient state)."""


class BacklogExceeded(FleetUnavailable):
    """SLO-aware admission rejection: the MODELED drain time
    of every eligible replica's backlog exceeds the router's TTFT
    budget, so admitting would only manufacture a guaranteed SLO miss.
    A QueueFull by inheritance — the HTTP layer's existing 503 path —
    but the Retry-After it ships is the modeled drain estimate, not a
    constant: `retry_after_s` carries it."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class PrefixAffinityIndex:
    """Router-side page-aligned prefix -> replica map.

    Keys are a rolling hash chain over full prompt pages (key_d =
    hash((key_{d-1}, page_d's tokens))), so indexing and lookup walk a
    prompt ONCE — O(len(prompt)) — instead of hashing every
    page-aligned prefix tuple separately (O(P^2) tokens for a P-page
    prompt; the router sits on the submit path of every request).
    Hash collisions can alias two prefixes: acceptable by the advisory
    contract (a mis-route costs one cold prefill, never correctness).
    LRU-bounded: entries past `cap_entries` evict oldest-touched, the
    same pressure story as the replica-side cache it mirrors."""

    def __init__(self, page_size: int, cap_entries: int = 8192):
        assert page_size >= 1 and cap_entries >= 1
        self.page_size = page_size
        self.cap_entries = cap_entries
        # key -> replica id; OrderedDict move_to_end is the LRU touch
        self._map: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()

    def _keys(self, prompt: Sequence[int]):
        """The hash-chain keys of every full-page prefix of `prompt`,
        capped at len - 1 (mirroring PrefixCache: the last prompt token
        always forwards for its logits, so no replica can ever have
        cached through it)."""
        ps = self.page_size
        usable = (len(prompt) - 1) // ps
        key = 0x9E3779B9  # chain seed, any fixed value
        out = []
        for d in range(usable):
            key = hash((key, tuple(prompt[d * ps:(d + 1) * ps])))
            out.append(key)
        return out

    def lookup(self, prompt: Sequence[int]) -> Tuple[Optional[int], int]:
        """(replica holding the longest indexed prefix, pages matched);
        (None, 0) on a miss. Touches the winning entry's LRU stamp."""
        keys = self._keys(prompt)
        best, depth = None, 0
        for d, key in enumerate(keys, start=1):
            r = self._map.get(key)
            if r is None:
                break
            best, depth = r, d
        if best is not None:
            # re-touch the deepest hit only: it pins the chain
            self._map.move_to_end(keys[depth - 1])
        return best, depth

    def register(self, prompt: Sequence[int], replica: int) -> None:
        """Point every full-page prefix of `prompt` at `replica` — the
        replica's own PrefixCache will register the same pages as its
        prefill passes each boundary. Last writer wins (the newest
        holder is the warmest)."""
        for key in self._keys(prompt):
            self._map[key] = replica
            self._map.move_to_end(key)
        while len(self._map) > self.cap_entries:
            self._map.popitem(last=False)

    def drop_replica(self, replica: int) -> int:
        """Remove every entry pointing at `replica` (its pools — and
        with them every cached page — died with its serve loop).
        Returns the count dropped."""
        dead = [k for k, r in self._map.items() if r == replica]
        for k in dead:
            del self._map[k]
        return len(dead)

    def __len__(self) -> int:
        return len(self._map)


class EngineReplica:
    """In-process replica: a `DecodeEngine` (tagged with a replica_id)
    behind the replica protocol the router speaks. The serving tool's
    `--router_replicas`, the scaleout bench, and the router tests all
    use this form; cross-host fleets use HTTPReplica.

    `chaos` (inference/chaos.py) arms deterministic fault
    injection: submits eat injected latency and advance the kill
    trigger, the engine's per-round `_fault_hook` is installed (kills
    and sentinel-trip stalls fire INSIDE the scheduler round, through
    the real poison/telemetry paths), and exported hand-off payloads
    pass through the corruption hook. None (the default) leaves every
    path bitwise-untouched."""

    def __init__(self, engine, chaos=None):
        if engine.replica_id is None:
            raise ValueError(
                "a routed engine needs a replica_id (DecodeEngine("
                "replica_id=i)): the router routes cancel() by it and "
                "every metric/dump from the fleet must stay "
                "attributable")
        self.engine = engine
        self.replica_id = engine.replica_id
        self.chaos = chaos
        if chaos is not None:
            engine._fault_hook = chaos.engine_hook(engine.replica_id)

    # -- dispatch ----------------------------------------------------------

    def submit(self, prompt, tokens_to_generate, **kw):
        if self.chaos is not None:
            self.chaos.on_submit(self.replica_id)
        return self.engine.submit(prompt, tokens_to_generate, **kw)

    def cancel(self, req):
        self.engine.cancel(req)

    # -- cross-replica KV hand-off ------------------------------

    def export_prefix(self, prompt):
        payload = self.engine.export_prefix(prompt)
        if self.chaos is not None:
            payload = self.chaos.on_export(self.replica_id, payload)
        return payload

    def import_prefix(self, payload):
        return self.engine.import_prefix(payload)

    # -- health / load (the /health + /metrics feed) -----------------------

    def health(self) -> dict:
        return self.engine.health()

    def load(self) -> int:
        h = self.engine.health()
        return h["queue_depth"] + h["slots_busy"]

    def modeled_backlog_flops(self):
        """The engine's modeled-FLOPs backlog — None when
        its cost registry is off, and the router then falls back to
        the occupancy load() signal for the whole fleet."""
        return self.engine.modeled_backlog_flops()

    def modeled_backlog_s(self):
        return self.engine.modeled_backlog_seconds()

    def retry_after_s(self) -> float:
        return self.engine.retry_after_s()

    def counters(self) -> dict:
        return self.engine.counters()

    def fleet_kv_pool_bytes(self) -> int:
        """This replica's TOTAL pool HBM across its mesh: the per-chip
        gauge (the small-fix semantics) times serving_tp —
        what the router's fleet aggregate sums (summing per-chip
        numbers across tp>1 replicas would be neither per-chip nor
        fleet)."""
        return self.engine.kv_pool_bytes() * self.engine.serving_tp

    def histograms(self):
        return self.engine.histograms()

    def flight_record(self) -> dict:
        return self.engine.flight_record()

    def last_dump_path(self):
        """The engine's most recent flight-record artifact on disk
        (poison / sentinel-trip auto-dump), or None — what the router
        attaches to this replica's eviction event."""
        return self.engine.recorder.last_dump_path

    # -- lifecycle ---------------------------------------------------------

    def warmup(self):
        """Pre-trace the engine's step executables — the replace cycle
        warms a replacement BEFORE rotating it in, so the first request
        it serves never eats a compile stall mid-recovery."""
        self.engine.warmup()

    def start(self):
        if self.engine._thread is None:
            self.engine.start()

    def stop(self, drain: bool = True):
        self.engine.stop(drain=drain)

    def drain(self):
        """Wait until the replica is idle: with the serve loop running,
        poll; otherwise step it here (manual-stepping tests/bench)."""
        eng = self.engine
        if eng._thread is not None and eng._thread.is_alive():
            while True:
                h = eng.health()
                if not h["alive"] or (h["queue_depth"] == 0
                                      and h["slots_busy"] == 0):
                    return
                time.sleep(0.002)
        eng.drain()

    @property
    def max_context(self) -> int:
        return self.engine.max_context

    @property
    def page_size(self) -> int:
        return self.engine.page_size

    @property
    def num_pages(self) -> int:
        return self.engine.num_pages


class HTTPReplica:
    """Remote replica over the engine server's existing HTTP surface
    (GET /health, GET /metrics, PUT /api). Generation submits ride a
    background thread per request so the router's submit stays
    non-blocking like the in-process form; the returned handle exposes
    the same `result(timeout)` contract as EngineRequest. Latency
    histograms ARE proxied: the probe also scrapes the
    replica's Prometheus text exposition (`/metrics?format=prometheus`)
    and rebuilds its cumulative histograms
    (telemetry/prometheus.histograms_from_prometheus), so the router's
    merged fleet distributions cover remote replicas too. Token
    streaming and cancel are still not proxied — front a remote
    fleet's streaming traffic at the replica, or run the router
    in-process with the engines (EngineReplica)."""

    def __init__(self, replica_id: int, base_url: str,
                 tokenizer=None, timeout_s: float = 600.0,
                 probe_ttl_s: float = 1.0,
                 probe_timeout_s: float = 5.0,
                 probe_backoff_cap_s: float = 30.0,
                 page_size: int = 64, max_context: int = 2048,
                 chaos=None):
        self.replica_id = replica_id
        self.base_url = base_url.rstrip("/")
        self.tokenizer = tokenizer
        self.timeout_s = timeout_s
        self.probe_ttl_s = probe_ttl_s
        self.page_size = page_size
        self.max_context = max_context
        self.num_pages = (max_context * 64) // page_size  # advisory
        # probe hardening (satellite): the probe's socket
        # timeout is a knob (was a hardcoded 5.0 — a sick host inside
        # a tighter SLO needs a tighter probe), and consecutive probe
        # FAILURES back the re-probe off exponentially (probe_ttl_s,
        # 2x, 4x ... capped at probe_backoff_cap_s) instead of hammering
        # a flapping replica at full rate; one success resets it. The
        # current backoff rides the router_reprobe_backoff_s gauge.
        self.probe_timeout_s = probe_timeout_s
        self.probe_backoff_cap_s = probe_backoff_cap_s
        self.chaos = chaos
        self._fail_streak = 0
        self._backoff_s = 0.0
        self._probe: Tuple[float, dict] = (0.0, {})
        # histogram scrape cached SEPARATELY from the health/load
        # probe: the probe feeds the ROUTING path (submit-time
        # health/load), which must never wait on the Prometheus text
        # fetch only the fleet /metrics aggregation consumes
        self._hist_probe: Tuple[float, list] = (0.0, [])

    def _get_raw(self, path: str, accept: Optional[str] = None,
                 timeout: Optional[float] = None) -> bytes:
        import urllib.request

        req = urllib.request.Request(
            self.base_url + path,
            headers={"Accept": accept} if accept else {})
        with urllib.request.urlopen(
                req, timeout=self.probe_timeout_s
                if timeout is None else timeout) as resp:
            return resp.read()

    def _get_json(self, path: str) -> dict:
        import json

        return json.loads(self._get_raw(path).decode())

    def _probed(self) -> dict:
        now = time.monotonic()
        t, snap = self._probe
        # a failing replica's snapshot lives probe_ttl_s PLUS the
        # current exponential backoff — a flapping remote re-probes at
        # a decaying rate, not the full routing rate
        if now - t < self.probe_ttl_s + self._backoff_s:
            return snap
        try:
            if self.chaos is not None \
                    and self.chaos.on_probe(self.replica_id):
                raise ConnectionError("chaos: health probe dropped")
            h = self._get_json("/health")
            m = self._get_json("/metrics")
            snap = {"health": h, "metrics": m}
            self._fail_streak = 0
            self._backoff_s = 0.0
        except Exception as e:  # noqa: BLE001 — a dead probe IS the signal
            snap = {"health": {"status": "unhealthy",
                               "engine": {"alive": False,
                                          "broken": repr(e),
                                          "queue_depth": 0,
                                          "slots_busy": 0}},
                    "metrics": {}}
            self._fail_streak += 1
            self._backoff_s = min(
                self.probe_ttl_s * (2 ** (self._fail_streak - 1)),
                self.probe_backoff_cap_s)
        self._probe = (now, snap)
        return snap

    def reprobe_backoff_s(self) -> float:
        """The current probe backoff (0.0 while the last probe
        succeeded) — the router's router_reprobe_backoff_s gauge takes
        the fleet max of these."""
        return self._backoff_s

    def _scrape_histograms(self) -> list:
        """The remote's latency distributions, rebuilt from its
        Prometheus text exposition, under its own TTL cache — lazy:
        only the fleet /metrics aggregation path (histograms()) pays
        this fetch, never a routing-time health/load probe. Failures
        degrade to [] — a replica on a pre-Prometheus build (or
        mid-restart) drops out of the merged distributions rather than
        failing the fleet scrape; its health/liveness probing is
        unaffected."""
        from megatron_llm_tpu_torch.telemetry import histograms_from_prometheus

        now = time.monotonic()
        t, cached = self._hist_probe
        if now - t < self.probe_ttl_s:
            return cached
        try:
            text = self._get_raw("/metrics?format=prometheus",
                                 accept="text/plain").decode()
            hs = histograms_from_prometheus(text)
        except Exception as e:  # noqa: BLE001
            _logger.warning(
                "HTTPReplica %d: Prometheus histogram scrape failed "
                "(%r) — this replica's distributions are missing from "
                "the merged fleet /metrics this probe window",
                self.replica_id, e)
            hs = []
        self._hist_probe = (now, hs)
        return hs

    def health(self) -> dict:
        h = self._probed()["health"]
        eng = h.get("engine") or {}
        return {"alive": h.get("status") == "ok"
                and bool(eng.get("alive", True)),
                "broken": eng.get("broken"),
                "queue_depth": eng.get("queue_depth", 0),
                "slots_busy": eng.get("slots_busy", 0)}

    def load(self) -> int:
        h = self.health()
        return h["queue_depth"] + h["slots_busy"]

    def counters(self) -> dict:
        return dict(self._probed()["metrics"])

    def fleet_kv_pool_bytes(self) -> int:
        """The remote per-chip gauge as-is: a remote replica's tp is
        not visible over /metrics JSON, so a tp>1 REMOTE replica's
        contribution to the fleet sum undercounts by its tp — scrape
        the replica directly for exact sizing (its own counters are
        per-chip by contract)."""
        return int(self.counters().get("serve_kv_pool_bytes", 0))

    def histograms(self):
        """The remote's histograms, scraped from its Prometheus
        exposition on demand (rebuilt cumulative-bucket form —
        mergeable with the in-process replicas' via
        Histogram.merged)."""
        return list(self._scrape_histograms())

    def flight_record(self) -> dict:
        try:
            return self._get_json("/flight_record")
        except Exception as e:  # noqa: BLE001
            return {"error": repr(e)}

    def submit(self, prompt, tokens_to_generate, **kw):
        import json
        import urllib.request

        if self.tokenizer is None:
            raise ValueError(
                "HTTPReplica.submit needs a tokenizer to detokenize "
                "the prompt ids for PUT /api")
        payload = {
            "prompts": [self.tokenizer.detokenize(list(prompt))],
            "tokens_to_generate": int(tokens_to_generate),
            "top_k": int(kw.get("top_k", 1)),
            "top_p": float(kw.get("top_p", 0.0)),
            "temperature": float(kw.get("temperature", 1.0)),
        }
        if kw.get("seed", None) is not None:
            payload["random_seed"] = int(kw["seed"])

        handle = _HTTPResult(self.replica_id)

        def run():
            try:
                req = urllib.request.Request(
                    self.base_url + "/api",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                    method="PUT")
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    handle._payload = json.loads(resp.read().decode())
            except Exception as e:  # noqa: BLE001 — surfaced at result()
                handle.error = repr(e)
            handle.done.set()

        threading.Thread(target=run, daemon=True).start()
        return handle

    def cancel(self, req):
        _logger.warning("HTTPReplica cannot cancel a remote request")

    # -- surfaces: not proxied over the wire ----------------------
    # A remote replica's modeled backlog and page pools are not
    # reachable through PUT /api; the router treats None/None/False as
    # "fall back to occupancy load / direct dispatch", so a mixed
    # fleet degrades to occupancy routing instead of failing.

    def modeled_backlog_flops(self):
        return None

    def modeled_backlog_s(self):
        return None

    def retry_after_s(self):
        return None

    def export_prefix(self, prompt):
        return None

    def import_prefix(self, payload):
        return False

    def start(self):
        pass

    def stop(self, drain: bool = True):
        pass

    def drain(self):
        while self.load() > 0:
            time.sleep(0.05)


class _HTTPResult:
    """EngineRequest-shaped handle for one HTTPReplica submit."""

    def __init__(self, replica_id: int):
        self.replica_id = replica_id
        self.rid = -1
        self.done = threading.Event()
        self.error: Optional[str] = None
        self._payload: Optional[dict] = None

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError("remote request still running")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self._payload, None


class _HandoffRequest:
    """EngineRequest-shaped handle for one TWO-STAGE dispatch (prefill
    replica -> page transfer -> decode replica, ). The caller
    gets it back immediately; a router orchestration thread runs the
    stages and attaches the decode replica's real EngineRequest when
    the final submit lands. Timestamps are absolute perf_counter
    values like EngineRequest's, with `t_submit` stamped at ROUTER
    submit time — so TTFT measured on this handle honestly includes
    the prefill stage and the page transfer, not just the decode
    replica's queue wait."""

    def __init__(self, prompt, tokens_to_generate, stream: bool = False):
        self.prompt = list(prompt)
        self.tokens_to_generate = int(tokens_to_generate)
        self.rid = -1  # until attach: no engine has admitted it yet
        self.replica_id: Optional[int] = None
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.timed_out = False
        self.cancelled = False
        self.inner = None  # the decode replica's EngineRequest
        self.tokens: list = []
        self.log_probs: list = []
        self.return_log_probs = False
        self.stream_q = queue_mod.SimpleQueue() if stream else None
        self.t_submit = time.perf_counter()
        self.t_first = 0.0
        self.t_done = 0.0

    def attach(self, inner) -> None:
        self.inner = inner
        self.rid = getattr(inner, "rid", -1)
        self.replica_id = getattr(inner, "replica_id", None)

    def finalize(self, inner) -> None:
        """Mirror the finished inner request's outcome onto the handle
        the caller holds, then release waiters."""
        self.tokens = list(getattr(inner, "tokens", []) or [])
        self.log_probs = list(getattr(inner, "log_probs", []) or [])
        self.return_log_probs = bool(
            getattr(inner, "return_log_probs", False))
        self.error = getattr(inner, "error", None)
        self.timed_out = bool(getattr(inner, "timed_out", False))
        # t_first may already be stamped at prefill-stage completion
        # (greedy hand-off: the donor's 1-token run IS the first token
        # of the continuation — the decode replica regenerates it
        # bitwise-identically) — keep the earlier, truthful timestamp
        if not self.t_first:
            self.t_first = getattr(inner, "t_first", 0.0) or 0.0
        self.t_done = getattr(inner, "t_done", 0.0) or time.perf_counter()
        self.done.set()

    def fail(self, msg: str, timed_out: bool = False) -> None:
        self.error = msg
        self.timed_out = timed_out
        self.t_done = time.perf_counter()
        if self.stream_q is not None:
            self.stream_q.put(None)  # close any SSE consumer
        self.done.set()

    def result(self, timeout: Optional[float] = None):
        """EngineRequest.result contract: (tokens, log_probs), raising
        TimeoutError/RuntimeError exactly like a direct dispatch."""
        if not self.done.wait(timeout):
            raise TimeoutError("hand-off request still running")
        if self.error is not None:
            if self.timed_out:
                raise TimeoutError(self.error)
            raise RuntimeError(self.error)
        return self.tokens, (self.log_probs if self.return_log_probs
                             else None)


class _RecoverableRequest:
    """EngineRequest-shaped handle that survives its replica's death
   : the router hands it back instead of the engine's raw
    request when `recover_requests=True`. If the inner request fails
    with a replica-death error (serve loop poisoned, engine stopped,
    an injected chaos kill) BEFORE any token reached the caller, the
    proxy transparently resubmits the same request through the router
    — a fresh probe excludes the dead replica — up to `max_resubmits`
    times. Greedy decoding makes the retry bitwise: the replacement
    replica regenerates exactly the token stream the dead one would
    have produced (and sampled requests carry their per-request seed,
    so they replay identically too).

    What is NOT retried (each documented in docs/GUIDE.md
    "Self-driving fleet operations"):
    - PARTIALLY-STREAMED requests: tokens already left the building;
      a resubmit would re-deliver or reorder them mid-SSE-stream. The
      proxy fails LOUDLY (the error names the streamed count and tells
      the client to honour Retry-After) and closes the stream — it
      never hangs.
    - deadline-shed (`timed_out`) and cancelled requests: the caller
      already gave up; resurrecting its request would waste fleet
      capacity on an abandoned answer.
    - request-shaped errors (ValueError): every replica refuses them
      identically.

    Streaming requests pump through a relay thread (the proxy owns the
    caller-visible stream_q; each inner attempt gets its own), so the
    SSE layer's contract — every generated token, then one None
    sentinel — holds across a mid-flight replica swap. Non-streaming
    requests recover lazily inside result(): no thread, no cost until
    a replica actually dies."""

    # substrings that identify a REPLICA death (vs a request fault):
    # the serve-loop poison prefix, engine stop, submit-on-stopped,
    # and the chaos injector's kill tag
    _DEATH_MARKERS = ("engine step failed", "engine stopped",
                      "engine is stopped", "chaos:")

    def __init__(self, router, prompt, tokens_to_generate, kw, inner,
                 budget: int):
        self._router = router
        self._prompt = list(prompt)
        self._n = int(tokens_to_generate)
        self._kw = dict(kw)
        self._inner = inner
        self._budget = int(budget)
        self._t_submit0 = getattr(inner, "t_submit", 0.0)
        self.cancelled = False
        self.error: Optional[str] = None
        self.timed_out = False
        self.done = threading.Event()
        self._tokens: Optional[list] = None
        self._log_probs = None
        self._streamed = 0
        self.stream_q = None
        if kw.get("stream"):
            self.stream_q = queue_mod.SimpleQueue()
            threading.Thread(target=self._pump, daemon=True).start()

    # -- EngineRequest-shaped surface (SSE id:, router.cancel, bench) ------

    @property
    def rid(self):
        return getattr(self._inner, "rid", -1)

    @property
    def replica_id(self):
        return getattr(self._inner, "replica_id", None)

    @property
    def tokens(self):
        if self._tokens is not None:
            return self._tokens
        return getattr(self._inner, "tokens", [])

    @property
    def log_probs(self):
        return getattr(self._inner, "log_probs", [])

    @property
    def return_log_probs(self):
        return getattr(self._inner, "return_log_probs", False)

    @property
    def t_submit(self):
        # the ORIGINAL submit time survives resubmits: TTFT measured on
        # this handle honestly includes the death + recovery
        return self._t_submit0

    @property
    def t_first(self):
        return getattr(self._inner, "t_first", 0.0)

    @property
    def t_done(self):
        return getattr(self._inner, "t_done", 0.0)

    # -- recovery ----------------------------------------------------------

    def _recoverable(self, inner, err: str) -> bool:
        if self._budget <= 0 or self.cancelled:
            return False
        if getattr(inner, "timed_out", False) \
                or getattr(inner, "cancelled", False):
            return False
        return any(m in err for m in self._DEATH_MARKERS)

    def _resubmit(self):
        """One recovery attempt: redispatch through the router (the
        fresh probe sees the dead replica's broken health and routes
        around it). Raises whatever the redispatch raises — a fleet
        with no healthy replica surfaces as FleetUnavailable, the 503 +
        Retry-After shape."""
        self._budget -= 1
        req = self._router._dispatch_raw(self._prompt, self._n,
                                         dict(self._kw))
        with self._router._lock:
            self._router._resubmitted += 1
        _logger.warning(
            "router: request resubmitted to replica %s after replica "
            "death (%d retr%s left)", getattr(req, "replica_id", None),
            self._budget, "y" if self._budget == 1 else "ies")
        self._inner = req
        return req

    def result(self, timeout: Optional[float] = None):
        if self.stream_q is not None:
            # streaming: the pump thread owns recovery and the final
            # outcome — result() just reports it
            if not self.done.wait(timeout):
                raise TimeoutError("request still running")
            if self.error is not None:
                if self.timed_out:
                    raise TimeoutError(self.error)
                raise RuntimeError(self.error)
            return self._tokens, self._log_probs
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            inner = self._inner
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            try:
                out = inner.result(left)
            except TimeoutError:
                # either our wait budget ran out or the request was
                # deadline-shed — neither is retried
                self.timed_out = getattr(inner, "timed_out", False)
                self.error = getattr(inner, "error", None)
                raise
            except RuntimeError as e:
                if not self._recoverable(inner, str(e)):
                    self.error = str(e)
                    self.done.set()
                    raise
                self._resubmit()  # raises FleetUnavailable when the
                continue          # whole fleet is gone (a 503, not a hang)
            self._tokens, self._log_probs = out
            self.done.set()
            return out

    def _pump(self):
        """Streaming relay: forward each inner attempt's tokens onto
        the caller's stream; on a pre-stream replica death, resubmit
        and keep pumping; on any terminal outcome, mirror it and close
        the stream with the one None sentinel."""
        while True:
            inner = self._inner
            q = getattr(inner, "stream_q", None)
            while True:
                tok = q.get()  # the engine ALWAYS closes with None
                if tok is None:
                    break
                self._streamed += 1
                self.stream_q.put(tok)
            # sentinel seen: error/done were set before _finish()
            err = getattr(inner, "error", None)
            if err is None:
                self._tokens = list(getattr(inner, "tokens", []) or [])
                self._log_probs = (list(inner.log_probs)
                                   if getattr(inner, "return_log_probs",
                                              False) else None)
                self.done.set()
                self.stream_q.put(None)
                return
            if self._streamed == 0 and self._recoverable(inner, err):
                try:
                    self._resubmit()
                    continue
                except BaseException as e:  # noqa: BLE001 — surfaced
                    err = (f"resubmit after replica death failed: "
                           f"{e!r} (original death: {err})")
            elif self._streamed > 0 and any(
                    m in err for m in self._DEATH_MARKERS):
                err = (f"replica died after {self._streamed} token(s) "
                       f"already streamed: {err} — partially-streamed "
                       f"requests are never resubmitted (a retry would "
                       f"re-deliver tokens the client already has); "
                       f"stream closed, retry the request after the "
                       f"Retry-After interval")
            self.error = err
            self.timed_out = getattr(inner, "timed_out", False)
            self.done.set()
            self.stream_q.put(None)
            return


class ReplicaRouter:
    """Prefix-affinity dispatcher over N replicas (module docstring).

    Knobs (docs/GUIDE.md "Serving on a tp mesh & replica routing"):
    - `affinity` (default True): route by the page-aligned prefix ->
      replica index; off, every dispatch takes the fallback policy
      (the scaleout bench's control arm).
    - `fallback` ("least_loaded" | "random"): the policy on an
      affinity miss / affinity off. Least-loaded reads
      queue_depth + slots_busy from the replica's health surface.
    - `index_entries`: LRU bound of the affinity index.
    - `unhealthy_cooldown_s`: how long a replica marked down at
      submit time stays out of rotation before the next health
      re-probe may readmit it.

    Disaggregated two-stage mode (docs/GUIDE.md
    "Disaggregated serving"): pass `prefill_replicas=` +
    `decode_replicas=` INSTEAD of `replicas=`. Long prompts (>=
    `disagg_min_prompt_pages` full pages) prefill on the
    least-modeled-backlog prefill replica, their finished KV pages
    ship to the least-backlogged decode replica
    (export_prefix/import_prefix), and the full request then admits
    there as a prefix HIT — decode replicas never eat long mixed
    rounds. Short prompts take the direct path onto decode replicas
    unchanged. `ttft_slo_s` arms modeled-backlog admission: when every
    eligible replica's modeled drain time exceeds the budget, submit
    raises BacklogExceeded (a 503) carrying the modeled Retry-After.
    """

    def __init__(self, replicas: Optional[List] = None, *,
                 affinity: bool = True,
                 fallback: str = "least_loaded",
                 index_entries: int = 8192,
                 unhealthy_cooldown_s: float = 1.0,
                 rng_seed: int = 0,
                 prefill_replicas: Optional[List] = None,
                 decode_replicas: Optional[List] = None,
                 disagg_min_prompt_pages: int = 2,
                 ttft_slo_s: Optional[float] = None,
                 handoff_timeout_s: float = 600.0,
                 recover_requests: bool = False,
                 max_resubmits: int = 2):
        if (prefill_replicas is None) != (decode_replicas is None):
            raise ValueError(
                "disaggregated mode takes BOTH prefill_replicas= and "
                "decode_replicas= (a fleet with only one role cannot "
                "hand pages off)")
        self.disagg = prefill_replicas is not None
        if self.disagg:
            if replicas:
                raise ValueError(
                    "pass either replicas= (symmetric fleet) or the "
                    "prefill_replicas=/decode_replicas= pair, not both")
            if not prefill_replicas or not decode_replicas:
                raise ValueError(
                    "disaggregated mode needs at least one prefill AND "
                    "one decode replica")
            self._prefill_ids = [r.replica_id for r in prefill_replicas]
            self._decode_ids = [r.replica_id for r in decode_replicas]
            replicas = list(prefill_replicas) + list(decode_replicas)
        else:
            replicas = list(replicas or [])
            self._prefill_ids = []
            self._decode_ids = [r.replica_id for r in replicas]
        if not replicas:
            raise ValueError("a router needs at least one replica")
        if fallback not in ("least_loaded", "random"):
            raise ValueError(f"unknown fallback policy {fallback!r}")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        sizes = {r.page_size for r in replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas disagree on page_size ({sorted(sizes)}): "
                f"the affinity index is page-aligned and needs ONE "
                f"granularity")
        self.replicas = list(replicas)
        self._by_id: Dict[int, object] = {r.replica_id: r
                                          for r in replicas}
        self.affinity = affinity
        self.fallback = fallback
        self.page_size = sizes.pop()
        self.max_context = min(r.max_context for r in replicas)
        self.num_pages = min(r.num_pages for r in replicas)
        self._index = PrefixAffinityIndex(self.page_size, index_entries)
        self._rng = random.Random(rng_seed)
        self.unhealthy_cooldown_s = unhealthy_cooldown_s
        self.disagg_min_prompt_pages = max(int(disagg_min_prompt_pages), 1)
        self.ttft_slo_s = ttft_slo_s
        self.handoff_timeout_s = handoff_timeout_s
        self._down_until: Dict[int, float] = {}  # replica_id -> monotonic
        self._lock = threading.Lock()  # index + policy state (submit
        # can be called from N HTTP handler threads concurrently)
        self._thread = None  # duck-typed "started" flag (server.run)

        # dispatch accounting (served under counters()["router"])
        self._dispatches = 0
        self._affinity_hits = 0
        self._affinity_hit_pages = 0
        self._failovers = 0
        self._rejected = 0
        self._per_replica: Dict[int, int] = {r.replica_id: 0
                                             for r in replicas}
        # accounting — exported GATED on disagg/SLO mode so
        # the symmetric fleet's /metrics JSON stays byte-compatible
        self._prefill_dispatches = 0
        self._transfer_pages = 0
        self._transfer_ms = 0.0
        self._slo_rejected = 0
        # placement-decision trail (reproducibility: every routing
        # choice alongside the modeled backlogs it was made from)
        self._decisions: collections.deque = collections.deque(
            maxlen=256)
        # in-flight recovery + self-driving fleet state.
        # `recover_requests` wraps every direct-path handle in a
        # _RecoverableRequest; everything below is gated on it (or on
        # a FleetController registering via _managed) so the
        # unmanaged router's /metrics and flight_record stay
        # byte-identical to the legacy schema.
        self.recover_requests = bool(recover_requests)
        self.max_resubmits = int(max_resubmits)
        self._resubmitted = 0
        self._fleet_replaced = 0
        self._scale_events = 0
        self._handoff_rejected = 0
        self._managed = False      # a FleetController owns this fleet
        self._controller = None
        # eviction trail: every replica that left rotation, with the
        # flight-record dump it left behind (ROADMAP 5a correlation)
        self._evictions: collections.deque = collections.deque(
            maxlen=64)

    # -- health ------------------------------------------------------------

    def _probe(self) -> Tuple[List[int], Dict[int, int], Dict[int, float]]:
        """(healthy replica ids, occupancy loads, modeled-FLOPs
        backlogs). Runs OUTSIDE the router lock on purpose: for
        HTTPReplica fleets health/load are network probes (seconds of
        blocking I/O on a sick host), and one hung replica must never
        stall every other handler thread's submit behind the lock.
        `_down_until` reads here are unsynchronized — a stale read only
        delays rotation changes by one dispatch, which the advisory
        contract absorbs. The modeled backlog is absent for
        replicas without a cost registry (and for remote replicas);
        ordering only trusts it when EVERY candidate reports one."""
        now = time.monotonic()
        healthy: List[int] = []
        loads: Dict[int, int] = {}
        mloads: Dict[int, float] = {}
        for rep in self.replicas:
            rid = rep.replica_id
            if self._down_until.get(rid, 0.0) > now:
                continue
            h = rep.health()
            if h["alive"] and h["broken"] is None:
                healthy.append(rid)
                loads[rid] = h["queue_depth"] + h["slots_busy"]
                fn = getattr(rep, "modeled_backlog_flops", None)
                if fn is not None:
                    try:
                        m = fn()
                    except Exception:  # noqa: BLE001 — advisory signal
                        m = None
                    if m is not None:
                        mloads[rid] = float(m)
            else:
                self._mark_down(rid, h["broken"] or "serve loop dead")
        return healthy, loads, mloads

    def _mark_down(self, rid: int, why,
                   cooldown: Optional[float] = None) -> None:
        """Takes the router lock itself — callers must NOT hold it.
        Every departure appends an eviction event carrying the
        replica's last flight-record dump path (/ ROADMAP 5a:
        poison rotation and the engine's auto-dump used to be
        uncorrelated artifacts)."""
        rep = self._by_id.get(rid)
        dump = None
        if rep is not None:
            fn = getattr(rep, "last_dump_path", None)
            if fn is not None:
                try:
                    dump = fn()
                except Exception:  # noqa: BLE001 — advisory attach
                    dump = None
        cd = self.unhealthy_cooldown_s if cooldown is None else cooldown
        with self._lock:
            dropped = self._index.drop_replica(rid)
            self._down_until[rid] = time.monotonic() + cd
            self._evictions.append({
                "t": time.time(), "replica": rid,
                "why": str(why)[:200], "index_dropped": dropped,
                "flight_dump": dump})
        _logger.warning(
            "router: replica %d out of rotation (%s); %d affinity "
            "entries dropped (its pools died with it), re-probe in "
            "%.1fs%s", rid, why, dropped, cd,
            f", flight record at {dump}" if dump else "")

    # -- fleet mutation (the FleetController's surface) ----------

    def condemn(self, rid: int, why: str = "condemned") -> None:
        """Take a replica out of rotation PERMANENTLY (infinite
        cooldown): the health re-probe can never readmit it. The
        controller's replace cycle condemns first — stopping admission
        — then drains, stops, and swaps in the replacement via
        replace_replica() (which clears the condemnation)."""
        self._mark_down(rid, why, cooldown=float("inf"))

    def replace_replica(self, rid: int, new_rep) -> None:
        """Swap a (condemned/dead) replica for a warmed replacement
        carrying the SAME replica id — the rotation-back-in step of
        the replace cycle. The replacement's pools start empty, so its
        affinity-index entries (already dropped at condemn time) stay
        dropped."""
        if new_rep.replica_id != rid:
            raise ValueError(
                f"replacement carries replica_id "
                f"{new_rep.replica_id}, expected {rid} — the fleet's "
                f"id space (dispatch accounting, SSE replica tags) "
                f"must stay stable across a replace")
        if new_rep.page_size != self.page_size:
            raise ValueError(
                f"replacement page_size {new_rep.page_size} != fleet "
                f"page_size {self.page_size}")
        with self._lock:
            if rid not in self._by_id:
                raise KeyError(f"no replica {rid} in this fleet")
            # rebuild as a NEW list: _probe/counters/health iterate
            # self.replicas unlocked, and must see either the old or
            # the new fleet, never a half-mutated one
            self.replicas = [new_rep if r.replica_id == rid else r
                             for r in self.replicas]
            self._by_id[rid] = new_rep
            self._index.drop_replica(rid)
            self._down_until.pop(rid, None)  # lift the condemnation
        _logger.warning("router: replica %d replaced, back in "
                        "rotation", rid)

    def add_replica(self, rep) -> None:
        """Grow the active set (scale-up). Symmetric fleets only: a
        disaggregated fleet's role lists are a topology decision the
        controller does not make."""
        if self.disagg:
            raise ValueError("add_replica: disaggregated fleets do "
                             "not support elastic scaling")
        if rep.page_size != self.page_size:
            raise ValueError(
                f"new replica page_size {rep.page_size} != fleet "
                f"page_size {self.page_size}")
        with self._lock:
            if rep.replica_id in self._by_id:
                raise ValueError(
                    f"duplicate replica id {rep.replica_id}")
            self.replicas = self.replicas + [rep]
            self._by_id[rep.replica_id] = rep
            self._decode_ids = self._decode_ids + [rep.replica_id]
            self._per_replica.setdefault(rep.replica_id, 0)
            self.max_context = min(r.max_context for r in self.replicas)
            self.num_pages = min(r.num_pages for r in self.replicas)
        _logger.warning("router: replica %d added (fleet now %d)",
                        rep.replica_id, len(self.replicas))

    def remove_replica(self, rid: int):
        """Shrink the active set (scale-down): drop the replica from
        rotation and RETURN it — the caller owns the drain + stop (the
        controller drains it outside the router lock). Refuses to
        remove the last replica: an empty fleet cannot 503 its way
        back."""
        if self.disagg:
            raise ValueError("remove_replica: disaggregated fleets do "
                             "not support elastic scaling")
        with self._lock:
            if rid not in self._by_id:
                raise KeyError(f"no replica {rid} in this fleet")
            if len(self.replicas) <= 1:
                raise ValueError("remove_replica: refusing to remove "
                                 "the last replica")
            rep = self._by_id.pop(rid)
            self.replicas = [r for r in self.replicas
                             if r.replica_id != rid]
            self._decode_ids = [r for r in self._decode_ids
                                if r != rid]
            self._index.drop_replica(rid)
            self._down_until.pop(rid, None)
            self.max_context = min(r.max_context for r in self.replicas)
            self.num_pages = min(r.num_pages for r in self.replicas)
        _logger.warning("router: replica %d removed (fleet now %d)",
                        rid, len(self.replicas))
        return rep

    def note_replaced(self) -> None:
        with self._lock:
            self._fleet_replaced += 1

    def note_scale_event(self) -> None:
        with self._lock:
            self._scale_events += 1

    def evictions(self) -> list:
        """The bounded eviction trail (replica departures with their
        flight-record dump paths)."""
        with self._lock:
            return [dict(e) for e in self._evictions]

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _order_by_backlog(ids: List[int], loads: Dict[int, int],
                          mloads: Dict[int, float]) -> List[int]:
        """Least-backlogged-first ordering: by modeled FLOPs when EVERY
        candidate reports them (a 4k-token prefill then outweighs ten
        12-token completions, which raw occupancy cannot see), by
        queue_depth + slots_busy otherwise — mixing modeled and
        occupancy numbers would compare incommensurable units."""
        if ids and all(rid in mloads for rid in ids):
            return sorted(ids, key=lambda rid: (mloads[rid], rid))
        return sorted(ids, key=lambda rid: (loads.get(rid, 0), rid))

    def _pick(self, prompt, healthy: List[int], loads: Dict[int, int],
              mloads: Dict[int, float]) -> List[int]:
        """Candidate replica ids in dispatch order: affinity hit first
        (when it is healthy), then the fallback-policy ordering of the
        rest — the failover path walks this list. Called under the
        router lock (index + counters); load comes pre-probed."""
        order: List[int] = []
        if self.affinity:
            hit, pages = self._index.lookup(prompt)
            if hit is not None and hit in healthy:
                order.append(hit)
                self._affinity_hits += 1
                self._affinity_hit_pages += pages
        rest = [r for r in healthy if r not in order]
        if self.fallback == "random":
            self._rng.shuffle(rest)
        else:
            rest = self._order_by_backlog(rest, loads, mloads)
        return order + rest

    def _admission_gate(self, cands: List[int]) -> None:
        """SLO-aware admission: with `ttft_slo_s` set,
        reject when the MODELED drain time of every eligible replica
        exceeds the budget — the request would be born an SLO miss.
        Stays open when any candidate cannot model its backlog (no
        cost registry / no chip spec / remote): an occupancy number is
        not a drain time, and rejecting on a guess would be the
        dishonest Retry-After this satellite exists to remove."""
        if self.ttft_slo_s is None:
            return
        secs: List[float] = []
        for rid in cands:
            fn = getattr(self._by_id[rid], "modeled_backlog_s", None)
            s = None
            if fn is not None:
                try:
                    s = fn()
                except Exception:  # noqa: BLE001 — advisory signal
                    s = None
            if s is None:
                return
            secs.append(float(s))
        if not secs or min(secs) <= self.ttft_slo_s:
            return
        best = min(secs)
        retry = float(min(max(best, 1.0), 60.0))
        with self._lock:
            self._rejected += 1
            self._slo_rejected += 1
            self._decisions.append({
                "path": "slo_reject", "modeled_backlog_s": round(best, 4),
                "ttft_slo_s": self.ttft_slo_s,
                "retry_after_s": retry})
        raise BacklogExceeded(
            f"router: modeled backlog {best:.2f}s exceeds the "
            f"ttft_slo_s={self.ttft_slo_s}s budget on every eligible "
            f"replica — admitting now would guarantee an SLO miss; "
            f"retry in {retry:.0f}s", retry_after_s=retry)

    def submit(self, prompt, tokens_to_generate, **kw):
        """Dispatch one request; the returned handle is the chosen
        engine's own EngineRequest (rid + replica_id identify it
        fleet-wide) — or, on the disaggregated two-stage path, a
        _HandoffRequest proxy with the same result()/stream contract.
        Raises the last replica error — QueueFull only when EVERY
        healthy replica's queue is full, FleetUnavailable (a QueueFull:
        the HTTP layer's 503 + Retry-After) when no replica is healthy
        at all, BacklogExceeded when modeled admission rejects.

        With `recover_requests=True` (symmetric fleets) the returned
        handle is a _RecoverableRequest: if its replica dies before any
        token streamed, the handle transparently redispatches through
        this router (in-flight recovery)."""
        if not self.disagg:
            prompt = list(prompt)
            req = self._dispatch_raw(prompt, tokens_to_generate, kw)
            if self.recover_requests:
                return _RecoverableRequest(self, prompt,
                                           tokens_to_generate, kw, req,
                                           self.max_resubmits)
            return req
        healthy, loads, mloads = self._probe()  # blocking I/O unlocked
        if not healthy:
            with self._lock:
                self._rejected += 1
            raise FleetUnavailable(
                "router: no healthy replica (all poisoned/stopped "
                "or cooling down) — the fleet cannot take traffic; "
                "retry after the cooldown")
        prompt = list(prompt)
        pre = [r for r in self._prefill_ids if r in healthy]
        # short prompts stay on decode replicas; with every decode
        # replica down the fleet degrades to whatever is healthy
        # (a prefill replica is a full engine) rather than 503ing
        dec = [r for r in self._decode_ids if r in healthy] or healthy
        self._admission_gate(dec)
        pages = (len(prompt) - 1) // self.page_size
        if (pre and pages >= self.disagg_min_prompt_pages
                and not kw.get("return_log_probs")):
            # return_log_probs stays direct: a transferred-prefix HIT
            # skips those positions' logits entirely, and the two-stage
            # win is TTFT on long-prompt GENERATION traffic
            return self._submit_two_stage(prompt, tokens_to_generate,
                                          kw)
        return self._submit_direct(prompt, tokens_to_generate, kw,
                                   dec, loads, mloads)

    def _dispatch_raw(self, prompt, tokens_to_generate, kw):
        """One symmetric-fleet dispatch attempt: probe, admission
        gate, direct submit. Split out of submit() so the recovery
        proxy can redispatch a dead replica's request through a FRESH
        probe (which sees the death and routes around it)."""
        healthy, loads, mloads = self._probe()  # blocking I/O unlocked
        if not healthy:
            with self._lock:
                self._rejected += 1
            raise FleetUnavailable(
                "router: no healthy replica (all poisoned/stopped "
                "or cooling down) — the fleet cannot take traffic; "
                "retry after the cooldown")
        self._admission_gate(healthy)
        return self._submit_direct(prompt, tokens_to_generate, kw,
                                   healthy, loads, mloads)

    def _submit_direct(self, prompt, tokens_to_generate, kw,
                       cands: List[int], loads, mloads):
        from megatron_llm_tpu_torch.inference.engine import QueueFull

        with self._lock:
            order = self._pick(prompt, cands, loads, mloads)
            self._dispatches += 1
        last_err: Optional[BaseException] = None
        for i, rid in enumerate(order):
            rep = self._by_id[rid]
            try:
                req = rep.submit(prompt, tokens_to_generate, **kw)
            except QueueFull as e:
                # this replica is full, the next may not be
                last_err = e
                with self._lock:
                    self._failovers += 1 if i + 1 < len(order) else 0
                continue
            except ValueError:
                # request-shaped error (oversize prompt etc.): every
                # replica would refuse it identically — surface as-is
                raise
            except Exception as e:  # noqa: BLE001 — poisoned mid-dispatch
                last_err = e
                self._mark_down(rid, repr(e))
                with self._lock:
                    self._failovers += 1 if i + 1 < len(order) else 0
                continue
            with self._lock:
                self._per_replica[rid] += 1
                if self.affinity:
                    self._index.register(prompt, rid)
                if self.disagg or self.ttft_slo_s is not None:
                    self._decisions.append({
                        "path": "direct", "replica": rid,
                        "prompt_tokens": len(prompt),
                        "loads": dict(loads),
                        "modeled_flops": dict(mloads)})
            return req
        with self._lock:
            self._rejected += 1
        raise last_err if last_err is not None else RuntimeError(
            "router: dispatch failed with no replica error")

    # -- two-stage (prefill -> transfer -> decode) dispatch ----------------

    def _submit_two_stage(self, prompt, tokens_to_generate, kw):
        proxy = _HandoffRequest(prompt, tokens_to_generate,
                                stream=bool(kw.get("stream")))
        with self._lock:
            self._dispatches += 1
        threading.Thread(
            target=self._run_two_stage,
            args=(proxy, prompt, tokens_to_generate, dict(kw)),
            daemon=True).start()
        return proxy

    def _run_two_stage(self, proxy, prompt, tokens_to_generate, kw):
        try:
            self._two_stage_inner(proxy, prompt, tokens_to_generate, kw)
        except BaseException as e:  # noqa: BLE001 — the caller holds
            # only the proxy; an unreported stage failure would hang it
            proxy.fail(f"two-stage dispatch failed: {e!r}",
                       timed_out=isinstance(e, TimeoutError))

    def _two_stage_inner(self, proxy, prompt, tokens_to_generate, kw):
        from megatron_llm_tpu_torch.inference.engine import QueueFull

        # stage 1: full-prompt chunked prefill on the least-backlogged
        # prefill replica. A greedy 1-token run prefills the whole
        # prompt and registers its full pages on the donor's
        # PrefixCache; the single generated token never lands in a
        # registered page, so the export is exactly the prompt's
        # full-page prefix.
        healthy, loads, mloads = self._probe()
        payload, pre_rid = None, None
        t_x0 = None
        pre_ids = [r for r in self._prefill_ids if r in healthy]
        if pre_ids and not proxy.cancelled:
            pre_rid = self._order_by_backlog(pre_ids, loads, mloads)[0]
            pre = self._by_id[pre_rid]
            try:
                pre_req = pre.submit(
                    prompt, 1, top_k=1, seed=0,
                    use_eod_for_early_termination=False,
                    deadline_s=kw.get("deadline_s"))
                pre_req.result(timeout=self.handoff_timeout_s)
                t_x0 = time.perf_counter()
                payload = pre.export_prefix(prompt)
            except Exception as e:  # noqa: BLE001 — donor trouble
                # never fails the request: fall back to direct prefill
                # on the decode replica (the symmetric-path behaviour)
                if not isinstance(e, (QueueFull, TimeoutError)):
                    self._mark_down(pre_rid, repr(e))
                payload, t_x0 = None, None
            else:
                with self._lock:
                    self._prefill_dispatches += 1
                    self._per_replica[pre_rid] += 1
                # for a greedy request the donor's 1-token run already
                # produced the continuation's first token (the decode
                # replica regenerates it bitwise-identically off the
                # transferred pages), so TTFT is prefill-stage
                # completion — stamp it now, before splice + resubmit
                if kw.get("top_k") == 1:
                    proxy.t_first = getattr(pre_req, "t_first", 0.0) or 0.0

        # stage 2 + 3: splice the pages into the least-backlogged
        # decode replica, then submit the full request there — the
        # transferred chain admits as a prefix HIT, so the decode
        # replica prefills nothing (or, on fallback, everything: the
        # request is correct either way, only slower).
        healthy, loads, mloads = self._probe()
        dec_ids = [r for r in self._decode_ids if r in healthy] or healthy
        if not dec_ids:
            with self._lock:
                self._rejected += 1
            raise FleetUnavailable(
                "router: no decode replica healthy for the hand-off")
        order = self._order_by_backlog(dec_ids, loads, mloads)
        last_err: Optional[BaseException] = None
        for i, rid in enumerate(order):
            rep = self._by_id[rid]
            moved = 0
            try:
                if payload is not None and not proxy.cancelled:
                    try:
                        res = rep.import_prefix(payload)
                    except ValueError as e:
                        # corrupt/mismatched payload (chaos
                        # matrix): the receiver's geometry gate refused
                        # the splice. Degrade, don't fail — drop the
                        # payload and let the decode replica prefill
                        # the prompt itself (correct, only slower).
                        _logger.warning(
                            "router: decode replica %d rejected the "
                            "hand-off payload (%s) — degrading to a "
                            "local prefill", rid, e)
                        with self._lock:
                            self._handoff_rejected += 1
                        res, payload = False, None
                    if res:
                        moved = int(res.get("pages", 0))
                req = rep.submit(prompt, tokens_to_generate, **kw)
            except QueueFull as e:
                last_err = e
                with self._lock:
                    self._failovers += 1 if i + 1 < len(order) else 0
                continue
            except ValueError:
                raise
            except Exception as e:  # noqa: BLE001 — replica died
                # mid-transfer: mark it down and fail over. The donor
                # needs NO cleanup — its pages stayed registered and
                # unreferenced, reclaimable by its own LRU eviction.
                last_err = e
                self._mark_down(rid, repr(e))
                with self._lock:
                    self._failovers += 1 if i + 1 < len(order) else 0
                continue
            xfer_ms = (0.0 if t_x0 is None
                       else (time.perf_counter() - t_x0) * 1e3)
            with self._lock:
                self._per_replica[rid] += 1
                if self.affinity:
                    # future same-prefix prompts route straight to the
                    # replica now holding the transferred pages
                    self._index.register(prompt, rid)
                if moved:
                    self._transfer_pages += moved
                    self._transfer_ms += xfer_ms
                self._decisions.append({
                    "path": "two_stage", "prefill": pre_rid,
                    "decode": rid, "pages": moved,
                    "prompt_tokens": len(prompt),
                    "loads": dict(loads),
                    "modeled_flops": dict(mloads)})
            self._finish_two_stage(proxy, rep, req)
            return
        with self._lock:
            self._rejected += 1
        raise last_err if last_err is not None else FleetUnavailable(
            "router: no decode replica accepted the hand-off")

    def _finish_two_stage(self, proxy, rep, req) -> None:
        """Wire the decode replica's live request back onto the proxy:
        attach ids, honour a pre-attach cancel, pump the token stream,
        and mirror the final outcome."""
        proxy.attach(req)
        if proxy.cancelled:
            try:
                rep.cancel(req)
            except Exception:  # noqa: BLE001
                pass
        inner_q = getattr(req, "stream_q", None)
        if proxy.stream_q is not None and inner_q is not None:
            while True:
                try:
                    tok = inner_q.get(timeout=self.handoff_timeout_s)
                except queue_mod.Empty:
                    break  # engine hung: finalize below reports it
                proxy.stream_q.put(tok)
                if tok is None:
                    break
        done = getattr(req, "done", None)
        if done is not None:
            done.wait(timeout=self.handoff_timeout_s)
        proxy.finalize(req)

    def cancel(self, req) -> None:
        if isinstance(req, _RecoverableRequest):
            req.cancelled = True  # stops any further resubmit
            req = req._inner      # fall through: cancel the live inner
        if isinstance(req, _HandoffRequest):
            req.cancelled = True  # pre-attach: the orchestration
            # thread sees it and cancels on arrival
            if req.inner is None:
                return
            req = req.inner
        rep = self._by_id.get(getattr(req, "replica_id", None))
        if rep is None:
            _logger.warning("router.cancel: request %r names no known "
                            "replica", getattr(req, "rid", None))
            return
        rep.cancel(req)

    # -- aggregated observability -----------------------------------------

    def router_stats(self) -> dict:
        # probe-backoff gauge reads replica state OUTSIDE the lock
        # (HTTPReplica accessors are plain attribute reads, but the
        # replica list itself may be mid-scale — snapshot it)
        backoff = 0.0
        for rep in list(self.replicas):
            fn = getattr(rep, "reprobe_backoff_s", None)
            if fn is not None:
                try:
                    backoff = max(backoff, float(fn()))
                except Exception:  # noqa: BLE001 — advisory gauge
                    pass
        with self._lock:
            d = max(self._dispatches, 1)
            out = {
                "router_replicas": len(self.replicas),
                "router_affinity": self.affinity,
                "router_fallback": self.fallback,
                "router_dispatches": self._dispatches,
                "router_affinity_hits": self._affinity_hits,
                "router_affinity_hit_rate": round(
                    self._affinity_hits / d, 4),
                "router_affinity_hit_pages": self._affinity_hit_pages,
                "router_failovers": self._failovers,
                "router_rejected": self._rejected,
                "router_index_entries": len(self._index),
                "router_per_replica_dispatches": dict(self._per_replica),
            }
            if self.disagg:
                # gated on disaggregated mode so symmetric
                # fleets keep the byte-compatible legacy /metrics JSON
                out["router_prefill_replicas"] = len(self._prefill_ids)
                out["router_decode_replicas"] = len(self._decode_ids)
                out["serve_prefill_replica"] = self._prefill_dispatches
                out["serve_transfer_pages"] = self._transfer_pages
                out["serve_transfer_ms"] = round(self._transfer_ms, 2)
            if self.ttft_slo_s is not None:
                out["router_slo_rejected"] = self._slo_rejected
            # each gated on ITS feature being armed so the
            # unmanaged, non-recovering fleet keeps the legacy schema
            if self.recover_requests:
                out["serve_resubmitted"] = self._resubmitted
            if self._managed:
                out["serve_fleet_replaced"] = self._fleet_replaced
                out["serve_scale_events"] = self._scale_events
            if self._handoff_rejected:
                out["serve_handoff_rejected"] = self._handoff_rejected
            if backoff > 0:
                out["router_reprobe_backoff_s"] = round(backoff, 3)
            return out

    def decision_log(self) -> list:
        """The recent placement decisions (bounded ring): path taken,
        chosen prefill/decode replicas, pages shipped, and the
        loads/modeled-FLOPs snapshot each choice was made from — the
        reproducibility trail (the bench re-derives the
        routing from exactly these records)."""
        with self._lock:
            return [dict(dec) for dec in self._decisions]

    def retry_after_s(self) -> float:
        """Honest fleet Retry-After (satellite): the SOONEST
        any replica's modeled backlog drains, clamped to [1, 60] s;
        constant 1 s when no replica can model (the legacy header)."""
        vals: List[float] = []
        for rep in self.replicas:
            fn = getattr(rep, "retry_after_s", None)
            if fn is None:
                continue
            try:
                v = fn()
            except Exception:  # noqa: BLE001 — advisory
                v = None
            if v is not None:
                vals.append(float(v))
        if not vals:
            return 1.0
        return float(min(max(min(vals), 1.0), 60.0))

    def counters(self) -> dict:
        """Fleet /metrics: router dispatch stats + additive engine
        counters summed across replicas + per-replica detail under
        "replicas" (keyed by replica id — each row carries its own
        serve_replica_id). Non-additive gauges (percentiles, rates,
        dtypes) stay per-replica only: summing a p95 would fabricate a
        number; the fleet-wide distributions live in the MERGED
        histograms on the Prometheus surface."""
        per = {r.replica_id: r.counters() for r in self.replicas}
        agg: dict = dict(self.router_stats())
        # serve_kv_pool_bytes is PER-CHIP by contract (engine.py
        # small fix) — the fleet sum scales each replica by
        # its tp instead (fleet_kv_pool_bytes), under its own key so
        # the two units can never be confused
        agg["serve_kv_pool_bytes_fleet"] = sum(
            r.fleet_kv_pool_bytes() for r in self.replicas)
        additive = (
            "serve_queue_depth",
            "serve_pages_in_use", "serve_pages_free", "serve_admitted",
            "serve_retired", "serve_timed_out", "serve_cancelled",
            "serve_steps", "serve_tok_s", "serve_prefill_tokens",
            "serve_prefix_hit_tokens", "serve_prefix_lookup_tokens",
            "serve_prefix_hits", "serve_prefix_lookups",
            "serve_prefix_cached_pages", "serve_prefix_shared_pages",
            "serve_prefix_cow_copies", "serve_prefix_evicted_pages",
            # device-cost + sentinel aggregates: present
            # only on replicas running with the cost registry /
            # sentinel on — the per-request cost records' fleet totals
            "serve_modeled_gflops", "serve_page_rounds",
            "serve_perf_regressions", "serve_perf_bad_rounds",
        )
        for key in additive:
            vals = [c[key] for c in per.values() if key in c]
            if vals:
                agg[key] = round(sum(vals), 2)
        agg["replicas"] = per
        return agg

    def health(self) -> dict:
        """The router's load-balancer probe, same shape the server
        expects from an engine: alive while ANY replica can take
        traffic."""
        per = {r.replica_id: r.health() for r in self.replicas}
        alive = [rid for rid, h in per.items()
                 if h["alive"] and h["broken"] is None]
        return {
            "alive": bool(alive),
            "broken": None if alive else "all replicas down",
            "queue_depth": sum(h["queue_depth"] for h in per.values()),
            "slots_busy": sum(h["slots_busy"] for h in per.values()),
            "replicas": per,
        }

    def histograms(self):
        """Fleet-wide latency histograms: per-name bucket merge across
        replicas (cumulative buckets are additive)."""
        from megatron_llm_tpu_torch.telemetry import Histogram

        by_name: Dict[str, list] = {}
        for rep in self.replicas:
            for h in rep.histograms():
                by_name.setdefault(h.name, []).append(h)
        return [Histogram.merged(hs) for hs in by_name.values()]

    def prometheus_metrics(self) -> str:
        from megatron_llm_tpu_torch.telemetry import render_prometheus

        counters = {k: v for k, v in self.counters().items()
                    if k not in ("replicas",
                                 "router_per_replica_dispatches")}
        return render_prometheus(counters, self.histograms())

    def flight_record(self) -> dict:
        out = {"reason": "on-demand",
               "router": self.router_stats(),
               "replicas": {r.replica_id: r.flight_record()
                            for r in self.replicas}}
        if self.disagg or self.ttft_slo_s is not None:
            # gated like the counters: pre-dumps keep their shape
            out["decisions"] = self.decision_log()
        # gated on having something to report — a fleet that
        # never lost a replica (and runs unmanaged) keeps legacy shape
        ev = self.evictions()
        if ev:
            out["evictions"] = ev
        if self._controller is not None:
            out["fleet"] = self._controller.flight_events()
        return out

    def request_profile(self, rounds: int,
                        trace_dir: Optional[str] = None,
                        replica: int = 0) -> dict:
        """Arm a profiler capture on ONE replica (the profiler is
        process-global — arming N in-process engines at once would
        collide; POST /profile defaults to replica 0)."""
        rep = self._by_id.get(replica)
        if rep is None or not hasattr(rep, "engine"):
            return {"ok": False,
                    "error": f"no in-process replica {replica}"}
        return rep.engine.request_profile(rounds, trace_dir=trace_dir)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        for rep in self.replicas:
            rep.start()
        self._thread = object()  # duck-typed "started" (server.run)

    def drain(self):
        for rep in self.replicas:
            rep.drain()

    def stop(self, drain: bool = True):
        for rep in self.replicas:
            rep.stop(drain=drain)
        self._thread = None
