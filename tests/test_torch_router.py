"""PyTorch port, the prefix-affinity replica router (inference/router.py)
against the JAX package's: the same scripted, duck-typed replicas (the
protocol surface the router speaks, with load, health, queue-full,
failure, hand-off and modeled-backlog knobs) run through both routers,
and each scenario's trail must be equal: the replicas that received each
submit, the exceptions raised, `decision_log()`, `router_stats()` (the
measured transfer ms aside) and the fleet's Retry-After. Covered:
affinity hits, the least-loaded and the seeded-random fallbacks,
failover on a dying replica, QueueFull, poisoned replicas leaving
rotation, ordering by modeled backlog, SLO admission with its clamped
Retry-After, the two-stage (disaggregated) route and its degradations,
the page-aligned affinity index, and the aggregated counters and merged
histograms."""

import threading
import time
import types

import pytest

from megatron_llm_tpu.inference import engine as jax_engine
from megatron_llm_tpu.inference import router as jax_router
from megatron_llm_tpu.telemetry import Histogram as JaxHistogram
from megatron_llm_tpu_torch.inference import engine as pt_engine
from megatron_llm_tpu_torch.inference import router as pt_router
from megatron_llm_tpu_torch.telemetry import Histogram as PtHistogram


class DoneReq:
    """A finished request handle (what the two-stage thread waits on)."""

    def __init__(self, rid, replica_id, prompt, n):
        self.rid = rid
        self.replica_id = replica_id
        self.tokens = list(prompt) + [7] * n
        self.log_probs = []
        self.return_log_probs = False
        self.error = None
        self.timed_out = False
        self.stream_q = None
        self.done = threading.Event()
        self.done.set()
        self.t_submit = self.t_first = self.t_done = 1.0

    def result(self, timeout=None):
        return list(self.tokens), None


def fake_class(queue_full, histogram):
    """A scripted replica class raising this package's QueueFull and
    reporting this package's Histogram."""

    class Fake:
        def __init__(self, rid, load=0, modeled_flops=None, modeled_s=None,
                     retry_after=None):
            self.replica_id = rid
            self._load = load
            self._alive = True
            self._broken = None
            self.full = False
            self.fail_submit = None
            self.fail_import = None
            self.import_result = "echo"
            self.export_payload = {"pages": 2, "tokens": list(range(32)),
                                   "page_size": 16}
            self.modeled_flops = modeled_flops
            self.modeled_s = modeled_s
            self.retry_after = retry_after
            self.trail = []
            self.page_size = 16
            self.max_context = 64
            self.num_pages = 9
            self._next = 0

        def submit(self, prompt, n, **kw):
            if self.full:
                raise queue_full("queue full")
            if self.fail_submit is not None:
                raise self.fail_submit
            self.trail.append(("submit", tuple(prompt), n))
            self._next += 1
            return DoneReq(self._next - 1, self.replica_id, prompt, n)

        def cancel(self, req):
            self.trail.append(("cancel", req.rid))

        def export_prefix(self, prompt):
            self.trail.append(("export", tuple(prompt)))
            return self.export_payload

        def import_prefix(self, payload):
            if self.fail_import is not None:
                raise self.fail_import
            self.trail.append(("import", payload.get("pages")))
            if self.import_result == "echo":
                return {"pages": int(payload["pages"]),
                        "registered": int(payload["pages"])}
            return self.import_result

        def health(self):
            return {"alive": self._alive, "broken": self._broken,
                    "queue_depth": self._load, "slots_busy": 0}

        def load(self):
            return self._load

        def modeled_backlog_flops(self):
            return self.modeled_flops

        def modeled_backlog_s(self):
            return self.modeled_s

        def retry_after_s(self):
            return self.retry_after

        def counters(self):
            return {"serve_replica_id": self.replica_id,
                    "serve_admitted": len(self.trail),
                    "serve_queue_depth": self._load,
                    "serve_kv_pool_bytes": 1000,
                    "serve_ttft_p95_ms": 10.0 * (self.replica_id + 1)}

        def fleet_kv_pool_bytes(self):
            return 2000

        def histograms(self):
            h = histogram("serve_ttft_ms")
            for v in range(self.replica_id + 2):
                h.observe(3.0 * v)
            return [h]

        def flight_record(self):
            return {"events": []}

        def start(self):
            pass

        def stop(self, drain=True):
            self.trail.append(("stop", drain))

        def drain(self):
            pass

    return Fake


JAX = types.SimpleNamespace(
    Router=jax_router.ReplicaRouter, QueueFull=jax_engine.QueueFull,
    Index=jax_router.PrefixAffinityIndex, Histogram=JaxHistogram,
    Fake=fake_class(jax_engine.QueueFull, JaxHistogram))
PORT = types.SimpleNamespace(
    Router=pt_router.ReplicaRouter, QueueFull=pt_engine.QueueFull,
    Index=pt_router.PrefixAffinityIndex, Histogram=PtHistogram,
    Fake=fake_class(pt_engine.QueueFull, PtHistogram))

LONG = list(range(2, 35))  # 33 tokens: 2 full pages of 16
SHORT = list(range(2, 18))  # 16 tokens: no full page
SHARED = list(range(100, 140))


def _submit(log, router, prompt, n=4, **kw):
    """Submit and log what came back: the replica and rid, or the
    exception's type and message."""
    try:
        req = router.submit(prompt, n, top_k=1, **kw)
    except Exception as e:  # noqa: BLE001: the trail records it
        log.append(("raised", type(e).__name__, str(e),
                    getattr(e, "retry_after_s", None)))
        return None
    if hasattr(req, "finalize") or hasattr(req, "_inner"):
        req.result(timeout=30)  # the two-stage thread finishes first
    log.append(("ok", getattr(req, "replica_id", None)))
    return req


def _trail(pkg, router, reps, log):
    stats = {k: v for k, v in router.router_stats().items()
             if not k.endswith("_ms")}
    return {"log": log, "replicas": [r.trail for r in reps],
            "decisions": router.decision_log(), "stats": stats,
            "retry_after": router.retry_after_s()}


def affinity(pkg):
    reps = [pkg.Fake(0, load=3), pkg.Fake(1, load=0), pkg.Fake(2, load=1)]
    r = pkg.Router(reps)
    log = []
    _submit(log, r, SHARED + [1, 2])  # miss: least loaded (1)
    reps[1]._load = 9
    _submit(log, r, SHARED + [3])  # hit on replica 1 despite its load
    _submit(log, r, [5] * 40)  # miss: least loaded now 2
    return _trail(pkg, r, reps, log)


def least_loaded(pkg):
    reps = [pkg.Fake(0, load=2), pkg.Fake(1, load=2), pkg.Fake(2, load=5)]
    r = pkg.Router(reps, affinity=False)
    log = []
    for i in range(3):
        _submit(log, r, SHARED)
        reps[i % 2]._load += 3
    return _trail(pkg, r, reps, log)


def seeded_random(pkg):
    reps = [pkg.Fake(i) for i in range(4)]
    r = pkg.Router(reps, affinity=False, fallback="random", rng_seed=11)
    log = []
    for i in range(8):
        _submit(log, r, [i + 2] * 20)
    return _trail(pkg, r, reps, log)


def failover(pkg):
    reps = [pkg.Fake(0), pkg.Fake(1, load=1)]
    reps[0].fail_submit = RuntimeError("engine is stopped: poisoned")
    r = pkg.Router(reps, unhealthy_cooldown_s=3600)
    log = []
    _submit(log, r, SHORT)  # 0 fails, fails over to 1, 0 marked down
    reps[0].fail_submit = None
    _submit(log, r, SHORT)  # 0 still cooling down
    return _trail(pkg, r, reps, log)


def queue_full(pkg):
    reps = [pkg.Fake(0), pkg.Fake(1, load=1)]
    reps[0].full = True
    r = pkg.Router(reps)
    log = []
    _submit(log, r, SHORT)
    reps[1].full = True
    _submit(log, r, SHORT)  # every queue full: QueueFull surfaces
    return _trail(pkg, r, reps, log)


def poisoned(pkg):
    reps = [pkg.Fake(0), pkg.Fake(1, load=4)]
    r = pkg.Router(reps, unhealthy_cooldown_s=3600)
    log = []
    _submit(log, r, SHARED)  # indexed on 0
    reps[0]._broken = "engine step failed"
    _submit(log, r, SHARED)  # 0 left rotation, its entries dropped
    reps[1]._alive = False
    _submit(log, r, SHARED)  # nobody healthy: FleetUnavailable
    return _trail(pkg, r, reps, log)


def backlog_order(pkg):
    reps = [pkg.Fake(0, load=0, modeled_flops=9e12),
            pkg.Fake(1, load=5, modeled_flops=1e12),
            pkg.Fake(2, load=1, modeled_flops=4e12)]
    r = pkg.Router(reps, affinity=False)
    log = []
    _submit(log, r, SHORT)  # least modeled FLOPs: 1
    reps[1].modeled_flops = None  # one cannot model: occupancy order
    _submit(log, r, SHORT)
    return _trail(pkg, r, reps, log)


def slo_admission(pkg):
    reps = [pkg.Fake(0, modeled_s=12.0, retry_after=12.0),
            pkg.Fake(1, modeled_s=30.0, retry_after=30.0)]
    r = pkg.Router(reps, ttft_slo_s=5.0)
    log = []
    _submit(log, r, SHORT)  # every candidate over budget
    reps[0].modeled_s = reps[0].retry_after = 500.0
    reps[1].modeled_s = reps[1].retry_after = 700.0
    _submit(log, r, SHORT)  # the Retry-After clamps to 60
    reps[1].modeled_s = None  # one cannot model: the gate stays open
    _submit(log, r, SHORT)
    reps[1].modeled_s = 0.5
    _submit(log, r, SHORT)
    return _trail(pkg, r, reps, log)


def retry_after_clamp(pkg):
    out = []
    for vals in ((5.0, 90.0), (90.0,), (None,), (0.2, None)):
        r = pkg.Router([pkg.Fake(i, retry_after=v)
                        for i, v in enumerate(vals)])
        out.append(r.retry_after_s())
    return out


def two_stage(pkg):
    pre = [pkg.Fake(0)]
    dec = [pkg.Fake(1, load=2), pkg.Fake(2, load=0)]
    r = pkg.Router(prefill_replicas=pre, decode_replicas=dec)
    log = []
    _submit(log, r, LONG)  # two-stage: prefill on 0, import on 2
    _submit(log, r, SHORT)  # direct to a decode replica
    _submit(log, r, LONG, return_log_probs=True)  # log-probs go direct
    dec[1].fail_import = ValueError("import_prefix: page_size 17")
    _submit(log, r, LONG + [9])  # a refused payload degrades
    dec[1].fail_import = None
    dec[1].import_result = False  # a full receiver prefills locally
    dec[0].full = True
    _submit(log, r, LONG + [8])
    pre[0].fail_submit = RuntimeError("prefill replica died")
    dec[0].full = False
    _submit(log, r, LONG + [7])  # donor trouble: direct prefill
    return _trail(pkg, r, pre + dec, log)


def index_and_aggregation(pkg):
    idx = pkg.Index(16, cap_entries=3)
    out = []
    for prompt, rep in ((list(range(50)), 0), (list(range(20)), 1),
                        (list(range(16)), 2), ([9] * 40, 1),
                        ([8] * 64, 2)):
        idx.register(prompt, rep)
        out.append((idx.lookup(list(range(50))), len(idx)))
    out.append(idx.drop_replica(2))
    reps = [pkg.Fake(0, load=1), pkg.Fake(1, load=2)]
    r = pkg.Router(reps)
    log = []
    _submit(log, r, SHORT)
    c = r.counters()
    hists = [(h.name, h.cumulative(), h.sum, h.count)
             for h in r.histograms()]
    return {"index": out, "counters": c, "hists": hists,
            "health": r.health()}


SCENARIOS = [affinity, least_loaded, seeded_random, failover, queue_full,
             poisoned, backlog_order, slo_admission, retry_after_clamp,
             two_stage, index_and_aggregation]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_router_trail_equals_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_fleet_errors_are_the_503_family():
    """FleetUnavailable and BacklogExceeded are the port's QueueFull
    (the server's 503 + Retry-After), as in JAX."""
    assert issubclass(pt_router.FleetUnavailable, pt_engine.QueueFull)
    assert issubclass(pt_router.BacklogExceeded,
                      pt_router.FleetUnavailable)
    assert pt_router.BacklogExceeded("x", 7.0).retry_after_s == 7.0
    assert set(pt_router.__all__) == set(jax_router.__all__)
