"""PyTorch port, the self-driving fleet: chaos (inference/chaos.py) and the
fleet controller (inference/fleet.py) against the JAX package's, and the
kill-one-of-two convergence on real engines of the port.

- the chaos grammar: the same specs parse to the same policies and the
  same bad specs fail with the same messages; the seeded probe drops,
  the kill's arming and firing, the stalls and the hand-off corruption
  draw the same;
- `FleetController.decide` gives the same verdicts on a seeded grid of
  inputs, and controllers driven tick by tick over the same scripted
  replicas (a poisoned replica, a sentinel trip, scale decisions under
  hysteresis) record the same events, which replay through `decide` to
  the same verdicts;
- two tiny fp32 engines of the port behind the router with
  `recover_requests`, a controller and `kill=0@3`: every request of
  shared-prefix traffic answers (zero failed), the answers equal the
  no-chaos engine's and the JAX engine's, the dead replica is replaced
  once and its flight-record dump is written.
"""

import threading
import time
import types

import numpy as np
import pytest

from megatron_llm_tpu.inference import chaos as jax_chaos
from megatron_llm_tpu.inference import engine as jax_engine
from megatron_llm_tpu.inference import fleet as jax_fleet
from megatron_llm_tpu.inference import router as jax_router
from megatron_llm_tpu_torch.inference import chaos as pt_chaos
from megatron_llm_tpu_torch.inference import engine as pt_engine
from megatron_llm_tpu_torch.inference import fleet as pt_fleet
from megatron_llm_tpu_torch.inference import router as pt_router
from torch_parity import tiny_pair

JAX = types.SimpleNamespace(chaos=jax_chaos, fleet=jax_fleet,
                            router=jax_router, engine=jax_engine)
PORT = types.SimpleNamespace(chaos=pt_chaos, fleet=pt_fleet,
                             router=pt_router, engine=pt_engine)

SPECS = ["kill=1@8, stall=0:5.5x3, submit_latency_ms=2, "
         "probe_latency_ms=1.5, probe_drop=0.25@2, corrupt_handoff, seed=7",
         "kill=0", "stall=1:2", "probe_drop=0.5,seed=3", "", "kil=1",
         "probe_drop=1.5", "corrupt_handoff=maybe", "kill=x"]


def _policy_facts(p):
    return {k: v for k, v in vars(p).items()
            if not k.startswith("_") and k != "events"} | {
        "corrupt_handoff": p.corrupt_handoff}


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_grammar_equals_jax(spec):
    out = []
    for pkg in (PORT, JAX):
        try:
            out.append(("ok", _policy_facts(pkg.chaos.ChaosPolicy.parse(
                spec))))
        except Exception as e:  # noqa: BLE001: both must fail alike
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]


def _draws(pkg):
    p = pkg.chaos.ChaosPolicy(seed=5, probe_drop_rate=0.4,
                              kill_replica=1, kill_after_submits=2,
                              stall_replica=0, stall_ms=0.1,
                              stall_rounds=2)
    drops = [p.on_probe(i % 3) for i in range(64)]
    armed = []
    for rid in (1, 0, 1):
        p.on_submit(rid)
        armed.append((p.kill_armed(0), p.kill_armed(1)))
    kills = []
    for rid in (0, 1, 1):
        try:
            p.engine_hook(rid)(None)
            kills.append(None)
        except pkg.chaos.ChaosFault as e:
            kills.append(str(e))
    p.corrupt_handoff = True
    payload = {"pages": 2, "page_size": 16, "tokens": [1]}
    bad = p.on_export(0, payload)
    return {"drops": drops, "armed": armed, "kills": kills,
            "killed": p.killed, "bad": bad, "payload": payload,
            "events": [{k: v for k, v in e.items() if k != "t"}
                       for e in p.events]}


def test_chaos_draws_equal_jax():
    got, ref = _draws(PORT), _draws(JAX)
    assert got == ref
    assert any(got["drops"]) and not all(got["drops"])


def test_decide_equals_jax_on_a_seeded_grid():
    rs = np.random.RandomState(3)
    for _ in range(400):
        n = int(rs.randint(1, 5))
        backlogs = [None if rs.rand() < 0.1 else float(rs.rand() * 10)
                    for _ in range(n)]
        up = None if rs.rand() < 0.2 else float(rs.rand() * 8)
        down = None if rs.rand() < 0.2 else float(rs.rand() * 2)
        args = (backlogs, int(rs.randint(1, 5)), up, down)
        assert pt_fleet.FleetController.decide(*args) \
            == jax_fleet.FleetController.decide(*args)


class _Req:
    def __init__(self, rid, replica_id, prompt, n):
        self.rid, self.replica_id = rid, replica_id
        self.tokens = list(prompt) + [3] * n
        self.log_probs, self.error, self.timed_out = [], None, False
        self.stream_q = None
        self.done = threading.Event()
        self.done.set()
        self.t_submit = self.t_first = self.t_done = 1.0

    def result(self, timeout=None):
        return self.tokens, None


def _replica_class(queue_full):
    class Rep:
        def __init__(self, rid):
            self.replica_id = rid
            self.broken = None
            self.alive = True
            self.regressions = 0
            self.backlog = 1.0
            self.trail = []
            self.page_size, self.max_context, self.num_pages = 16, 64, 9

        def submit(self, prompt, n, **kw):
            if self.broken:
                raise RuntimeError(f"engine is stopped: {self.broken}")
            self.trail.append(("submit", len(prompt)))
            return _Req(len(self.trail), self.replica_id, prompt, n)

        def cancel(self, req):
            pass

        def health(self):
            return {"alive": self.alive, "broken": self.broken,
                    "queue_depth": 0, "slots_busy": 0}

        def load(self):
            return 0

        def modeled_backlog_flops(self):
            return None

        def modeled_backlog_s(self):
            return self.backlog

        def counters(self):
            out = {"serve_replica_id": self.replica_id}
            if self.regressions:
                out["serve_perf_regressions"] = self.regressions
            return out

        def fleet_kv_pool_bytes(self):
            return 0

        def histograms(self):
            return []

        def flight_record(self):
            return {"events": []}

        def last_dump_path(self):
            return f"dump-{self.replica_id}"

        def warmup(self):
            self.trail.append("warmup")

        def start(self):
            self.trail.append("start")

        def stop(self, drain=True):
            self.trail.append(("stop", drain))
            self.alive = False

        def drain(self):
            pass

    return Rep


def _controller_run(pkg):
    Rep = _replica_class(pkg.engine.QueueFull)
    spawned = []

    def spawn(old):
        new = Rep(old.replica_id)
        spawned.append(new)
        return new

    reps = [Rep(0), Rep(1)]
    standby = [Rep(2)]
    router = pkg.router.ReplicaRouter(reps, recover_requests=True)
    ctl = pkg.fleet.FleetController(
        router, spawn_replica=spawn, scale_up_backlog_s=2.0,
        scale_down_backlog_s=0.5, scale_patience=2, max_replicas=3,
        standby=standby, drain_timeout_s=0.2)
    trace = []

    def tick():
        ctl.tick()
        trace.append(([r.replica_id for r in router.replicas],
                      router.router_stats()))

    tick()                          # healthy, backlog 1.0: hold
    reps[1].broken = "engine step failed: chaos"
    tick()                          # poison: replace replica 1
    router.replicas[0].regressions = 2
    tick()                          # sentinel trip: replace replica 0
    for r in router.replicas:
        r.backlog = 5.0
    tick()                          # up, streak 1
    tick()                          # up, streak 2: scale up
    for r in router.replicas:
        r.backlog = 0.01
    tick()
    tick()                          # down: scale down
    events = [{k: v for k, v in e.items() if k not in ("t", "recovery_s")}
              for e in ctl.flight_events()]
    replay = [pkg.fleet.FleetController.decide(
        e["backlogs"], e["n_active"], 2.0, 0.5)
        for e in ctl.flight_events() if e["kind"] == "scale_decision"]
    return {"events": events, "trace": trace, "replay": replay,
            "spawned": [r.trail for r in spawned],
            "old": [r.trail for r in reps + standby]}


def test_controller_events_and_replays_equal_jax():
    got, ref = _controller_run(PORT), _controller_run(JAX)
    assert got == ref
    kinds = [e["kind"] for e in got["events"]]
    assert kinds.count("replace") == 2 and "scale_decision" in kinds
    assert got["replay"] == [e["verdict"] for e in got["events"]
                             if e["kind"] == "scale_decision"]


# ---------------------------------------------------------------------------
# kill one replica of two on real engines of the port
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots=2, page_size=16, max_context=96, max_queue=16,
                 termination_id=None, vocab_size=256,
                 prefill_chunk_tokens=16, prefix_cache=True, step_horizon=4)


def _traffic(n=8, gen=8):
    rs = np.random.RandomState(11)
    system = [int(x) for x in rs.randint(2, 256, 40)]
    return [(system + [int(x) for x in rs.randint(2, 256, 3 + i)], gen)
            for i in range(n)]


def test_kill_one_of_two_converges_with_zero_failed_requests(tmp_path):
    _, _, tm, tp = tiny_pair(max_pos=96)
    traffic = _traffic()
    plain = pt_engine.DecodeEngine(tm, tp, **ENGINE_KW)
    oracle = [plain.submit(p, g) for p, g in traffic]
    plain.drain()
    oracle = [r.result(timeout=10)[0] for r in oracle]

    chaos = pt_chaos.ChaosPolicy(kill_replica=0, kill_after_submits=3)

    def engine(rid):
        return pt_engine.DecodeEngine(tm, tp, replica_id=rid,
                                      record_dir=str(tmp_path), **ENGINE_KW)

    router = pt_router.ReplicaRouter(
        [pt_router.EngineReplica(engine(i), chaos=chaos) for i in (0, 1)],
        recover_requests=True, unhealthy_cooldown_s=0.2)
    ctl = pt_fleet.FleetController(
        router, spawn_replica=lambda old: pt_router.EngineReplica(
            engine(old.replica_id)), check_interval_s=0.05)
    router.start()
    ctl.start()
    try:
        reqs = [router.submit(p, g, top_k=1) for p, g in traffic]
        answers, failed = [], 0
        for r in reqs:
            try:
                answers.append(r.result(timeout=120)[0])
            except Exception:  # noqa: BLE001: counted, then asserted
                failed += 1
                answers.append(None)
        deadline = time.monotonic() + 60
        while router.router_stats().get("serve_fleet_replaced", 0) < 1:
            assert time.monotonic() < deadline, "no replacement"
            time.sleep(0.05)
    finally:
        ctl.stop()
        router.stop(drain=True)
    assert failed == 0
    assert answers == oracle
    stats = router.router_stats()
    assert chaos.killed == [0]
    assert stats["serve_fleet_replaced"] == 1
    assert stats["serve_resubmitted"] >= 1
    assert stats["router_affinity_hits"] >= 1
    assert list(tmp_path.glob("flight_record_engine-poison-r0_*.json"))
    # the JAX engine's greedy streams on the same weights and prompts
    jm, jp, _, _ = tiny_pair(max_pos=96)
    jeng = jax_engine.DecodeEngine(jm, jp, **ENGINE_KW)
    jreqs = [jeng.submit(p, g) for p, g in traffic]
    jeng.drain()
    assert answers == [r.result(timeout=10)[0] for r in jreqs]
