"""PyTorch port, the telemetry package (telemetry/) and the engine's
telemetry, against the JAX package's on the same inputs.

- Prometheus: histogram bucket math, the exposition text, the
  `from_cumulative` round trip, merged histograms and the parser equal;
- the span tracer's Chrome JSON equal under an injected clock, and the
  same engine traffic gives the same span names (and counts) and the
  same flight-recorder event kinds in both engines;
- the flight recorder's ring, snapshot and dump equal; the perf
  sentinel's verdicts equal on one seeded series (and the loss
  watchdog's `RobustWindow` is the sentinel's); the goodput ledger
  equal under an injected clock;
- chipspec: the H100's row, the override / env / default / None
  contract of detection, the fp32 peak (the port's divergence), and the
  FLOPs-per-token formulas equal JAX's;
- costs: the same records give the same rows, snapshot and Prometheus
  samples and the same roofline seconds; the torch counting (FlopCounter
  FLOPs, bytes of distinct tensors, a kernel wrapper's own report);
- the engine's counters() schema with every knob off equals the JAX
  engine's (the JSON /metrics pin), and with the telemetry knobs on it
  grows the JAX engine's keys.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

import megatron_llm_tpu.telemetry as jt
from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.telemetry import chipspec as jax_chipspec
from megatron_llm_tpu.telemetry import costs as jax_costs
from megatron_llm_tpu.telemetry import trace as jax_trace
import megatron_llm_tpu_torch.telemetry as pt
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.telemetry import chipspec as pt_chipspec
from megatron_llm_tpu_torch.telemetry import costs as pt_costs
from megatron_llm_tpu_torch.telemetry import trace as pt_trace
from megatron_llm_tpu_torch.training import watchdog
from torch_parity import tiny_pair

PKGS = (pt, jt)


def _values(seed=0, n=500):
    rs = np.random.RandomState(seed)
    return [float(x) for x in np.exp(rs.randn(n) * 2.5 + 3.0)]


def test_histogram_bucket_math_and_text_equal_jax():
    out = []
    for pkg in PKGS:
        h = pkg.Histogram("serve_ttft_ms", help_text="ttft")
        for v in _values():
            h.observe(v)
        h2 = pkg.Histogram("serve_ttft_ms", help_text="ttft")
        for v in _values(1, 77):
            h2.observe(v)
        m = pkg.Histogram.merged([h, h2])
        cum = h.cumulative()
        back = pkg.Histogram.from_cumulative(
            h.name, [c for c in cum if c[0] != float("inf")], h.sum,
            h.count)
        odd = pkg.Histogram("x", buckets=(0.5, 2, 3.25))
        for v in (0.1, 0.5, 1.0, 2.0, 3.25, 9.0):
            odd.observe(v)
        out.append((cum, h.sum, h.count, h.to_prom_lines("p_"),
                    m.cumulative(), m.sum, back.cumulative(), back.sum,
                    odd.to_prom_lines()))
    assert out[0] == out[1]


def test_render_and_parse_prometheus_equal_jax():
    counters = {"serve_replica_id": 3, "serve_kv_dtype": "bfloat16",
                "serve_tok_s": 123.45, "serve_captured": False,
                "serve_steps": 10, "weird key-name": 1e20,
                "serve_ttft_p50_ms": 0.1 + 0.2, "a_list": [1, 2],
                "quote": 'a"b\\c'}
    texts = []
    for pkg in PKGS:
        h = pkg.Histogram("serve_decode_round_ms", help_text="round")
        for v in _values(2, 50):
            h.observe(v)
        text = pkg.render_prometheus(counters, [h], prefix="m_")
        hists = pkg.histograms_from_prometheus(text)
        texts.append((text, pkg.parse_prometheus(text),
                      [(x.name, x.cumulative(), x.sum, x.count)
                       for x in hists]))
    assert texts[0] == texts[1]
    assert pt.PROMETHEUS_CONTENT_TYPE == jt.PROMETHEUS_CONTENT_TYPE
    assert pt.DEFAULT_LATENCY_BUCKETS_MS == jt.DEFAULT_LATENCY_BUCKETS_MS
    for bad in ("# TYPE h histogram\nh_bucket{le=\"1\"} 3\n",
                "# TYPE h histogram\nh_bucket{le=\"1\"} 3\n"
                "h_bucket{le=\"2\"} 2\nh_sum 1\nh_count 3\n"):
        errs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as e:
                pkg.histograms_from_prometheus(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _trace_run(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod.time, "perf_counter", clock)
    monkeypatch.setattr(mod.time, "time", lambda: 1.7e9)
    tr = mod.SpanTracer(capacity=8)
    tr.set_context(replica=1)
    with tr.span("admit", rid=3):
        tr.instant("first_token", rid=3, ttft_ms=1.5)
        with tr.span("round.mixed", round=0):
            pass
    tr.complete("queue_wait", 1000.0, 1000.5, rid=4)
    for i in range(9):
        tr.instant("retire", rid=i)
    off = mod.SpanTracer(enabled=False)
    with off.span("x"):
        off.instant("y")
    return tr.to_chrome_trace(), tr.dropped, off.events(), \
        mod.NULL_TRACER.enabled


def test_tracer_chrome_json_equals_jax(monkeypatch, tmp_path):
    got = _trace_run(pt_trace, monkeypatch)
    ref = _trace_run(jax_trace, monkeypatch)
    assert got == ref
    assert got[1] == 5 and got[0]["traceEvents"][0]["ph"] == "M"


def _recorder_run(pkg, tmp_path, monkeypatch, mod):
    monkeypatch.setattr(mod.time, "time", lambda: 1.7e9)
    rec = pkg.FlightRecorder(16, base={"replica": 2})
    for i in range(20):
        rec.record("round.decode_scan", round=i, ms=0.5 * i)
    rec.note_counters({"serve_steps": 20})
    snap = rec.snapshot(reason="on-demand", extra={"k": 1})
    path = rec.dump(str(tmp_path / pkg.__name__), "engine-poison-r2")
    with open(path) as f:
        dumped = json.load(f)
    none = rec.dump(None, "nowhere")
    return snap, dumped, os.path.basename(path), none, rec.dropped, \
        rec.dumps


def test_flight_recorder_ring_and_dump_equal_jax(tmp_path, monkeypatch):
    import megatron_llm_tpu.telemetry.recorder as jrec
    import megatron_llm_tpu_torch.telemetry.recorder as prec

    got = _recorder_run(pt, tmp_path, monkeypatch, prec)
    ref = _recorder_run(jt, tmp_path, monkeypatch, jrec)
    assert got == ref
    assert len(got[0]["events"]) == 16 and got[4] == 4


def test_sentinel_verdicts_equal_jax():
    rs = np.random.RandomState(5)
    series = list(10 + rs.randn(300))
    series[150:170] = [30.0] * 20  # a sustained regression
    series[220:223] = [40.0] * 3  # a blip under patience
    runs = []
    for pkg in PKGS:
        s = pkg.PerfSentinel(k_sigma=6, window=32, patience=8,
                             name="decode_round_ms")
        verdicts = [s.observe(v, step=i) for i, v in enumerate(series)]
        runs.append((verdicts, s.trips, s.bad_total, s.counters(),
                     s.last_threshold))
    assert runs[0] == runs[1]
    assert runs[0][1] >= 1
    assert watchdog.RobustWindow is pt.RobustWindow


def test_goodput_equal_jax():
    out = []
    for pkg in PKGS:
        clock = _Clock()
        g = pkg.GoodputLedger(clock=clock)
        g.start()
        for i, bucket in enumerate(["productive", "compile", "data_wait",
                                    "checkpoint", "productive",
                                    "watchdog"]):
            g.note(bucket, 0.001 * (i + 1))
        out.append((g.snapshot(), g.counters(), g.wall_s()))
    assert out[0] == out[1]
    assert pt.GOODPUT_BUCKETS == jt.GOODPUT_BUCKETS


def test_chipspec_h100_row_and_detection_contract(monkeypatch):
    monkeypatch.delenv("MEGATRON_TPU_CHIPSPEC", raising=False)
    spec = pt_chipspec.CHIP_SPECS["h100"]
    assert spec.peak_flops == {"bf16": 989e12, "int8": 1979e12,
                               "fp32": 67e12}
    assert spec.hbm_bytes_s == 3.35e12
    assert spec.peak_flops_for("bf16") == 989e12
    assert spec.peak_flops_for("int8") == 1979e12
    # the port's divergence: fp32 is fp32's peak (JAX maps it to bf16)
    assert spec.peak_flops_for("fp32") == 67e12
    assert spec.peak_flops_for("float32") == 67e12
    jv5e = jax_chipspec.CHIP_SPECS["v5e"]
    assert jv5e.peak_flops_for("fp32") == jv5e.peak_flops_for("bf16")
    # no card here: None unless overridden or defaulted, as in JAX
    assert pt_chipspec.detect_chip() is None
    assert jax_chipspec.detect_chip(devices=[]) is None
    assert pt_chipspec.detect_chip(override="H100").label() \
        == "h100:override"
    assert pt_chipspec.detect_chip(default="h100").label() == "h100:assumed"
    monkeypatch.setenv("MEGATRON_TPU_CHIPSPEC", "h100")
    assert pt_chipspec.detect_chip().source == "override"
    for pkg in (pt_chipspec, jax_chipspec):
        with pytest.raises(ValueError, match="unknown chip spec"):
            pkg.detect_chip(override="a100")
    monkeypatch.delenv("MEGATRON_TPU_CHIPSPEC")
    for args in ((6_738_415_616, 32, 4096, 4096), (1000, 2, 64, 17)):
        assert pt_chipspec.train_flops_per_token(*args) \
            == jax_chipspec.train_flops_per_token(*args)
        assert pt_chipspec.decode_flops_per_token(*args) \
            == jax_chipspec.decode_flops_per_token(*args)


def test_detection_reads_the_cards_name(monkeypatch):
    """On a card named as the H100 reports itself, detection picks the
    row and takes the card's own memory as the capacity."""
    monkeypatch.delenv("MEGATRON_TPU_CHIPSPEC", raising=False)
    monkeypatch.setattr(pt_chipspec, "_device_name",
                        lambda d: ("nvidia h100 80gb hbm3", 85_520_809_984))
    spec = pt_chipspec.detect_chip(devices=["cuda:0"])
    assert spec.label() == "h100:detected"
    assert spec.hbm_bytes == 85_520_809_984
    monkeypatch.setattr(pt_chipspec, "_device_name",
                        lambda d: ("nvidia a100-sxm4-80gb", 1))
    assert pt_chipspec.detect_chip(devices=["cuda:0"]) is None


def _registry(pkg_costs, chip):
    reg = pkg_costs.CostRegistry(chip=chip)
    for name, key, fl, by, tmp in (
            ("engine.decode_scan", (8, True), 4.2e9, 1.3e9, 1 << 20),
            ("engine.mixed_step", (256, False), 9.9e10, 2.1e9, None),
            ("engine.page_copy", (), None, 3.0e6, 0)):
        reg._store(pkg_costs.CostRecord(
            contract=name, key=repr(key), flops=fl, bytes_accessed=by,
            temp_bytes=tmp, arg_bytes=123, source="compiled"))
    reg.note_mint("engine.prefill_bucket", 64)
    return reg


def test_cost_records_export_equal_jax():
    chip = pt_chipspec.detect_chip(override="h100")
    regs = [_registry(pt_costs, chip), _registry(jax_costs, chip)]
    outs = []
    for reg in regs:
        rec = reg.record("engine.decode_scan", (8, True))
        outs.append((reg.rows(), reg.snapshot(), reg.prometheus_lines("x_"),
                     rec.modeled_seconds(chip, n_chips=2),
                     rec.modeled_seconds(chip, dtype="int8"),
                     reg.record("engine.page_copy").modeled_seconds(chip),
                     rec.modeled_seconds(None)))
    assert outs[0] == outs[1]


def test_torch_counting_of_a_run():
    """FLOPs from flop_counter's formulas, bytes of each op's distinct tensors,
    and a wrapper's own report (`note_launch`) added only inside a
    capture; the run's result comes back unchanged."""
    reg = pt_costs.CostRegistry()
    a, b = torch.randn(8, 16), torch.randn(16, 4)

    def run():
        pt_costs.note_launch(1000.0, 64.0)
        out = a @ b
        out.add_(1.0)
        return out.view(-1)

    out = reg.capture("engine.decode_scan", (1, True), run, arg_bytes=7)
    assert torch.equal(out, (a @ b + 1.0).view(-1))
    rec = reg.record("engine.decode_scan", (1, True))
    assert rec.flops == 2 * 8 * 16 * 4 + 1000.0
    # mm reads a and b, writes out; add_ reads and writes out once; the
    # view moves nothing
    assert rec.bytes_accessed == 4 * (8 * 16 + 16 * 4 + 8 * 4 + 8 * 4) + 64
    assert rec.launches == 1 and rec.arg_bytes == 7
    pt_costs.note_launch(1e9, 1e9)  # outside a capture: nothing counts
    assert reg.captures == 1 and reg.has("engine.decode_scan", (1, True))


KW = dict(slots=2, page_size=16, max_context=64, max_queue=8,
          termination_id=None, vocab_size=256, prefill_chunk_tokens=8,
          prefix_cache=True)


def _traffic():
    rs = np.random.RandomState(0)
    shared = [int(x) for x in rs.randint(2, 256, 20)]
    return [(shared + [int(x) for x in rs.randint(2, 256, n)], g)
            for n, g in ((5, 6), (9, 4), (3, 8), (17, 5))]


def _engine_telemetry(engine_cls, model, params, tmp, **over):
    eng = engine_cls(model, params, trace_dir=str(tmp), replica_id=1,
                     **KW, **over)
    reqs = [eng.submit(p, g, top_k=1) for p, g in _traffic()]
    eng.drain()
    toks = [r.result(timeout=10)[0] for r in reqs]
    names = collections.Counter(e["name"] for e in eng.tracer.events())
    kinds = [e["kind"] for e in eng.recorder.snapshot()["events"]]
    assert all(e["args"].get("replica") == 1
               for e in eng.tracer.events())
    return toks, names, kinds, [h.count for h in eng.histograms()], \
        sorted(eng.counters())


def test_engine_spans_and_events_equal_jax(tmp_path):
    jm, jp, tm, tp = tiny_pair()
    got = _engine_telemetry(DecodeEngine, tm, tp, tmp_path / "pt")
    ref = _engine_telemetry(JaxEngine, jm, jp, tmp_path / "jax")
    assert got == ref
    assert {"round.mixed", "round.decode_scan", "queue_wait", "admit",
            "first_token", "retire"} <= set(got[1])


@pytest.mark.parametrize("knobs", ["off", "on"])
def test_counters_schema_equals_jax(knobs):
    """With every telemetry knob off the JSON counters keep the schema of
    the engine without telemetry (the JAX engine's, key for key); with
    the cost registry, a chip and the sentinel on, both grow the same
    keys."""
    jm, jp, tm, tp = tiny_pair()
    kw = dict(KW)
    if knobs == "on":
        kw.update(cost_registry=True, perf_sentinel_ksigma=6.0)
    port = DecodeEngine(tm, tp, **kw, **(
        {"chip_spec": "h100"} if knobs == "on" else {}))
    ref = JaxEngine(jm, jp, **kw, **(
        {"chip_spec": "v5e"} if knobs == "on" else {}))
    for eng in (port, ref):
        reqs = [eng.submit(p, g, top_k=1) for p, g in _traffic()[:2]]
        eng.drain()
        [r.result(timeout=10) for r in reqs]
    assert list(port.counters()) == list(ref.counters())
    if knobs == "off":
        assert list(port.counters()) == [
            "serve_kv_dtype", "serve_kv_pool_bytes",
            "serve_kv_bytes_per_token", "serve_slot_occupancy",
            "serve_queue_depth", "serve_pages_in_use", "serve_pages_free",
            "serve_admitted", "serve_retired", "serve_timed_out",
            "serve_cancelled", "serve_steps", "serve_tok_s",
            "serve_prefill_tokens", "serve_ttft_p50_ms",
            "serve_ttft_p95_ms", "serve_decode_p95_ms",
            *("serve_" + k for k in port._prefix.stats())]
    else:
        c = port.counters()
        assert c["serve_chip_spec"] == "h100:override"
        assert c["serve_modeled_gflops"] == ref.counters()[
            "serve_modeled_gflops"]


def test_export_gauges_equals_jax():
    """`timers=` is the gauges' sink: `export_gauges()` writes every
    counter as a gauge, the same names and (timing aside) values as the
    JAX engine's."""
    from megatron_llm_tpu.training.timers import Timers as JaxTimers
    from megatron_llm_tpu_torch.training.timers import Timers

    jm, jp, tm, tp = tiny_pair()
    sinks = [Timers(), JaxTimers()]
    engines = [DecodeEngine(tm, tp, timers=sinks[0], **KW),
               JaxEngine(jm, jp, timers=sinks[1], **KW)]
    for eng in engines:
        reqs = [eng.submit(p, g, top_k=1) for p, g in _traffic()[:2]]
        eng.drain()
        [r.result(timeout=10) for r in reqs]
        eng.export_gauges()
    got, ref = (s.gauges() for s in sinks)
    assert list(got) == list(ref) == list(engines[0].counters())
    timed = ("serve_tok_s", "serve_ttft_p50_ms", "serve_ttft_p95_ms",
             "serve_decode_p95_ms")
    assert {k: v for k, v in got.items() if k not in timed} \
        == {k: v for k, v in ref.items() if k not in timed}
