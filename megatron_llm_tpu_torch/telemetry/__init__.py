"""Flight-recorder telemetry of the port (port of the JAX package's
telemetry/): structured tracing, Prometheus metrics and postmortem
recording on the serving hot path, and the device-cost layer on top.

- `trace.SpanTracer`: nestable host-side spans with request-id
  correlation, exported as Chrome trace-event JSON (Perfetto);
- `recorder.FlightRecorder`: a bounded ring of structured events and
  counter snapshots, dumped to a JSON artifact on engine poison;
- `prometheus.Histogram` / `render_prometheus`: histogram metrics (TTFT,
  decode-round ms, queue wait) behind the content-negotiated Prometheus
  text exposition on GET /metrics;
- `chipspec.ChipSpec` / `detect_chip`: the card's peak FLOP/s and HBM
  rate (the H100's row);
- `costs.CostRegistry`: FLOPs, bytes and temp memory per engine entry
  point, counted once per specialization (the torch form of XLA's
  cost analysis, telemetry/costs.py);
- `goodput.GoodputLedger`: the trainer's exclusive wall-time partition;
- `sentinel.PerfSentinel`: median + MAD over recent round latencies,
  dumping the flight ring on a sustained regression.

Every emission stays on the host, outside the captured rounds: a
telemetry-on round launches the same kernels as a telemetry-off one.
"""

from megatron_llm_tpu_torch.telemetry.chipspec import ChipSpec, detect_chip
from megatron_llm_tpu_torch.telemetry.costs import CostRecord, CostRegistry
from megatron_llm_tpu_torch.telemetry.goodput import (
    GOODPUT_BUCKETS,
    GoodputLedger,
)
from megatron_llm_tpu_torch.telemetry.prometheus import (
    DEFAULT_LATENCY_BUCKETS_MS,
    PROMETHEUS_CONTENT_TYPE,
    Histogram,
    histograms_from_prometheus,
    parse_prometheus,
    render_prometheus,
)
from megatron_llm_tpu_torch.telemetry.recorder import FlightRecorder
from megatron_llm_tpu_torch.telemetry.sentinel import (
    PerfSentinel,
    RobustWindow,
)
from megatron_llm_tpu_torch.telemetry.trace import NULL_TRACER, SpanTracer

__all__ = [
    "SpanTracer",
    "NULL_TRACER",
    "FlightRecorder",
    "Histogram",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "PROMETHEUS_CONTENT_TYPE",
    "render_prometheus",
    "parse_prometheus",
    "histograms_from_prometheus",
    "ChipSpec",
    "detect_chip",
    "CostRecord",
    "CostRegistry",
    "GoodputLedger",
    "GOODPUT_BUCKETS",
    "PerfSentinel",
    "RobustWindow",
]
