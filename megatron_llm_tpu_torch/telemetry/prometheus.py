"""Histogram metrics + Prometheus text exposition (port of
telemetry/prometheus.py, stdlib only: a copy, since importing any module
of the JAX package imports JAX).

The serving SLO contract (the Gemma fine-tune-and-serve paper,
PAPERS.md) is a latency DISTRIBUTION, not a point percentile: the
engine's `serve_ttft_p95_ms` gauge collapses the last 256 requests to
one number, which a scraping system can neither aggregate across
replicas nor re-quantile over time. This module adds real cumulative
histograms (fixed bucket bounds, monotone bucket counts, sum + count —
the Prometheus `histogram` type, aggregatable by summing buckets) and
renders them, plus the existing scalar counters, in the Prometheus text
exposition format (version 0.0.4) that GET /metrics serves under
content negotiation (inference/server.py; the legacy JSON schema stays
byte-compatible on the default path).

`Histogram.observe` is on the engine's per-token/per-request hot path:
it is a bisect + two increments on host floats, so it can never grow a
device sync.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Tuple

__all__ = [
    "Histogram",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "render_prometheus",
    "histograms_from_prometheus",
    "PROMETHEUS_CONTENT_TYPE",
]

# ms-denominated latency bounds: sub-ms decode rounds up to multi-minute
# stalls; roughly log-spaced like prometheus.ExponentialBuckets
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class Histogram:
    """Cumulative-bucket histogram (the Prometheus semantics: bucket
    `le=B` counts every observation <= B; `+Inf` == count)."""

    def __init__(self, name: str, buckets: Iterable[float] =
                 DEFAULT_LATENCY_BUCKETS_MS, help_text: str = ""):
        self.name = name
        self.help_text = help_text
        bounds = tuple(sorted(float(b) for b in buckets))
        assert bounds, "a histogram needs at least one finite bucket"
        self.bounds = bounds
        # per-bucket (non-cumulative) counts + one overflow cell; the
        # exposition accumulates — keeping raw cells makes observe O(1)
        # after the bisect instead of touching every higher bucket.
        # The lock keeps (cells, sum, count) consistent against a
        # concurrent scrape: an unsynchronized render mid-observe can
        # emit a finite bucket cumulative > the +Inf count — an invalid
        # Prometheus histogram strict consumers reject.
        self._lock = threading.Lock()
        self._cells: List[int] = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # hot path: host floats only — a device scalar here would
        # be a per-token device sync (the lock is uncontended except
        # during a scrape's snapshot copy)
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._cells[idx] += 1
            self._sum += value
            self._count += 1

    def _snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._cells), self._sum, self._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(bound, cumulative_count), ...] + (inf, count) — one
        consistent snapshot (+Inf always equals the total count)."""
        cells, _, count = self._snapshot()
        out, acc = [], 0
        for b, c in zip(self.bounds, cells):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), count))
        return out

    @classmethod
    def from_cumulative(cls, name: str, cumulative, total: float,
                        count: int, help_text: str = "") -> "Histogram":
        """Rebuild a Histogram from its exposition form — [(bound,
        cumulative_count), ...] WITHOUT the +Inf row, plus sum and
        count. The inverse of `cumulative()`/`to_prom_lines()`: raw
        cells are first-differences of the cumulative counts, the
        overflow cell is count - last cumulative. This is how the
        replica router rebuilds a REMOTE replica's distributions from
        its scraped /metrics text (HTTPReplica histogram
        proxying) so `merged` can fold them into the fleet view."""
        pairs = sorted((float(b), int(c)) for b, c in cumulative)
        bounds = tuple(b for b, _ in pairs)
        h = cls(name, buckets=bounds, help_text=help_text)
        prev = 0
        cells = []
        for _, c in pairs:
            if c < prev:
                raise ValueError(
                    f"histogram {name!r}: non-monotone cumulative "
                    f"bucket counts {pairs} — not a valid Prometheus "
                    f"histogram")
            cells.append(c - prev)
            prev = c
        overflow = int(count) - prev
        if overflow < 0:
            raise ValueError(
                f"histogram {name!r}: count {count} below the last "
                f"finite bucket's cumulative {prev}")
        h._cells = cells + [overflow]
        h._sum = float(total)
        h._count = int(count)
        return h

    @classmethod
    def merged(cls, histograms: Iterable["Histogram"]) -> "Histogram":
        """Sum same-named, same-bucket histograms from N engines into
        one — cumulative buckets are additive by design (the module
        docstring's aggregatability claim made executable): the
        replica router's GET /metrics serves fleet-wide TTFT/decode
        distributions this way (inference/router.py, )."""
        hs = list(histograms)
        assert hs, "merged() needs at least one histogram"
        first = hs[0]
        out = cls(first.name, buckets=first.bounds,
                  help_text=first.help_text)
        for h in hs:
            assert h.name == first.name and h.bounds == first.bounds, (
                "merging histograms with different names/buckets would "
                "fabricate a distribution", h.name, first.name)
            cells, s, c = h._snapshot()
            out._cells = [a + b for a, b in zip(out._cells, cells)]
            out._sum += s
            out._count += c
        return out

    def to_prom_lines(self, prefix: str = "") -> List[str]:
        name = prefix + self.name
        lines = []
        if self.help_text:
            lines.append(f"# HELP {name} {self.help_text}")
        lines.append(f"# TYPE {name} histogram")
        cells, total, count = self._snapshot()
        acc = 0
        for b, c in zip(self.bounds, cells):
            acc += c
            lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {acc}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{name}_sum {_fmt(total)}")
        lines.append(f"{name}_count {count}")
        return lines


def _fmt(v) -> str:
    """Prometheus float formatting: integral values without the .0
    noise, everything else repr-exact."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def render_prometheus(counters: Dict, histograms: Iterable[Histogram] = (),
                      prefix: str = "", info_name: str = "build_info",
                      ) -> str:
    """One Prometheus text page from a flat counters dict (the engine's
    `counters()` / the trainer's gauges) plus histogram objects.

    Numeric values become gauges under their (sanitized) key; string
    values — e.g. `serve_kv_dtype` — collapse into ONE info-style
    metric (`<prefix><info_name>{key="value", ...} 1`), the Prometheus
    idiom for non-numeric facts; other types are skipped rather than
    guessed at."""
    lines: List[str] = []
    info_labels: List[str] = []
    for key in counters:
        value = counters[key]
        name = prefix + _sanitize(key)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            if isinstance(value, str):
                esc = value.replace("\\", "\\\\").replace('"', '\\"')
                info_labels.append(f'{_sanitize(key)}="{esc}"')
            continue
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(value)}")
    if info_labels:
        iname = prefix + info_name
        lines.append(f"# TYPE {iname} gauge")
        lines.append(f"{iname}{{{','.join(info_labels)}}} 1")
    for h in histograms:
        lines.extend(h.to_prom_lines(prefix))
    return "\n".join(lines) + "\n"


def histograms_from_prometheus(text: str) -> List[Histogram]:
    """Reconstruct every histogram-typed metric in a Prometheus text
    page (the inverse of `to_prom_lines`): `# TYPE <name> histogram`
    declares one, its `<name>_bucket{le=...}` samples carry the
    cumulative counts, `<name>_sum`/`<name>_count` the totals. Used by
    `inference/router.HTTPReplica` to merge REMOTE replicas' latency
    distributions into the fleet /metrics (in-process replicas merge
    their Histogram objects directly). Malformed sections raise
    ValueError — a fleet view silently missing one replica's
    distribution would misstate the SLO."""
    hist_names: List[str] = []
    for line in text.splitlines():
        parts = line.strip().split()
        if len(parts) == 4 and parts[0] == "#" and parts[1] == "TYPE" \
                and parts[3] == "histogram":
            hist_names.append(parts[2])
    if not hist_names:
        return []
    samples = parse_prometheus(text)
    out: List[Histogram] = []
    for name in hist_names:
        buckets = samples.get(f"{name}_bucket", {})
        cumulative = []
        count = None
        for labels, value in buckets.items():
            le = None
            for part in labels.split(","):
                k, _, v = part.partition("=")
                if k.strip() == "le":
                    le = v.strip().strip('"')
            if le is None:
                raise ValueError(
                    f"histogram {name!r}: bucket sample without an le "
                    f"label ({labels!r})")
            if le in ("+Inf", "inf", "Inf"):
                count = int(value)
            else:
                cumulative.append((float(le), int(value)))
        total = samples.get(f"{name}_sum", {}).get("")
        n = samples.get(f"{name}_count", {}).get("")
        if count is None:
            count = int(n) if n is not None else None
        if count is None or total is None or not cumulative:
            raise ValueError(
                f"histogram {name!r}: incomplete exposition (buckets="
                f"{len(cumulative)}, sum={total}, count={count})")
        out.append(Histogram.from_cumulative(
            name, cumulative, total, count))
    return out


def parse_prometheus(text: str) -> Dict[str, Dict]:
    """Tiny exposition parser for tests' self-checks: returns
    {metric_name: {"labels...": value}} with the bare sample keyed "".
    Not a general client — enough to verify our own rendering."""
    out: Dict[str, Dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, val = line.rpartition(" ")
        if "{" in name_part:
            name, _, labels = name_part.partition("{")
            labels = labels.rstrip("}")
        else:
            name, labels = name_part, ""
        out.setdefault(name, {})[labels] = float(val)
    return out
