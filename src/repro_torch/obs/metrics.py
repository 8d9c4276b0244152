"""Metrics registry: counters / gauges / histograms + two exporters.

Host-side aggregation for the serving stack (DarthServer, the drift
monitor, the compaction lifecycle). Metrics are named following the
Prometheus conventions (``darth_<noun>_<unit>`` with ``_total`` counter
suffixes) and label sets are free-form keyword arguments; every metric
family is exported two ways:

  * ``to_prometheus()`` — the text exposition format (one scrapeable
    page: ``# HELP`` / ``# TYPE`` headers, ``name{labels} value``
    samples, histogram ``_bucket``/``_sum``/``_count`` series with
    fixed, pre-declared bucket edges so series never churn);
  * ``events`` + ``write_events()`` — an append-only JSONL event log
    for discrete occurrences (drift checks, recalibrations, compaction
    begin/tick/swap, hot-swaps) that a histogram would flatten.

Histograms keep fixed bucket edges (cumulative ``le`` counts) AND the
raw samples, so percentile summaries go through the one shared helper
(obs.stats) instead of bucket interpolation. Registries are cheap and
in-process; there is no global default — each server / monitor /
launcher owns the instance it is handed.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import stats as stats_lib

# Fixed default edges (milliseconds / engine steps / recall). Fixed at
# declaration so the exported bucket series are stable across runs —
# the overhead contract (docs/observability.md) depends on bucket
# bounds never being data-derived.
LATENCY_MS_EDGES = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0)
STEP_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)
RECALL_EDGES = (0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 0.99, 1.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


@dataclasses.dataclass
class Counter:
    """Monotonic counter family (one value per label set)."""
    name: str
    help: str
    values: Dict[Tuple, float] = dataclasses.field(default_factory=dict)

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (must be >= 0) to the labelled series."""
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        """Current value of the labelled series (0 if never touched)."""
        return self.values.get(_label_key(labels), 0.0)


@dataclasses.dataclass
class Gauge:
    """Set-to-current-value family (one value per label set)."""
    name: str
    help: str
    values: Dict[Tuple, float] = dataclasses.field(default_factory=dict)

    def set(self, value: float, **labels) -> None:
        """Set the labelled series to ``value``."""
        self.values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        """Current value of the labelled series (NaN if never set)."""
        return self.values.get(_label_key(labels), float("nan"))


@dataclasses.dataclass
class Histogram:
    """Fixed-bucket histogram family.

    ``edges`` are the upper bounds of the cumulative ``le`` buckets (a
    final +Inf bucket is implicit). Raw samples are retained per label
    set so p50/p99 summaries use obs.stats — bucket interpolation would
    re-introduce exactly the small-sample tail bias that helper fixes.
    """
    name: str
    help: str
    edges: Tuple[float, ...]
    samples: Dict[Tuple, List[float]] = dataclasses.field(
        default_factory=dict)

    def observe(self, value: float, **labels) -> None:
        """Record one sample into the labelled series."""
        self.samples.setdefault(_label_key(labels), []).append(float(value))

    def count(self, **labels) -> int:
        """Number of samples observed by the labelled series."""
        return len(self.samples.get(_label_key(labels), ()))

    def summary(self, **labels) -> Tuple[float, float]:
        """(p50, p99) of the raw samples via the shared helper."""
        return stats_lib.summarize(self.samples.get(_label_key(labels), ()))


class MetricsRegistry:
    """One process-local metrics surface: typed families + event log."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        #: discrete occurrences, in order (drift checks, swaps, ...)
        self.events: List[Dict] = []
        self._clock = 0

    def _declare(self, cls, name: str, help_: str, **kw):
        cur = self._metrics.get(name)
        if cur is not None:
            if not isinstance(cur, cls):
                raise TypeError(
                    f"metric {name!r} already declared as "
                    f"{type(cur).__name__}, not {cls.__name__}")
            return cur
        m = cls(name=name, help=help_, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        """Get or declare a counter family."""
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get or declare a gauge family."""
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  edges: Sequence[float] = LATENCY_MS_EDGES) -> Histogram:
        """Get or declare a fixed-bucket histogram family."""
        h = self._declare(Histogram, name, help,
                          edges=tuple(float(e) for e in edges))
        return h

    def event(self, kind: str, **fields) -> Dict:
        """Append one discrete occurrence to the JSONL event log."""
        self._clock += 1
        ev = {"seq": self._clock, "kind": kind, **fields}
        self.events.append(ev)
        return ev

    # -- export ------------------------------------------------------------
    def to_prometheus(self) -> str:
        """Text exposition format (the scrape page)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(m)]
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                for key, xs in sorted(m.samples.items()):
                    total = 0
                    for edge in m.edges + (float("inf"),):
                        total = sum(1 for x in xs if x <= edge)
                        le = 'le="' + _fmt_value(edge) + '"'
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, le)} {total}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} "
                        f"{_fmt_value(sum(xs))}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {len(xs)}")
            else:
                for key, v in sorted(m.values.items()):
                    lines.append(f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Write the exposition page to ``path``."""
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def write_events(self, path: str, append: bool = True) -> None:
        """Write the event log as JSONL (one event per line)."""
        with open(path, "a" if append else "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, default=float) + "\n")


def serve_metrics(registry: Optional[MetricsRegistry]
                  ) -> Optional[MetricsRegistry]:
    """Pre-declare the serving metric families on ``registry`` (no-op on
    None) so exposition pages show every family even before traffic.

    The naming contract (docs/observability.md): queries are counted
    once per terminal outcome under ``darth_queries_total{outcome=..}``,
    chunk round-trips land in ``darth_chunk_latency_ms``, harvest-time
    predicted recall in ``darth_harvest_recall`` and admission→harvest
    service time in ``darth_service_steps``.
    """
    if registry is None:
        return None
    registry.counter("darth_queries_total",
                     "queries by terminal outcome (termination reason)")
    registry.counter("darth_refills_total", "refill splices per host")
    registry.counter("darth_hedges_total", "hedge duplicates launched")
    registry.counter("darth_swaps_total",
                     "drained atomic hot-swaps applied mid-serve")
    registry.counter("darth_steals_total",
                     "queue entries stolen between hosts")
    registry.counter("darth_sq8_clipped_total",
                     "SQ8 values clamped to the frozen base range "
                     "during delta re-quantization")
    registry.counter("darth_cold_prefetch_total",
                     "cold IVF buckets staged into device slots ahead "
                     "of their probe turn")
    registry.counter("darth_cold_evictions_total",
                     "resident buckets evicted to make room for "
                     "prefetched cold buckets")
    registry.counter("darth_cold_miss_total",
                     "probes that resolved cold and were skipped "
                     "(bucket not resident in time)")
    registry.histogram("darth_chunk_latency_ms",
                       "per-chunk device round-trip wall time",
                       edges=LATENCY_MS_EDGES)
    registry.histogram("darth_harvest_recall",
                       "predicted recall at harvest",
                       edges=RECALL_EDGES)
    registry.histogram("darth_service_steps",
                       "engine steps from admission to harvest",
                       edges=STEP_EDGES)
    registry.gauge("darth_engine_epoch",
                   "engine/predictor version of the serving view")
    return registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "serve_metrics", "LATENCY_MS_EDGES", "STEP_EDGES",
           "RECALL_EDGES"]
