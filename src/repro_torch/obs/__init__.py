"""repro_torch.obs — tracing, metrics export and termination explainability.

The observability layer of the port's serving stack (a port of
``repro.obs``):

  * ``obs.trace``   — per-query lifecycle spans + the device-side
                      predicted-recall trajectory ring the serve chunks
                      carry (zero extra syncs);
  * ``obs.metrics`` — counters / gauges / fixed-bucket histograms with
                      Prometheus text exposition and a JSONL event log;
  * ``obs.explain`` — reconstruct any query's story from a trace
                      (``python -m repro_torch.obs.explain``);
  * ``obs.stats``   — the one shared p50/p99 percentile helper
                      (conservative tails, NaN on empty).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, serve_metrics)
from repro_torch.obs.stats import p01, p50, p99, percentile, summarize
from repro_torch.obs.trace import (NO_PREDICTION, TERMINATION_REASONS, Span,
                                   Tracer, load_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "serve_metrics",
    "p01", "p50", "p99", "percentile", "summarize",
    "NO_PREDICTION", "TERMINATION_REASONS", "Span", "Tracer", "load_trace",
]
