"""Shared percentile math for every serving-stats surface (a copy of the
reference's numpy-only ``repro.obs.stats``; the port imports nothing of it).

One definition of "p50/p99" used by ServeStats, TierStats, the obs
histograms and the benchmark gates, fixing two edge cases the ad-hoc
``np.percentile`` calls had:

  * empty sample sets returned an exception path (or were guarded
    inconsistently at each call site) — here they are NaN, always;
  * small samples were linearly interpolated, which is the WRONG
    direction for an SLO tail: with 2 chunk latencies, linear p99 sits
    just under the max, under-reporting the tail, and the 1st-percentile
    recall sits just above the min, over-reporting the worst query.
    Tail percentiles here round conservatively — away from the median —
    so a single sample IS its own p99 and a 2-sample p99 is the max.

Interior percentiles (the median) keep linear interpolation: there is
no conservative direction for a central tendency.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """Percentile with NaN-on-empty and conservative tail rounding.

    ``q`` is in [0, 100]. Above the median the value rounds UP to an
    observed sample ("higher"), below the median it rounds DOWN
    ("lower"), so tail estimates never interpolate past the worst
    observation toward the center. q == 50 is the linearly interpolated
    median. Empty input returns NaN instead of raising.
    """
    xs = np.asarray(xs, np.float64).reshape(-1)
    xs = xs[np.isfinite(xs)]
    if xs.size == 0:
        return float("nan")
    method = "higher" if q > 50 else ("lower" if q < 50 else "linear")
    return float(np.percentile(xs, q, method=method))


def p50(xs: Sequence[float]) -> float:
    """Median (linear interpolation; NaN on empty)."""
    return percentile(xs, 50)


def p99(xs: Sequence[float]) -> float:
    """Conservative upper-tail p99: rounds up to an observed sample, so
    1 sample is its own p99 and 2 samples give the max (NaN on empty)."""
    return percentile(xs, 99)


def p01(xs: Sequence[float]) -> float:
    """Conservative lower-tail 1st percentile (the "worst 1%" recall
    convention): rounds DOWN to an observed sample (NaN on empty)."""
    return percentile(xs, 1)


def summarize(xs: Sequence[float]) -> tuple:
    """(p50, p99) with the shared conventions — the pair every stats
    surface reports."""
    return p50(xs), p99(xs)


__all__ = ["percentile", "p50", "p99", "p01", "summarize"]
