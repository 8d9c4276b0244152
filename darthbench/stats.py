"""Percentiles, as the port's ``obs/stats.py`` defines them (copied, so that
a change to the program cannot move the yardstick).

Empty input gives NaN. Above the median a percentile rounds up to an
observed sample ("higher"), below it rounds down, so a tail never
interpolates toward the centre; the median interpolates linearly.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    xs = np.asarray(xs, np.float64).reshape(-1)
    xs = xs[np.isfinite(xs)]
    if xs.size == 0:
        return float("nan")
    method = "higher" if q > 50 else ("lower" if q < 50 else "linear")
    return float(np.percentile(xs, q, method=method))


def p50(xs: Sequence[float]) -> float:
    return percentile(xs, 50)
