"""DARTH's 11 search-state features (paper Table 1), vectorized.

Feature vector layout (fixed order, float32[B, 11]):
  0 nstep      search step (IVF: probe number §3.3.2)
  1 ndis       #distance calculations so far
  2 ninserts   #updates to the NN result set
  3 firstNN    distance to the nearest centroid (IVF §3.3.2)
  4 closestNN  current closest NN distance
  5 furthestNN current k-th NN distance
  6 avg        mean of the k NN distances found
  7 var        variance of the NN distances
  8 med        median
  9 perc25     25th percentile
 10 perc75     75th percentile

The result set is kept sorted ascending by every engine, so the median
and percentiles are indexed reads. Distances are metric (sqrt of the
squared L2 the engines carry); a partially filled result set (+inf tail)
is handled with masked statistics.
"""
from __future__ import annotations

import torch

NUM_FEATURES = 11
FEATURE_NAMES = (
    "nstep", "ndis", "ninserts", "firstNN", "closestNN", "furthestNN",
    "avg", "var", "med", "perc25", "perc75",
)


def _row_sum(v: torch.Tensor) -> torch.Tensor:
    # Left to right over the k columns: the order XLA's CPU reduction
    # takes for short rows, so the features match the reference's as
    # closely as its own rounding allows (tests/test_torch_darth.py).
    acc = v[:, 0]
    for j in range(1, v.shape[1]):
        acc = acc + v[:, j]
    return acc


def extract(nstep: torch.Tensor, ndis: torch.Tensor, ninserts: torch.Tensor,
            first_nn: torch.Tensor, topk_sqd: torch.Tensor) -> torch.Tensor:
    """nstep, ndis, ninserts: int32[B]; first_nn: f32[B] (metric);
    topk_sqd: f32[B, K] squared, ascending, +inf = empty.
    Returns f32[B, NUM_FEATURES]."""
    k = topk_sqd.shape[1]
    finite = torch.isfinite(topk_sqd)
    cnt = finite.sum(1)
    cnt_safe = cnt.clamp_min(1).float()
    d = torch.sqrt(torch.where(finite, topk_sqd.clamp_min(0.0), 0.0))

    closest = d[:, 0]
    furthest = torch.gather(d, 1, (cnt - 1).clamp_min(0)[:, None])[:, 0]
    avg = _row_sum(d) / cnt_safe
    var = _row_sum(d * d) / cnt_safe - avg * avg

    def pct(p: float) -> torch.Tensor:
        # float32 product truncated toward zero, as astype(int32) does.
        idx = (p * (cnt - 1).float()).to(torch.int32).clamp(0, k - 1)
        return torch.gather(d, 1, idx[:, None].long())[:, 0]

    feats = torch.stack([
        nstep.float(), ndis.float(), ninserts.float(), first_nn.float(),
        closest, furthest, avg, var.clamp_min(0.0),
        pct(0.5), pct(0.25), pct(0.75),
    ], 1)
    return torch.where(cnt[:, None] > 0, feats, 0.0)
