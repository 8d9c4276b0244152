"""Difficulty-aware admission for the slot-pool server (serve.engine); the
port of the reference's ``serve/difficulty.py``, on host numpy as there.

DARTH's recall predictor estimates per-query search progress, but the
slot pool treats every query identically — so the hard tail of a query
stream drags p99 recall/latency even when MEAN recall meets the
declared target. This module classifies queries at admission time with
cheap features read off the same routing scan every engine already
performs, so the server can give the hard tier structurally different
treatment (reserved slots, boosted effective targets, hedged
duplicates, overload shedding) without touching the device programs.

Difficulty features (all from one [N, R] distance matrix against the
index's ROUTING points — IVF centroids, or the HNSW routing sample
`route_ids`; identical to what ivf.init_state / hnsw init compute on
device, so classification costs one extra host-side matmul and nothing
per step):

  * first_nn — distance to the nearest routing point. This is exactly
    the `first_nn` feature the recall predictor consumes, i.e. the
    predictor's step-0 progress signal. (The full GBDT cannot be asked
    directly at admission: features.extract zeroes a query's feature
    row while its top-k is empty, so a pre-search predictor call
    returns a constant.) Far-from-index queries are harder.
  * gap — relative margin (d2 - d1) / d1 between the two nearest
    routing points. A small gap means routing is ambiguous: the true
    neighbors plausibly live under several routing regions and early
    probes rank them poorly.
  * crowd — fraction of routing points within `crowd_margin` x d1.
    A crowded neighborhood means many regions must be visited before
    the predictor's recall estimate saturates.

The scalar score is  crowd - w_gap * gap + w_nn * (first_nn / median)
— higher is harder. Scores only ever order queries within one serve()
batch (tier assignment is by quantile or explicit threshold), so the
scale of the individual terms does not need calibration across
datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Difficulty-tier policy for DarthServer (None disables tiering).

    The identity configuration — `TierConfig()` with hard_threshold=inf
    (nothing classified hard), hard_slot_fraction=0, boost=0,
    hedge=False, max_queue=None, rebalance=False — schedules exactly
    like the untiered server: one FIFO queue per host, declared
    targets served unmodified.

    Attributes:
      hard_quantile: score quantile above which a query is "hard"
        (per serve() batch; ignored when hard_threshold is set).
      hard_threshold: absolute score cutoff; overrides the quantile.
      hard_slot_fraction: fraction of each host's slot slice reserved
        for the hard tier (the partition is work-conserving: either
        tier spills into the other's free slots when its own queue is
        empty).
      boost: added to hard queries' effective recall target (clipped
        to 0.99, never below the declared target) — deeper search for
        the tail, which is what lifts p99 recall.
      hedge: when a host has idle hard slots and nothing queued, launch
        duplicate searches of in-flight hard queries at a further
        `hedge_boost`-raised target; a hedge that completes naturally
        upgrades the query's result, a truncated hedge is dropped.
      hedge_boost: extra target boost for hedged duplicates.
      max_queue: per-host admission bound; beyond it the overload
        policy applies instead of queueing unboundedly.
      overload: "degrade" serves overflow queries at
        min(target, degrade_target); "shed" refuses them outright
        (hard tier first — the expensive queries are dropped before
        cheap ones), recording ids in HostStats.shed_ids.
      degrade_target: the lowered target for "degrade".
      rebalance: hosts with idle slots and empty queues steal queued
        queries from the most-backlogged host at refill boundaries
        (deterministic work stealing; changes which host serves a
        query but never its result — per-slot state is slot-local).
    """
    hard_quantile: float = 0.75
    hard_threshold: Optional[float] = None
    hard_slot_fraction: float = 0.25
    boost: float = 0.0
    hedge: bool = False
    hedge_boost: float = 0.05
    max_queue: Optional[int] = None
    overload: str = "degrade"
    degrade_target: float = 0.80
    rebalance: bool = False

    def __post_init__(self):
        if not 0.0 <= self.hard_slot_fraction <= 1.0:
            raise ValueError(
                f"hard_slot_fraction must be in [0, 1], got "
                f"{self.hard_slot_fraction}")
        if not 0.0 <= self.hard_quantile <= 1.0:
            raise ValueError(
                f"hard_quantile must be in [0, 1], got "
                f"{self.hard_quantile}")
        if self.overload not in ("degrade", "shed"):
            raise ValueError(
                f"overload must be 'degrade' or 'shed', got "
                f"{self.overload!r}")
        if not 0.0 < self.degrade_target <= 1.0:
            raise ValueError(
                f"degrade_target must be in (0, 1], got "
                f"{self.degrade_target}")
        if self.boost < 0.0 or self.hedge_boost < 0.0:
            raise ValueError("boost / hedge_boost must be >= 0")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got "
                             f"{self.max_queue}")

    @staticmethod
    def uniform() -> "TierConfig":
        """The identity policy: tiering machinery on, behavior exactly
        the untiered server's (see class docstring)."""
        return TierConfig(hard_threshold=np.inf, hard_slot_fraction=0.0,
                          boost=0.0, hedge=False, max_queue=None,
                          rebalance=False)


@dataclasses.dataclass
class TierStats:
    """Per-tier SLO counters (ServeStats.tiers['easy'|'hard']).

    recall_* are percentiles of the PREDICTED recall at harvest
    (DarthState.r_pred — what the declarative-recall contract actually
    controls on; ground-truth recall needs the true neighbors, which
    the server never sees). recall_p99 is the 1st percentile of the
    distribution — the recall the worst 1% of the tier's queries got.
    latency_* are percentiles of engine steps from admission to
    harvest (service latency in sync units; queueing wait is visible
    as admission happening at a later engine step). NaN when the tier
    completed no queries."""
    count: int = 0              # queries assigned to the tier
    completed: int = 0
    truncated: int = 0
    shed: int = 0
    degraded: int = 0
    hedged: int = 0             # hedge duplicates launched
    hedge_upgrades: int = 0     # results replaced by a deeper hedge
    recall_p50: float = float("nan")
    recall_p99: float = float("nan")
    latency_p50: float = float("nan")
    latency_p99: float = float("nan")


def _routing_points(index) -> np.ndarray:
    """The index's routing scan targets, copied to the host.

    IVF routes over centroids; HNSW over the uniform node sample
    route_ids (a placed graph keeps their vectors); a MutableIndexView
    routes with its base index (the delta ring is scanned brute-force,
    it has no routing structure)."""
    if hasattr(index, "base") and hasattr(index, "delta"):
        return _routing_points(index.base)
    if hasattr(index, "centroids"):
        return index.centroids.cpu().numpy().astype(np.float32, copy=False)
    if hasattr(index, "route_vecs"):     # a graph placed on a mesh
        return index.route_vecs.cpu().numpy()
    if hasattr(index, "route_ids"):
        ids = index.route_ids.long()
        return index.vectors[ids].cpu().numpy().astype(np.float32)
    raise TypeError(
        f"cannot derive routing points from index type "
        f"{type(index).__name__}: expected IVF (centroids), HNSW "
        f"(route_ids) or a mutable view of either")


def difficulty_scores(index, queries: np.ndarray, *,
                      crowd_margin: float = 1.25,
                      w_gap: float = 1.0, w_nn: float = 0.5
                      ) -> np.ndarray:
    """Admission-time difficulty score per query (higher = harder).

    One [N, R] squared-distance matrix against the routing points (the
    same scan ivf.init_state / hnsw init run on device), reduced to the
    crowd / gap / first_nn features described in the module docstring.
    Deterministic in (index, queries)."""
    pts = _routing_points(index)
    q = np.asarray(queries, np.float32)
    d2 = (np.sum(q * q, axis=1)[:, None] + np.sum(pts * pts, axis=1)[None]
          - 2.0 * q @ pts.T)
    d2 = np.maximum(d2, 0.0)
    if d2.shape[1] < 2:         # a single routing point: nothing to rank
        return np.zeros((q.shape[0],), np.float32)
    part = np.partition(d2, 1, axis=1)
    d1, dsecond = part[:, 0], part[:, 1]
    eps = 1e-12
    gap = (dsecond - d1) / (d1 + eps)
    crowd = np.mean(d2 <= (crowd_margin ** 2) * d1[:, None] + eps, axis=1)
    first_nn = np.sqrt(d1)
    nn_norm = first_nn / (np.median(first_nn) + eps)
    return (crowd - w_gap * gap + w_nn * nn_norm).astype(np.float32)


def assign_tiers(scores: np.ndarray, config: TierConfig) -> np.ndarray:
    """bool[N] hard-tier mask from scores + policy (threshold wins over
    quantile; the quantile is taken within the batch being served)."""
    scores = np.asarray(scores, np.float32)
    if config.hard_threshold is not None:
        return scores >= config.hard_threshold
    cut = float(np.quantile(scores, config.hard_quantile))
    return scores >= cut


__all__ = ["TierConfig", "TierStats", "difficulty_scores", "assign_tiers"]
