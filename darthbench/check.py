"""Whether what the timed window served is correct.

Each number is compared with a limit of its own (a configuration's
``correct`` block holds the limits):

* ``missing``: queries offered in the window that did not come back
  exactly once (the server's promise); limit 0.
* ``bad_rows``: returned rows with an id outside the collection, an id
  twice, or distances out of ascending order; limit 0.
* ``dist_gap``: over every returned (query, id), the gap between the
  distance served and the reference's ||q - x||^2 of that id, over
  ||q||^2 + ||x||^2 (the scale of the expanded form's cancellation); the
  probe or beam step and the kernels under it. Limit ``dist_gap``.
* ``recall_short``: over the declared targets t, the largest
  min(t, attainable) - tolerance - (mean recall@k of a seeded sample of
  the returned rows declared at t), against the reference's exact
  neighbours: the predictor and early termination. Limit 0, the
  configuration's stated promise (``recall_tolerance``,
  ``attainable_recall``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from darthbench import data, reference


@dataclasses.dataclass
class Served:
    """What a window returned, row by row for the queries it offered."""
    queries: torch.Tensor    # f32[S, D] the offered queries, on the device
    targets: np.ndarray      # f32[S]
    returned: np.ndarray     # bool[S] came back exactly once
    ids: np.ndarray          # i64[S, k] (-1 where not returned)
    dists: np.ndarray        # f32[S, k] (+inf where not returned)


def _row_faults(ids: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    out_of_range = ((ids < 0) | (ids >= n)).any(1)
    srt = np.sort(ids, axis=1)
    twice = (srt[:, 1:] == srt[:, :-1]).any(1)
    unordered = (np.diff(dists, axis=1) < 0).any(1)
    return out_of_range | twice | unordered


def compare(base: torch.Tensor, served: Served, limits: Dict[str, Any],
            seed: int) -> Dict[str, Any]:
    """The numbers compared, each beside its limit, and per-target recall
    (for the earlier lines of a run's output)."""
    n, k = base.shape[0], served.ids.shape[1]
    ret = np.nonzero(served.returned)[0]
    ids, dists = served.ids[ret], served.dists[ret]
    bad = _row_faults(ids, dists, n)

    gap = 0.0
    good = ret[~bad]
    for lo in range(0, good.size, 1 << 16):
        rows = good[lo:lo + (1 << 16)]
        q = served.queries[torch.as_tensor(rows, device=base.device)]
        gi = torch.as_tensor(served.ids[rows], device=base.device)
        want = reference.distances(base, q, gi)
        got = torch.as_tensor(served.dists[rows], device=base.device)
        scale = reference.sqnorm(q)[:, None] + reference.sqnorm(
            base[gi.long()])
        gap = max(gap, float(((got - want).abs() / scale).max()))

    rng = np.random.default_rng(data.derive(seed, 7))
    size = min(int(limits["recall_sample"]), ret.size)
    sample = np.sort(rng.choice(ret, size=size, replace=False))
    recall_by_target: Dict[float, float] = {}
    short = 1.0          # nothing returned: the whole promise is missed
    if size:
        short = -np.inf
        q = served.queries[torch.as_tensor(sample, device=base.device)]
        _, exact = reference.exact_knn(base, q, k)
        exact = exact.cpu().numpy()
        got = served.ids[sample]
        hits = (got[:, :, None] == exact[:, None, :]).any(2).sum(1) / k
        tol = float(limits["recall_tolerance"])
        reach = float(limits["attainable_recall"])
        for t in np.unique(served.targets[sample]):
            sel = served.targets[sample] == t
            r = float(hits[sel].mean())
            recall_by_target[float(t)] = r
            short = max(short, min(float(t), reach) - tol - r)
    checks: List[Dict[str, Any]] = [
        {"name": "missing", "value": int((~served.returned).sum()),
         "limit": 0},
        {"name": "bad_rows", "value": int(bad.sum()), "limit": 0},
        {"name": "dist_gap", "value": gap, "limit": float(limits["dist_gap"])},
        {"name": "recall_short", "value": float(short), "limit": 0.0},
    ]
    for c in checks:
        c["ok"] = bool(c["value"] <= c["limit"])
    return {"checks": checks, "recall_by_target": recall_by_target,
            "recall_sample": int(size)}
