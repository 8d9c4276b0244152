"""The one traffic generator: every mix is a JSON file of parameters.

Keys of a mix (``darthbench/traffic/<name>.json``):

* ``kind``: ``"backlog"`` (a closed backlog: serve calls back to back,
  each on a queue of ``queue_per_slot`` x the server's slots) or
  ``"open"`` (arrivals at a constant rate, served by a drain loop);
* ``shares``: {"clean": a, "noisy": b}, the query kinds;
* ``noise_pct``: [lo, hi], the noisy queries' pct (sigma = sqrt(pct *
  ||q|| / D), the paper's generator);
* ``targets``: the declared recall targets, in equal shares;
* backlog: ``queue_per_slot`` and ``pool_queues`` (the distinct queues
  made, served in turn and then again);
* open: ``rate_qps``; one query is made per arrival.

The queries are drawn from the run's seed, around the modes of the
configuration's collection (``data``), with their per-query parameters
stratified: every seed gets its kinds, noise levels and targets in the
stated shares, evenly spread, and new vectors. The open loop's
inter-arrival gaps are the exponential's quantiles, shuffled by the seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from darthbench import data


@dataclasses.dataclass
class Stream:
    queries: torch.Tensor     # f32[M, D] on the device
    host: np.ndarray          # the same on the host (the server takes numpy)
    targets: np.ndarray       # f32[M] declared recall targets
    kinds: np.ndarray         # str[M] clean / noisy
    due: Optional[np.ndarray] = None   # f64[M] seconds into the window


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(data.derive(seed, stream))


def stratified_targets(targets: List[float], m: int,
                       rng: np.random.Generator) -> np.ndarray:
    reps = np.resize(np.asarray(targets, np.float32), m)
    return reps[rng.permutation(m)]


def kind_labels(shares: Dict[str, float], m: int,
                rng: np.random.Generator) -> np.ndarray:
    """m labels in the stated shares (largest remainders), shuffled."""
    names = sorted(shares)
    total = sum(float(shares[n]) for n in names)
    exact = [m * float(shares[n]) / total for n in names]
    counts = [int(math.floor(e)) for e in exact]
    order = sorted(range(len(names)), key=lambda j: counts[j] - exact[j])
    for j in order[:m - sum(counts)]:
        counts[j] += 1
    labels = np.repeat(np.asarray(names), counts)
    return labels[rng.permutation(m)]


def make_stream(mix: Dict[str, Any], coll: data.Collection, seed: int,
                m: int, stream: int = 1) -> Stream:
    """m queries of the mix, drawn from stream ``stream`` of the run's
    ``seed``."""
    rng = _rng(seed, stream)
    dev = coll.base.device
    g = data.generator(dev, seed, stream)
    std = float(coll.cfg["cluster_std"])
    kinds = kind_labels(mix["shares"], m, rng)
    q = data.mixture(g, coll.centers, m, std)
    noisy = np.nonzero(kinds == "noisy")[0]
    if noisy.size:
        lo, hi = (float(v) for v in mix["noise_pct"])
        pct = lo + (hi - lo) * (np.arange(noisy.size) + 0.5) / noisy.size
        pct = torch.as_tensor(pct[rng.permutation(noisy.size)],
                              dtype=torch.float32, device=dev)
        sel = torch.as_tensor(noisy, device=dev)
        q[sel] = data.add_noise(g, q[sel], pct)
    targets = stratified_targets(mix["targets"], m, rng)
    return Stream(queries=q, host=q.cpu().numpy(), targets=targets,
                  kinds=kinds)


def arrival_bound(mix: Dict[str, Any], seconds: float) -> int:
    """Arrivals drawn for a window: more than fall inside it."""
    return int(math.ceil(1.5 * float(mix["rate_qps"]) * seconds)) + 64


def arrivals(mix: Dict[str, Any], seed: int, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of a Poisson process at the mix's rate,
    whose gaps are the exponential's quantiles, shuffled by the seed."""
    m = arrival_bound(mix, seconds)
    u = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-u)[_rng(seed, 2).permutation(m)]
    t = (np.cumsum(gaps) - gaps[0]) / float(mix["rate_qps"])
    return t[t < seconds]
