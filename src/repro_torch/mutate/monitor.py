"""Drift-triggered predictor recalibration (a port of
``repro.mutate.monitor``): the declarative-recall contract under
mutation.

The GBDT recall predictor was fit against a frozen index; inserts shift
the feature distribution (the merged top-k's distance statistics move
with the delta's contents) and deletes change what recall even means.
The monitor closes the loop:

  1. ``observe`` samples served queries (query, declared target, returned
     ids) into a fixed-capacity replay ring stamped with the mutation
     epoch;
  2. ``drift`` recomputes EXACT ground truth over the live base+delta set
     (``MutableIndex.live_ground_truth``) and measures achieved recall
     per declared target, over the current epoch's entries only;
  3. when a target's achieved recall falls more than ``threshold`` below
     its declaration, ``recalibrate`` refits the predictor through the
     CURRENT mutable engine (``Darth.fit(ids=)``) and hot-swaps it into a
     running DarthServer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.padding import PAD_ID
from repro_torch.index import flat


@dataclasses.dataclass
class DriftReport:
    achieved: Dict[float, float]   # declared target -> mean achieved
    counts: Dict[float, int]       # declared target -> #replay queries
    worst_gap: float               # max(target - achieved), 0 if none
    num_queries: int
    drifted: bool


class RecalibrationMonitor:
    """Replay buffer + drift check + refit/hot-swap."""

    def __init__(self, mutable, darth, *,
                 targets: Sequence[float] = (0.8, 0.9, 0.95),
                 threshold: float = 0.02, capacity: int = 2048,
                 mesh=None, metrics=None):
        self.mutable = mutable
        self.darth = darth
        # optional obs.MetricsRegistry: drift checks and recalibrations
        # land in its event log + gauges
        self.metrics = metrics
        self.targets = tuple(float(t) for t in targets)
        self.threshold = float(threshold)
        self.capacity = int(capacity)
        # with a mesh, the drift check's and the refit's ground-truth
        # scans row-shard over it (the index itself is not placed)
        self.mesh = mesh
        self.k = darth.engine.k
        dim = mutable.dim
        self._q = np.zeros((self.capacity, dim), np.float32)
        self._rt = np.zeros((self.capacity,), np.float32)
        self._ids = np.full((self.capacity, self.k), PAD_ID, np.int64)
        # -1 is the "never written" epoch sentinel (the mutation-version
        # stamp), not a pad id — padlint: ok
        self._ver = np.full((self.capacity,), -1, np.int64)
        self._n = 0
        self._cursor = 0
        self.recalibrations = 0
        # wall seconds of the last refit: live-set extraction, then
        # Darth.fit's own split (ground truth / observations / gbdt)
        self.refit_seconds: Dict[str, float] = {}

    # -- replay buffer -----------------------------------------------------
    def observe(self, q: np.ndarray, r_t: np.ndarray,
                ids: np.ndarray) -> None:
        """Record served queries (ring overwrite when full). Entries are
        stamped with the index's mutation epoch: results served against
        an OLDER live set can never contain vectors inserted since, so
        their recall gap is irreducible by a predictor refit and they
        must not count as drift."""
        q = np.asarray(q, np.float32).reshape(-1, self._q.shape[1])
        r_t = np.broadcast_to(np.asarray(r_t, np.float32), (q.shape[0],))
        ids = np.asarray(ids).reshape(q.shape[0], -1)[:, :self.k]
        for j in range(q.shape[0]):
            c = self._cursor
            self._q[c] = q[j]
            self._rt[c] = r_t[j]
            self._ids[c] = ids[j]
            self._ver[c] = self.mutable.version
            self._cursor = (c + 1) % self.capacity
            self._n = min(self._n + 1, self.capacity)

    def drift(self) -> DriftReport:
        """Replay recall vs fresh base+delta ground truth, per target
        (current-epoch replay entries only — see observe)."""
        cur = self._ver[:self._n] == self.mutable.version
        if not cur.any():
            return DriftReport({}, {}, 0.0, 0, False)
        q = self._q[:self._n][cur]
        rt = self._rt[:self._n][cur]
        found = self._ids[:self._n][cur]
        gt = self.mutable.live_ground_truth(q, self.k, mesh=self.mesh)
        rec = flat.recall_at_k(torch.as_tensor(found.astype(np.int32)),
                               torch.as_tensor(gt)).numpy()
        achieved, counts = {}, {}
        worst = 0.0
        for t in self.targets:
            sel = np.abs(rt - t) < 1e-6
            if not sel.any():
                continue
            achieved[t] = float(rec[sel].mean())
            counts[t] = int(sel.sum())
            worst = max(worst, t - achieved[t])
        rep = DriftReport(achieved=achieved, counts=counts,
                          worst_gap=worst, num_queries=int(cur.sum()),
                          drifted=worst > self.threshold)
        if self.metrics is not None:
            self.metrics.event("drift", worst_gap=rep.worst_gap,
                               num_queries=rep.num_queries,
                               drifted=rep.drifted,
                               version=int(self.mutable.version))
            self.metrics.gauge(
                "darth_drift_worst_gap",
                "declared-minus-achieved recall gap at the last drift "
                "check").set(rep.worst_gap)
        return rep

    # -- recalibration -----------------------------------------------------
    def recalibrate(self, learn_q: np.ndarray, *, server=None,
                    batch: int = 256, seed: int = 0):
        """Refit the predictor through the current mutable engine against
        live base+delta ground truth; hot-swap into ``server`` if given."""
        import time
        t0 = time.perf_counter()
        live_ids, live_vecs = self.mutable._live_tensors()
        t1 = time.perf_counter()
        trained = self.darth.fit(np.asarray(learn_q, np.float32), live_vecs,
                                 ids=live_ids, batch=batch, seed=seed,
                                 mesh=self.mesh)
        self.refit_seconds = dict({"live_set": t1 - t0},
                                  **self.darth.fit_seconds)
        self.recalibrations += 1
        if self.metrics is not None:
            self.metrics.event("recal", recalibrations=self.recalibrations,
                               version=int(self.mutable.version),
                               hot_swapped=server is not None)
            self.metrics.counter(
                "darth_recalibrations_total",
                "predictor refits triggered by drift").inc()
        if server is not None:
            server.set_predictor(trained.predictor)
        # Drop the replay ring: its entries were served by the OLD
        # predictor against an older live set — keeping them would pin
        # drift() above threshold and make step() refit on every tick
        # with no effect on the measured gap.
        self._n = 0
        self._cursor = 0
        return trained

    def step(self, learn_q: np.ndarray, *, server=None,
             batch: int = 256) -> DriftReport:
        """One monitor tick: check drift, recalibrate if past threshold."""
        rep = self.drift()
        if rep.drifted:
            self.recalibrate(learn_q, server=server, batch=batch)
        return rep
