"""Public declarative-recall API: ANNS(q, index, k, R_t) (paper §2.3).

`Darth` bundles an engine, a trained recall predictor and per-target
heuristic interval parameters. After `Darth.fit()` (one training-data
generation + GBDT fit), any attainable recall target can be declared per
query with no further tuning.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import darth_search, engines as engines_lib
from repro_torch.core import intervals as intervals_lib
from repro_torch.core import training as training_lib

Targets = Union[float, np.ndarray, torch.Tensor]


def validate_targets(r_target: Targets, batch: int) -> np.ndarray:
    """Reject malformed declared-recall targets before they broadcast.

    A scalar or a [batch] vector is accepted; anything else (a wrong
    length or a 2-D array) would broadcast garbage against per-query
    state. Targets must be finite and in (0, 1]. Returns the validated
    float32 array."""
    if isinstance(r_target, torch.Tensor):
        r_target = r_target.detach().cpu().numpy()
    rt = np.asarray(r_target, np.float32)
    if rt.ndim > 1 or (rt.ndim == 1 and rt.shape[0] != batch):
        raise ValueError(
            f"r_target shape {rt.shape} does not match query batch "
            f"{batch}: pass a scalar or a [{batch}] vector of per-query "
            f"declared recall targets")
    if rt.size == 0 or not np.all(np.isfinite(rt)) or \
            float(rt.min()) <= 0.0 or float(rt.max()) > 1.0:
        raise ValueError(
            f"declared recall targets must be finite and in (0, 1], got "
            f"range [{rt.min() if rt.size else 'empty'}, "
            f"{rt.max() if rt.size else 'empty'}]")
    return rt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Darth:
    """Declarative-recall searcher over one index + one k. Queries and
    the database may be numpy arrays or tensors; they are moved to the
    device of the engine's index."""
    make_engine: Callable[..., engines_lib.Engine]
    engine: engines_lib.Engine
    trained: Optional[training_lib.TrainedDarth] = None
    # Wall-clock split of the last fit (ground truth / observations /
    # gbdt), in seconds.
    fit_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.engine.index.centroids.device

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- training ----------------------------------------------------------
    def fit(self, q_train, x, *,
            targets: Sequence[float] = (0.8, 0.85, 0.9, 0.95, 0.99),
            max_samples: int = 2_000_000, batch: int = 256,
            seed: int = 0) -> training_lib.TrainedDarth:
        """One-time fit: exact ground truth, the step log, the GBDT."""
        k = self.engine.k
        q_train = self._on_device(q_train)
        t0 = time.time()
        _, gt_i = training_lib.ground_truth(q_train, self._on_device(x), k)
        _sync(self.device)
        t1 = time.time()
        log = training_lib.generate_observations(self.engine, q_train, gt_i,
                                                 batch=batch)
        t2 = time.time()
        self.trained = training_lib.fit_predictor(
            log, targets=targets, max_samples=max_samples, seed=seed,
            device=self.device)
        self.fit_seconds = {"ground_truth": t1 - t0, "observations": t2 - t1,
                            "gbdt": time.time() - t2}
        self._last_log = log
        return self.trained

    # -- search ------------------------------------------------------------
    def _dists_table(self):
        assert self.trained is not None, "call fit() first"
        keys = sorted(self.trained.dists_rt)
        return (np.array(keys),
                np.array([self.trained.dists_rt[t] for t in keys]))

    def interval_params(self, r_target: float) -> intervals_lib.IntervalParams:
        """Interval parameters from the trained dists_Rt, interpolated
        between the fitted targets."""
        arr, dists = self._dists_table()
        return intervals_lib.heuristic_params(
            float(np.interp(r_target, arr, dists)))

    def interval_for_target(self, r_target) -> intervals_lib.IntervalParams:
        """Per-query IntervalParams for a scalar or [B] vector of declared
        targets; element j equals ``interval_params(r_target[j])``."""
        arr, dists = self._dists_table()
        rt = np.atleast_1d(np.asarray(r_target, np.float32))
        return intervals_lib.heuristic_params(
            np.interp(rt.astype(np.float64), arr, dists))

    def search(self, q, r_target: Targets
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          darth_search.DarthState]:
        """ANNS(q, G, k, R_t): returns (dists, ids, diagnostics state).
        The intervals come from the MEAN declared target, as in the
        reference."""
        assert self.trained is not None, "call fit() first"
        q = self._on_device(q)
        r_target = validate_targets(r_target, q.shape[0])
        params = self.interval_params(float(np.mean(r_target)))
        st = darth_search.darth_search(self.engine, q, r_target,
                                       self.trained.predictor, params)
        return (self.engine.topk_d(st.inner), self.engine.topk_i(st.inner),
                st)

    def search_plain(self, q):
        inner = darth_search.plain_search(self.engine, self._on_device(q))
        return self.engine.topk_d(inner), self.engine.topk_i(inner), inner
