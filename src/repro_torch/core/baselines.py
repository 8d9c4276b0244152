"""Declarative-recall competitors (paper §4: Baseline, REM, LAET).

  Baseline  terminate every query after dists_Rt distance calcs (§3.2.2):
            ``darth_search.budget_search``.
  REM       Recall-to-efSearch/nprobe Mapping: one linear sweep over the
            effort parameter on validation queries; pick the smallest value
            whose mean recall >= target.
  LAET      Learned Adaptive Early Termination (Li et al. 2020): after a
            fixed initial search, predict the TOTAL distance calcs a query
            needs to find all its NNs, multiply by a hand-tuned multiplier,
            terminate at that budget. Multiplier tuned per target on
            validation queries (the paper's adaptation, §4 'Comparison
            Algorithms').

The reference's ``lax.while_loop`` over budget steps is a host loop here
with one ``.any()`` sync per step, as in ``darth_search``. LAET's single
prediction goes through ``kernels.ops.gbdt_predict``: the gbdt_predict
kernel on the card, its plain version on the CPU. Mean recalls are taken
in numpy over the per-query f32 recalls, as the reference takes them, so
the REM sweep and the multiplier search decide alike.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import darth_search, engines as engines_lib
from repro_torch.core import features as features_lib
from repro_torch.core.training import TrainLog
from repro_torch.gbdt import train as gbdt_train
from repro_torch.gbdt.model import GBDTParams
from repro_torch.index import flat
from repro_torch.kernels import ops


def _mean_recall(engine: engines_lib.Engine, inner, gt: torch.Tensor
                 ) -> float:
    return float(flat.recall_at_k(engine.topk_i(inner), gt).cpu().numpy()
                 .mean())


# ---------------------------------------------------------------------------
# REM
# ---------------------------------------------------------------------------

class REM(NamedTuple):
    mapping: Dict[float, int]   # target recall -> effort parameter
    sweep: Dict[int, float]     # effort parameter -> measured mean recall


def fit_rem(make_engine: Callable[[int], engines_lib.Engine],
            q_val: torch.Tensor, gt_val: torch.Tensor,
            param_grid: Sequence[int],
            targets: Sequence[float]) -> REM:
    sweep = {}
    for p in sorted(param_grid):
        eng = make_engine(int(p))
        sweep[int(p)] = _mean_recall(
            eng, darth_search.plain_search(eng, q_val), gt_val)
    mapping = {}
    for rt in targets:
        ok = [p for p, r in sweep.items() if r >= rt]
        mapping[float(rt)] = min(ok) if ok else max(sweep)
    return REM(mapping=mapping, sweep=sweep)


# ---------------------------------------------------------------------------
# LAET
# ---------------------------------------------------------------------------

class LAET(NamedTuple):
    params: GBDTParams           # predicts log1p(total dists to all NNs)
    n0: int                      # fixed initial steps before prediction
    multipliers: Dict[float, float]


def _total_dists_to_final(log: TrainLog) -> np.ndarray:
    """Per-query ndis at the first step reaching its FINAL recall."""
    t, b = log.recall.shape
    final = log.recall[-1]
    hit = (log.recall >= final[None, :] - 1e-9) & log.valid
    t_idx = np.where(hit.any(0), hit.argmax(0), t - 1)
    return log.ndis[t_idx, np.arange(b)].astype(np.float64)


def fit_laet(log: TrainLog, *, n0: int = 2,
             cfg: gbdt_train.GBDTConfig = gbdt_train.GBDTConfig(),
             device="cuda") -> LAET:
    """Train LAET's total-effort regressor from the same step logs."""
    x = log.features[n0 - 1]            # features after the fixed prefix
    y = np.log1p(_total_dists_to_final(log))
    params = gbdt_train.fit(x, y.astype(np.float32), cfg, device=device)
    return LAET(params=params, n0=n0, multipliers={})


def laet_search(laet: LAET, engine: engines_lib.Engine, q: torch.Tensor,
                multiplier: float):
    """Run LAET: n0 fixed steps, one prediction, fixed budget after."""
    inner = engine.init(engine.index, q)
    for _ in range(laet.n0):
        inner = engine.step(engine.index, inner)
    feats = features_lib.extract(
        engine.nstep(inner), inner.ndis, inner.ninserts, inner.first_nn,
        engine.topk_d(inner))
    pred_total = torch.expm1(ops.gbdt_predict(laet.params, feats))
    budget = torch.maximum(pred_total * multiplier, inner.ndis.float())
    return _run_with_budget(engine, inner, budget)


def _run_with_budget(engine: engines_lib.Engine, inner,
                     budget: torch.Tensor):
    t = 0
    while t < engine.max_steps and bool(inner.active.any()):
        inner = engine.step(engine.index, inner)
        over = inner.ndis.float() >= budget
        inner = engines_lib.set_active(inner, inner.active & ~over)
        t += 1
    return inner


def tune_laet(laet: LAET, engine: engines_lib.Engine, q_val: torch.Tensor,
              gt_val: torch.Tensor, targets: Sequence[float],
              lo: float = 0.1, hi: float = 3.0, steps: int = 8) -> LAET:
    """Binary-search the multiplier per target (monotone recall-vs-mult)."""
    mult = {}
    for rt in targets:
        a, b = lo, hi
        best = hi
        for _ in range(steps):
            mid = 0.5 * (a + b)
            rec = _mean_recall(engine, laet_search(laet, engine, q_val, mid),
                               gt_val)
            if rec >= rt:
                best, b = mid, mid
            else:
                a = mid
        mult[float(rt)] = best
    return laet._replace(multipliers=mult)
