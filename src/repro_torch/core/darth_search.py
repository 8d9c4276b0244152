"""DARTH early-termination search driver (paper Algorithm 1, batched).

The driver wraps an `Engine` and steps it in a host loop with:

  * per-query `idis` counters (distance calcs since last predictor call),
  * per-query adaptive prediction intervals `pi` (Eq. 1),
  * batched GBDT recall prediction for the queries that are due,
  * per-query early termination: predicted recall >= declared target.

The reference skips the predictor with a ``lax.cond`` when no query is
due; every output of the prediction is masked by ``due``, so computing it
at every step gives the same results without a host sync. The loop
condition costs one ``.any()`` sync per step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.core import engines as engines_lib
from repro_torch.core import features as features_lib
from repro_torch.core.intervals import IntervalParams, next_interval

PredictorFn = Callable[[torch.Tensor], torch.Tensor]  # f32[B,11] -> f32[B]


@dataclasses.dataclass
class DarthState:
    inner: Any
    idis: torch.Tensor    # i32[B] distance calcs since last predictor call
    pi: torch.Tensor      # f32[B] current prediction interval
    r_pred: torch.Tensor  # f32[B] last predicted recall (-1 = never called)
    npred: torch.Tensor   # i32[B] #predictor invocations
    early: torch.Tensor   # bool[B] terminated by DARTH (vs natural/budget)
    steps: int            # loop steps executed


def _features(engine: engines_lib.Engine, inner: Any) -> torch.Tensor:
    return features_lib.extract(
        engine.nstep(inner), inner.ndis, inner.ninserts, inner.first_nn,
        engine.topk_d(inner))


def _interval_field(v, device) -> torch.Tensor:
    """One interval field as an f32 tensor on ``device``: a host value
    (float or numpy array) is copied there; a tensor is moved only if it
    lies elsewhere (no host round trip)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _params_on(params: IntervalParams, device) -> IntervalParams:
    """Per-query (array or tensor) interval fields become f32 tensors on
    device; scalar fields stay Python floats, as the reference keeps
    them."""
    if np.ndim(params.ipi) == 0:
        return params
    return IntervalParams(ipi=_interval_field(params.ipi, device),
                          mpi=_interval_field(params.mpi, device))


def init_darth_state(engine: engines_lib.Engine, q: torch.Tensor,
                     params: IntervalParams) -> DarthState:
    b, dev = q.shape[0], q.device
    pi = _interval_field(params.ipi, dev)
    return DarthState(
        inner=engine.init(engine.index, q),
        idis=torch.zeros((b,), dtype=torch.int32, device=dev),
        pi=pi.expand(b).clone(),
        r_pred=torch.full((b,), -1.0, dtype=torch.float32, device=dev),
        npred=torch.zeros((b,), dtype=torch.int32, device=dev),
        early=torch.zeros((b,), dtype=torch.bool, device=dev),
        steps=0,
    )


def make_darth_body(engine: engines_lib.Engine, predictor: PredictorFn,
                    params: IntervalParams, r_t: torch.Tensor):
    """One Algorithm-1 iteration as a reusable body."""
    params = _params_on(params, r_t.device)

    def body(st: DarthState) -> DarthState:
        prev_ndis = st.inner.ndis
        inner = engine.step(engine.index, st.inner)
        idis = st.idis + (inner.ndis - prev_ndis)
        due = inner.active & (idis.float() >= st.pi)
        rp = torch.clamp(predictor(_features(engine, inner)), 0.0, 1.0)
        rp = torch.where(due, rp, st.r_pred)
        stop = due & (rp >= r_t)
        inner = engines_lib.set_active(inner, inner.active & ~stop)
        pi = torch.where(due, next_interval(params, r_t, rp), st.pi)
        return DarthState(inner=inner, idis=torch.where(due, 0, idis), pi=pi,
                          r_pred=rp, npred=st.npred + due.to(torch.int32),
                          early=st.early | stop, steps=st.steps + 1)

    return body


def darth_search(engine: engines_lib.Engine, q: torch.Tensor,
                 r_target: Union[float, np.ndarray, torch.Tensor],
                 predictor: PredictorFn,
                 params: IntervalParams) -> DarthState:
    """Run declarative-recall search to completion. Returns final state."""
    b = q.shape[0]
    r_t = torch.as_tensor(r_target, dtype=torch.float32, device=q.device)
    r_t = r_t.expand(b).contiguous()
    st = init_darth_state(engine, q, params)
    body = make_darth_body(engine, predictor, params, r_t)
    while st.steps < engine.max_steps and bool(st.inner.active.any()):
        st = body(st)
    return st


def plain_search(engine: engines_lib.Engine, q: torch.Tensor) -> Any:
    """Run the engine to natural termination (no early termination)."""
    inner = engine.init(engine.index, q)
    t = 0
    while t < engine.max_steps and bool(inner.active.any()):
        inner = engine.step(engine.index, inner)
        t += 1
    return inner


def budget_search(engine: engines_lib.Engine, q: torch.Tensor,
                  budget: Union[float, np.ndarray, torch.Tensor]) -> Any:
    """Fixed distance-calculation budget per query (the paper's 'Baseline'
    competitor §3.2.2 and LAET's termination primitive)."""
    b = q.shape[0]
    budget = torch.as_tensor(budget, dtype=torch.float32, device=q.device)
    budget = budget.expand(b)
    inner = engine.init(engine.index, q)
    t = 0
    while t < engine.max_steps and bool(inner.active.any()):
        inner = engine.step(engine.index, inner)
        over = inner.ndis.float() >= budget
        inner = engines_lib.set_active(inner, inner.active & ~over)
        t += 1
    return inner
