"""Mutable-index engine adapter: base engine + delta tier, one Engine (a
port of ``repro.mutate.engine``).

``mutable_engine(base_engine, delta)`` wraps an Engine (IVF or HNSW) into
a new Engine whose init runs the base init plus one brute-force delta
scan (fused l2_topk), whose step is exactly the base probe/beam step, and
whose top-k getters merge the frozen delta candidates into the base
result via ``merge_topk``. Because the wrapper honours the full Engine
protocol (state carries active / ndis / ninserts / first_nn, init/step
take the index as an argument), the DARTH driver, the plain and budget
searches, the slot-pool server and the training-data generator all serve
a mutating index unchanged.

Accounting: the delta scan is a FIXED per-query cost (one fused kernel
call at init, ``live`` distances), deliberately kept OUT of ndis /
ninserts — those counters pace DARTH's adaptive prediction intervals and
feed the ndis feature, and folding a large constant into them inflates
dists_Rt until the heuristic intervals exceed the engine's remaining work
and early termination never fires. The predictor still sees the delta
through the distance-statistic features (closestNN, percentiles, ...),
which are extracted from the MERGED top-k; fit and serve both run through
the wrapper, so the feature scale is consistent. An EMPTY delta therefore
perturbs nothing: the wrapper is bit-for-bit the base engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import engines as engines_lib
from repro_torch.dist.collectives import merge_topk
from repro_torch.mutate import delta as delta_lib


@dataclasses.dataclass
class MutableIndexView:
    """What a mutable Engine carries as ``.index``: the base index plus
    the delta ring."""
    base: Any
    delta: delta_lib.DeltaTier

    @property
    def device(self) -> torch.device:
        return self.base.device


@dataclasses.dataclass
class MutableSearchState:
    """Base search state + the per-query delta-scan candidates.

    ``active`` is the authoritative mask (set_active replaces it; step
    syncs it into the base state before stepping). ndis / ninserts /
    first_nn forward to the base state — the delta scan's fixed cost is
    intentionally not folded in (see the module docstring). A step
    returns a new state and never writes delta_d / delta_i in place, so
    the merge memoized on a state (``merged`` below) never outlives it."""
    inner: Any               # base engine state (IVFSearchState / HNSW...)
    delta_d: torch.Tensor    # f32[B, k] squared, ascending (+inf empty)
    delta_i: torch.Tensor    # i32[B, k] global ids (-1 empty)
    active: torch.Tensor     # bool[B]

    @property
    def ndis(self) -> torch.Tensor:
        return self.inner.ndis

    @property
    def ninserts(self) -> torch.Tensor:
        return self.inner.ninserts

    @property
    def first_nn(self) -> torch.Tensor:
        return self.inner.first_nn


def mutable_engine(base: engines_lib.Engine,
                   delta: delta_lib.DeltaTier) -> engines_lib.Engine:
    """Wrap ``base`` so search covers base + delta minus tombstones."""
    k = base.k
    if delta.capacity < k:
        raise ValueError(
            f"delta capacity {delta.capacity} < k={k}: the delta scan "
            f"must be able to yield k candidates")
    view = MutableIndexView(base=base.index, delta=delta)
    # init/step only ever read the index from the `idx` ARGUMENT; the
    # closures must not pin the construction-time base across
    # contents-only swaps.
    base = base._replace(index=None)

    def init(idx: MutableIndexView, q: torch.Tensor) -> MutableSearchState:
        inner = base.init(idx.base, q)
        dd, di, _, _ = delta_lib.delta_topk(idx.delta, q, k)
        return MutableSearchState(inner=inner, delta_d=dd, delta_i=di,
                                  active=inner.active)

    def step(idx: MutableIndexView, ws: MutableSearchState
             ) -> MutableSearchState:
        inner = engines_lib.set_active(ws.inner, ws.active)
        inner = base.step(idx.base, inner)
        return MutableSearchState(inner=inner, delta_d=ws.delta_d,
                                  delta_i=ws.delta_i, active=inner.active)

    def merged(ws: MutableSearchState):
        # topk_d and topk_i are separate protocol getters that callers
        # (slot harvest, Darth.search) invoke on the same state: memoize
        # the merge on the state instance so it runs once. Every step,
        # set_active and slot splice builds a new instance, which never
        # carries the cache.
        cached = ws.__dict__.get("_merged_topk")
        if cached is None:
            cached = merge_topk(
                torch.cat([base.topk_d(ws.inner), ws.delta_d], 1),
                torch.cat([base.topk_i(ws.inner), ws.delta_i], 1), k)
            ws.__dict__["_merged_topk"] = cached
        return cached

    return engines_lib.Engine(
        index=view,
        init=init,
        step=step,
        topk_d=lambda ws: merged(ws)[0],
        topk_i=lambda ws: merged(ws)[1],
        nstep=lambda ws: base.nstep(ws.inner),
        max_steps=base.max_steps,
        name=base.name + "+delta",
        k=k,
    )


def refresh_view(engine: engines_lib.Engine, *, base: Any = None,
                 delta: Any = None) -> engines_lib.Engine:
    """Contents-only view refresh — the cheap half of the double-buffered
    swap. Returns a new Engine reusing the wrapper's closures with only
    the view's base and/or delta replaced; hand it to
    ``DarthServer.set_engine(contents_only=True)``. Components passed as
    None keep the current buffers."""
    view = engine.index
    if not isinstance(view, MutableIndexView):
        raise TypeError(
            f"refresh_view needs an Engine carrying a MutableIndexView "
            f"(mutable_engine), got {type(view).__name__}")
    return engine._replace(index=MutableIndexView(
        base=view.base if base is None else base,
        delta=view.delta if delta is None else delta))
