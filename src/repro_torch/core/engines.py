"""Uniform engine adapter: the step-wise protocol DARTH's driver runs.

DARTH's driver (darth_search.py) is engine-agnostic: anything that exposes
init/step plus the counters the features need can be driven to a
declarative recall target (paper §3.3): the IVF probe loop and the HNSW
beam loop share it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.index import hnsw as hnsw_lib
from repro_torch.index import ivf as ivf_lib


class Engine(NamedTuple):
    """Step-wise search engine protocol.

    State objects carry .active bool[B], .ndis i32[B], .ninserts i32[B],
    .first_nn f32[B]. init/step take the index as an explicit argument
    (``engine.init(engine.index, q)``, ``engine.step(engine.index, s)``),
    as in the reference."""
    index: Any
    init: Callable[[Any, torch.Tensor], Any]
    step: Callable[[Any, Any], Any]
    topk_d: Callable[[Any], torch.Tensor]   # f32[B, K] squared, ascending
    topk_i: Callable[[Any], torch.Tensor]   # i32[B, K]
    nstep: Callable[[Any], torch.Tensor]    # i32[B]
    max_steps: int
    name: str
    k: int


def set_active(state: Any, mask: torch.Tensor) -> Any:
    return dataclasses.replace(state, active=mask)


def ivf_engine(index: ivf_lib.IVFIndex, *, k: int, nprobe: int) -> Engine:
    return Engine(
        index=index,
        init=lambda idx, q: ivf_lib.init_state(idx, q, k=k, nprobe=nprobe),
        step=ivf_lib.probe_step,
        topk_d=lambda s: s.topk_d,
        topk_i=lambda s: s.topk_i,
        nstep=lambda s: s.probe_pos,
        max_steps=nprobe,
        name="ivf",
        k=k,
    )


def sharded_ivf_engine(index, mesh, *, k: int, nprobe: int) -> Engine:
    """The IVF probe loop over a cap-sharded bucket store
    (``dist.place_index`` + ``dist.collectives.make_sharded_probe_step``).
    Same protocol and the same IVFSearchState as ``ivf_engine``, so
    darth_search, budget_search and the slot pool drive it unchanged;
    only the probe step's data movement differs. ``index`` must have been
    placed with ``dist.place_index(index, mesh)``."""
    from repro_torch.dist import collectives

    init = collectives.make_sharded_ivf_init(mesh)
    return Engine(
        index=index,
        init=lambda idx, q: init(idx, q, k=k, nprobe=nprobe),
        step=collectives.make_sharded_probe_step(mesh),
        topk_d=lambda s: s.topk_d,
        topk_i=lambda s: s.topk_i,
        nstep=lambda s: s.probe_pos,
        max_steps=nprobe,
        name="ivf-sharded",
        k=k,
    )


def hnsw_engine(index: hnsw_lib.HNSWIndex, *, k: int, ef: int,
                max_steps: int = 0, visited_width: int = 0) -> Engine:
    """The beam loop; ``max_steps`` defaults to 8 * ef. ``visited_width``
    > 0 swaps the exact [B, N] visited bitmap for a hashed filter
    [B, visited_width] (a power of two < N; see hnsw.init_state)."""
    return Engine(
        index=index,
        init=lambda idx, q: hnsw_lib.init_state(
            idx, q, ef=ef, visited_width=visited_width),
        step=lambda idx, s: hnsw_lib.beam_step(idx, s, k=k),
        topk_d=lambda s: s.cand_d[:, :k],
        topk_i=lambda s: s.cand_i[:, :k],
        nstep=lambda s: s.nstep,
        max_steps=max_steps or 8 * ef,
        name="hnsw",
        k=k,
    )


def sharded_hnsw_engine(index, mesh, *, k: int, ef: int, max_steps: int = 0,
                        visited_width: int = 0) -> Engine:
    """The beam loop over a row-sharded graph (``dist.place_index`` +
    ``dist.collectives.make_sharded_beam_step``). Same protocol and the
    same HNSWSearchState as ``hnsw_engine`` (its visited structure a
    tuple of per-shard blocks), so darth_search, budget_search and the
    slot pool drive it unchanged; only the beam step's data movement
    differs. ``max_steps`` defaults to 8 * ef; ``visited_width`` > 0
    selects the hashed filter (a power of two the shard count divides).
    ``index`` must have been placed with ``dist.place_index(index,
    mesh)``."""
    from repro_torch.dist import collectives

    init = collectives.make_sharded_hnsw_init(mesh)
    step = collectives.make_sharded_beam_step(mesh)
    return Engine(
        index=index,
        init=lambda idx, q: init(idx, q, ef=ef, visited_width=visited_width),
        step=lambda idx, s: step(idx, s, k=k),
        topk_d=lambda s: s.cand_d[:, :k],
        topk_i=lambda s: s.cand_i[:, :k],
        nstep=lambda s: s.nstep,
        max_steps=max_steps or 8 * ef,
        name="hnsw-sharded",
        k=k,
    )


def mutable_engine(base_engine: Engine, delta) -> Engine:
    """Wrap an engine with a delta tier: init adds one brute-force delta
    scan (fused l2_topk), step is the base step, and the top-k getters
    merge the delta candidates via merge_topk. Tombstoned slots carry
    sqnorm +inf / ids -1 in base and delta alike, so deletes are
    invisible to every driver. See repro_torch.mutate."""
    from repro_torch.mutate import engine as mutate_engine_lib

    return mutate_engine_lib.mutable_engine(base_engine, delta)
