"""Uniform engine adapter: the step-wise protocol DARTH's driver runs.

DARTH's driver (darth_search.py) is engine-agnostic: anything that exposes
init/step plus the counters the features need can be driven to a
declarative recall target (paper §3.3). This slice of the port carries
the IVF engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

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
