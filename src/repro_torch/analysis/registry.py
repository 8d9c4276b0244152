"""Entry-point registry: what the runtime passes get to run.

An entry point is executable: its build function makes a small, self-contained
REAL instance of one of the port's code paths (a fused kernel's call, a
sharded search step, the DarthServer chunks, a cold tier under a mesh)
at a requested size on a given device, from random data, and returns
what the passes read (``Built``): the steps to run under the recorder,
the payloads that must stay SQ8-resident, and the placements to weigh.
``repro_torch.analysis.manifest`` holds them all.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

#: size label -> (num index rows, dim). The pair varies N ONLY: the
#: cross-shard-bytes pass asserts that a step's transfers do not scale
#: with the database size. D is held fixed because one-time routing
#: legitimately moves vector-sized (D-scaled) payloads; index rows
#: crossing shards is the bug class.
SIZES: Dict[str, Tuple[int, int]] = {
    "small": (2048, 16),
    "large": (8192, 16),
}


@dataclasses.dataclass
class Built:
    """What one build of an entry hands the passes.

    ``steps``: tag -> zero-argument callable, run under the recorder
    (``cross-shard-bytes`` sums its transfers at both sizes).
    ``payloads``: tag -> an index or tensor whose N-scaled ``[..., D]``
    arrays must be int8 (``resident-dtype``, entries marked
    ``resident_sq8``). ``placements``: (tag, unplaced index, placed
    index) triples (``replicated-store``). ``findings``: what the
    build function itself found wrong (an entry that would check nothing)."""
    steps: Dict[str, Callable[[], Any]] = dataclasses.field(
        default_factory=dict)
    payloads: Dict[str, Any] = dataclasses.field(default_factory=dict)
    placements: List[Tuple[str, Any, Any]] = dataclasses.field(
        default_factory=list)
    findings: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One registered code path.

    ``build(size, device)`` returns a ``Built``. ``check(device)``, when
    set instead, is an executable audit (the host-sync loop) returning
    Findings directly; such entries skip the other passes.

    ``resident_sq8`` marks entries whose build functions serve the compact
    SQ8-resident format: the resident-dtype pass then asserts that every
    N-scaled payload is int8 (and that at least one exists), so a
    regression back to f32 residency fails the gate."""
    name: str
    build: Optional[Callable[[str, Any], Built]] = None
    check: Optional[Callable[[Any], List[Any]]] = None
    resident_sq8: bool = False


_REGISTRY: Dict[str, EntryPoint] = {}


def register(name: str, *, check: bool = False, resident_sq8: bool = False):
    """Decorator: register a build function (or, with check=True, an executable
    audit) under ``name``."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate entry point {name!r}")
        _REGISTRY[name] = (EntryPoint(name, check=fn) if check else
                           EntryPoint(name, build=fn,
                                      resident_sq8=resident_sq8))
        return fn
    return deco


def entry_points() -> List[EntryPoint]:
    """All registered entries (importing the manifest registers them)."""
    from repro_torch.analysis import manifest  # noqa: F401  (registration)
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]
