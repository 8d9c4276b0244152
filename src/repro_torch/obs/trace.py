"""Per-query trace spans + the device-side recall-trajectory ring.

Every query admitted into the slot-pool server leaves a story: where it
was admitted (host / slot / epoch / tier), which scheduling events it
crossed (refill splices, hedge launches, queue steals, hot-swaps), how
its predicted recall evolved per engine step, and WHY it terminated.
This module is the host half of that story:

  * ``Span`` — one structured record. Event spans mark lifecycle edges
    (``admit``, ``hedge_launch``, ``steal``, ``swap_staged``,
    ``swap_applied``, ``compact_begin``/``compact_swap``, ...);
    terminal spans (kind ``"terminal"``) close a query exactly once
    with a ``reason`` from TERMINATION_REASONS and the per-step
    predicted-recall trajectory.
  * ``Tracer`` — the in-memory span sink a DarthServer writes through
    (serve.engine threads it through admission / harvest / swap /
    steal), flushed as JSONL at the end of each serve call.
  * ``traj_init`` / ``traj_record`` — the DEVICE side: a fixed-shape
    ``f32[slots, traj_cap]`` tensor ring on the engine's device, carried
    through the serving chunks. Each engine step writes every slot's
    current predicted recall at column ``(step - 1) % traj_cap``; the
    step count is a host int, so the write needs no sync, and the host
    drains the ring only at chunk boundaries (where serve() already
    syncs for the active mask): tracing adds ZERO extra device<->host
    sync points. The slot dim leads, so a refill splice resets a slot's
    row like the rest of its state.

Termination-reason taxonomy (docs/observability.md):

  * ``interval_met``      — the predictor's recall estimate reached the
                            declared (effective) target: DARTH stopped
                            the slot early (DarthState.early).
  * ``engine_exhausted``  — the engine hit its natural step limit
                            (nprobe / beam budget) before the interval
                            fired; the result is still a full top-k.
  * ``budget_truncated``  — serve()'s max_engine_steps ran out with the
                            query in flight; partial top-k harvested.
  * ``host_killed``       — fault injection killed the owning host; the
                            in-flight partial top-k was harvested.
  * ``shed``              — refused at admission control (overload
                            policy "shed"); never held a slot.
  * ``abandoned``         — queued but never admitted (its host died,
                            or the step budget ended first).

``degraded`` admission (overload policy "degrade") is NOT a terminal
reason — a degraded query still terminates through one of the reasons
above, at a lowered target; its terminal span carries
``degraded: true`` so the lowered contract stays attributable.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

TERMINATION_REASONS = ("interval_met", "engine_exhausted",
                       "budget_truncated", "host_killed", "shed",
                       "abandoned")

#: trajectory entries before the predictor's first firing (r_pred's
#: "never called" sentinel; mirrors DarthState.r_pred's init value)
NO_PREDICTION = -1.0


# ---------------------------------------------------------------------------
# Device side: the per-slot predicted-recall ring
# ---------------------------------------------------------------------------

def traj_init(num_slots: int, traj_cap: int, device=None) -> torch.Tensor:
    """Fresh trajectory ring f32[num_slots, traj_cap] on ``device``,
    NO_PREDICTION everywhere."""
    return torch.full((num_slots, traj_cap), NO_PREDICTION,
                      dtype=torch.float32, device=device)


def traj_record(traj: torch.Tensor, steps: int,
                r_pred: torch.Tensor) -> torch.Tensor:
    """Record every slot's current predicted recall after chunk step
    ``steps`` (the step counter AFTER the step ran, so step g lands at
    column (g-1) % cap). ``steps`` is a Python int, so the column is
    known on the host: one device write, no host sync. Writes ``traj``
    in place and returns it."""
    traj[:, (steps - 1) % traj.shape[1]] = r_pred
    return traj


def traj_window(row: np.ndarray, admit_step: int, harvest_step: int,
                base: int) -> Tuple[List[float], bool]:
    """Host-side drain: one slot's trajectory between its admission and
    harvest, unrolled by the ring cursor so values come out oldest
    first regardless of how many times the ring wrapped. ``base`` is
    the engine-step count when the ring's chunk state was
    (re)initialized (ring columns count from there).

    Returns ``(values, truncated)``. Windows longer than the ring keep
    only the most recent ``cap`` entries — the ring overwrote the older
    prefix in place — and report ``truncated=True`` so consumers (the
    explain sparkline, the trajectory-final == harvested ``r_pred``
    invariant checks) know the series is a suffix, not the full life
    of the query."""
    cap = row.shape[0]
    lo = admit_step - base
    hi = harvest_step - base
    truncated = (hi - lo) > cap
    lo = max(lo, hi - cap)
    if hi <= lo:
        return [], False
    cols = np.arange(lo, hi) % cap
    return [float(v) for v in row[cols]], truncated


# ---------------------------------------------------------------------------
# Host side: spans + tracer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One trace record (event edge or terminal close-out).

    ``qid`` is the query id (-1 for server-level events: swaps,
    compaction lifecycle). ``seq`` is the tracer's monotonic order —
    wall clocks never enter spans, so traces are deterministic and
    replayable. ``step`` is the global engine-step count at emission;
    ``epoch`` the server's engine/predictor version."""
    seq: int
    serve: int
    kind: str
    qid: int = -1
    host: int = -1
    step: int = 0
    epoch: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """Flat JSONL payload (attrs inlined, stable field order)."""
        out = {"seq": self.seq, "serve": self.serve, "kind": self.kind,
               "qid": self.qid, "host": self.host, "step": self.step,
               "epoch": self.epoch}
        out.update(self.attrs)
        return out


class Tracer:
    """Span sink for one DarthServer (one serve call at a time).

    Construction-time ``traj_cap`` sizes the device ring, fixed per
    server (the server binds its chunks to it). ``path``, when set, appends
    every finished serve's spans as JSONL; spans also stay available
    in-memory (``last_spans``) for programmatic access and tests.

    Exactly-once terminal contract: ``terminal()`` raises on a second
    terminal for the same qid; the one sanctioned mutation is
    ``upgrade_terminal`` (a hedge's deeper result replacing its
    primary's — still one terminal span, now marked upgraded)."""

    def __init__(self, path: Optional[str] = None, *, traj_cap: int = 64,
                 label: str = ""):
        if traj_cap < 1:
            raise ValueError(f"traj_cap must be >= 1, got {traj_cap}")
        self.path = path
        self.traj_cap = int(traj_cap)
        self.label = label
        self.serve_id = 0
        self._seq = 0
        self._events: List[Span] = []
        self._terminal: Dict[int, Span] = {}
        self.last_spans: List[Span] = []

    # -- lifecycle ---------------------------------------------------------
    def begin(self, label: Optional[str] = None) -> None:
        """Start a new serve's trace (serve.engine calls this at the top
        of every serve(); the previous serve's spans stay in
        ``last_spans`` until the next finish)."""
        self.serve_id += 1
        if label is not None:
            self.label = label
        self._events = []
        self._terminal = {}

    def finish(self) -> List[Span]:
        """Close the serve: order spans, append to ``path`` (JSONL) when
        set, return them (also kept as ``last_spans``)."""
        spans = sorted(self._events + list(self._terminal.values()),
                       key=lambda s: s.seq)
        self.last_spans = spans
        if self.path is not None:
            with open(self.path, "a") as f:
                for s in spans:
                    f.write(json.dumps(s.to_dict(), default=float) + "\n")
        return spans

    # -- span emission -----------------------------------------------------
    def _next(self) -> int:
        self._seq += 1
        return self._seq

    def event(self, kind: str, *, qid: int = -1, host: int = -1,
              step: int = 0, epoch: int = 0, **attrs) -> Span:
        """Emit one lifecycle-edge span."""
        if self.label:
            attrs.setdefault("label", self.label)
        sp = Span(seq=self._next(), serve=self.serve_id, kind=kind,
                  qid=qid, host=host, step=step, epoch=epoch, attrs=attrs)
        self._events.append(sp)
        return sp

    def terminal(self, qid: int, reason: str, *, host: int = -1,
                 step: int = 0, epoch: int = 0, **attrs) -> Span:
        """Close query ``qid`` with a terminal span (exactly once)."""
        if reason not in TERMINATION_REASONS:
            raise ValueError(f"unknown termination reason {reason!r} "
                             f"(taxonomy: {TERMINATION_REASONS})")
        if qid in self._terminal:
            raise RuntimeError(
                f"query {qid} already has a terminal span "
                f"({self._terminal[qid].attrs.get('reason')!r}); a second "
                f"termination ({reason!r}) breaks the exactly-once trace "
                f"contract")
        if self.label:
            attrs.setdefault("label", self.label)
        attrs["reason"] = reason
        sp = Span(seq=self._next(), serve=self.serve_id, kind="terminal",
                  qid=qid, host=host, step=step, epoch=epoch, attrs=attrs)
        self._terminal[qid] = sp
        return sp

    def upgrade_terminal(self, qid: int, *, step: int, **attrs) -> Span:
        """Replace qid's terminal payload with a hedge's deeper result
        (the one sanctioned terminal mutation; marks ``upgraded``)."""
        sp = self._terminal[qid]
        sp.attrs.update(attrs)
        sp.attrs["upgraded"] = True
        sp.step = step
        return sp

    # -- introspection (tests / explain) -----------------------------------
    def terminals(self) -> Dict[int, Span]:
        """qid -> terminal span for the serve in progress (or just
        finished, before the next begin)."""
        return dict(self._terminal)


def load_trace(path: str, serve: Optional[int] = None) -> List[Dict]:
    """Read a JSONL trace file back into span dicts; ``serve`` filters
    to one serve call's spans (default: the LAST serve in the file)."""
    spans: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    if not spans:
        return spans
    if serve is None:
        serve = max(s.get("serve", 0) for s in spans)
    return [s for s in spans if s.get("serve", 0) == serve]


__all__ = ["Span", "Tracer", "TERMINATION_REASONS", "NO_PREDICTION",
           "traj_init", "traj_record", "traj_window", "load_trace"]
