"""Each query's distance count at the moment the server frees its slot.

``repro_torch.serve``'s ``_HostSlots.harvest`` is handed the slots'
``ndis`` (true distance computations, the engine's own counter) as it
pulls their top-k out; ``ServeStats`` keeps only their sum. The tally
wraps that method to keep them per query, so that a run can tell the
queries that searched every bucket (an IVF query whose ``ndis`` equals the
collection) from those that DARTH stopped, and report distances per
declared target. The wrapper reads and changes nothing the server uses.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List

import numpy as np


class Tally:
    def __init__(self) -> None:
        self.qids: List[np.ndarray] = []
        self.ndis: List[np.ndarray] = []

    def take(self, num_queries: int) -> np.ndarray:
        """Per query of the serve call just ended, its ``ndis`` at harvest
        (-1 where none was harvested); the tally is emptied."""
        out = np.full(num_queries, -1, np.int64)
        for q, d in zip(self.qids, self.ndis):
            out[q] = d
        self.qids, self.ndis = [], []
        return out


@contextlib.contextmanager
def tallied(tally: Tally) -> Iterator[Tally]:
    from repro_torch.serve import engine

    cls = engine._HostSlots
    original = cls.harvest

    def harvest(self, mask, topk_d, topk_i, ndis, **kw):
        sel = np.asarray(mask, bool)
        tally.qids.append(np.asarray(self.slot_query)[sel].astype(np.int64))
        tally.ndis.append(np.asarray(ndis)[sel].astype(np.int64))
        return original(self, mask, topk_d, topk_i, ndis, **kw)

    cls.harvest = harvest
    try:
        yield tally
    finally:
        cls.harvest = original
