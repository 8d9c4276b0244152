"""Streaming mutable-index subsystem (LSM style; a port of
``repro.mutate``): delta tier (ring of recent inserts, scanned with the
fused l2_topk kernel), tombstones (the pad convention: sqnorm +inf /
ids -1), compaction back into the base index, and drift-triggered
predictor recalibration — so DARTH's declarative-recall contract
survives a mutating collection.
"""
from repro_torch.mutate import compact, delta, engine, index, monitor
from repro_torch.mutate.delta import DeltaTier, make_delta
from repro_torch.mutate.engine import (MutableIndexView, MutableSearchState,
                                       mutable_engine, refresh_view)
from repro_torch.mutate.index import CompactionJob, MutableIndex
from repro_torch.mutate.monitor import DriftReport, RecalibrationMonitor

__all__ = ["compact", "delta", "engine", "index", "monitor",
           "DeltaTier", "make_delta", "MutableIndexView",
           "MutableSearchState", "mutable_engine", "refresh_view",
           "MutableIndex", "CompactionJob",
           "DriftReport", "RecalibrationMonitor"]
