"""repro_torch.serve — the slot-pool server, its difficulty tiers and the
IVF cold bucket tier (a port of ``repro.serve``)."""
from repro_torch.serve import cold, difficulty, engine
from repro_torch.serve.cold import ColdTier, make_cold_tier
from repro_torch.serve.difficulty import (TierConfig, TierStats,
                                          assign_tiers, difficulty_scores)
from repro_torch.serve.engine import DarthServer, HostStats, ServeStats

__all__ = [
    "engine", "difficulty", "cold", "DarthServer", "HostStats",
    "ServeStats", "ColdTier", "make_cold_tier",
    "TierConfig", "TierStats", "assign_tiers", "difficulty_scores",
]
