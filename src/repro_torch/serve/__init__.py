"""repro_torch.serve — the slot-pool server and its difficulty tiers (a port
of ``repro.serve``; the cold tier, ``ColdTier``, is ROADMAP Queue 1 item 7)."""
from repro_torch.serve import difficulty, engine
from repro_torch.serve.difficulty import (TierConfig, TierStats,
                                          assign_tiers, difficulty_scores)
from repro_torch.serve.engine import DarthServer, HostStats, ServeStats

__all__ = [
    "engine", "difficulty", "DarthServer", "HostStats", "ServeStats",
    "TierConfig", "TierStats", "assign_tiers", "difficulty_scores",
]
