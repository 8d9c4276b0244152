"""Cross-shard search collectives (a port of ``repro.dist.collectives``).

So far only ``merge_topk``: the candidate merge that the mutable engine
uses to fold the delta ring's top-k into the base engine's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.padding import PAD_ID


def merge_topk(cand_d: torch.Tensor, cand_i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge [B, M] candidate (dist, id) lists to the best k per row,
    ascending, the lower column first on a tie (``lax.top_k``'s order:
    a stable sort, never a bare ``torch.topk``). +inf candidates (pads,
    tombstones) are masked back to id -1."""
    d, pos = torch.sort(cand_d, dim=1, stable=True)
    d = d[:, :k]
    i = torch.gather(cand_i, 1, pos[:, :k])
    return d, torch.where(torch.isfinite(d), i, PAD_ID)
