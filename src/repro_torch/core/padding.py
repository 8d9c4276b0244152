"""The shard-pad / tombstone convention, in one place.

Every fixed-shape layout (IVF bucket slots, candidate merges) marks an
empty slot the same way:

    vecs 0, ids PAD_ID (-1, int32), sqnorm / distance PAD_SQNORM (+inf, f32)

+inf sqnorms can never win a top-k and -1 ids are dropped by every
consumer (recall, merges), so a pad slot never surfaces in a result set.
"""
from __future__ import annotations

import torch

# Empty / tombstoned id slot (bucket_ids, merges).
PAD_ID = -1
# Empty / tombstoned sqnorm: +inf can never enter a top-k.
PAD_SQNORM = float("inf")
# Masked candidate distance (same value; named for call-site clarity).
PAD_DIST = PAD_SQNORM


def pad_ids(shape, device, dtype=torch.int32) -> torch.Tensor:
    """An integer tensor full of PAD_ID."""
    if dtype.is_floating_point or dtype == torch.bool:
        raise TypeError(f"pad id dtype {dtype} is not an integer type")
    return torch.full(shape, PAD_ID, dtype=dtype, device=device)


def pad_dists(shape, device, dtype=torch.float32) -> torch.Tensor:
    """A float tensor full of PAD_SQNORM (+inf)."""
    if not dtype.is_floating_point:
        raise TypeError(f"pad distance dtype {dtype} is not a float type")
    return torch.full(shape, PAD_SQNORM, dtype=dtype, device=device)


__all__ = ["PAD_ID", "PAD_SQNORM", "PAD_DIST", "pad_ids", "pad_dists"]
