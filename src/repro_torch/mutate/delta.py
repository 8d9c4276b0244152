"""Delta tier: a fixed-capacity ring of recently inserted vectors (a port
of ``repro.mutate.delta``).

The base index (IVF bucket store / HNSW graph) stays immutable between
compactions; inserts land here, in a flat [capacity, D] buffer that every
search scans brute-force with the fused ``l2_topk`` kernel and merges
into the base top-k. Slots follow the repo-wide padding contract, so an
empty or tombstoned slot can never surface in a result set:

    vecs 0, ids -1, sqnorm +inf

Ring-cursor bookkeeping lives on the host (``mutate.index.MutableIndex``).
``write`` and ``tombstone`` return a new ring and never write into the
one they were given: a server may still be serving it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.padding import PAD_ID, PAD_SQNORM, pad_dists, pad_ids
from repro_torch.kernels import ops


@dataclasses.dataclass
class DeltaTier:
    vecs: torch.Tensor    # f32[capacity, D] (zeros when empty)
    ids: torch.Tensor     # i32[capacity] global ids (-1 = empty/tombstoned)
    sqnorm: torch.Tensor  # f32[capacity] (+inf = empty/tombstoned)

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vecs.device


def make_delta(capacity: int, dim: int, device="cuda") -> DeltaTier:
    """Empty delta ring on ``device`` (all slots carry the pad convention)."""
    return DeltaTier(
        vecs=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        ids=pad_ids((capacity,), device),
        sqnorm=pad_dists((capacity,), device),
    )


def _in_range(delta: DeltaTier, slots) -> torch.Tensor:
    """The row mask of the slots that name a ring slot. The host pads
    every write to a round length with slot -1; JAX scatters drop such a
    row, while a torch index would write -1 to the last slot, so the pad
    rows are filtered out before indexing."""
    slots = torch.as_tensor(slots, device=delta.device).long()
    return slots, (slots >= 0) & (slots < delta.capacity)


def write(delta: DeltaTier, slots, vecs, ids) -> DeltaTier:
    """Scatter ``vecs``/``ids`` into ring ``slots`` (rows with slot -1 are
    dropped) and return the new ring."""
    slots, keep = _in_range(delta, slots)
    s = slots[keep]
    v = torch.as_tensor(vecs, device=delta.device).float()[keep]
    i = torch.as_tensor(ids, device=delta.device).to(torch.int32)[keep]
    out = DeltaTier(vecs=delta.vecs.clone(), ids=delta.ids.clone(),
                    sqnorm=delta.sqnorm.clone())
    out.vecs[s] = v
    out.ids[s] = i
    out.sqnorm[s] = (v ** 2).sum(1)
    return out


def tombstone(delta: DeltaTier, slots) -> DeltaTier:
    """Mask ring ``slots`` back to the pad convention (ids -1, sqnorm
    +inf) so a deleted insert can never re-enter a top-k. Slot -1 is a
    no-op. The vectors are shared with the given ring."""
    slots, keep = _in_range(delta, slots)
    s = slots[keep]
    ids, sqnorm = delta.ids.clone(), delta.sqnorm.clone()
    ids[s] = PAD_ID
    sqnorm[s] = PAD_SQNORM
    return dataclasses.replace(delta, ids=ids, sqnorm=sqnorm)


def live_count(delta: DeltaTier) -> torch.Tensor:
    """i32[] count of live ring slots."""
    return (delta.ids >= 0).sum().to(torch.int32)


def delta_topk(delta: DeltaTier, q: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Brute-force scan of the delta tier with the fused l2_topk kernel.

    Returns (dist f32[B, k] squared ascending, global ids i32[B, k],
    live i32[] scanned-slot count, ninserts i32[B] finite candidates).
    Empty / tombstoned slots enter with sqnorm +inf so they can never
    win; their ids are masked to -1 on the way out."""
    d, i_loc = ops.l2_topk(q, delta.vecs, k=k, x_sqnorm=delta.sqnorm)
    g = delta.ids[i_loc.clamp_min(0).long()]
    g = torch.where((i_loc >= 0) & torch.isfinite(d), g, PAD_ID)
    nins = torch.isfinite(d).sum(1, dtype=torch.int32)
    return d, g, live_count(delta), nins
