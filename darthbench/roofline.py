"""Peaks of the card and the least time of each hand-written kernel call.

A roofline share is the least time the card could take for the calls,
the larger of their operations over the peak rate and their bytes over
the peak bandwidth, divided by the device time the profiler recorded for
the same calls. The counts follow the byte bounds of the port's on-chip
smoke script (``probe_bound``, the ``gbdt_predict`` row), copied here:
every input byte is counted once, every output byte once, and where the
work depends on the data (which buckets an active query reads) what the
call's inputs need is counted, not the most they could.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

# NVIDIA H100 SXM data sheet (dense, without sparsity), at its 700 W
# limit. The 80 GB HBM3 part is the SXM one (the PCIe part has HBM2e).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12,
                              "tf32_flop_per_s": 495e12,
                              "bf16_flop_per_s": 989e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold (a
    share is then not reported, never guessed)."""
    return PEAKS.get(kind)


def probe_counts(slot: torch.Tensor, active: torch.Tensor,
                 live_per_bucket: torch.Tensor, *, cap: int, dim: int,
                 code_bytes: int, k: int) -> Dict[str, torch.Tensor]:
    """Bytes and operations of ``bucket_probe_slots`` calls, one per row
    of ``slot`` / ``active`` [R, B] (query b of call r reads bucket
    slot[r, b] when active[r, b]).

    Bytes of one call: each distinct bucket that an active query reads,
    once (every id of it, 4 x cap; the codes and sqnorm of its live rows,
    live x (dim x code_bytes + 4)); every query's active flag (1 byte);
    each active query's own inputs (q 4 x dim, its slot, bias and kth, 4
    each) and its running top-k in and out (2 x 8 x k) and its count out
    (4). Operations: 2 x dim for each live row an active query scans.
    Returns float64 tensors [R]."""
    slot = slot.reshape(-1, slot.shape[-1]).long()
    active = active.reshape(slot.shape).bool()
    nrows = live_per_bucket.shape[0]
    live = live_per_bucket.to(torch.float64)
    read = torch.zeros((slot.shape[0], nrows + 1), dtype=torch.float64,
                       device=slot.device)
    read.scatter_(1, slot.masked_fill(~active, nrows), 1.0)
    read = read[:, :nrows]
    buckets = read.sum(1)
    live_read = read @ live
    rows = active.sum(1).to(torch.float64)
    own = rows * (4.0 * dim + 12.0 + 16.0 * k + 4.0) + slot.shape[1]
    byts = 4.0 * cap * buckets + live_read * (dim * code_bytes + 4.0) + own
    scanned = (live[slot.clamp(0, nrows - 1)] * active).sum(1)
    return {"bytes": byts, "flops": 2.0 * dim * scanned}


def probe_least_s(counts: Dict[str, torch.Tensor],
                  pk: Dict[str, float]) -> float:
    """Summed least time of the calls whose counts are given."""
    t_b = counts["bytes"] / pk["bytes_per_s"]
    t_f = counts["flops"] / pk["f32_flop_per_s"]
    return float(torch.maximum(t_b, t_f).sum())


def gbdt_counts(rows: int, features: int, trees: int,
                depth: int) -> Dict[str, float]:
    """Bytes and operations of one ``gbdt_predict`` call: the features in
    (4 x rows x features), the trees once (feature index and threshold of
    each internal node, 4 bytes each, and each leaf value, 4 bytes) and
    the predictions out (4 x rows); a comparison per level and a sum per
    tree for each row."""
    internal = 2 ** depth - 1
    tree_bytes = 4.0 * trees * (2 * internal + internal + 1)
    return {"bytes": 4.0 * rows * features + tree_bytes + 4.0 * rows,
            "flops": float(rows) * trees * (depth + 1)}


def gbdt_least_s(counts: Dict[str, float], pk: Dict[str, float]) -> float:
    return max(counts["bytes"] / pk["bytes_per_s"],
               counts["flops"] / pk["f32_flop_per_s"])
