"""Search-quality measures used in the paper's evaluation (§4, Fig 10-16):
recall, RDE, RQUT, NRS, P99 error, worst-1% error.

A copy of ``repro.core.metrics`` (numpy only): the port imports nothing of
the reference package. Inputs are numpy arrays; call ``.cpu().numpy()`` on
tensors first."""
from __future__ import annotations

from typing import Dict

import numpy as np


def recall(found_ids: np.ndarray, true_ids: np.ndarray) -> np.ndarray:
    """Per-query recall@k. [B, k] int arrays (-1 = empty)."""
    b, k = true_ids.shape
    out = np.zeros((b,), np.float64)
    for i in range(b):
        f = set(x for x in found_ids[i].tolist() if x >= 0)
        out[i] = len(f & set(true_ids[i].tolist())) / k
    return out


def rde(found_d: np.ndarray, true_d: np.ndarray) -> np.ndarray:
    """Relative Distance Error per query: mean over the k slots of
    (d_found - d_true)/d_true using METRIC distances (sqrt of squared)."""
    f = np.sqrt(np.maximum(np.where(np.isfinite(found_d), found_d, 0.0), 0))
    t = np.sqrt(np.maximum(true_d, 0))
    denom = np.maximum(t, 1e-9)
    return np.mean(np.maximum(f - t, 0.0) / denom, axis=1)


def rqut(rec: np.ndarray, r_target: float) -> float:
    """Ratio of Queries Under the recall Target."""
    return float((rec < r_target - 1e-9).mean())


def nrs(found_ids: np.ndarray, gt_ids_wide: np.ndarray) -> np.ndarray:
    """Normalized Rank Sum per query: ideal_rank_sum / actual_rank_sum,
    in (0, 1]; 1 = perfect. gt_ids_wide: [B, K'] (K' >> k) true ranking;
    retrieved ids not in the top-K' get rank K'."""
    b, k = found_ids.shape
    kw = gt_ids_wide.shape[1]
    ideal = k * (k - 1) / 2.0 + k  # sum of ranks 1..k
    out = np.zeros((b,), np.float64)
    for i in range(b):
        pos = {int(v): r + 1 for r, v in enumerate(gt_ids_wide[i].tolist())}
        s = sum(pos.get(int(v), kw + 1) for v in found_ids[i].tolist())
        out[i] = ideal / max(s, 1)
    return out


def error_stats(rec: np.ndarray, r_target: float) -> Dict[str, float]:
    """P99 of |R_t - R_q| and mean error over the worst 1% (paper Fig 15/16).
    Error counts only shortfall below the target."""
    err = np.maximum(r_target - rec, 0.0)
    p99 = float(np.percentile(err, 99))
    n_worst = max(1, int(np.ceil(0.01 * len(err))))
    worst = float(np.sort(err)[-n_worst:].mean())
    return {"p99": p99, "worst1pct": worst}


def summarize(found_d, found_i, true_d, true_i, gt_wide_i,
              r_target: float) -> Dict[str, float]:
    rec = recall(found_i, true_i)
    return {
        "recall": float(rec.mean()),
        "rqut": rqut(rec, r_target),
        "rde": float(rde(found_d, true_d).mean()),
        "nrs": float(nrs(found_i, gt_wide_i).mean()),
        **error_stats(rec, r_target),
    }
