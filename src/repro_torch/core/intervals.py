"""Adaptive prediction intervals (paper §3.2, Eq. 1) + the heuristic
hyperparameter selection that makes DARTH tuning-free (§3.2.2)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class IntervalParams(NamedTuple):
    ipi: float  # initial (max) prediction interval, in distance calcs
    mpi: float  # minimum prediction interval


def next_interval(p: IntervalParams, r_target: torch.Tensor,
                  r_pred: torch.Tensor) -> torch.Tensor:
    """Eq. 1: pi = mpi + (ipi - mpi) * (R_t - R_p), clipped to [mpi, ipi]."""
    pi = p.mpi + (p.ipi - p.mpi) * (r_target - r_pred)
    return torch.clamp(pi, p.mpi, p.ipi)


def heuristic_params(dists_rt) -> IntervalParams:
    """ipi = dists_Rt / 2, mpi = dists_Rt / 10 (§3.2.2). A scalar gives
    float fields; an array of per-query dists_Rt gives float32 arrays."""
    d = np.maximum(np.asarray(dists_rt, np.float64), 1.0)
    ipi = np.maximum(d / 2.0, 1.0)
    mpi = np.maximum(d / 10.0, 1.0)
    if d.ndim == 0:
        return IntervalParams(ipi=float(ipi), mpi=float(mpi))
    return IntervalParams(ipi=ipi.astype(np.float32),
                          mpi=mpi.astype(np.float32))


def static_params(dists_rt: float, divisor: float = 4.0) -> IntervalParams:
    """Ablation variant (§4.1.6 'Adaptive-Static'): fixed pi = dists_Rt/4."""
    v = max(float(dists_rt) / divisor, 1.0)
    return IntervalParams(ipi=v, mpi=v)


def dists_to_target(recall_log: np.ndarray, ndis_log: np.ndarray,
                    valid: np.ndarray, r_target: float) -> np.ndarray:
    """Per-query oracle: #distance calcs at the first step reaching R_t.

    recall_log/ndis_log/valid: [T, B] per-step logs from training-data
    generation. Queries that never reach R_t get their final ndis.
    Returns float64[B].
    """
    hit = (recall_log >= r_target - 1e-9) & valid
    t_idx = np.where(hit.any(0), hit.argmax(0), -1)
    last_valid = np.maximum(valid.astype(np.int64).cumsum(0).argmax(0), 0)
    t_eff = np.where(t_idx >= 0, t_idx, last_valid)
    return ndis_log[t_eff, np.arange(ndis_log.shape[1])].astype(np.float64)
