"""Recall predictor: GBDT params + the path that runs them.

A feature tensor on the card goes through the gbdt_predict kernel
(``kernels.ops``); one on the CPU through ``gbdt.predict_efficient``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.features import NUM_FEATURES
from repro_torch.gbdt import infer
from repro_torch.gbdt.model import GBDTParams, from_state_dict, to_state_dict
from repro_torch.kernels import ops


@dataclasses.dataclass
class RecallPredictor:
    params: GBDTParams

    def __post_init__(self):
        # The kernel loads x[f] unchecked: validate the ensemble once.
        if int(self.params.feat.max()) >= NUM_FEATURES:
            raise ValueError("GBDT split feature index out of range")

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        if feats.is_cuda:
            return ops.gbdt_predict(self.params, feats)
        return infer.predict_efficient(self.params, feats)

    def save(self, path: str) -> None:
        np.savez(path, **to_state_dict(self.params))

    @classmethod
    def load(cls, path: str, device="cuda") -> "RecallPredictor":
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
        return cls(params=from_state_dict(sd, device=device))


def regression_metrics(pred: np.ndarray, true: np.ndarray) -> dict:
    pred = np.asarray(pred, np.float64)
    true = np.asarray(true, np.float64)
    mse = float(np.mean((pred - true) ** 2))
    mae = float(np.mean(np.abs(pred - true)))
    ss_res = float(np.sum((pred - true) ** 2))
    ss_tot = float(np.sum((true - true.mean()) ** 2)) + 1e-12
    return {"mse": mse, "mae": mae, "r2": 1.0 - ss_res / ss_tot}
