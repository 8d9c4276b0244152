"""Array-form GBDT ensemble: a dataclass of fixed-shape tensors.

Trees are complete binary trees of fixed ``depth`` stored in level order:
internal node ``i`` has children ``2i+1`` (left, x[f] <= thr) and ``2i+2``
(right). Leaves are the final level, indexed ``node - (2**depth - 1)``.
The state dict (and the ``.npz`` files ``RecallPredictor.save`` writes)
has the same keys and dtypes as ``repro.gbdt.model``, so files load in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass
class GBDTParams:
    """Ensemble parameters.

    feat:   int32[T, 2**depth - 1]  split feature per internal node
            (-1 => degenerate node: everything goes left)
    thresh: float32[T, 2**depth - 1] raw-space threshold (left iff x <= thr)
    leaf:   float32[T, 2**depth]     leaf values (already scaled by lr)
    base:   float32[]                initial prediction (mean of targets)
    """

    feat: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor
    base: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def depth(self) -> int:
        return int(np.log2(self.leaf.shape[1]))


def to_state_dict(p: GBDTParams) -> Dict[str, Any]:
    return {
        "feat": p.feat.cpu().numpy(),
        "thresh": p.thresh.cpu().numpy(),
        "leaf": p.leaf.cpu().numpy(),
        "base": p.base.cpu().numpy(),
    }


def from_state_dict(d: Dict[str, Any], device="cuda") -> GBDTParams:
    def t(v, dtype):
        return torch.as_tensor(np.array(v, dtype), device=device)
    return GBDTParams(
        feat=t(d["feat"], np.int32),
        thresh=t(d["thresh"], np.float32),
        leaf=t(d["leaf"], np.float32),
        base=t(d["base"], np.float32),
    )
