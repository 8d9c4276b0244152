"""Batched GBDT inference in plain PyTorch (the CPU path; on the card the
recall predictor goes through the gbdt_predict kernel)."""
from __future__ import annotations

import torch

from repro_torch.gbdt.model import GBDTParams
from repro_torch.kernels import ref


def predict(params: GBDTParams, x: torch.Tensor) -> torch.Tensor:
    """Per-tree gathers. x: f32[B, F] -> f32[B]."""
    depth = params.depth
    b = x.shape[0]
    t = params.num_trees
    feat = params.feat.long()[None].expand(b, -1, -1)
    thresh = params.thresh[None].expand(b, -1, -1)
    node = torch.zeros((b, t), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = torch.gather(feat, 2, node[..., None])[..., 0]
        thr = torch.gather(thresh, 2, node[..., None])[..., 0]
        xv = torch.gather(x, 1, f.clamp_min(0))
        node = 2 * node + 1 + ((xv > thr) & (f >= 0)).long()
    leaf_idx = node - (2 ** depth - 1)
    vals = torch.gather(params.leaf[None].expand(b, -1, -1), 2,
                        leaf_idx[..., None])[..., 0]
    return params.base + vals.sum(1)


def predict_efficient(params: GBDTParams, x: torch.Tensor) -> torch.Tensor:
    """Same math through flattened tables: one gather per level."""
    return params.base + ref.gbdt_predict_ref(x, params.feat, params.thresh,
                                              params.leaf)
