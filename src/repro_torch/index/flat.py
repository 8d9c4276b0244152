"""Exact (flat) k-NN search: ground truth for recall measurement and the
fit's training data."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops


def search(q, x, k: int, chunk: int = 1024, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k. q: [B, D], x: [N, D] -> (dist [B, k] ascending,
    i32 idx [B, k]). Runs on ``device``: by default where ``q`` lies if it
    is a tensor, else on the card. There it goes through the fused l2_topk
    kernel; on the CPU through its plain version. Queries go in chunks of
    ``chunk`` rows, which bounds the kernel's scratch."""
    if device is None:
        device = q.device if isinstance(q, torch.Tensor) else "cuda"
    q = torch.as_tensor(q, device=device)
    x = torch.as_tensor(x, device=device)
    xsq = (x.float() ** 2).sum(1)
    outs = [ops.l2_topk(q[lo:lo + chunk], x, k=k, x_sqnorm=xsq)
            for lo in range(0, q.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor
                ) -> torch.Tensor:
    """recall@k: |found ∩ true| / k. found/true: int32[B, k] (-1 = empty)."""
    matches = ((found_ids[:, :, None] == true_ids[:, None, :])
               & (found_ids[:, :, None] >= 0))
    return matches.any(2).sum(1).float() / true_ids.shape[1]
