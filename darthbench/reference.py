"""The plain reference: exact k nearest neighbours under squared L2.

Plain PyTorch, blockwise, on whatever device the collection lies on. It
takes only the collection and the queries the benchmark made, imports
nothing of the program, and computes in float32 with TF32 off (the
configurations state float32). ``matmul`` names a lower precision for the
control that the check must refuse: "tf32" (the card's TF32 tensor-core
products) or "bf16" (inputs rounded to bfloat16, for the CPU).
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

Q_BLOCK = 2048
X_BLOCK = 1 << 18


@contextlib.contextmanager
def _precision(matmul: str):
    cuda_mm = torch.backends.cuda.matmul
    old = (cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda_mm.allow_tf32 = matmul == "tf32"
    torch.backends.cudnn.allow_tf32 = matmul == "tf32"
    try:
        yield
    finally:
        cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _dots(q: torch.Tensor, x: torch.Tensor, matmul: str) -> torch.Tensor:
    if matmul == "bf16":
        return (q.bfloat16().float() @ x.bfloat16().float().T)
    return q @ x.T


def exact_knn(base: torch.Tensor, queries: torch.Tensor, k: int, *,
              matmul: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances f32[Q, k] ascending, ids i64[Q, k]) of the k
    nearest rows of ``base`` to each query, by ||x||^2 - 2 q.x + ||q||^2
    over blocks of queries and rows."""
    if matmul not in ("f32", "tf32", "bf16"):
        raise ValueError(f"matmul {matmul!r}: f32, tf32 or bf16")
    base = base.float()
    queries = queries.to(base.device).float()
    xsq = (base * base).sum(1)
    out_d, out_i = [], []
    with _precision(matmul):
        for q0 in range(0, queries.shape[0], Q_BLOCK):
            q = queries[q0:q0 + Q_BLOCK]
            qsq = (q * q).sum(1, keepdim=True)
            best_d = torch.full((q.shape[0], k), float("inf"),
                                device=base.device)
            best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                                device=base.device)
            for x0 in range(0, base.shape[0], X_BLOCK):
                xb = base[x0:x0 + X_BLOCK]
                d = xsq[None, x0:x0 + X_BLOCK] - 2.0 * _dots(q, xb, matmul) \
                    + qsq
                kk = min(k, d.shape[1])
                v, i = torch.topk(d, kk, dim=1, largest=False)
                cat_d = torch.cat([best_d, v], 1)
                cat_i = torch.cat([best_i, i + x0], 1)
                best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
                best_i = cat_i.gather(1, pos)
            out_d.append(best_d.clamp_min(0.0))
            out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def distances(base: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """||q - x_id||^2 of each (query, id) pair, f32[Q, k], taken as the sum
    of squared differences (no cancellation); +inf where an id is outside
    the collection."""
    ids = ids.to(base.device).long()
    ok = (ids >= 0) & (ids < base.shape[0])
    out = torch.empty(ids.shape, dtype=torch.float32, device=base.device)
    rows = max(1, X_BLOCK // max(1, ids.shape[1]))
    for q0 in range(0, ids.shape[0], rows):
        sl = slice(q0, q0 + rows)
        x = base[ids[sl].clamp(0, base.shape[0] - 1)]
        diff = x - queries[sl].to(base.device).float()[:, None, :]
        out[sl] = (diff * diff).sum(2)
    return torch.where(ok, out, torch.full_like(out, float("inf")))


def sqnorm(a: torch.Tensor) -> torch.Tensor:
    return (a.float() * a.float()).sum(-1)
