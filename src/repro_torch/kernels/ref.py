"""Plain PyTorch versions of the three Hopper kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, on
any device: the CPU tests run them against the JAX reference, and
``chip_smoke.py`` holds each kernel against them on the card. They are
slow and allocate freely; speed is the kernels' job.

Ties break like ``lax.top_k``: lowest candidate column first. Candidate
columns are [running top-k, new candidates], so among equal distances a
running entry beats a new one and a lower database row beats a higher
one. ``torch.topk`` promises no order among ties, so every merge here
is a stable sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.padding import PAD_DIST, pad_dists, pad_ids


def merge_topk(cand_d: torch.Tensor, cand_i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest of each row, ascending, lowest column first on a tie."""
    d, order = torch.sort(cand_d, dim=1, stable=True)
    return d[:, :k], torch.gather(cand_i, 1, order[:, :k])


def l2_topk_ref(q: torch.Tensor, x: torch.Tensor, x_sqnorm: torch.Tensor,
                k: int, chunk: int = 65536
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``x_sqnorm - 2 q.x`` per query row (no ``||q||^2``).

    q: [B, D], x: [N, D] (f32, bf16 or int8), x_sqnorm: f32[N] (+inf on
    rows that must never win). Returns (f32[B, k] ascending, i32[B, k]);
    slots left empty hold (+inf, -1), as the kernel's running top-k
    starts with them."""
    b = q.shape[0]
    n = x.shape[0]
    qf = q.float()
    run_d = pad_dists((b, k), q.device)
    run_i = pad_ids((b, k), q.device)
    for lo in range(0, n, chunk):
        xc = x[lo:lo + chunk].float()
        part = x_sqnorm[lo:lo + chunk].float()[None, :] - 2.0 * (qf @ xc.T)
        ids = torch.arange(lo, lo + xc.shape[0], dtype=torch.int32,
                           device=q.device).expand(b, -1)
        run_d, run_i = merge_topk(torch.cat([run_d, part], 1),
                                  torch.cat([run_i, ids], 1), k)
    return run_d, run_i


def bucket_probe_ref(q, vecs, sqn, ids, bias, kth, run_d, run_i
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused probe on pre-gathered buckets.

    q: f32[B, D]; vecs: [B, C, D] f32/bf16/int8; sqn f32[B, C];
    ids i32[B, C]; bias, kth f32[B, 1]; run_d f32[B, K] ascending,
    run_i i32[B, K]. dist = sqn - 2 q.vecs + bias, clamped at 0, +inf
    where ids < 0. Returns (merged dist [B, K], merged ids [B, K],
    i32[B] count of bucket distances strictly below kth, unclipped)."""
    dist = (sqn.float()
            - 2.0 * torch.einsum("bd,bcd->bc", q.float(), vecs.float())
            + bias.float())
    dist = torch.where(ids >= 0, torch.clamp_min(dist, 0.0), PAD_DIST)
    cnt = (dist < kth.float()).sum(1).to(torch.int32)
    d, i = merge_topk(torch.cat([run_d, dist], 1),
                      torch.cat([run_i, ids], 1), run_d.shape[1])
    return d, i, cnt


def bucket_probe_slots_ref(q, store_vecs, store_sqn, store_ids, slot, active,
                           bias, kth, run_d, run_i):
    """The fused probe reading bucket ``slot[b]`` of the whole store.

    store_vecs: [S, C, D]; store_sqn / store_ids: [S, C]; slot: i32[B];
    active: bool[B]. An inactive query keeps its running top-k and
    counts 0, as the kernel does without reading its bucket."""
    s = slot.long()
    d, i, cnt = bucket_probe_ref(q, store_vecs[s], store_sqn[s],
                                 store_ids[s], bias, kth, run_d, run_i)
    a = active[:, None]
    return (torch.where(a, d, run_d), torch.where(a, i, run_i),
            torch.where(active, cnt, 0))


def gbdt_predict_ref(x: torch.Tensor, feat: torch.Tensor,
                     thresh: torch.Tensor, leaf: torch.Tensor
                     ) -> torch.Tensor:
    """Sum of leaf values over the ensemble (no base). x: f32[B, F];
    feat i32[T, 2^d - 1]; thresh f32[T, 2^d - 1]; leaf f32[T, 2^d].
    Go right iff x[f] > thr and f >= 0."""
    num_trees, n_internal = feat.shape
    depth = (n_internal + 1).bit_length() - 1
    b = x.shape[0]
    feat_flat = feat.reshape(-1).long()
    thresh_flat = thresh.reshape(-1)
    tree_off = torch.arange(num_trees, device=x.device) * n_internal
    node = torch.zeros((b, num_trees), dtype=torch.long, device=x.device)
    for _ in range(depth):
        idx = node + tree_off[None, :]
        f = feat_flat[idx]
        t = thresh_flat[idx]
        xv = torch.gather(x, 1, torch.clamp_min(f, 0))
        node = 2 * node + 1 + ((xv > t) & (f >= 0)).long()
    leaf_idx = node - n_internal
    n_leaf = leaf.shape[1]
    leaf_off = torch.arange(num_trees, device=x.device) * n_leaf
    return leaf.reshape(-1)[leaf_idx + leaf_off[None, :]].sum(1)
