"""Lloyd's k-means (the IVF coarse quantizer).

kmeans++-style seeding on a subsample, then Lloyd iterations whose
assignment is the fused l2_topk kernel with k = 1. Randomness comes from
a CPU ``torch.Generator`` seeded with ``seed``; it cannot reproduce the
reference's ``jax.random`` stream, so the two builds agree in quality
(recall), not in centroids. The Lloyd step's sums go through
``reduce.index_sum`` (fixed-point on the card), so a build repeats bit
for bit from call to call on the card as on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.reduce import index_sum


def assign(x: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment, lowest centroid on a tie.
    x: [N, D], centroids: [C, D] -> int32[N]."""
    csq = (centroids ** 2).sum(1)
    zero = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
    out = [ops.l2_topk(x[lo:lo + chunk], centroids, k=1, x_sqnorm=csq,
                       bias=zero.expand(min(chunk, x.shape[0] - lo), 1))[1]
           for lo in range(0, x.shape[0], chunk)]
    return torch.cat(out)[:, 0]


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor,
                gen: torch.Generator):
    c = centroids.shape[0]
    a = assign(x, centroids).long()
    sums = index_sum(a, x, c)
    counts = torch.zeros((c,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, a, torch.ones((x.shape[0],), dtype=torch.float32, device=x.device))
    new = sums / counts.clamp_min(1.0)[:, None]
    # Re-seed empty clusters from random points.
    rand_idx = torch.randint(0, x.shape[0], (c,), generator=gen).to(x.device)
    new = torch.where((counts > 0)[:, None], new, x[rand_idx])
    shift = ((new - centroids) ** 2).sum()
    return new, shift


def kmeans(x: torch.Tensor, num_clusters: int, iters: int = 15,
           seed: int = 0, sample: int = 200_000) -> torch.Tensor:
    """Fit centroids on x's device. Returns float32[num_clusters, D]."""
    x = x.float()
    dev = x.device
    gen = torch.Generator().manual_seed(seed)
    n = x.shape[0]
    train = x
    if n > sample:
        train = x[torch.randperm(n, generator=gen)[:sample].to(dev)]

    # kmeans++-lite seeding: d2-weighted sequential picks on a subsample.
    # The uniforms are drawn up front, so the picks need no host sync.
    pool = min(train.shape[0], 20 * num_clusters)
    seed_pool = train[torch.randperm(train.shape[0],
                                     generator=gen)[:pool].to(dev)]
    u = torch.rand((num_clusters,), generator=gen, dtype=torch.float64
                   ).to(dev)
    cents = [seed_pool[:1]]
    d2 = ((seed_pool - seed_pool[0]) ** 2).sum(1)
    for i in range(1, num_clusters):
        cdf = torch.cumsum(d2.double(), 0)
        pick = torch.searchsorted(cdf, (u[i] * cdf[-1]).reshape(1),
                                  right=True).clamp_max(pool - 1)
        c = seed_pool.index_select(0, pick)
        cents.append(c)
        d2 = torch.minimum(d2, ((seed_pool - c) ** 2).sum(1))
    centroids = torch.cat(cents)

    for _ in range(iters):
        centroids, shift = _lloyd_step(train, centroids, gen)
        if float(shift) < 1e-7:
            break
    return centroids
