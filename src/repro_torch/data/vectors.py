"""Synthetic vector collections + query workloads (paper §4 methodology).

A numpy-only copy of ``repro.data.vectors``: the port imports nothing of
the JAX package, and the same seed must give bit-identical datasets in
both packages (tests/test_torch_kernels.py checks it).

The paper's datasets (SIFT/DEEP/T2I/GLOVE/GIST) are not redistributable;
this module generates matched-structure stand-ins:

  * clustered Gaussian mixtures with a hardness dial (cluster count,
    spread ratio) — GLOVE-like when tightly clustered, GIST-like when
    diffuse;
  * *noisy* query workloads: Gaussian noise with sigma = pct * ||q||
    (exactly the paper's harder-workload generator, §4 'Queries');
  * *OOD* query workloads: queries drawn from a shifted/rotated
    distribution (the T2I100M analogue);
  * learn/base/query splits that never overlap, mirroring the benchmarks'
    learning sets.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class VectorDataset(NamedTuple):
    base: np.ndarray      # f32[N, D] indexed collection
    learn: np.ndarray     # f32[L, D] training-query pool (disjoint)
    queries: np.ndarray   # f32[Q, D] default test workload
    name: str


def make_dataset(n: int = 100_000, d: int = 64, *, num_learn: int = 10_000,
                 num_queries: int = 1_000, clusters: int = 256,
                 cluster_std: float = 1.0, center_scale: float = 4.0,
                 seed: int = 0, name: str = "synth") -> VectorDataset:
    """Clustered mixture. center_scale/cluster_std controls separation
    (higher = more clustered = easier queries, lower LID)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)) * center_scale
    total = n + num_learn + num_queries

    assign = rng.integers(0, clusters, size=total)
    pts = centers[assign] + rng.normal(size=(total, d)) * cluster_std
    pts = pts.astype(np.float32)
    base = pts[:n]
    learn = pts[n:n + num_learn]
    queries = pts[n + num_learn:]
    # Real benchmark learning sets span a DIVERSE hardness range (paper
    # Fig 4b: effort is ~normally distributed). A purely in-cluster
    # synthetic learn set is uniformly easy, which starves the recall
    # predictor of hard examples; diversify ~30% of it: 20% noise-
    # perturbed, 10% drawn from unseen modes of the same family.
    if num_learn >= 10:
        n_noisy = num_learn // 5
        n_far = num_learn // 10
        idx = rng.permutation(num_learn)
        noisy_sel = idx[:n_noisy]
        far_sel = idx[n_noisy:n_noisy + n_far]
        learn = learn.copy()
        pcts = rng.uniform(0.5, 8.0, size=(n_noisy, 1)).astype(np.float32)
        norms = np.linalg.norm(learn[noisy_sel], axis=1, keepdims=True)
        sigma = np.sqrt(pcts * norms / d)
        learn[noisy_sel] += (rng.normal(size=(n_noisy, d)) * sigma
                             ).astype(np.float32)
        far_centers = rng.normal(size=(n_far, d)) * center_scale
        learn[far_sel] = (far_centers + rng.normal(size=(n_far, d))
                          * cluster_std).astype(np.float32)
    return VectorDataset(base=base, learn=learn, queries=queries, name=name)


def noisy_queries(q: np.ndarray, noise_pct: float,
                  seed: int = 0) -> np.ndarray:
    """Harder workloads: add Gaussian noise with sigma^2 = pct * ||q||
    (paper §4: 'The sigma^2 of the added Gaussian Noise is a percentage of
    the norm of each query vector')."""
    rng = np.random.default_rng(seed)
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    sigma = np.sqrt(noise_pct * norms / q.shape[1])
    return (q + rng.normal(size=q.shape) * sigma).astype(np.float32)


def ood_queries(d: int, num: int, *, clusters: int = 64,
                cluster_std: float = 1.0, center_scale: float = 4.0,
                seed: int = 1, like: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Out-of-distribution workload (T2I100M analogue): queries drawn from
    UNSEEN modes of the same generative family — same scale, different
    cluster centers (text-vs-image embeddings sharing one space). Queries
    land between/outside the indexed clusters: harder, distribution-
    shifted, but within the feature ranges a tree predictor can interpolate
    (matching the paper's T2I setup, where OOD degrades predictor MSE but
    targets remain attainable)."""
    rng = np.random.default_rng(seed + 104729)
    centers = rng.normal(size=(clusters, d)) * center_scale
    assign = rng.integers(0, clusters, size=num)
    q = centers[assign] + rng.normal(size=(num, d)) * cluster_std
    return q.astype(np.float32)


class MutationEvent(NamedTuple):
    """One timestamped step of a streaming-update workload."""
    t: int
    kind: str                      # "insert" | "delete"
    vecs: Optional[np.ndarray]     # inserts: f32[M, D]
    ids: Optional[np.ndarray]      # deletes: i64[M] base ids


def mutation_stream(ds: VectorDataset, insert_pct: float = 0.2,
                    delete_pct: float = 0.1, *, drift: float = 0.0,
                    steps: int = 8, clusters: int = 64,
                    seed: int = 0) -> list:
    """Timestamped insert/delete schedule over `ds.base` — the ONE
    workload definition the mutable-index benchmarks and tests share.

    Inserts total insert_pct * N vectors: a `drift` fraction is drawn
    from UNSEEN modes via the `ood_queries` cluster machinery (the
    distribution shift that decays a frozen recall predictor), the rest
    are in-distribution noisy perturbations of base vectors
    (`noisy_queries`). Deletes remove delete_pct * N distinct base ids.
    Events alternate insert/delete across `steps` timestamps so the two
    interleave the way a live collection mutates.
    """
    rng = np.random.default_rng(seed + 7919)
    n, d = ds.base.shape
    n_ins = int(round(insert_pct * n))
    n_del = int(round(delete_pct * n))
    n_ood = int(round(np.clip(drift, 0.0, 1.0) * n_ins))

    src = rng.choice(n, size=max(n_ins - n_ood, 0), replace=True)
    in_dist = noisy_queries(ds.base[src], 0.05, seed=seed + 1)
    ood = ood_queries(d, n_ood, clusters=clusters, seed=seed + 2)
    inserts = np.concatenate([in_dist, ood], axis=0).astype(np.float32)
    inserts = inserts[rng.permutation(inserts.shape[0])]
    del_ids = rng.choice(n, size=min(n_del, n), replace=False
                         ).astype(np.int64)

    events = []
    for t in range(steps):
        ins_t = inserts[t * n_ins // steps:(t + 1) * n_ins // steps]
        if ins_t.shape[0]:
            events.append(MutationEvent(t=t, kind="insert", vecs=ins_t,
                                        ids=None))
        del_t = del_ids[t * n_del // steps:(t + 1) * n_del // steps]
        if del_t.shape[0]:
            events.append(MutationEvent(t=t, kind="delete", vecs=None,
                                        ids=del_t))
    return events


def local_intrinsic_dimensionality(dists: np.ndarray) -> np.ndarray:
    """MLE LID per query from ascending kNN distances [B, k] (paper §4
    'Dataset Complexity'): LID = -(1/k * sum log(d_i / d_k))^-1."""
    d = np.asarray(dists, np.float64)
    d = np.sqrt(np.maximum(d, 1e-12))  # squared -> metric
    w = d[:, -1:]
    ratio = np.clip(d / w, 1e-12, 1.0)
    s = np.mean(np.log(ratio[:, :-1]), axis=1)
    return -1.0 / np.minimum(s, -1e-12)
