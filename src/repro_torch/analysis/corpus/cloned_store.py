"""Known-bad: a placement that gives every shard a clone of the whole
bucket store instead of its slice (pass replicated-store)."""
import dataclasses

import numpy as np
import torch

from repro_torch.analysis.registry import SIZES, Built
from repro_torch.dist import sharding
from repro_torch.index import ivf
from repro_torch.launch import mesh as mesh_lib

EXPECT_PASS = "replicated-store"
SHARDS = 2


def build_bad(device):
    n, d = SIZES["small"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bv, bi, bsq, sizes = ivf.pack_buckets(
        x, x, np.arange(n, dtype=np.int32), rng.integers(0, 16, n), 16)

    def t(v):
        return torch.as_tensor(v, device=device)
    index = ivf.IVFIndex(
        centroids=t(rng.normal(size=(16, d)).astype(np.float32)),
        bucket_vecs=t(bv), bucket_ids=t(bi), bucket_sqnorm=t(bsq),
        bucket_sizes=t(sizes), scale=t(np.ones(d, np.float32)),
        offset=t(np.zeros(d, np.float32)))
    mesh = mesh_lib.make_search_mesh(SHARDS, device)
    placed = sharding.place_index(index, mesh)
    cloned = dataclasses.replace(placed, **{
        name: tuple(getattr(index, name).clone() for _ in range(SHARDS))
        for name in ("bucket_vecs", "bucket_ids", "bucket_sqnorm")})
    return Built(placements=[("cloned store", index, cloned)])
